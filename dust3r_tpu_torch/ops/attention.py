"""Attention entry point of the model blocks: the plain version or the kernel.

Counterpart of `dust3r_tpu/ops/attention.py`. Unlike the JAX dispatcher,
nothing here catches an exception: a kernel that cannot serve a call
raises, so a measurement never times the plain version by mistake.

The kernel route is differentiable through `KernelAttention`, the
counterpart of the JAX custom VJP (`_attention_pallas_diff`): its forward
is the kernel's wrapper, its backward recomputes in plain PyTorch, in fp32,
as the JAX backward does in XLA (nothing but q, k and v is kept from the
forward).
"""
from __future__ import annotations

import torch

from .fused_attention import attention_ref, fused_attention
from .rope import apply_rope2d, apply_rope2d_inverse

IMPLS = ("plain", "kernel")


def attention_backward(q, k, v, positions_q, positions_k, rope_base, g):
    """(dq, dk, dv) of `attention_ref` at g, as the JAX `_attention_pallas_bwd`
    computes them: the rope'd q and k (in their dtype) and P = softmax(q kᵀ
    / √d) recomputed in fp32; dv = Pᵀ g, dP = g vᵀ, dS = P ∘ (dP − rowsum(dP
    ∘ P)); dq and dk through the inverse rotation; each cast back to its
    input's dtype."""
    qr = apply_rope2d(q, positions_q, rope_base) if positions_q is not None else q
    kr = apply_rope2d(k, positions_k, rope_base) if positions_k is not None else k
    scale = q.shape[-1] ** -0.5
    qr, kr = qr.float(), kr.float()
    p = torch.softmax(torch.matmul(qr, kr.transpose(-1, -2)) * scale, dim=-1)
    g32 = g.float()
    dv = torch.matmul(p.transpose(-1, -2), g32)
    dp = torch.matmul(g32, v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    del p, dp
    dqr = torch.matmul(ds, kr) * scale
    dkr = torch.matmul(ds.transpose(-1, -2), qr) * scale
    if positions_q is not None:
        dqr = apply_rope2d_inverse(dqr, positions_q, rope_base)
    if positions_k is not None:
        dkr = apply_rope2d_inverse(dkr, positions_k, rope_base)
    return dqr.to(q.dtype), dkr.to(k.dtype), dv.to(v.dtype)


class KernelAttention(torch.autograd.Function):
    """`fused_attention` with the JAX custom VJP's backward. q, k and v may
    be strided head views of the projections (the kernel reads them in
    place); autograd routes dq, dk and dv back into their bases. Positions,
    the RoPE base and the tables get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, positions_q, positions_k, rope_base, tables_q, tables_k):
        ctx.save_for_backward(q, k, v, positions_q, positions_k)
        ctx.rope_base = rope_base
        return fused_attention(q, k, v, positions_q, positions_k, rope_base, tables_q,
                               tables_k)

    @staticmethod
    def backward(ctx, g):
        q, k, v, positions_q, positions_k = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, positions_q, positions_k, ctx.rope_base, g)
        return dq, dk, dv, None, None, None, None, None


def attention(q, k, v, positions_q=None, positions_k=None, rope_base=100.0,
              impl=None, tables_q=None, tables_k=None):
    """q, k, v: (B, H, N, d), any strides with unit stride in d; positions:
    (B, N, 2) or None.

    impl: None (auto: the kernel for CUDA tensors, else the plain version),
    'plain' or 'kernel'. 'kernel' on CPU tensors runs the kernel's plain
    version, as the kernel's wrapper does, behind the same autograd
    Function. tables_q / tables_k: optional fp32 `rope_tables` of the
    positions, read by the kernel only.
    """
    if impl is None:
        impl = "kernel" if q.is_cuda else "plain"
    if impl == "kernel":
        return KernelAttention.apply(q, k, v, positions_q, positions_k, rope_base, tables_q,
                                     tables_k)
    if impl == "plain":
        return attention_ref(q, k, v, positions_q, positions_k, rope_base)
    raise ValueError(f"attention impl {impl!r} not in {IMPLS} or None")
