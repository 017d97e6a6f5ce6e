"""Softmax variants of the fused attention: the CUDA kernels' wrapper and
their plain version.

Counterpart of the TPU experiments that vary the fused attention's
softmax: `scripts/exp_softmax_r2.py::attn(safe=False)` ("nomax", the
script's G = 2 heads a program) and the `kern_bf16s` ("bf16_logits") and
`kern_bf16exp` ("bf16_exp") kernels of `scripts/exp_attn_variants.py`.
Two hand-written sm_90a kernels serve them, each named by its `core` as in
`fused_attention`, given a softmax code:

* "sm90", `csrc/fused_attention_sm90.cu`: the variants are modes of its
  consumer loop (TMA ring of K and V, products on wgmma), for bf16 with
  head dim 64 at any G heads a block that divides the heads;
* "mma", `csrc/fused_attention.cu` on the mma.sync core of
  `csrc/attention_core.cuh`: bf16 at head dims 16-64, one head a block
  (any G runs there at one head a block, with the same bits); with
  `core="mma"` it is the sm90 kernel's baseline.

The headers say what each variant computes. They answer a question of
speed and are served by this entry point and `tools/attn_variants.py`,
not by the model: "nomax" overflows where a logit passes ~88.

* `attention_variant_ref` is the plain version, step by step the scripts'
  arithmetic: q and k to fp32, RoPE from fp32 tables, q scaled, q and k
  rounded to the input dtype; logits in fp32 (bf16 for "bf16_logits");
  the row max subtracted (in the logits' dtype; not for "nomax"); exp in
  fp32 (in bf16 for "bf16_logits" and "bf16_exp"); the fp32 row sum of
  that P; P rounded to the input dtype, P.v with fp32 sums, the divide.
  softmax="exact" is the TPU row-1 kernel's own arithmetic (fp32 RoPE),
  the yardstick the variants are held to.
* `attention_variant` is the wrapper: the plain version for CPU tensors;
  for CUDA tensors it launches the kernel of its core or raises; nothing
  falls back from one kernel to the other. `attention_variant.launches`
  counts launches of the sm90 kernel, `attention_variant.core_launches`
  those of the mma.sync core.
"""
from __future__ import annotations

import torch

from ._build import count_launch
from .attention_floors import check_heads_per_program
from .fused_attention import CORES, SM90_HEAD_DIM, check, launch, launch_sm90, route
from .rope import apply_rope2d

SOFTMAXES = ("nomax", "bf16_logits", "bf16_exp")
_CODES = dict(nomax=1, bf16_logits=2, bf16_exp=3)  # attn::Softmax


def attention_variant_ref(q, k, v, positions_q=None, positions_k=None, rope_base=100.0,
                          softmax="exact"):
    """q, k, v: (B, H, N, d); positions (B, N, 2) or None. softmax: "exact"
    or one of SOFTMAXES. Returns (B, H, Nq, d) in q's dtype."""
    if softmax not in ("exact",) + SOFTMAXES:
        raise ValueError(f"softmax {softmax!r} not in {('exact',) + SOFTMAXES}")
    dt = q.dtype
    q32, k32 = q.float(), k.float()
    if positions_q is not None:
        q32 = apply_rope2d(q32, positions_q, rope_base)  # fp32 tables on fp32 tokens
        k32 = apply_rope2d(k32, positions_k, rope_base)
    q_ = (q32 * q.shape[-1] ** -0.5).to(dt)
    k_ = k32.to(dt)
    s = torch.matmul(q_.float(), k_.float().transpose(-1, -2))
    if softmax == "bf16_logits":
        s = s.to(torch.bfloat16)
    if softmax != "nomax":
        s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s) if softmax in ("exact", "nomax") else torch.exp(s.to(torch.bfloat16))
    l = p.float().sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(dt).float(), v.float())
    return (o / l).to(v.dtype)


def attention_variant(q, k, v, positions_q=None, positions_k=None, rope_base=100.0, *,
                      softmax, heads_per_program=1, tables_q=None, tables_k=None, core=None):
    """The fused attention with softmax "nomax", "bf16_logits" or
    "bf16_exp" (see the module docstring). Arguments and output as
    `fused_attention`'s, bf16 on the card. heads_per_program: any divisor
    of the heads (the script's rule, `check_heads_per_program`), every
    value giving the same bits. core: None (`route`: the sm90 kernel for
    head dim 64, the mma.sync core below it), "sm90" (raises where that
    kernel does not serve) or "mma"."""
    if softmax not in SOFTMAXES:
        raise ValueError(f"softmax {softmax!r} not in {SOFTMAXES}")
    check_heads_per_program(heads_per_program, q.shape[1])
    if core is not None and core not in CORES:
        raise ValueError(f"core {core!r} not in {CORES} or None")
    if q.device.type == "cpu":
        return attention_variant_ref(q, k, v, positions_q, positions_k, rope_base, softmax)
    routed = route(q.dtype, q.shape[-1])
    if core == "sm90" and routed != "sm90":
        raise ValueError(f"the sm90 kernel takes bf16 with head dim {SM90_HEAD_DIM}, got "
                         f"{q.dtype}, d={q.shape[-1]}")
    core = core or routed
    G = heads_per_program if core == "sm90" else 1  # the core's variants: one head a block
    check(q, k, v, positions_q, positions_k, G)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the softmax variants are bf16 kernels, got {q.dtype}")
    if core == "sm90":
        out = launch_sm90(q, k, v, positions_q, positions_k, rope_base, tables_q, tables_k, G,
                          softmax=_CODES[softmax])
        count_launch(attention_variant, "launches")
        return out
    out = launch(q, k, v, positions_q, positions_k, rope_base, tables_q, tables_k,
                 softmax=_CODES[softmax])
    count_launch(attention_variant, "core_launches")
    return out


attention_variant.launches = 0
attention_variant.core_launches = 0
