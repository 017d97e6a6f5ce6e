"""Softmax variants of the fused attention: the CUDA kernel's wrapper and
its plain version.

Counterpart of the TPU experiments that vary the fused attention's
softmax: `scripts/exp_softmax_r2.py::attn(safe=False)` ("nomax") and the
`kern_bf16s` ("bf16_logits") and `kern_bf16exp` ("bf16_exp") kernels of
`scripts/exp_attn_variants.py`. The kernel is `csrc/fused_attention.cu`'s,
on the core of `csrc/attention_core.cuh`, given a softmax code; its
header says what each variant computes. They answer a question of speed
and are served by this entry point and `tools/attn_variants.py`, not by
the model: "nomax" overflows where a logit passes ~88.

* `attention_variant_ref` is the plain version, step by step the scripts'
  arithmetic: q and k to fp32, RoPE from fp32 tables, q scaled, q and k
  rounded to the input dtype; logits in fp32 (bf16 for "bf16_logits");
  the row max subtracted (in the logits' dtype; not for "nomax"); exp in
  fp32 (in bf16 for "bf16_logits" and "bf16_exp"); the fp32 row sum of
  that P; P rounded to the input dtype, P.v with fp32 sums, the divide.
  softmax="exact" is the TPU row-1 kernel's own arithmetic (fp32 RoPE),
  the yardstick the variants are held to.
* `attention_variant` is the wrapper: the plain version for CPU tensors;
  for CUDA tensors it launches the kernel or raises.
  `attention_variant.launches` counts kernel launches.
"""
from __future__ import annotations

import torch

from .fused_attention import check, launch
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
                      softmax, tables_q=None, tables_k=None):
    """The fused attention with softmax "nomax", "bf16_logits" or
    "bf16_exp" (see the module docstring). Arguments and output as
    `fused_attention`'s, one head a block, bf16 on the card."""
    if softmax not in SOFTMAXES:
        raise ValueError(f"softmax {softmax!r} not in {SOFTMAXES}")
    if q.device.type == "cpu":
        return attention_variant_ref(q, k, v, positions_q, positions_k, rope_base, softmax)
    check(q, k, v, positions_q, positions_k)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the softmax variants are bf16 kernels, got {q.dtype}")
    out = launch(q, k, v, positions_q, positions_k, rope_base, tables_q, tables_k,
                 softmax=_CODES[softmax])
    attention_variant.launches += 1
    return out


attention_variant.launches = 0
