"""Attention entry point of the model blocks: the plain version or the kernel.

Counterpart of `dust3r_tpu/ops/attention.py`. Unlike the JAX dispatcher,
nothing here catches an exception: a kernel that cannot serve a call
raises, so a measurement never times the plain version by mistake. The
kernel's backward (the JAX custom VJP) comes with training.
"""
from __future__ import annotations

from .fused_attention import attention_ref, fused_attention

IMPLS = ("plain", "kernel")


def attention(q, k, v, positions_q=None, positions_k=None, rope_base=100.0,
              impl=None, tables_q=None, tables_k=None):
    """q, k, v: (B, H, N, d), any strides with unit stride in d; positions:
    (B, N, 2) or None.

    impl: None (auto: the kernel for CUDA tensors, else the plain version),
    'plain' or 'kernel'. 'kernel' on CPU tensors runs the kernel's plain
    version, as the kernel's wrapper does. tables_q / tables_k: optional
    fp32 `rope_tables` of the positions, read by the kernel only.
    """
    if impl is None:
        impl = "kernel" if q.is_cuda else "plain"
    if impl == "kernel":
        return fused_attention(q, k, v, positions_q, positions_k, rope_base,
                               tables_q, tables_k)
    if impl == "plain":
        return attention_ref(q, k, v, positions_q, positions_k, rope_base)
    raise ValueError(f"attention impl {impl!r} not in {IMPLS} or None")
