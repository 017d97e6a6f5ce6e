"""The DPT head's epilogue, the 1x1 conv (32 -> 4) and the exp postprocess,
as one CUDA kernel: its wrapper and its plain version (TPU row 13).

Counterpart of `scripts/exp_tailk2_r2.py::post_pallas`, rows 12/14's
epilogue split off their conv: on the ReLU'd conv2 output h it computes
the 1x1 plus b3, `xyz / max(|xyz|, 1e-8) * expm1(|xyz|)` and
`conf_vmin + exp(o[3])` (the script's `conf_vmin` is 1.0). The kernel is
`csrc/dpt_post.cu` (hand-written for sm_90a: one thread a pixel; its
header says what bounds it), whose per-pixel body, `csrc/dpt_post.cuh`, is
also the fused tail's epilogue (`csrc/dpt_tail.cu`). The model's path takes
the fused tail (`ops/dpt_tail.py`); this serves `tools/conv_variants.py`,
which times the epilogue alone beside it.

Layouts are PyTorch's: h is (B, 32, H, W) fp32 in `torch.channels_last`
memory (the memory of the script's (B, H, W, 32)), w3 (4, 32, 1, 1) as
`dpt.head.4`, b3 (4,); the results are pts3d (B, H, W, 3) and conf
(B, H, W), contiguous fp32.

* `dpt_post_ref` is the plain version: fp32 `F.conv2d` for the 1x1, then
  the tail's own `_postprocess`.
* `dpt_post_kernel` is the wrapper: it refuses what the kernel cannot take,
  returns the plain version for CPU tensors and launches the kernel for
  CUDA tensors (or raises). `dpt_post_kernel.launches` counts launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import count_launch
from .dpt_tail import HIDDEN, NOUT, _postprocess


def dpt_post_ref(h, w3, b3, conf_vmin=1.0):
    """The 1x1 conv plus b3 in fp32, then the postprocess."""
    return _postprocess(F.conv2d(h, w3, b3), conf_vmin)


_LIB = None


def _kernel():
    global _LIB
    if _LIB is None:
        from ._build import load_library

        fn = load_library("dpt_post").dust3r_dpt_post
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 2
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = fn
    return _LIB


def _check(h, w3, b3):
    """Refuse what the kernel cannot take, on any device."""
    tensors = (h, w3, b3)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"dpt_post takes fp32 tensors, got {[t.dtype for t in tensors]}")
    if any(t.device != h.device for t in tensors):
        raise ValueError("h, w3 and b3 must lie on one device")
    if h.dim() != 4 or h.shape[1] != HIDDEN or tuple(w3.shape) != (NOUT, HIDDEN, 1, 1) or (
            tuple(b3.shape) != (NOUT,)):
        raise ValueError(f"want h (B, {HIDDEN}, H, W), w3 {(NOUT, HIDDEN, 1, 1)}, b3 "
                         f"{(NOUT,)}; got {tuple(h.shape)}, {tuple(w3.shape)}, "
                         f"{tuple(b3.shape)}")
    if h.numel() == 0:
        raise ValueError(f"empty h {tuple(h.shape)}")
    if not h.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("h must be channels_last (NHWC memory)")


def dpt_post_kernel(h, w3, b3, conf_vmin=1.0):
    """h (B, 32, H, W) fp32 channels_last -> pts3d (B, H, W, 3), conf
    (B, H, W), both contiguous fp32."""
    _check(h, w3, b3)
    if h.device.type == "cpu":
        return dpt_post_ref(h, w3, b3, conf_vmin)
    if not h.is_cuda:
        raise ValueError(f"dpt_post runs on CPU or CUDA tensors, got {h.device}")
    if h.data_ptr() % 16:
        raise ValueError("h must start at a 16-byte aligned address")
    B, _, H, W = h.shape
    w3c, b3c = w3.reshape(NOUT, HIDDEN).contiguous(), b3.contiguous()
    pts = torch.empty((B, H, W, 3), device=h.device, dtype=torch.float32)
    conf = torch.empty((B, H, W), device=h.device, dtype=torch.float32)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = _kernel()(h.data_ptr(), w3c.data_ptr(), b3c.data_ptr(), float(conf_vmin),
                        pts.data_ptr(), conf.data_ptr(), B * H * W, stream)
    if err != 0:
        raise RuntimeError(f"dpt_post kernel launch failed: CUDA error {err} "
                           f"(h {tuple(h.shape)})")
    count_launch(dpt_post_kernel, "launches")
    return pts, conf


dpt_post_kernel.launches = 0
