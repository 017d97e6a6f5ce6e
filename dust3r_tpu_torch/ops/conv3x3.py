"""3x3 stride-1 same-pad convolution: the CUDA kernel's wrapper, its plain
versions and the dispatcher of the DPT heads.

Replaces `dust3r_tpu/ops/conv3x3.py::_conv3x3_pallas_raw`. The kernel is
`csrc/conv3x3.cu` (hand-written for sm_90a: an implicit GEMM over the nine
taps on mma.sync bf16 tensor cores, fp32 accumulation; its header says what
bounds it on the card and how the design answers that). Like the TPU kernel
it rounds x and w to bf16 and accumulates in fp32; unlike it, it never
stores the per-tap partial sums, so it rounds less, never more.

Layouts are PyTorch's: x is (B, Cin, H, W), w is `nn.Conv2d`'s
(Cout, Cin, 3, 3), b is (Cout,) or None. The kernel reads x in
`torch.channels_last` memory (NHWC, the layout of the JAX function) and
writes y in it.

* `conv3x3_ref` is fp32 `F.conv2d`, the counterpart of the JAX
  `conv3x3_ref`.
* `conv3x3_bf16_ref` is the kernel's plain version: `F.conv2d` in fp32 on
  bf16-rounded x and w, plus the bias. The CPU tests and the card-side
  comparison use it.
* `conv3x3_kernel` is the wrapper. For a CPU tensor it returns the plain
  version; for a CUDA tensor it launches the kernel or raises.
  `conv3x3_kernel.launches` counts kernel launches.
* `conv3x3(x, w, b, impl)` dispatches: impl None (auto: the kernel for CUDA
  tensors, 'ref' for CPU tensors), 'ref' or 'kernel'. Nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

IMPLS = ("ref", "kernel")
CHANNEL_MULTIPLE = 32  # the kernel's k-tile (Cin) and narrowest n-tile (Cout)


def conv3x3_ref(x, w, b=None):
    """Plain conv in x's dtype (fp32 on the heads' path)."""
    return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype), padding=1)


def conv3x3_bf16_ref(x, w, b=None):
    """The kernel's function in plain PyTorch: x and w rounded to bf16, the
    conv in fp32 (bf16 products are exact in fp32), then the bias."""
    xr = x.to(torch.bfloat16).float()
    wr = w.to(torch.bfloat16).float()
    y = F.conv2d(xr, wr, padding=1)
    if b is not None:
        y = y + b.float()[:, None, None]
    return y


_LIB = None


def _kernel():
    global _LIB
    if _LIB is None:
        from ._build import load_library

        fn = load_library("conv3x3").dust3r_conv3x3
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = fn
    return _LIB


def pack_weight(w):
    """(Cout, Cin, 3, 3) -> the kernel's bf16 (9 * Cin, Cout): row
    (dy * 3 + dx) * Cin + ci holds the tap's weights of every output channel."""
    cout, cin = w.shape[:2]
    return w.permute(2, 3, 1, 0).reshape(9 * cin, cout).to(torch.bfloat16).contiguous()


def _check(x, w, b):
    if not (x.is_cuda and w.device == x.device and (b is None or b.device == x.device)):
        raise ValueError("x, w and b must lie on one CUDA device")
    if x.dtype != torch.float32 or w.dtype != torch.float32 or (
            b is not None and b.dtype != torch.float32):
        raise TypeError(f"conv3x3 kernel takes fp32 x, w, b, got {x.dtype}, {w.dtype}, "
                        f"{None if b is None else b.dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[2:] != (3, 3) or w.shape[1] != x.shape[1]:
        raise ValueError(f"want x (B, Cin, H, W) and w (Cout, Cin, 3, 3), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, cin, H, W = x.shape
    cout = w.shape[0]
    if cin % CHANNEL_MULTIPLE or cout % CHANNEL_MULTIPLE:
        raise ValueError(f"Cin {cin} and Cout {cout} must be multiples of "
                         f"{CHANNEL_MULTIPLE}")
    if b is not None and b.shape != (cout,):
        raise ValueError(f"bias must be ({cout},), got {tuple(b.shape)}")
    if B * H * W == 0 or B * H * W * max(cin, cout) >= 2 ** 31:
        raise ValueError(f"unsupported size {tuple(x.shape)} -> {cout} channels")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels_last (NHWC memory)")
    if x.data_ptr() % 16:
        raise ValueError("x must start at a 16-byte aligned address")


def conv3x3_kernel(x, w, b=None):
    """x (B, Cin, H, W) fp32 channels_last, w (Cout, Cin, 3, 3) fp32, b
    (Cout,) fp32 or None -> y (B, Cout, H, W) fp32 channels_last."""
    if x.device.type == "cpu":
        return conv3x3_bf16_ref(x, w, b)
    _check(x, w, b)
    B, cin, H, W = x.shape
    cout = w.shape[0]
    wp = pack_weight(w)
    bias = None if b is None else b.contiguous()
    y = torch.empty((B, cout, H, W), device=x.device, dtype=torch.float32,
                    memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(x.data_ptr(), wp.data_ptr(),
                        None if bias is None else bias.data_ptr(), y.data_ptr(),
                        B, H, W, cin, cout, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)}, Cout {cout})")
    conv3x3_kernel.launches += 1
    return y


conv3x3_kernel.launches = 0


def conv3x3(x, w, b=None, impl=None):
    """The DPT heads' 3x3 conv. impl: None (auto: the kernel for CUDA
    tensors, else 'ref'), 'ref' or 'kernel' ('kernel' on CPU tensors runs
    the kernel's plain version, as its wrapper does)."""
    if impl is None:
        impl = "kernel" if x.is_cuda else "ref"
    if impl == "kernel":
        return conv3x3_kernel(x, w, b)
    if impl == "ref":
        return conv3x3_ref(x, w, b)
    raise ValueError(f"conv3x3 impl {impl!r} not in {IMPLS} or None")
