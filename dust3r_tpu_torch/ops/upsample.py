"""2x bilinear upsample with align_corners=True: the CUDA kernel's wrapper,
its plain version and the dispatcher of the DPT heads.

Replaces `scripts/exp_up_pallas_r2.py::up2x_phase_pallas`, the Pallas TPU
kernel of `dust3r_tpu/models/heads.py::upsample2x_align_corners`. The
kernel is `csrc/up2x.cu` (hand-written for sm_90a: one thread per output
pixel and 4 channels, 16-byte loads and stores; its header says what
bounds it on the card and how the design answers that). It writes the fine
NHWC map directly, where the TPU kernel wrote four phase channel groups.

Layouts are PyTorch's: x is (B, C, H, W) in `torch.channels_last` memory
(NHWC, the layout of the JAX function), and so is the (B, C, 2H, 2W)
result, in x's dtype: fp32, or bf16 (the bf16 mode of the serving
configuration's bf16 heads: the lerps in fp32, y rounded once).

* `up2x_ref` is the plain version: the even/odd closed form of the JAX
  `_up2x_axis_lerp` (rows, then columns) in fp32 PyTorch, rounded once to
  x's dtype. The CPU tests, the card-side comparison and `impl='ref'` use
  it.
* `up2x_kernel` is the wrapper. For a CPU tensor it returns the plain
  version; for a CUDA tensor it launches the kernel or raises.
  `up2x_kernel.launches` counts kernel launches, `up2x_kernel.bf16_launches`
  those of the bf16 mode.
* `KernelUp2x` makes the kernel differentiable: its backward is the
  adjoint of the lerps, `up2x_ref` differentiated by autograd (the JAX
  head's `upsample2x_align_corners` under `jax.vjp`). The map is linear,
  so the backward keeps only x's shape.
* `up2x(x, impl)` dispatches: impl None (auto: the kernel for CUDA
  tensors, 'ref' for CPU tensors), 'ref' or 'kernel' (through
  `KernelUp2x`). Nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

IMPLS = ("ref", "kernel")
# the kernel moves 16 bytes an access: 4 fp32 or 8 bf16 channels
CHANNEL_MULTIPLE = {torch.float32: 4, torch.bfloat16: 8}


def _up2x_axis(x, axis):
    """2x along `axis` of an NHWC tensor: for n samples and k = 0..n-1,
      out[2k]   = k/(2n-1) * x[k-1] + (1 - k/(2n-1)) * x[k]
      out[2k+1] = (1 - w_k) * x[k] + w_k * x[k+1],  w_k = (n-1-k)/(2n-1)
    with the shifts clamped at the edges (their weights are 0 there)."""
    n = x.shape[axis]
    shape = [1] * x.dim()
    shape[axis] = n
    k = torch.arange(n, dtype=torch.float64, device=x.device)
    we = (k / (2 * n - 1)).to(x.dtype).reshape(shape)
    wo = ((n - 1 - k) / (2 * n - 1)).to(x.dtype).reshape(shape)
    up = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], axis)
    down = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], axis)
    even = we * up + (1.0 - we) * x
    odd = (1.0 - wo) * x + wo * down
    out_shape = list(x.shape)
    out_shape[axis] = 2 * n
    return torch.stack([even, odd], axis + 1).reshape(out_shape)


def up2x_ref(x):
    """The kernel's function in plain PyTorch: (B, C, H, W) -> (B, C, 2H,
    2W), channels_last; the lerps in fp32 (in x's dtype if wider), the
    result rounded once to x's dtype."""
    y = x.permute(0, 2, 3, 1)  # NHWC
    y = _up2x_axis(_up2x_axis(y.float() if x.dtype == torch.bfloat16 else y, 1), 2)
    return y.permute(0, 3, 1, 2).to(x.dtype)


_LIB = None


def _kernel():
    global _LIB
    if _LIB is None:
        from ._build import load_library

        fn = load_library("up2x").dust3r_up2x
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = fn
    return _LIB


def _check(x):
    if not x.is_cuda:
        raise ValueError("x must lie on a CUDA device")
    if x.dtype not in CHANNEL_MULTIPLE:
        raise TypeError(f"up2x kernel takes fp32 or bf16 x, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"want x (B, C, H, W), got {tuple(x.shape)}")
    B, C, H, W = x.shape
    if C % CHANNEL_MULTIPLE[x.dtype]:
        raise ValueError(f"C {C} must be a multiple of {CHANNEL_MULTIPLE[x.dtype]} "
                         f"for {x.dtype}")
    if x.numel() == 0 or x.numel() >= 2 ** 31 - 1:  # y's 16-byte groups index in 32 bits
        raise ValueError(f"unsupported size {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels_last (NHWC memory)")
    if x.data_ptr() % 16:
        raise ValueError("x must start at a 16-byte aligned address")


def up2x_kernel(x):
    """x (B, C, H, W) fp32 or bf16 channels_last -> (B, C, 2H, 2W)
    channels_last in x's dtype, align_corners=True."""
    if x.device.type == "cpu":
        return up2x_ref(x)
    _check(x)
    B, C, H, W = x.shape
    y = torch.empty((B, C, 2 * H, 2 * W), device=x.device, dtype=x.dtype,
                    memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(x.data_ptr(), y.data_ptr(), B, H, W, C,
                        int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"up2x kernel launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)})")
    up2x_kernel.launches += 1
    up2x_kernel.bf16_launches += int(x.dtype == torch.bfloat16)
    return y


up2x_kernel.launches = 0
up2x_kernel.bf16_launches = 0  # of them, the bf16 mode's


def up2x_backward(g):
    """dx of `up2x_ref` at g (B, C, 2H, 2W): the adjoint of the lerps, by
    autograd. The map is linear, so no value of x is needed."""
    B, C, H2, W2 = g.shape
    x = torch.zeros((B, C, H2 // 2, W2 // 2), dtype=g.dtype, device=g.device,
                    requires_grad=True)
    with torch.enable_grad():
        y = up2x_ref(x)
    return torch.autograd.grad(y, x, g)[0]


class KernelUp2x(torch.autograd.Function):
    """`up2x_kernel` with `up2x_backward` as its backward."""

    @staticmethod
    def forward(ctx, x):
        return up2x_kernel(x)

    @staticmethod
    def backward(ctx, g):
        return up2x_backward(g)


def up2x(x, impl=None):
    """The DPT heads' 2x upsample. impl: None (auto: the kernel for CUDA
    tensors, else 'ref'), 'ref' or 'kernel' ('kernel' on CPU tensors runs
    the plain version, as its wrapper does)."""
    if impl is None:
        impl = "kernel" if x.is_cuda else "ref"
    if impl == "kernel":
        return KernelUp2x.apply(x)
    if impl == "ref":
        return up2x_ref(x)
    raise ValueError(f"up2x impl {impl!r} not in {IMPLS} or None")
