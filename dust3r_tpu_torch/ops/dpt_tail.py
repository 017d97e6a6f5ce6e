"""The DPT head's tail: conv2 (3x3, 128 -> 32) + ReLU + conv3 (1x1, 32 -> 4)
+ the exp postprocess, as one CUDA kernel; its wrapper, its plain versions
and the dispatcher.

Replaces `scripts/exp_tailk_r2.py::tail_pallas` and
`scripts/exp_tailk2_r2.py::tail3_pallas` (two TPU blockings of one
function: the last four lines of `dust3r_tpu/models/heads.py::DPTHead`).
The kernel is `csrc/dpt_tail.cu` (hand-written for sm_90a: persistent
blocks over 16 x 16 output tiles; each tile's halo box of y is loaded once
by TMA and rounded to bf16 once by one warpgroup, the other reads the nine
taps from that one patch by ldmatrix into mma.sync, then applies the ReLU,
the 1x1 and the postprocess to each pixel in shared memory; its header
says what bounds it on the card and how the design answers that).
Like conv3x3 it rounds y and w2 to bf16 and sums in fp32; the rest is fp32.
y may be bf16 (the bf16 mode, the serving configuration's bf16 heads): the
same function, y read as it is, half its bytes.

It serves the depth mode ('exp', -inf, inf) and a conf mode ('exp',
conf_vmin, inf), those of every published config (`kernel_conf_vmin`
tells). Layouts are PyTorch's: y is (B, 128, H, W) in `torch.channels_last`
memory (the upsample's output), fp32 or bf16, w2 (32, 128, 3, 3), b2 (32,), w3
(4, 32, 1, 1), b3 (4,); the results are pts3d (B, H, W, 3) and conf
(B, H, W), contiguous fp32, as the JAX head returns them.

* `dpt_tail_ref` runs in y's dtype (`F.conv2d`, ReLU, the 1x1) with the
  postprocess in fp32: fp32 throughout for fp32 y, the counterpart of the
  script's `tail_xla` and of the JAX head's last lines; for bf16 y the JAX
  bf16 head's chain (`heads.py:369-375`).
* `dpt_tail_bf16_ref` is the kernel's function in plain PyTorch: y and w2
  rounded to bf16, everything else fp32.
* `pack_w2` is the kernel's packing of w2 (`unpack_w2` inverts it); the
  model's `DPTOutputAdapter` keeps it once per version of the weight.
* `dpt_tail_kernel` is the wrapper. For CPU tensors it returns
  `dpt_tail_bf16_ref`; for CUDA tensors it launches the kernel (once a
  call) or raises. `dpt_tail_kernel.launches` counts kernel launches,
  `dpt_tail_kernel.bf16_launches` those of the bf16 mode.
* `KernelDptTail` makes the kernel differentiable: its backward
  recomputes `dpt_tail_ref` (fp32: conv2, ReLU, conv3, the postprocess)
  under autograd, as `jax.vjp` differentiates the JAX head's last lines,
  into y, w2, b2, w3 and b3. The packed w2 is a derived buffer and takes
  no gradient.
* `dpt_tail(..., impl)` dispatches: impl None (auto: the kernel for CUDA
  tensors, 'ref' for CPU tensors), 'ref' or 'kernel' (through
  `KernelDptTail`). Nothing falls back.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

IMPLS = ("ref", "kernel")
CIN, HIDDEN, NOUT = 128, 32, 4  # y's channels, conv2's outputs, conv3's outputs


def kernel_conf_vmin(depth_mode, conf_mode):
    """conf_vmin when the kernel serves these modes (depth ('exp', -inf,
    inf), conf ('exp', vmin, inf) with a finite vmin), else None."""
    if tuple(depth_mode) != ("exp", -math.inf, math.inf) or conf_mode is None:
        return None
    name, vmin, vmax = conf_mode
    if name != "exp" or vmax != math.inf or not math.isfinite(vmin):
        return None
    return float(vmin)


def _postprocess(o4, conf_vmin):
    """o4 (B, 4, H, W) -> pts3d (B, H, W, 3), conf (B, H, W): the JAX
    `reg_dense_depth` ('exp', -inf, inf) and `reg_dense_conf` ('exp',
    conf_vmin, inf)."""
    o4 = o4.permute(0, 2, 3, 1)
    xyz = o4[..., 0:3]
    d = xyz.norm(dim=-1, keepdim=True)
    pts = xyz / d.clamp(min=1e-8) * torch.expm1(d)
    return pts.contiguous(), (conf_vmin + o4[..., 3].exp()).contiguous()


def dpt_tail_ref(y, w2, b2, w3, b3, conf_vmin):
    """The tail in y's dtype (conv2 + b2, ReLU, conv3 + b3), then the
    postprocess in fp32."""
    dt = y.dtype
    h = F.relu(F.conv2d(y, w2.to(dt), b2.to(dt), padding=1))
    return _postprocess(F.conv2d(h, w3.to(dt), b3.to(dt)).float(), conf_vmin)


def dpt_tail_bf16_ref(y, w2, b2, w3, b3, conf_vmin):
    """The kernel's function in plain PyTorch: y and w2 rounded to bf16
    (their products are exact in fp32), the rest in fp32; y fp32 or bf16."""
    yr = y.to(torch.bfloat16).float()
    w2r = w2.to(torch.bfloat16).float()
    return dpt_tail_ref(yr, w2r, b2, w3, b3, conf_vmin)


_LIB = None


def pack_w2(w2):
    """(32, 128, 3, 3) -> the kernel's bf16 (9 * 128, 32): row
    (dy * 3 + dx) * 128 + c holds the tap's weights of every output
    channel."""
    cout, cin = w2.shape[:2]
    return w2.detach().to(torch.bfloat16).permute(2, 3, 1, 0).reshape(9 * cin, cout).contiguous()


def unpack_w2(w2p):
    """`pack_w2`'s inverse: (9 * Cin, Cout) -> (Cout, Cin, 3, 3) in w2p's
    dtype."""
    cout = w2p.shape[1]
    return w2p.reshape(3, 3, -1, cout).permute(3, 2, 0, 1)


def _kernel():
    global _LIB
    if _LIB is None:
        from ._build import load_library

        fn = load_library("dpt_tail").dust3r_dpt_tail
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_float] + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = fn
    return _LIB


def _check(y, w2, b2, w3, b3):
    tensors = (y, w2, b2, w3, b3)
    if not (y.is_cuda and all(t.device == y.device for t in tensors)):
        raise ValueError("y, w2, b2, w3 and b3 must lie on one CUDA device")
    if y.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != torch.float32 for t in tensors[1:]):
        raise TypeError(f"dpt_tail kernel takes fp32 or bf16 y and fp32 weights, got "
                        f"{[t.dtype for t in tensors]}")
    want = ((CIN,), (HIDDEN, CIN, 3, 3), (HIDDEN,), (NOUT, HIDDEN, 1, 1), (NOUT,))
    got = (tuple(y.shape[1:2]),) + tuple(tuple(t.shape) for t in tensors[1:])
    if y.dim() != 4 or got != want:
        raise ValueError(f"want y (B, {CIN}, H, W), w2 {want[1]}, b2 {want[2]}, w3 "
                         f"{want[3]}, b3 {want[4]}; got y {tuple(y.shape)}, "
                         f"{[tuple(t.shape) for t in tensors[1:]]}")
    B, _, H, W = y.shape
    if B * H * W == 0:
        raise ValueError(f"unsupported size {tuple(y.shape)}")
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("y must be channels_last (NHWC memory)")
    if y.data_ptr() % 16:
        raise ValueError("y must start at a 16-byte aligned address")


def _packed(w2, packed):
    """The kernel's W2: `packed` (checked against w2) or w2 packed here."""
    if packed is None:
        return pack_w2(w2)
    want = (9 * CIN, HIDDEN)
    if (tuple(packed.shape) != want or packed.dtype != torch.bfloat16
            or packed.device != w2.device or not packed.is_contiguous()
            or packed.data_ptr() % 16):
        raise ValueError(f"packed w2 must be contiguous, 16-byte aligned bf16 {want} on "
                         f"{w2.device}, got {packed.dtype} {tuple(packed.shape)} on "
                         f"{packed.device}")
    return packed


def dpt_tail_kernel(y, w2, b2, w3, b3, conf_vmin, packed=None):
    """y (B, 128, H, W) fp32 or bf16 channels_last -> pts3d (B, H, W, 3),
    conf (B, H, W), both contiguous fp32. packed: `pack_w2(w2)` when the caller
    keeps it (the kernel reads it), else packed here; w3, b2 and b3 reach
    the kernel as views of the caller's tensors."""
    if y.device.type == "cpu":
        return dpt_tail_bf16_ref(y, w2, b2, w3, b3, conf_vmin)
    _check(y, w2, b2, w3, b3)
    B, _, H, W = y.shape
    w2p = _packed(w2, packed)
    w3c, b2c, b3c = w3.reshape(NOUT, HIDDEN).contiguous(), b2.contiguous(), b3.contiguous()
    pts = torch.empty((B, H, W, 3), device=y.device, dtype=torch.float32)
    conf = torch.empty((B, H, W), device=y.device, dtype=torch.float32)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = _kernel()(y.data_ptr(), w2p.data_ptr(), b2c.data_ptr(), w3c.data_ptr(),
                        b3c.data_ptr(), float(conf_vmin), pts.data_ptr(), conf.data_ptr(),
                        B, H, W, int(y.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"dpt_tail kernel launch failed: error {err} (y {tuple(y.shape)}; "
                           f"-1: a size it does not take; above 1000: 1000 + the CUresult "
                           f"of encoding y's tensor map)")
    dpt_tail_kernel.launches += 1
    dpt_tail_kernel.bf16_launches += int(y.dtype == torch.bfloat16)
    return pts, conf


dpt_tail_kernel.launches = 0
dpt_tail_kernel.bf16_launches = 0  # of them, the bf16 mode's


def dpt_tail_backward(inputs, conf_vmin, g_pts, g_conf, needs=(True,) * 5):
    """Gradients of `dpt_tail_ref(y, w2, b2, w3, b3, conf_vmin)` at (g_pts,
    g_conf) with respect to the five `inputs`, recomputed in fp32 under
    autograd (None where `needs` says no)."""
    leaves = [t.detach().requires_grad_(need) for t, need in zip(inputs, needs)]
    with torch.enable_grad():
        outs = dpt_tail_ref(*leaves, conf_vmin)
    grads = iter(torch.autograd.grad(outs, [t for t in leaves if t.requires_grad],
                                     (g_pts, g_conf)))
    return tuple(next(grads) if t.requires_grad else None for t in leaves)


class KernelDptTail(torch.autograd.Function):
    """`dpt_tail_kernel` with `dpt_tail_backward` as its backward."""

    @staticmethod
    def forward(ctx, y, w2, b2, w3, b3, conf_vmin, packed):
        ctx.save_for_backward(y, w2, b2, w3, b3)
        ctx.conf_vmin = conf_vmin
        return dpt_tail_kernel(y, w2, b2, w3, b3, conf_vmin, packed)

    @staticmethod
    def backward(ctx, g_pts, g_conf):
        return (*dpt_tail_backward(ctx.saved_tensors, ctx.conf_vmin, g_pts, g_conf,
                                   ctx.needs_input_grad[:5]), None, None)


def dpt_tail(y, w2, b2, w3, b3, conf_vmin, impl=None, packed=None):
    """The DPT head's tail. impl: None (auto: the kernel for CUDA tensors,
    else 'ref'), 'ref' or 'kernel' ('kernel' on CPU tensors runs the
    kernel's plain version, as its wrapper does). packed: the kernel's
    `pack_w2(w2)`, kept by the caller."""
    if impl is None:
        impl = "kernel" if y.is_cuda else "ref"
    if impl == "kernel":
        return KernelDptTail.apply(y, w2, b2, w3, b3, conf_vmin, packed)
    if impl == "ref":
        return dpt_tail_ref(y, w2, b2, w3, b3, conf_vmin)
    raise ValueError(f"dpt_tail impl {impl!r} not in {IMPLS} or None")
