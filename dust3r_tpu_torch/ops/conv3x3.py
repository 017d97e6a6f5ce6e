"""3x3 stride-1 same-pad convolution: the CUDA kernel's wrapper, its plain
versions, its weight packing and the dispatcher of the DPT heads.

Replaces `dust3r_tpu/ops/conv3x3.py::_conv3x3_pallas_raw`. The kernel is
`csrc/conv3x3.cu` (hand-written for sm_90a: an implicit GEMM fed by a TMA
ring, the products on wgmma with fp32 accumulation, the reduction split
over several blocks on small grids; its header says what bounds it on the
card and how the design answers that). Like the TPU kernel it rounds x and
w to bf16 and accumulates in fp32; unlike it, it never stores the per-tap
partial sums, so it rounds less, never more.

Layouts are PyTorch's: x is (B, Cin, H, W), w is `nn.Conv2d`'s
(Cout, Cin, 3, 3), b is (Cout,) or None. The kernel reads x in
`torch.channels_last` memory (NHWC, the layout of the JAX function) and
writes y in it, in x's dtype: fp32, or bf16 (the bf16 mode of the serving
configuration's bf16 heads: x read as it is, the sums and the bias in
fp32, y rounded once); it reads w packed by `pack_weight`, which the
model's `Conv3x3` modules do once per version of their weight.

* `conv3x3_ref` is `F.conv2d` in x's dtype, the counterpart of the JAX
  `conv3x3_ref`.
* `conv3x3_bf16_ref` is the kernel's plain version: `F.conv2d` in fp32 on
  bf16-rounded x and w, plus the bias, rounded once to x's dtype. The CPU
  tests and the card-side comparison use it.
* `plan` is the launch's shape: output channels a block and how many
  blocks a tile splits the reduction over.
* `conv3x3_kernel` is the wrapper. For a CPU tensor it returns the plain
  version; for a CUDA tensor it launches the kernel (once a call, split or
  not) or raises. `conv3x3_kernel.launches` counts kernel launches,
  `conv3x3_kernel.bf16_launches` those of the bf16 mode.
* `KernelConv3x3` makes the kernel differentiable, as the JAX custom VJP
  (`_conv3x3_pallas_diff`) does: the kernel forward, and a backward of
  the exact fp32 transpose convs of `conv3x3_ref` (dx, dw) and the sum of
  g (db). The packed weight is a derived buffer: it takes no gradient,
  which goes to w.
* `conv3x3(x, w, b, impl)` dispatches: impl None (auto: the kernel for CUDA
  tensors, 'ref' for CPU tensors), 'ref' or 'kernel' (through
  `KernelConv3x3`). Nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

IMPLS = ("ref", "kernel")
CHANNEL_MULTIPLE = 32  # the kernel's k-tile (Cin) and narrowest n-tile (Cout)


def conv3x3_ref(x, w, b=None):
    """Plain conv in x's dtype (fp32 on the heads' path, bf16 in bf16 heads)."""
    return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype), padding=1)


def conv3x3_bf16_ref(x, w, b=None):
    """The kernel's function in plain PyTorch: x and w rounded to bf16, the
    conv in fp32 (bf16 products are exact in fp32), then the bias; y
    rounded once to x's dtype."""
    xr = x.to(torch.bfloat16).float()
    wr = w.to(torch.bfloat16).float()
    y = F.conv2d(xr, wr, padding=1)
    if b is not None:
        y = y + b.float()[:, None, None]
    return y.to(x.dtype)


_LIB = None
_COUNTERS = {}  # device -> zeroed uint32 tile counters of the split reduction

# the kernel's block: an 8 x 16 patch of output pixels; channels a block
BLOCK_ROWS, BLOCK_COLS = 8, 16
BLOCK_CHANNELS = (128, 64, 32)
MAX_SPLITS = 16
COUNTERS = 1 << 16


def _kernel():
    global _LIB
    if _LIB is None:
        from ._build import load_library

        fn = load_library("conv3x3").dust3r_conv3x3
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = fn
    return _LIB


def pack_weight(w):
    """(Cout, Cin, 3, 3) -> the kernel's bf16 (Cin / 32, 9, Cout, 32): chunk
    c of 32 input channels, tap dy * 3 + dx, output channel co, input
    channel c * 32 + i at [c, dy * 3 + dx, co, i]. A step of the kernel
    reads one chunk's three taps of one tap row for a block of channels as
    one box."""
    cout, cin = w.shape[:2]
    return (w.detach().to(torch.bfloat16).permute(2, 3, 0, 1)
            .reshape(9, cout, cin // CHANNEL_MULTIPLE, CHANNEL_MULTIPLE)
            .permute(2, 0, 1, 3).contiguous())


def unpack_weight(wp):
    """`pack_weight`'s inverse: (Cin / 32, 9, Cout, 32) -> (Cout, Cin, 3, 3)
    in wp's dtype."""
    chunks, _, cout, _ = wp.shape
    return wp.permute(1, 2, 0, 3).reshape(3, 3, cout, chunks * CHANNEL_MULTIPLE).permute(
        2, 3, 0, 1)


def plan(B, H, W, cin, cout, sms):
    """(channels a block, tiles, splits) of one launch on a card of `sms`
    SMs (one block an SM): the widest block of channels that divides Cout;
    a tile per 8 x 16 pixel patch of an image and block of channels; and,
    where the tiles fill under half the card, the reduction's (32-channel
    chunk, tap row) steps split over up to 16 blocks a tile, at least 3
    steps each, as many as keep the blocks to one wave."""
    bn = next(n for n in BLOCK_CHANNELS if cout % n == 0)
    tiles = B * -(-H // BLOCK_ROWS) * -(-W // BLOCK_COLS) * (cout // bn)
    steps = 3 * (cin // CHANNEL_MULTIPLE)
    splits = 1
    if tiles < sms:
        splits = max(1, min(sms // tiles, steps // 3, MAX_SPLITS))
    return bn, tiles, splits


def _check(x, w, b):
    if not (x.is_cuda and w.device == x.device and (b is None or b.device == x.device)):
        raise ValueError("x, w and b must lie on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != torch.float32 or (
            b is not None and b.dtype != torch.float32):
        raise TypeError(f"conv3x3 kernel takes fp32 or bf16 x and fp32 w, b, got {x.dtype}, "
                        f"{w.dtype}, {None if b is None else b.dtype}")
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


def _packed(w, packed):
    """The kernel's weight: `packed` (checked against w) or w packed here."""
    if packed is None:
        return pack_weight(w)
    cout, cin = w.shape[:2]
    want = (cin // CHANNEL_MULTIPLE, 9, cout, CHANNEL_MULTIPLE)
    if (tuple(packed.shape) != want or packed.dtype != torch.bfloat16
            or packed.device != w.device or not packed.is_contiguous()):
        raise ValueError(f"packed weight must be contiguous bf16 {want} on {w.device}, got "
                         f"{packed.dtype} {tuple(packed.shape)} on {packed.device}")
    return packed


def _counters(device):
    if device not in _COUNTERS:
        _COUNTERS[device] = torch.zeros(COUNTERS, dtype=torch.int32, device=device)
    return _COUNTERS[device]


def conv3x3_kernel(x, w, b=None, packed=None):
    """x (B, Cin, H, W) fp32 or bf16 channels_last, w (Cout, Cin, 3, 3)
    fp32, b (Cout,) fp32 or None -> y (B, Cout, H, W) channels_last in x's
    dtype. packed: `pack_weight(w)` when the caller keeps it (the kernel
    reads it), else packed here."""
    if x.device.type == "cpu":
        return conv3x3_bf16_ref(x, w, b)
    _check(x, w, b)
    B, cin, H, W = x.shape
    cout = w.shape[0]
    wp = _packed(w, packed)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    bn, tiles, splits = plan(B, H, W, cin, cout, sms)
    ws = counters = None
    if splits > 1:
        if tiles > COUNTERS:
            raise ValueError(f"{tiles} tiles of a split reduction pass the {COUNTERS} counters")
        ws = torch.empty(tiles * splits * BLOCK_ROWS * BLOCK_COLS * bn, device=x.device,
                         dtype=torch.float32)
        counters = _counters(x.device)
    bias = None if b is None else b.contiguous()
    y = torch.empty((B, cout, H, W), device=x.device, dtype=x.dtype,
                    memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(x.data_ptr(), wp.data_ptr(), None if bias is None else bias.data_ptr(),
                        y.data_ptr(), None if ws is None else ws.data_ptr(),
                        None if counters is None else counters.data_ptr(),
                        B, H, W, cin, cout, bn, splits, int(x.dtype == torch.bfloat16),
                        stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: error {err} (x {tuple(x.shape)}, "
                           f"Cout {cout}, {bn} channels a block, {splits} splits; above 1000: "
                           f"1000 + the CUresult of encoding a tensor map)")
    conv3x3_kernel.launches += 1
    conv3x3_kernel.bf16_launches += int(x.dtype == torch.bfloat16)
    return y


conv3x3_kernel.launches = 0
conv3x3_kernel.bf16_launches = 0  # of them, the bf16 mode's


def conv3x3_backward(x, w, g, has_bias=True, needs=(True, True, True)):
    """(dx, dw, db) of `conv3x3_ref(x, w, b)` at g, as the JAX custom VJP
    computes them: g cast to x's dtype, dx and dw the exact transpose convs,
    db the sum of g over (B, H, W) (None without a bias, or where `needs`
    says no)."""
    return torch.ops.aten.convolution_backward(
        g.to(x.dtype), x, w, [w.shape[0]] if has_bias else None, [1, 1], [1, 1], [1, 1],
        False, [0, 0], 1, [needs[0], needs[1], needs[2] and has_bias])


class KernelConv3x3(torch.autograd.Function):
    """`conv3x3_kernel` with `conv3x3_backward` as its backward."""

    @staticmethod
    def forward(ctx, x, w, b, packed):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return conv3x3_kernel(x, w, b, packed)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return (*conv3x3_backward(x, w, g, ctx.has_bias, ctx.needs_input_grad[:3]), None)


def conv3x3(x, w, b=None, impl=None, packed=None):
    """The DPT heads' 3x3 conv. impl: None (auto: the kernel for CUDA
    tensors, else 'ref'), 'ref' or 'kernel' ('kernel' on CPU tensors runs
    the kernel's plain version, as its wrapper does). packed: the kernel's
    `pack_weight(w)`, kept by the caller."""
    if impl is None:
        impl = "kernel" if x.is_cuda else "ref"
    if impl == "kernel":
        return KernelConv3x3.apply(x, w, b, packed)
    if impl == "ref":
        return conv3x3_ref(x, w, b)
    raise ValueError(f"conv3x3 impl {impl!r} not in {IMPLS} or None")
