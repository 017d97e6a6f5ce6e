"""The tap-sum form of the 3x3 stride-1 same-pad conv: the CUDA kernel's
wrapper and its plain version (TPU rows 10 and 11).

Counterpart of the TPU experiments `scripts/exp_convk_r3.py::conv3x3_pallas`
(row 10, variant "slices": one bf16 x, the W halo applied in the kernel)
and `scripts/exp_convk2_r3.py::conv3x3_pallas` (row 11, variant "copies":
three W-shifted bf16 copies of x made before the kernel). Both compute

    Z[b, h, w, dy * Cout + c] = bf16(sum_{dx, ci} bf16(x[b, h, w + dx - 1, ci]) * W[dy, dx, ci, c])

with fp32 sums, zero outside the width, then the vertical combine
`y[h] = Z_0[h - 1] + Z_1[h] + Z_2[h + 1]` as two bf16 adds, zero outside
the height: a conv whose result is bf16. The kernel is
`csrc/conv3x3_taps.cu` (hand-written for sm_90a: an implicit GEMM of
M = B*H*W pixels, N = 3*Cout, K = 3*Cin on TMA and wgmma, persistent
blocks, the W halo from TMA's zero fill; its header says what bounds it and
how the design answers that). Its baseline, the mma.sync kernel it
replaced, is `csrc/conv3x3_taps_mma.cu` (`core="mma"`). The combine stays
in PyTorch, as the JAX functions leave it to XLA outside their
`pallas_call`. The model's path takes row 2's nine-tap kernel
(`ops/conv3x3.py`); these serve `tools/conv_variants.py`, which times the Z
form beside it.

The weight is packed as row 11 packs it, (3, Cin, 3 * Cout), row dx,
column dy * Cout + c (`pack_tap_weight`, the mma.sync kernel's), or with
its last two dims swapped, (3, 3 * Cout, Cin), K-major for wgmma
(`pack_tap_weight_kmajor`, the sm90 kernel's). Row 10's own wrapper packs
it otherwise (`exp_convk_r3.py:72-74` mixes dx with Cin) and computes no
conv; the port holds to its kernel body, not to that packing (ROADMAP §C).

Layouts are PyTorch's: x (B, Cin, H, W) fp32 in `torch.channels_last`
memory, w `nn.Conv2d`'s (Cout, Cin, 3, 3); y (B, Cout, H, W) bf16 in
channels_last memory (the scripts return bf16 NHWC).

* `conv3x3_taps_ref` is the plain version, step by step the scripts'
  arithmetic.
* `conv3x3_taps_kernel(x, w, variant, core=None)` is the wrapper: it
  refuses what the kernel cannot take, returns the plain version for CPU
  tensors (whatever the core) and launches the kernel for CUDA tensors (or
  raises): the sm90 kernel for core None or "sm90", the mma.sync baseline
  for "mma". `tap_sums(taps, wt, variant, core=None)` is the kernel step
  alone (bf16 NHWC x in, Z out, the weight packed for the core by
  `pack_for(w, core)`), which counts the launches: the sm90 kernel's in
  `tap_sums.slices_launches` and `tap_sums.copies_launches`, the baseline's
  in `tap_sums.mma_launches`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import count_launch

VARIANTS = ("slices", "copies")
CORES = ("sm90", "mma")  # csrc/conv3x3_taps.cu, csrc/conv3x3_taps_mma.cu (the baseline)
CHANNEL_MULTIPLE = 32  # the kernels' narrowest k-step (Cin) and n-tile (Cout)


def pack_tap_weight(w):
    """(Cout, Cin, 3, 3) -> bf16 (3, Cin, 3 * Cout): [dx, ci, dy * Cout + c]
    holds w[c, ci, dy, dx]."""
    cout, cin = w.shape[:2]
    return w.permute(3, 1, 2, 0).reshape(3, cin, 3 * cout).to(torch.bfloat16).contiguous()


def pack_tap_weight_kmajor(w):
    """(Cout, Cin, 3, 3) -> bf16 (3, 3 * Cout, Cin): [dx, dy * Cout + c, ci]
    holds w[c, ci, dy, dx], `pack_tap_weight` with its last two dims
    swapped (each tap's B K-major, as wgmma reads it)."""
    cout, cin = w.shape[:2]
    return w.permute(3, 2, 0, 1).reshape(3, 3 * cout, cin).to(torch.bfloat16).contiguous()


def pack_for(w, core=None):
    """The weight packed for `core`'s kernel: K-major for the sm90 kernel
    (None, "sm90"), row 11's packing for the mma.sync baseline ("mma")."""
    _check_core(core)
    return pack_tap_weight(w) if core == "mma" else pack_tap_weight_kmajor(w)


def combine_rows(z, cout):
    """Z (B, H, W, 3 * Cout) bf16 -> y (B, Cout, H, W) bf16, channels_last:
    y[h] = (Z_0[h - 1] + Z_1[h]) + Z_2[h + 1], zero outside the height, each
    add rounded to bf16 (the scripts' `sum` over the padded Z). Built in
    place from a copy of Z_1, with no padded copy of Z: a bf16 add is
    commutative and adding a zero is exact, so the bits are the padded
    formula's."""
    y = z[..., cout:2 * cout].contiguous()  # Z_1[h]
    y[:, 1:] += z[:, :-1, :, 0:cout]  # + Z_0[h - 1]
    y[:, :-1] += z[:, 1:, :, 2 * cout:3 * cout]  # + Z_2[h + 1]
    return y.permute(0, 3, 1, 2)


def conv3x3_taps_ref(x, w, variant="slices"):
    """The plain version: x and w rounded to bf16, Z from fp32 sums over the
    dx taps (a (1, 3) conv of 3 * Cout output channels), rounded to bf16,
    then `combine_rows`. Both variants compute this."""
    _check_variant(variant)
    cout, cin = w.shape[:2]
    xb = x.to(torch.bfloat16).float()
    # [dy * Cout + c, ci, 0, dx] = w[c, ci, dy, dx]
    wz = w.to(torch.bfloat16).float().permute(2, 0, 1, 3).reshape(3 * cout, cin, 1, 3)
    z = F.conv2d(xb, wz, padding=(0, 1)).to(torch.bfloat16)
    return combine_rows(z.permute(0, 2, 3, 1), cout)


_ENTRIES = dict(sm90=("conv3x3_taps", "dust3r_conv3x3_taps"),
                mma=("conv3x3_taps_mma", "dust3r_conv3x3_taps_mma"))
_LIBS = {}


def _kernel(core):
    """The C entry of `core`'s kernel, built at first use; both take the
    same arguments."""
    if core not in _LIBS:
        from ._build import load_library

        source, entry = _ENTRIES[core]
        fn = getattr(load_library(source), entry)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIBS[core] = fn
    return _LIBS[core]


def _check_variant(variant):
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")


def _check_core(core):
    if core is not None and core not in CORES:
        raise ValueError(f"core {core!r} not in {CORES} or None")


def _check(x, w, variant, core=None):
    """Refuse what the kernels cannot take, on any device."""
    _check_variant(variant)
    _check_core(core)
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"conv3x3_taps takes fp32 x and w, got {x.dtype}, {w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[2:] != (3, 3) or w.shape[1] != x.shape[1]:
        raise ValueError(f"want x (B, Cin, H, W) and w (Cout, Cin, 3, 3), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError("x and w must lie on one device")
    B, cin, H, W = x.shape
    cout = w.shape[0]
    if cin % CHANNEL_MULTIPLE or cout % CHANNEL_MULTIPLE or cin == 0 or cout == 0:
        raise ValueError(f"Cin {cin} and Cout {cout} must be multiples of {CHANNEL_MULTIPLE}")
    npix = B * H * W
    if npix == 0 or npix * max(cin, 3 * cout) >= 2 ** 31 - 1 or -(-npix // 128) > 65535:
        raise ValueError(f"unsupported size {tuple(x.shape)} -> {cout} channels")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels_last (NHWC memory)")


def tap_inputs(xb, variant):
    """The kernel's A operand(s) from bf16 NHWC x (B, H, W, Cin): x itself
    ("slices"), or its three W-shifted copies, zero-padded, each (B * H, W,
    Cin) contiguous ("copies", as `exp_convk2_r3.py:70-72` makes them)."""
    if variant == "slices":
        return (xb,)
    W = xb.shape[2]
    xp = F.pad(xb, (0, 0, 1, 1))
    return tuple(xp[:, :, dx:dx + W].contiguous() for dx in range(3))


def tap_sums(taps, wt, variant, core=None):
    """The kernel alone: `tap_inputs(...)` and `pack_for(w, core)` on one
    CUDA device -> Z (B, H, W, 3 * Cout) bf16, on the sm90 kernel (core
    None or "sm90") or the mma.sync baseline ("mma"). Counts its launches."""
    _check_variant(variant)
    _check_core(core)
    core = core or "sm90"
    B, H, W, cin = taps[0].shape
    n = wt.shape[1] if core == "sm90" else wt.shape[2]
    want = (3, n, cin) if core == "sm90" else (3, cin, n)
    if tuple(wt.shape) != want or wt.dtype != torch.bfloat16 or not wt.is_contiguous():
        raise ValueError(f"the {core} kernel takes its weight packed by pack_for(w, {core!r}): "
                         f"bf16 {want}, got {wt.dtype} {tuple(wt.shape)}")
    if len(taps) != (3 if variant == "copies" else 1):
        raise ValueError(f"{variant} takes tap_inputs(x, {variant!r}), got {len(taps)} inputs")
    z = torch.empty((B, H, W, n), device=wt.device, dtype=torch.bfloat16)
    ptrs = [t.data_ptr() for t in taps] + [None] * (3 - len(taps))
    if any(p % 16 for p in ptrs if p is not None) or wt.data_ptr() % 16:
        raise ValueError("the tap inputs and the packed weight must be 16-byte aligned")
    with torch.cuda.device(wt.device):
        stream = torch.cuda.current_stream(wt.device).cuda_stream
        err = _kernel(core)(*ptrs, wt.data_ptr(), z.data_ptr(), B * H * W, W, cin, n // 3,
                            int(variant == "copies"), stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_taps {core} kernel launch failed: CUDA error {err} "
                           f"(x {(B, H, W, cin)}, Cout {n // 3}, {variant})")
    if core == "mma":
        count_launch(tap_sums, "mma_launches")
    elif variant == "copies":
        count_launch(tap_sums, "copies_launches")
    else:
        count_launch(tap_sums, "slices_launches")
    return z


tap_sums.slices_launches = 0
tap_sums.copies_launches = 0
tap_sums.mma_launches = 0


def conv3x3_taps_kernel(x, w, variant="slices", core=None):
    """x (B, Cin, H, W) fp32 channels_last, w (Cout, Cin, 3, 3) fp32 ->
    y (B, Cout, H, W) bf16 channels_last: cast, (copies,) kernel, combine.
    core: None or "sm90" (the TMA + wgmma kernel), "mma" (the mma.sync
    baseline); CPU tensors take the plain version whatever the core."""
    _check(x, w, variant, core)
    if x.device.type == "cpu":
        return conv3x3_taps_ref(x, w, variant)
    if not x.is_cuda:
        raise ValueError(f"conv3x3_taps runs on CPU or CUDA tensors, got {x.device}")
    xb = x.permute(0, 2, 3, 1).to(torch.bfloat16)  # NHWC memory: a contiguous cast
    z = tap_sums(tap_inputs(xb, variant), pack_for(w, core), variant, core)
    return combine_rows(z, w.shape[0])
