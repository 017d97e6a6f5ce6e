"""The measurement floors of the fused attention: the CUDA kernels' wrapper
and their plain version (the floor modes of TPU row 3).

Counterpart of `scripts/exp_attn_r2.py::attn_g` in its floor modes, under
the script's names (`MODES`): kernels that do part of the attention
kernel's work, so that its time on the card splits into parts:

* "copynr": q + v, the I/O alone;
* "copy": RoPE(q) + v, the I/O and RoPE;
* "copymm": q cos + (q P) sin + v, RoPE through a tensor-core product with
  P the signed permutation of `rot_matrix` (equal to "copy" up to
  rounding);
* "qkonly": the logits q.k^T over every key, the first d columns written;
* "nosmax": bf16(q.k^T) v, both products and no softmax at all. It is not
  `attention_variants`' "nomax", which keeps the exp and the row sum and
  drops only the max.

The kernels are hand-written for sm_90a. All five floors are modes of the
sm90 attention kernel's consumer loop (`csrc/fused_attention_sm90.cu`, TMA
+ wgmma), on its ring of K and V tiles, so their differences split that
kernel's time: copynr the ring's I/O, copy - copynr Q's rotation, qkonly -
copy K's rotation and q.k^T, nosmax - qkonly P.v, the exact kernel -
nosmax the softmax. With `core="mma"` they run on
`csrc/attention_floor.cu` instead, their baseline: nosmax and qkonly on
the mma.sync attention core of `csrc/attention_core.cuh` (two more softmax
codes), the copy modes on one small kernel on the core's tile loaders.
The headers say what bounds each and how work that a floor discards is
kept from being compiled away. They answer a question of speed, served by
this entry point and `tools/attn_variants.py`, not by the model.

* `attention_floor_ref` is the plain version, step by step the script's
  arithmetic (`exp_attn_r2.py:63-115`): q and k to fp32, RoPE from fp32
  tables; for the products q scaled by d^-1/2 and both rounded to the input
  dtype, logits with fp32 sums; the copy modes unscaled, in fp32, rounded
  once. The output has v's dtype.
* `attention_floor` is the wrapper: it refuses what the kernels cannot
  take, returns the plain version for CPU tensors and launches a kernel
  for CUDA tensors (bf16, d = 64), or raises: a CUDA tensor launches the
  kernel the call names and nothing else. `attention_floor.launches`
  counts launches of the sm90 kernel's floors,
  `attention_floor.core_launches` those of `csrc/attention_floor.cu`.
* `rot_matrix` is the script's P; `rot_tile` is P^T as the sm90 kernel
  builds it for copymm, by the kernel's own rule.
"""
from __future__ import annotations

import ctypes
import numbers

import torch

from ._build import count_launch
from .fused_attention import CORES, check, kernel_heads_per_program, launch, launch_sm90
from .rope import apply_rope2d, rope_tables

MODES = ("nosmax", "qkonly", "copy", "copynr", "copymm")  # attention_floor.cu's codes 0-4
COPY_MODES = ("copy", "copynr", "copymm")
# the floors as modes of the sm90 kernel: their attn::Softmax codes
SM90_CODES = dict(nosmax=4, qkonly=5, copy=6, copynr=7, copymm=8)
HEAD_DIM = 64  # the kernels' head dim, the script's


def rot_matrix(d, device=None):
    """(d, d) fp32 P with t @ P == rotate-half(t) within each half [y | x]
    (the script's `rot_matrix`), built on the host, then moved."""
    h, qq = d // 2, d // 4
    P = torch.zeros(d, d)
    for o in (0, h):
        for i in range(qq):
            P[o + qq + i, o + i] = -1.0
            P[o + i, o + qq + i] = 1.0
    return P.to(device)


def rot_tile(d, device=None):
    """(d, d) fp32 P^T, the B operand of copymm's rot = q P as
    `csrc/fused_attention_sm90.cu::build_rot_tile` builds it (a K-major B
    holds B's columns as rows): row n, column c is +1 where n = c + d/4 for
    c in the first quarter of a half, -1 where n = c - d/4 for c in the
    second, else 0. Equal to `rot_matrix(d).T`."""
    n, c = torch.arange(d)[:, None], torch.arange(d)[None]
    first = c % (d // 2) < d // 4
    plus, minus = first & (n == c + d // 4), ~first & (n == c - d // 4)
    return (plus.float() - minus.float()).to(device)


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")


def check_heads_per_program(G, heads):
    """The script's rule: G heads a program must divide the heads
    (`exp_attn_r2.py:151-156` grids over H // G groups and leaves the rest
    of the output unwritten)."""
    if isinstance(G, bool) or not isinstance(G, numbers.Integral) or G < 1 or heads % G:
        raise ValueError(f"heads_per_program {G!r} not in the divisors of the {heads} heads: "
                         f"the script's grid of H // G groups would leave heads unwritten")


def attention_floor_ref(q, k, v, positions_q, positions_k, rope_base=100.0, mode="nosmax"):
    """q (B, H, Nq, d), k and v (B, H, Nk, d); positions (B, N, 2) integer.
    Returns (B, H, Nq, d) in v's dtype."""
    _check_mode(mode)
    dt, d = q.dtype, q.shape[-1]
    q32, v32 = q.float(), v.float()
    if mode == "copynr":
        return (q32 + v32).to(v.dtype)
    if mode == "copy":
        return (apply_rope2d(q32, positions_q, rope_base) + v32).to(v.dtype)
    if mode == "copymm":
        cos, sin = rope_tables(positions_q, d, rope_base)
        rot = torch.matmul(q32.to(dt).float(), rot_matrix(d, q.device))
        return (q32 * cos[:, None] + rot * sin[:, None] + v32).to(v.dtype)
    q_ = (apply_rope2d(q32, positions_q, rope_base) * d ** -0.5).to(dt)
    k_ = apply_rope2d(k.float(), positions_k, rope_base).to(dt)
    s = torch.matmul(q_.float(), k_.float().transpose(-1, -2))
    if mode == "qkonly":
        return s[..., :d].to(v.dtype)
    return torch.matmul(s.to(dt).float(), v32).to(v.dtype)


_LIB = None


def _kernel():
    """`csrc/attention_floor.cu`'s C entry, built at first use; its arguments
    are `fused_attention.cu`'s, the mode's code in the softmax code's place."""
    global _LIB
    if _LIB is None:
        from ._build import load_library

        fn = load_library("attention_floor").dust3r_attention_floor
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = fn
    return _LIB


def attention_floor(q, k, v, positions_q, positions_k, rope_base=100.0, *, mode,
                    heads_per_program=1, tables_q=None, tables_k=None, core=None):
    """The floor `mode` of the fused attention (see the module docstring).
    Arguments as `fused_attention`'s; positions are required (the script's
    attention always rotates). heads_per_program: any divisor of the heads,
    every value giving the same bits. core: None or "sm90" (the sm90
    kernel, every mode), or "mma" (the baseline, `csrc/attention_floor.cu`,
    every mode, at the largest of 4, 2, 1 heads a block dividing G).
    Output as `fused_attention`'s."""
    _check_mode(mode)
    check_heads_per_program(heads_per_program, q.shape[1])
    if core is not None and core not in CORES:
        raise ValueError(f"core {core!r} not in {CORES} or None")
    if positions_q is None or positions_k is None:
        raise ValueError("the floors run the script's RoPE attention: give positions for "
                         "q and k")
    d, Nq, Nk = q.shape[-1], q.shape[2], k.shape[2]
    if mode == "qkonly" and Nk < d:
        raise ValueError(f"qkonly writes the logits' first d = {d} columns, and Nk = {Nk} "
                         f"keys give fewer (the script's s[:, :d] fails there too)")
    if mode in COPY_MODES and Nq != Nk:
        raise ValueError(f"{mode} adds v to q: Nq = {Nq} and Nk = {Nk} must agree")
    if q.device.type == "cpu":
        return attention_floor_ref(q, k, v, positions_q, positions_k, rope_base, mode)
    core = core or "sm90"
    G = kernel_heads_per_program(core, heads_per_program)
    check(q, k, v, positions_q, positions_k, G)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the floors are bf16 kernels, got {q.dtype}")
    if d != HEAD_DIM:
        raise ValueError(f"the floor kernels take head dim {HEAD_DIM} (the script's), got {d}")
    if core == "sm90":
        out = launch_sm90(q, k, v, positions_q, positions_k, rope_base, tables_q, tables_k, G,
                          softmax=SM90_CODES[mode])
        count_launch(attention_floor, "launches")
        return out
    out = launch(q, k, v, positions_q, positions_k, rope_base, tables_q, tables_k, G,
                 softmax=MODES.index(mode), entry=_kernel())
    count_launch(attention_floor, "core_launches")
    return out


attention_floor.launches = 0
attention_floor.core_launches = 0
