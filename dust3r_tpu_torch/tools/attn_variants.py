"""The TPU attention experiments (kernel rows 3-9) on one CUDA card.

    python -m dust3r_tpu_torch.tools.attn_variants [--iters 20]

The port's counterpart of the seven scripts (`scripts/exp_attn_r2.py`,
`exp_attn_variants.py`, `exp_attn_vmem_r2.py`, `exp_attn_dma_r2.py`,
`exp_attn_layout_r2.py`, `bench_attn3.py`, `exp_softmax_r2.py`). Each row
runs at its script's shapes, bf16, q, k and v from a seeded generator, a
24x32 token grid (row 8: random positions in [0, 48), as `bench_attn3.py`
draws them):

  3  fused_attention with G = 1, 2, 4 heads a block on the sm90 kernel and
     G = 2, 4 on the mma.sync core (the baseline), (16,16,768,64); and
     attention_floor's floor modes, (16,16,768,64): nosmax and qkonly on
     the sm90 kernel at G = 1, 4, 8, the copy floors there at the script's
     G, and all five on their baseline, `csrc/attention_floor.cu`, at the
     script's G (nosmax and copynr at 1, 2, 4, qkonly, copy and copymm at
     1, 4)
  4  attention_variant "bf16_exp" and "bf16_logits", (16,16,768,64), on
     either kernel
  5  fused_attention G = 4 and G = 8 on the sm90 kernel, (16,16,768,64)
  6  fused_attention on (B, H, N, d) views of a (B, N, 3C) qkv projection,
     (16,16,768,64) and (8,12,768,64), on either kernel
  7  the same on views of three head-packed (B, N, C) projections
  8  fused_attention G = 1 on random positions, (16,16,768,64), on either
  9  attention_variant "nomax", (16,16,768,64), on the sm90 kernel at G = 1
     and at the script's G = 2, and on the mma.sync core

A row names its kernel: the sm90 kernel (`core=None`, the route of every
bf16 d = 64 call) or the mma.sync core (`core="mma"`, the baseline). For
each: the row's kernel, the row-1 baseline (the
mma.sync core, G = 1 on contiguous q, k, v; for a floor, the exact kernel
of its own core, G = 1), the plain version, the library yardstick
(`F.scaled_dot_product_attention` on q and k rotated beforehand, in the
row's layout; for a floor, the one call that does its work where there is
one: `q + v` for copynr, the logits' matmul on q and k rotated beforehand
for qkonly) and the bound (bytes at 3.35 TB/s or bf16 operations at 989
TFLOP/s; each floor's own count, `floor_bound`), in ms as replays of a
CUDA graph of the calls (`card.graph_ms`, the device's time), the plain
version by CUDA events through its calls (`time_ms`), with the RoPE tables
built once; the kernel's error against its plain version; for the exact
softmax whether its bits equal its own kernel's at G = 1 on contiguous q,
k, v, and its largest distance from the row-1 baseline's output; for a
floor or a variant with G > 1, whether its bits equal its G = 1 call's;
for a variant on the sm90 kernel, whether its bits equal the same
variant's on the mma.sync core; for a copy floor on the sm90 kernel,
whether its bits equal its baseline's at the same G, how many elements
differ and by how many bf16 units at most (copynr must give the baseline's
bits, copy and copymm at most one unit). The split of the sm90 exact
kernel by its floors at (16,16,768,64), G = 1, from one set of timings:
the ring (copynr), Q's rotation (copy - copynr), K's rotation and q.k^T
(qkonly - copy), P.v (nosmax - qkonly), the softmax (exact - nosmax).
qkonly is also
timed at Nk = 64 beside Nk = 768 on both kernels: its time must grow with
the keys it reads. The sm90 kernel's K rotation: its time with and without
RoPE at (16,16,768,64), beside the bytes of fp32 tables its rotating warps
read. Then the scripts' chain comparison (`exp_attn_dma_r2.py:149-159`,
`exp_attn_layout_r2.py:148-157`): projection GEMM(s) -> attention ->
out-projection, with the head-transposing copies of q, k, v and a copy of
the merged output (the path before the kernel read strides) against the
strided path, for self-attention on one qkv GEMM and for cross-attention
on three. Last, which `ex2` instructions the attention sources compiled
to: the PTX of `csrc/fused_attention.cu` and `csrc/fused_attention_sm90.cu`
(the bf16x2 ones are the bf16 variants'), and the SASS `MUFU.EX2` forms of
each instance of the sm90 kernel (`cuobjdump` of its library), where the
bf16 variants' instances must show the bf16x2 form and the others must not.
Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from ..models.blocks import token_positions
from ..ops import _build
from ..ops.attention_floors import COPY_MODES, MODES, attention_floor, attention_floor_ref
from ..ops.attention_variants import attention_variant, attention_variant_ref
from ..ops.fused_attention import attention_ref, fused_attention
from ..ops.rope import apply_rope2d, rope_tables
from .card import attention_bound, bound, card_name, graph_ms, time_ms, warm_up

SEED = 0
ENC16 = (16, 16, 768, 64)  # the scripts' encoder shape
DEC12 = (8, 12, 768, 64)   # and decoder shape
GRID = (24, 32)            # 512x384 at patch 16
# max abs error over max |plain| of a bf16 kernel against its plain version
# on the same bf16 inputs: the exact softmax rounds as its plain version
# except for the order of fp32 sums and ex2.approx; the bf16 variants
# round (s - max) at the running max, in log2 units, so a P may sit one
# bf16 unit from the plain version's, and the output two
RTOL = 1e-2
# row, label, (B, H, N, d), layout, heads a block, softmax (None: exact;
# a floor mode of attention_floors.MODES), positions, core (None: the
# route, the sm90 kernel for bf16 d = 64; "mma": the mma.sync core)
ROWS = (
    (3, "G=1", ENC16, "contiguous", 1, None, "grid", None),
    (3, "G=2", ENC16, "contiguous", 2, None, "grid", None),
    (3, "G=4", ENC16, "contiguous", 4, None, "grid", None),
    (3, "G=2 mma", ENC16, "contiguous", 2, None, "grid", "mma"),
    (3, "G=4 mma", ENC16, "contiguous", 4, None, "grid", "mma"),
    (4, "bf16_exp", ENC16, "contiguous", 1, "bf16_exp", "grid", None),
    (4, "bf16_exp mma", ENC16, "contiguous", 1, "bf16_exp", "grid", "mma"),
    (4, "bf16_logits", ENC16, "contiguous", 1, "bf16_logits", "grid", None),
    (4, "bf16_logits mma", ENC16, "contiguous", 1, "bf16_logits", "grid", "mma"),
    (5, "G=4", ENC16, "contiguous", 4, None, "grid", None),
    (5, "G=8", ENC16, "contiguous", 8, None, "grid", None),
) + tuple((row, label + suffix, shape, layout, 1, None, kind, core)
          for row, label, shape, layout, kind in (
              (6, "qkv views", ENC16, "qkv", "grid"), (6, "qkv views", DEC12, "qkv", "grid"),
              (7, "head-packed views", ENC16, "packed", "grid"),
              (7, "head-packed views", DEC12, "packed", "grid"),
              (8, "random positions", ENC16, "contiguous", "random"))
          for suffix, core in (("", None), (" mma", "mma"))) + (
    (9, "nomax", ENC16, "contiguous", 1, "nomax", "grid", None),
    (9, "nomax G=2", ENC16, "contiguous", 2, "nomax", "grid", None),
    (9, "nomax mma", ENC16, "contiguous", 1, "nomax", "grid", "mma"),
) + tuple((3, f"{m} G={G}", ENC16, "contiguous", G, m, "grid", None)
          for m, Gs in (("nosmax", (1, 4, 8)), ("qkonly", (1, 4, 8)), ("copy", (1, 4)),
                        ("copynr", (1, 2, 4)), ("copymm", (1, 4)))
          for G in Gs) + tuple(
    (3, f"{m} G={G} mma", ENC16, "contiguous", G, m, "grid", "mma")
    for m, Gs in (("nosmax", (1, 2, 4)), ("qkonly", (1, 4)), ("copy", (1, 4)),
                  ("copynr", (1, 2, 4)), ("copymm", (1, 4)))
    for G in Gs)


def positions(B, grid, kind, gen):
    """(B, N, 2) int32: the row-major token grid, or random in [0, 48)."""
    if kind == "random":
        return torch.randint(0, 48, (B, grid[0] * grid[1], 2), generator=gen, device="cuda",
                             dtype=torch.int32)
    return token_positions(B, *grid, "cuda").contiguous()


def make_qkv(B, H, Nq, Nk, d, layout, gen):
    """bf16 q (B, H, Nq, d), k and v (B, H, Nk, d) in a layout of the model:
    "contiguous"; "qkv", views of one (B, N, 3C) projection (self-attention,
    Nq == Nk); "packed", views of three (B, N, C) projections."""
    C = H * d

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    if layout == "qkv":
        assert Nq == Nk, "a qkv projection serves self-attention"
        return tuple(rnd(B, Nq, 3 * C).view(B, Nq, 3, H, d).permute(2, 0, 3, 1, 4))
    if layout == "packed":
        return tuple(rnd(B, n, C).view(B, n, H, d).transpose(1, 2) for n in (Nq, Nk, Nk))
    return rnd(B, H, Nq, d), rnd(B, H, Nk, d), rnd(B, H, Nk, d)


def rotated_like(t, pos):
    """RoPE-rotated t (bf16, as the plain attention rotates) in t's layout:
    the library yardstick's pre-rotated q or k."""
    out = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)
    return out.copy_(apply_rope2d(t, pos))


def bf16_units_apart(a, b):
    """Elementwise distance of two bf16 tensors of one shape in units in
    the last place: how many bf16 steps lie between them (0: the same
    value; +0 and -0 are 0 apart)."""
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(a) - ordered(b)).abs()


def floor_bound(mode, B, H, Nq, Nk, d):
    """(ms, what bounds it) of a floor's work: copynr moves q, k, v and o
    (2 bytes a value), copy and copymm also the four fp32 tables; qkonly
    reads q, k and the tables, writes o, and does 2*B*H*Nq*Nk*d bf16
    FLOPs; nosmax is the attention's count (4*B*H*Nq*Nk*d)."""
    tables = 8 * B * (Nq + Nk) * d
    if mode == "nosmax":
        return attention_bound(B, H, Nq, Nk, d, rope=True)
    if mode == "qkonly":
        return bound(2 * B * H * (2 * Nq + Nk) * d + tables, dict(bf16=2 * B * H * Nq * Nk * d))
    return bound(2 * B * H * (2 * Nq + 2 * Nk) * d + (0 if mode == "copynr" else tables), {})


def measure(q, k, v, pq, pk, heads_per_program=1, softmax=None, iters=20, warm=False,
            core=None):
    """One kernel configuration against its baseline, plain version, library
    yardstick and bound; returns a dict of ms, errors, whether the output's
    bits equal its own kernel's at G = 1 on contiguous q, k, v (for a floor
    or a variant, its G = 1 call's where G > 1, else None), for a variant
    on the sm90 kernel `equals_mma`, whether its bits equal the same
    variant's on the mma.sync core (else None), and, for the exact softmax,
    `from_baseline`, its max abs distance from the row-1 baseline's
    output. core: the row's kernel (None: the route). warm: run the kernel
    for half a second first (for the process's first timing)."""
    tq, tk = rope_tables(pq, q.shape[-1]), rope_tables(pk, q.shape[-1])
    if softmax in MODES:
        return measure_floor(q, k, v, pq, pk, tq, tk, heads_per_program, softmax, iters, warm,
                             core)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    if softmax is None:
        def kernel():
            return fused_attention(q, k, v, pq, pk, 100.0, tq, tk, heads_per_program,
                                   core=core)

        def one_head():
            return fused_attention(qc, kc, vc, pq, pk, 100.0, tq, tk, core=core)

        def plain():
            return attention_ref(q, k, v, pq, pk)
    else:
        def kernel(G=heads_per_program, core=core):
            return attention_variant(q, k, v, pq, pk, 100.0, softmax=softmax,
                                     heads_per_program=G, tables_q=tq, tables_k=tk, core=core)

        def plain():
            return attention_variant_ref(q, k, v, pq, pk, 100.0, softmax)

    def baseline():
        return fused_attention(qc, kc, vc, pq, pk, 100.0, tq, tk, core="mma")

    out = kernel()
    torch.cuda.synchronize()
    # the exact kernel is held to the fp32 plain version, as on the main
    # path; a variant to its own plain version on the same bf16 inputs
    ref = (attention_ref(q.float(), k.float(), v.float(), pq, pk) if softmax is None
           else plain().float())
    err = (out.float() - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    if softmax is None:
        identical = torch.equal(out, one_head())
    else:
        identical = torch.equal(out, kernel(1)) if heads_per_program > 1 else None
    equals_mma = (torch.equal(out, kernel(1, "mma"))
                  if softmax is not None and core != "mma" else None)
    from_baseline = ((out.float() - baseline().float()).abs().max().item()
                     if softmax is None else None)
    if not (out.shape == q.shape and torch.isfinite(out).all()):
        raise AssertionError(f"bad kernel output {tuple(out.shape)}")
    qr, kr = rotated_like(q, pq), rotated_like(k, pk)
    B, H, Nq, d = q.shape
    bound_ms, bound_by = attention_bound(B, H, Nq, k.shape[2], d, rope=True)
    if warm:
        warm_up(kernel)
    return dict(ms=graph_ms(kernel, iters), baseline_ms=graph_ms(baseline, iters),
                plain_ms=time_ms(plain, iters),
                library_ms=graph_ms(lambda: F.scaled_dot_product_attention(qr, kr, v), iters),
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err, rel=rel,
                identical=identical, from_baseline=from_baseline, equals_mma=equals_mma,
                wrapper_ms=time_ms(kernel, iters))


def measure_floor(q, k, v, pq, pk, tq, tk, heads_per_program, mode, iters=20, warm=False,
                  core=None):
    """`measure` for a floor mode (tables built by the caller) on `core`'s
    kernel, against the exact kernel of the same core at G = 1; a copy
    floor on the sm90 kernel also against its baseline's output at the same
    G (`equals_mma`, `mma_differing` elements, at most `mma_units` bf16
    units apart)."""
    def kernel(G=heads_per_program, core=core):
        return attention_floor(q, k, v, pq, pk, 100.0, mode=mode, heads_per_program=G,
                               tables_q=tq, tables_k=tk, core=core)

    def plain():
        return attention_floor_ref(q, k, v, pq, pk, 100.0, mode)

    def baseline():
        return fused_attention(q, k, v, pq, pk, 100.0, tq, tk, core=core)

    out = kernel()
    torch.cuda.synchronize()
    ref = plain().float()
    err = (out.float() - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    identical = torch.equal(out, kernel(1)) if heads_per_program > 1 else None
    if not (out.shape == q.shape and torch.isfinite(out).all()):
        raise AssertionError(f"bad kernel output {tuple(out.shape)}")
    against_mma = dict(equals_mma=None)
    if mode in COPY_MODES and core != "mma":
        units = bf16_units_apart(out, kernel(core="mma"))
        against_mma = dict(equals_mma=bool((units == 0).all()),
                           mma_differing=int((units > 0).sum()), mma_units=int(units.max()))
    B, H, Nq, d = q.shape
    library = None
    if mode == "copynr":
        library = lambda: q + v  # noqa: E731
    elif mode == "qkonly":
        qs = (rotated_like(q, pq).float() * d ** -0.5).to(q.dtype)
        kr = rotated_like(k, pk)
        library = lambda: torch.matmul(qs, kr.transpose(-1, -2))  # noqa: E731
    bound_ms, bound_by = floor_bound(mode, B, H, Nq, k.shape[2], d)
    if warm:
        warm_up(kernel)
    return dict(ms=graph_ms(kernel, iters), baseline_ms=graph_ms(baseline, iters),
                plain_ms=time_ms(plain, iters),
                library_ms=None if library is None else graph_ms(library, iters),
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err, rel=rel,
                identical=identical, from_baseline=None, wrapper_ms=time_ms(kernel, iters),
                **against_mma)


def floor_line(r):
    """The log text of a copy floor's comparison with its baseline ("" for
    any other row)."""
    if "mma_units" not in r:
        return ""
    return (f"; bits equal attention_floor.cu's: {r['equals_mma']} ({r['mma_differing']} "
            f"elements differ, at most {r['mma_units']} bf16 unit(s) apart)")


def check_floor(label, mode, r):
    """Raise unless a row agrees: within RTOL of its plain version, G > 1
    with G = 1's bits, and a copy floor on the sm90 kernel with its
    baseline's bits (copynr) or within one bf16 unit of them (copy and
    copymm: the same fp32 multiply-adds, perhaps fused in another way)."""
    limit = 0 if mode == "copynr" else 1
    if not r["rel"] <= RTOL or r["identical"] is False or r.get("mma_units", 0) > limit:
        raise AssertionError(f"{label}: the kernel disagrees ({r})")


def split(iters=20, log=print):
    """The sm90 exact kernel's time at (16,16,768,64), G = 1, split by its
    floors, each a mode of the same loop on the same ring: the ring's I/O
    (copynr), Q's rotation (copy - copynr), K's rotation and q.k^T (qkonly
    - copy), P.v (nosmax - qkonly), the softmax (exact - nosmax). Each by
    `graph_ms`, twice, in the order copynr ... exact ... copynr, the mean
    taken; returns the times by mode and the parts by name."""
    B, H, N, d = ENC16
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = make_qkv(B, H, N, N, d, "contiguous", gen)
    pos = positions(B, GRID, "grid", gen)
    tables = rope_tables(pos, d)
    order = ("copynr", "copy", "qkonly", "nosmax", "exact")

    def call(mode):
        if mode == "exact":
            return fused_attention(q, k, v, pos, pos, 100.0, tables, tables)
        return attention_floor(q, k, v, pos, pos, 100.0, mode=mode, tables_q=tables,
                               tables_k=tables)

    ms = dict.fromkeys(order, 0.0)
    for turn in (order, order[::-1]):
        for mode in turn:
            ms[mode] += graph_ms(lambda m=mode: call(m), iters) / 2
    parts = {"ring (copynr)": ms["copynr"],
             "Q rotation (copy - copynr)": ms["copy"] - ms["copynr"],
             "K rotation + q.k^T (qkonly - copy)": ms["qkonly"] - ms["copy"],
             "P.v (nosmax - qkonly)": ms["nosmax"] - ms["qkonly"],
             "softmax (exact - nosmax)": ms["exact"] - ms["nosmax"]}
    log(f"[split] sm90 exact {(B, H, N, d)} G=1 {ms['exact']:.4f} ms: "
        + ", ".join(f"{name} {t:.4f} ms ({100 * t / ms['exact']:.1f} %)"
                    for name, t in parts.items())
        + "; floors " + ", ".join(f"{m} {ms[m]:.4f}" for m in order[:-1]))
    return ms, parts


def qkonly_growth(iters=20, log=print, core=None):
    """qkonly at (16,16,768,64) against 768 and against 64 keys on `core`'s
    kernel: a floor whose q.k^T over the later key tiles were compiled away
    would take the same time at both."""
    B, H, N, d = ENC16
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = make_qkv(B, H, N, N, d, "contiguous", gen)
    pos = positions(B, GRID, "grid", gen)
    tables = rope_tables(pos, d)
    pk = pos[:, :64].contiguous()
    tk = tuple(t[:, :64].contiguous() for t in tables)
    k64, v64 = k[:, :, :64].contiguous(), v[:, :, :64].contiguous()
    ms = {nk: graph_ms(lambda: attention_floor(q, kk, vv, pos, pp, 100.0, mode="qkonly",
                                               tables_q=tables, tables_k=tt, core=core), iters)
          for nk, kk, vv, pp, tt in ((768, k, v, pos, tables), (64, k64, v64, pk, tk))}
    log(f"[row 3] qkonly {core or 'sm90'} q{(B, H, N, d)}: {ms[768]:.4f} ms at Nk = 768, "
        f"{ms[64]:.4f} ms at Nk = 64 ({ms[768] / ms[64]:.2f}x)")
    return ms


def rotation(iters=20, log=print):
    """The sm90 kernel's K rotation at (16,16,768,64): its time with RoPE
    and without (the rotating warps idle, the products read K's TMA stage),
    and the fp32 tables the rotating warps read: for every 64-key tile of
    every (batch, head, 192-row query tile), 256 units of 8 columns, one
    cos and one sin of 8 values each (a rotated pair shares them), 16 KB
    against the tile's 8 KB of K. Counts from the kernel's design, times by
    `graph_ms`; returns them."""
    B, H, N, d = ENC16
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = make_qkv(B, H, N, N, d, "contiguous", gen)
    pos = positions(B, GRID, "grid", gen)
    tables = rope_tables(pos, d)
    rope_ms = graph_ms(lambda: fused_attention(q, k, v, pos, pos, 100.0, tables, tables), iters)
    bare_ms = graph_ms(lambda: fused_attention(q, k, v), iters)
    tiles = B * H * -(-N // 192) * -(-N // 64)
    table_bytes, k_bytes = tiles * 256 * 2 * 8 * 4, tiles * 64 * d * 2
    log(f"[rotation] sm90 {(B, H, N, d)}: {rope_ms:.4f} ms with RoPE, {bare_ms:.4f} ms without "
        f"({rope_ms - bare_ms:.4f} ms, {100 * (rope_ms - bare_ms) / rope_ms:.1f} %); the "
        f"rotating warps read {table_bytes} bytes of fp32 tables ({table_bytes / 2**20:.1f} "
        f"MiB, {table_bytes / rope_ms / 1e6:.1f} GB/s over the kernel) against {k_bytes} bytes "
        f"of K tiles, for {tiles} key tiles")
    return dict(rope_ms=rope_ms, bare_ms=bare_ms, table_bytes=table_bytes, k_bytes=k_bytes)


def library_label(softmax, ms):
    """The library yardstick of a row, named, with its time."""
    if softmax not in MODES:
        return f"sdpa (q, k rotated beforehand) {ms:.4f} ms"
    if softmax == "copynr":
        return f"q + v {ms:.4f} ms"
    if softmax == "qkonly":
        return f"all logits' matmul (q, k rotated beforehand) {ms:.4f} ms"
    return "no one library call"


def run_rows(iters=20, rows=ROWS, log=print):
    """Every row of `rows` on the card; raises if a kernel disagrees with
    its plain version or a grouped or strided one with its G = 1 bits."""
    results = []
    for n, (row, label, (B, H, N, d), layout, G, softmax, kind, core) in enumerate(rows):
        gen = torch.Generator(device="cuda").manual_seed(SEED + n)
        q, k, v = make_qkv(B, H, N, N, d, layout, gen)
        pos = positions(B, GRID, kind, gen)
        r = measure(q, k, v, pos, pos, G, softmax, iters, warm=n == 0, core=core)
        log(f"[row {row}] {label} {(B, H, N, d)} {layout}: kernel {r['ms']:.4f} ms "
            f"({r['wrapper_ms']:.4f} ms a call through the wrapper's launches), "
            f"{'exact kernel of its core' if softmax in MODES else 'row-1 baseline'} "
            f"{r['baseline_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"{library_label(softmax, r['library_ms'])}, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); max_abs_err {r['max_abs_err']:.3e} rel {r['rel']:.3e} "
            f"(limit {RTOL:g})"
            + ("" if r["from_baseline"] is None else
               f"; max |out - row-1 baseline| {r['from_baseline']:.3e}")
            + ("" if r["identical"] is None else f"; bits equal G=1's: {r['identical']}")
            + ("" if r["equals_mma"] is None or softmax in MODES else
               f"; bits equal the mma.sync core's: {r['equals_mma']}")
            + floor_line(r))
        check_floor(f"row {row} {label}", softmax, r)
        results.append(dict(row=row, label=label, shape=(B, H, N, d), layout=layout, **r))
    return results


def chains(shape, iters=20, log=print):
    """The scripts' chain comparison at `shape`: projection GEMM(s) ->
    attention -> out-projection, head copies against strided views."""
    B, H, N, d = shape
    C = H * d
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    x, y = rnd(B, N, C), rnd(B, N, C)
    wqkv, wq, wk, wv, wp = (rnd(n, C, scale=C ** -0.5) for n in (3 * C, C, C, C, C))
    pos = positions(B, GRID, "grid", gen)
    tables = rope_tables(pos, d)

    def attend(q, k, v, copies):
        if copies:  # the head split's copies, then the merge's
            q, k, v = (t.contiguous() for t in (q, k, v))
        o = fused_attention(q, k, v, pos, pos, 100.0, tables, tables)
        o = o.transpose(1, 2).reshape(B, N, C)
        return F.linear(o.clone() if copies else o, wp)

    def self_chain(copies):
        q, k, v = F.linear(x, wqkv).view(B, N, 3, H, d).permute(2, 0, 3, 1, 4)
        return attend(q, k, v, copies)

    def cross_chain(copies):
        q, k, v = (F.linear(t, w).view(B, N, H, d).transpose(1, 2)
                   for t, w in ((x, wq), (y, wk), (y, wv)))
        return attend(q, k, v, copies)

    out = {}
    for name, fn in (("self", self_chain), ("cross", cross_chain)):
        if not torch.equal(fn(True), fn(False)):
            raise AssertionError(f"{name} chain: the strided path changed the result")
        # copies, strided, strided, copies
        t = [time_ms(lambda c=c: fn(c), iters) for c in (True, False, False, True)]
        out[name] = dict(copies_ms=(t[0] + t[3]) / 2, strided_ms=(t[1] + t[2]) / 2)
        log(f"[chain] {name}-attention {shape}: GEMM -> attention -> out-projection with "
            f"the head copies {out[name]['copies_ms']:.4f} ms, strided "
            f"{out[name]['strided_ms']:.4f} ms (each the mean of two runs of {iters}, in the "
            f"order copies, strided, strided, copies; results bit-identical)")
    return out


def ptx_exp_instructions(name):
    """Counts of the `ex2` instructions in the PTX of csrc/<name>.cu."""
    src = _build.CSRC / f"{name}.cu"
    out = _build.BUILD_ROOT / "ptx" / f"{name}.ptx"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), "-ptx", "-arch=sm_90a", "-std=c++17", "-O3",
                    "-o", str(out), str(src)], check=True, capture_output=True, text=True)
    return collections.Counter(re.findall(r"ex2\.approx[.\w]*", out.read_text()))


# an instance of the sm90 kernel in the SASS: attn_sm90_kernel<kRope, S>
SM90_INSTANCE = re.compile(r"attn_sm90_kernelILb(\d)ELi(\d)E")
BF16_SOFTMAX_CODES = {2: "bf16_logits", 3: "bf16_exp"}  # attn::Softmax


def sass_exp_instructions():
    """{(rope, softmax code): Counter of `MUFU.EX2` forms} of every instance
    of the built sm90 kernel, from `cuobjdump -sass` of its library."""
    lib = _build.library_path("fused_attention_sm90")
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for function in sass.split("Function : ")[1:]:
        m = SM90_INSTANCE.search(function.split(None, 1)[0])
        if m:
            out[bool(int(m[1])), int(m[2])] = collections.Counter(
                re.findall(r"MUFU\.EX2[.\w]*", function))
    return out


def check_sass(sass, log=print):
    """Log each instance's `MUFU.EX2` forms; raise unless the bf16 variants'
    instances hold a bf16x2 form (one naming BF16) and no other instance
    does."""
    for (rope, code), forms in sorted(sass.items()):
        bf16x2 = sum(n for form, n in forms.items() if "BF16" in form)
        log(f"[sass] attn_sm90_kernel<rope={rope}, softmax={code}"
            f"{' ' + BF16_SOFTMAX_CODES[code] if code in BF16_SOFTMAX_CODES else ''}>: "
            f"{dict(forms)}")
        if (bf16x2 > 0) != (code in BF16_SOFTMAX_CODES):
            raise AssertionError(f"sm90 instance rope={rope} softmax={code}: {dict(forms)}")
    if len(sass) != 13:
        raise AssertionError(f"expected the 13 instances of the sm90 kernel, found "
                             f"{sorted(sass)}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_variants: no CUDA device (torch.cuda.is_available() is False)")
    print(card_name())
    _build.build(["fused_attention_sm90", "fused_attention", "attention_floor"])
    run_rows(args.iters)
    for core in (None, "mma"):
        qkonly_growth(args.iters, core=core)
    rotation(args.iters)
    split(args.iters)
    for shape in (ENC16, DEC12):
        chains(shape, args.iters)
    for name in ("fused_attention", "fused_attention_sm90"):
        print(f"[ptx] {name}.cu ex2 instructions: {dict(ptx_exp_instructions(name))}")
    check_sass(sass_exp_instructions())


if __name__ == "__main__":
    sys.exit(main())
