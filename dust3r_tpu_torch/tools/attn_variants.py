"""The TPU attention experiments (kernel rows 3-9) on one CUDA card.

    python -m dust3r_tpu_torch.tools.attn_variants [--iters 20]

The port's counterpart of the seven scripts (`scripts/exp_attn_r2.py`,
`exp_attn_variants.py`, `exp_attn_vmem_r2.py`, `exp_attn_dma_r2.py`,
`exp_attn_layout_r2.py`, `bench_attn3.py`, `exp_softmax_r2.py`). Each row
runs at its script's shapes, bf16, q, k and v from a seeded generator, a
24x32 token grid (row 8: random positions in [0, 48), as `bench_attn3.py`
draws them):

  3  fused_attention with G = 1, 2, 4 heads a block, (16,16,768,64); and
     attention_floor's floor modes at the script's G: nosmax and copynr
     at 1, 2, 4, qkonly, copy and copymm at 1, 4, (16,16,768,64)
  4  attention_variant "bf16_exp" and "bf16_logits", (16,16,768,64)
  5  fused_attention G = 4 (G = 8 is refused: 1024 threads), (16,16,768,64)
  6  fused_attention on (B, H, N, d) views of a (B, N, 3C) qkv projection,
     (16,16,768,64) and (8,12,768,64)
  7  the same on views of three head-packed (B, N, C) projections
  8  fused_attention G = 1 on random positions, (16,16,768,64)
  9  attention_variant "nomax", (16,16,768,64)

The rows' fused_attention calls run on the mma.sync core (`core="mma"`),
whose G, softmax and layout the experiments vary. For each: the row's
kernel, the row-1 baseline (that core, G = 1 on contiguous q, k, v), the
plain version, the library yardstick (`F.scaled_dot_product_attention`
on q and k rotated beforehand, in the row's layout; for a floor, the one
call that does its work where there is one: `q + v` for copynr, the
logits' matmul on q and k rotated beforehand for qkonly) and the bound
(bytes at 3.35 TB/s or bf16 operations at 989 TFLOP/s; each floor's own
count, `floor_bound`), in ms by CUDA events through the wrappers, with the
RoPE tables built once (a floor row's kernel, baseline and library call
as CUDA-graph replays, `card.graph_ms`: the copy floors run shorter than
their wrapper's launch); the kernel's error against its plain version,
and for the exact softmax whether its bits equal the baseline's (for a
floor with G > 1, its G = 1 call's). qkonly is also timed at Nk = 64
beside Nk = 768: its time must grow with the keys it reads. Then the
scripts' chain comparison (`exp_attn_dma_r2.py:149-159`,
`exp_attn_layout_r2.py:148-157`): projection GEMM(s) -> attention ->
out-projection, with the head-transposing copies of q, k, v and a copy of
the merged output (the path before the kernel read strides) against the
strided path, for self-attention on one qkv GEMM and for cross-attention
on three. Last, which `ex2` instructions the attention source compiled
to (the PTX of `csrc/fused_attention.cu`: the bf16x2 ones are the bf16
variants'). Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..models.blocks import token_positions
from ..ops import _build
from ..ops.attention_floors import MODES, attention_floor, attention_floor_ref
from ..ops.attention_variants import attention_variant, attention_variant_ref
from ..ops.fused_attention import attention_ref, check_heads_per_program, fused_attention
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
# a floor mode of attention_floors.MODES), positions
ROWS = (
    (3, "G=1", ENC16, "contiguous", 1, None, "grid"),
    (3, "G=2", ENC16, "contiguous", 2, None, "grid"),
    (3, "G=4", ENC16, "contiguous", 4, None, "grid"),
    (4, "bf16_exp", ENC16, "contiguous", 1, "bf16_exp", "grid"),
    (4, "bf16_logits", ENC16, "contiguous", 1, "bf16_logits", "grid"),
    (5, "G=4", ENC16, "contiguous", 4, None, "grid"),
    (6, "qkv views", ENC16, "qkv", 1, None, "grid"),
    (6, "qkv views", DEC12, "qkv", 1, None, "grid"),
    (7, "head-packed views", ENC16, "packed", 1, None, "grid"),
    (7, "head-packed views", DEC12, "packed", 1, None, "grid"),
    (8, "random positions", ENC16, "contiguous", 1, None, "random"),
    (9, "nomax", ENC16, "contiguous", 1, "nomax", "grid"),
) + tuple((3, f"{m} G={G}", ENC16, "contiguous", G, m, "grid")
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


def measure(q, k, v, pq, pk, heads_per_program=1, softmax=None, iters=20, warm=False):
    """One kernel configuration against its baseline, plain version, library
    yardstick and bound; returns a dict of ms, errors and whether the
    output's bits equal the baseline's (None for a variant; for a floor
    with G > 1, its G = 1 call's). warm: run the kernel for half a second
    first (for the process's first timing)."""
    tq, tk = rope_tables(pq, q.shape[-1]), rope_tables(pk, q.shape[-1])
    if softmax in MODES:
        return measure_floor(q, k, v, pq, pk, tq, tk, heads_per_program, softmax, iters, warm)
    if softmax is None:
        def kernel():
            return fused_attention(q, k, v, pq, pk, 100.0, tq, tk, heads_per_program,
                                   core="mma")

        def plain():
            return attention_ref(q, k, v, pq, pk)
    else:
        def kernel():
            return attention_variant(q, k, v, pq, pk, 100.0, softmax=softmax, tables_q=tq,
                                     tables_k=tk)

        def plain():
            return attention_variant_ref(q, k, v, pq, pk, 100.0, softmax)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))

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
    identical = torch.equal(out, baseline()) if softmax is None else None
    if not (out.shape == q.shape and torch.isfinite(out).all()):
        raise AssertionError(f"bad kernel output {tuple(out.shape)}")
    qr, kr = rotated_like(q, pq), rotated_like(k, pk)
    B, H, Nq, d = q.shape
    bound_ms, bound_by = attention_bound(B, H, Nq, k.shape[2], d, rope=True)
    if warm:
        warm_up(kernel)
    return dict(ms=time_ms(kernel, iters), baseline_ms=time_ms(baseline, iters),
                plain_ms=time_ms(plain, iters),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(qr, kr, v), iters),
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err, rel=rel,
                identical=identical)


def measure_floor(q, k, v, pq, pk, tq, tk, heads_per_program, mode, iters=20, warm=False):
    """`measure` for a floor mode (tables built by the caller): the kernel,
    the baseline and the library call by `graph_ms` (device time), the
    plain version by `time_ms`; `wrapper_ms` is the kernel by `time_ms`,
    the rate at which the host launches it through its wrapper."""
    def kernel(G=heads_per_program):
        return attention_floor(q, k, v, pq, pk, 100.0, mode=mode, heads_per_program=G,
                               tables_q=tq, tables_k=tk)

    def plain():
        return attention_floor_ref(q, k, v, pq, pk, 100.0, mode)

    def baseline():
        return fused_attention(q, k, v, pq, pk, 100.0, tq, tk, core="mma")

    out = kernel()
    torch.cuda.synchronize()
    ref = plain().float()
    err = (out.float() - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    identical = torch.equal(out, kernel(1)) if heads_per_program > 1 else None
    if not (out.shape == q.shape and torch.isfinite(out).all()):
        raise AssertionError(f"bad kernel output {tuple(out.shape)}")
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
    # the copy floors run shorter than their wrapper's launch: the kernel,
    # the baseline and the library call are timed as replays of CUDA graphs
    return dict(ms=graph_ms(kernel, iters), baseline_ms=graph_ms(baseline, iters),
                plain_ms=time_ms(plain, iters),
                library_ms=None if library is None else graph_ms(library, iters),
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err, rel=rel,
                identical=identical, wrapper_ms=time_ms(kernel, iters))


def qkonly_growth(iters=20, log=print):
    """qkonly at (16,16,768,64) against 768 and against 64 keys: a floor
    whose q.k^T over the later key tiles were compiled away would take the
    same time at both."""
    B, H, N, d = ENC16
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = make_qkv(B, H, N, N, d, "contiguous", gen)
    pos = positions(B, GRID, "grid", gen)
    tables = rope_tables(pos, d)
    pk = pos[:, :64].contiguous()
    tk = tuple(t[:, :64].contiguous() for t in tables)
    k64, v64 = k[:, :, :64].contiguous(), v[:, :, :64].contiguous()
    ms = {nk: graph_ms(lambda: attention_floor(q, kk, vv, pos, pp, 100.0, mode="qkonly",
                                               tables_q=tables, tables_k=tt), iters)
          for nk, kk, vv, pp, tt in ((768, k, v, pos, tables), (64, k64, v64, pk, tk))}
    log(f"[row 3] qkonly q{(B, H, N, d)}: {ms[768]:.4f} ms at Nk = 768, {ms[64]:.4f} ms at "
        f"Nk = 64 ({ms[768] / ms[64]:.2f}x)")
    return ms


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
    its plain version or an exact one with its baseline's bits."""
    results = []
    for n, (row, label, (B, H, N, d), layout, G, softmax, kind) in enumerate(rows):
        gen = torch.Generator(device="cuda").manual_seed(SEED + n)
        q, k, v = make_qkv(B, H, N, N, d, layout, gen)
        pos = positions(B, GRID, kind, gen)
        r = measure(q, k, v, pos, pos, G, softmax, iters, warm=n == 0)
        log(f"[row {row}] {label} {(B, H, N, d)} {layout}: kernel {r['ms']:.4f} ms"
            + ("" if "wrapper_ms" not in r else
               f" ({r['wrapper_ms']:.4f} ms a call through the wrapper's launches)")
            + f", row-1 "
            f"baseline {r['baseline_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"{library_label(softmax, r['library_ms'])}, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); max_abs_err {r['max_abs_err']:.3e} rel {r['rel']:.3e} "
            f"(limit {RTOL:g})"
            + ("" if r["identical"] is None else
               f"; bits equal {'G=1' if softmax in MODES else 'the baseline'}'s: "
               f"{r['identical']}"))
        if not r["rel"] <= RTOL or r["identical"] is False:
            raise AssertionError(f"row {row} {label}: the kernel disagrees ({r})")
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


def ptx_exp_instructions():
    """Counts of the `ex2` instructions in the PTX of fused_attention.cu."""
    src = _build.CSRC / "fused_attention.cu"
    out = _build.BUILD_ROOT / "ptx" / "fused_attention.ptx"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), "-ptx", "-arch=sm_90a", "-std=c++17", "-O3",
                    "-o", str(out), str(src)], check=True, capture_output=True, text=True)
    return collections.Counter(re.findall(r"ex2\.approx[.\w]*", out.read_text()))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_variants: no CUDA device (torch.cuda.is_available() is False)")
    print(card_name())
    _build.build(["fused_attention", "attention_floor"])
    try:
        check_heads_per_program(8, 16)
    except ValueError as e:  # row 5's G = 8, refused by the wrapper
        print(f"[row 5] G=8: refused: {e}")
    run_rows(args.iters)
    qkonly_growth(args.iters)
    for shape in (ENC16, DEC12):
        chains(shape, args.iters)
    print(f"[ptx] fused_attention.cu ex2 instructions: {dict(ptx_exp_instructions())}")


if __name__ == "__main__":
    sys.exit(main())
