"""What holds the tap-sum conv's sm90 kernel (TPU rows 10, 11) on one CUDA
card: the kernel beside copies of itself with one cost taken out.

    python -m dust3r_tpu_torch.tools.taps_probe [--iters 50]

Each variant is `csrc/conv3x3_taps.cu` with one line guarded by a test
that never holds, built by nvcc into `build/taps_probe/`. Their Z is wrong
on purpose: the times say how much a cost weighs, nothing else.
  base      the kernel as it is;
  no_store  no epilogue (no bf16 rounding, staging or TMA store of Z);
  no_tma    Z rounded and staged in shared memory, never stored;
  a_once    x loaded once a channel chunk, not once a (tap, chunk) step:
            the most that loading one box of Wt + 2 columns for the three
            taps (shifted wgmma descriptors) could give;
  b_once    the weight tiles loaded only into the first ring stages, so
            the steps after them read no weight from L2: the most that
            sharing weight tiles between blocks could give.
At the six shapes of `tools/conv_variants.py`, both variants, each device
time the least of three CUDA-graph replays of `--iters` calls, the
variants timed in turns (in order, then reversed), and the least turn
kept. Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import torch

from ..ops import _build
from ..ops.conv3x3_taps import VARIANTS, pack_for, tap_inputs
from .card import card_name, graph_ms, warm_up
from .conv_variants import SHAPES, taps_bound

OUT = _build.BUILD_ROOT.parent / "taps_probe"
STORE = "store_z<BN>(zbuf, &zmap, acc, t, g, cw, e);"
TMA = "sm90::tma_store_3d(zmap, buf, t.n0 + kZCols * j, t.w0 + wq, t.r0 + rq);"
EXPECT = "sm90::mbar_arrive_expect_tx(&sm.full[s], S::kStageBytes);"
ALOAD = "sm90::tma_load_3d(sm.a[s], xmap,"
BLOAD = "sm90::tma_load_3d(sm.b[s], &wmap,"
NEVER = "if (acc[0] == 1234.5f) "  # a test the accumulators never meet


def variant_source(src, name):
    """The kernel source with the cost `name` taken out."""
    for needle in (STORE, TMA, EXPECT, ALOAD, BLOAD):
        if src.count(needle) != 1:
            raise RuntimeError(f"csrc/conv3x3_taps.cu changed: {needle!r} not found once")
    if name == "no_store":
        return src.replace(STORE, NEVER + STORE)
    if name == "no_tma":
        return src.replace(TMA, NEVER + TMA)
    if name in ("a_once", "b_once"):
        a = "(it < kS || dx == 0)" if name == "a_once" else "(true)"
        b = "(it < kS)" if name == "b_once" else "(true)"
        src = src.replace(EXPECT, f"sm90::mbar_arrive_expect_tx(&sm.full[s], ({a} ? "
                                  f"S::kABytes : 0) + ({b} ? S::kBBytes : 0));")
        return src.replace(ALOAD, f"if {a} " + ALOAD).replace(BLOAD, f"if {b} " + BLOAD)
    return src


NAMES = ("base", "no_store", "no_tma", "a_once", "b_once")


def build_variants():
    """{name: the C entry of that variant}, one nvcc each, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "conv3x3_taps.cu").read_text()
    procs = {}
    for name in NAMES:
        path = OUT / f"conv3x3_taps_{name}.cu"
        path.write_text(variant_source(src, name))
        lib = OUT / f"libconv3x3_taps_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed to build the {name} variant:\n{err}")
        fn = ctypes.CDLL(str(lib)).dust3r_conv3x3_taps
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def run(iters=50, log=print):
    fns = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    order = list(NAMES) + list(NAMES)[::-1]
    totals = {(n, v): 0.0 for n in NAMES for v in VARIANTS}
    for label, B, H, W, cin, cout in SHAPES:
        x = torch.randn(B, H, W, cin, device="cuda", generator=gen).to(torch.bfloat16)
        wk = pack_for(0.05 * torch.randn(cout, cin, 3, 3, device="cuda", generator=gen))
        z = torch.empty(B, H, W, 3 * cout, device="cuda", dtype=torch.bfloat16)
        for variant in VARIANTS:
            taps = tap_inputs(x, variant)
            ptrs = [t.data_ptr() for t in taps] + [None] * (3 - len(taps))
            times = {n: [] for n in NAMES}
            for name in order:
                def call(fn=fns[name]):
                    err = fn(*ptrs, wk.data_ptr(), z.data_ptr(), B * H * W, W, cin, cout,
                             int(variant == "copies"), torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
                warm_up(call, 0.3)
                times[name].append(min(graph_ms(call, iters) for _ in range(3)))
            best = {n: min(t) for n, t in times.items()}
            for n in NAMES:
                totals[n, variant] += best[n]
            bound_ms = taps_bound(B, H, W, cin, cout, variant)[0]
            log(f"[probe] {variant} {label}: bound {bound_ms:.4f} ms; "
                + ", ".join(f"{n} {best[n]:.4f}" for n in NAMES))
    for variant in VARIANTS:
        log(f"[probe] {variant}, the {len(SHAPES)} shapes summed: "
            + ", ".join(f"{n} {totals[n, variant]:.4f}" for n in NAMES))
    return totals


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=50)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("taps_probe: no CUDA device (torch.cuda.is_available() is False)")
    print(card_name())
    run(args.iters)


if __name__ == "__main__":
    sys.exit(main())
