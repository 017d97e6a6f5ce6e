"""The TPU conv experiments (kernel rows 10, 11) and the DPT tail's epilogue
(row 13) on one CUDA card.

    python -m dust3r_tpu_torch.tools.conv_variants [--iters 20]

The port's counterpart of `scripts/exp_convk_r3.py`, `exp_convk2_r3.py`
(the tap-sum conv: a bf16 Z of the three horizontal taps, then a vertical
combine) and `exp_tailk2_r2.py`'s `post_pallas` (the 1x1 and the exp
postprocess alone). Rows 10 and 11 run at the six `SHAPES` of
`exp_convk_r3.py:109-116` (batch 8, fp32 x from a seeded generator, w times
0.05), row 13 at (8, 384, 512, 32). For each shape, in ms:
  rows 10, 11: the kernel alone (`tap_sums`: bf16 x or its copies in, Z
    out) on the sm90 kernel and on its mma.sync baseline (`core="mma"`),
    both as CUDA-graph replays (`card.graph_ms`), with the kernel-alone
    bound (bf16 x read once, three times for the copies, Z written once,
    2*M*9*Cin*Cout bf16 FLOPs) and the two kernels' Z against each other
    (at most one bf16 unit of the largest Z apart: their fp32 sums run in
    other orders); by CUDA events through the wrappers, the whole function
    (cast, copies, kernel, combine), the plain version, row 2's nine-tap
    `conv3x3_kernel` (the kernel it varies; also as a graph replay) and
    the library call (`F.conv2d` on bf16 channels_last x and w; also as a
    graph replay), the conv's bound (fp32 x read once, bf16 y written once,
    the same FLOPs) and the error against the plain version; then the sums
    over the six shapes;
  row 13: the kernel (timed as a CUDA-graph replay, `card.graph_ms`: it
    runs about as long as its wrapper's launch), the plain version (fp32
    cuDNN 1x1 + the postprocess: the chain it stands for; no one PyTorch
    call computes it), row 12's
    fused `dpt_tail_kernel` on the (8, 128, 384, 512) input that gives the
    same outputs (the kernel it varies), the bound and the errors.
Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import argparse
import math
import sys

import torch
import torch.nn.functional as F

from ..ops import _build
from ..ops.conv3x3 import conv3x3_kernel, pack_weight
from ..ops.conv3x3_taps import (CORES, VARIANTS, conv3x3_taps_kernel, conv3x3_taps_ref, pack_for,
                                tap_inputs, tap_sums)
from ..ops.dpt_post import dpt_post_kernel, dpt_post_ref
from ..ops.dpt_tail import dpt_tail_kernel
from .card import bound, card_name, graph_ms, time_ms, warm_up

SEED = 0
# exp_convk_r3.py:109-116: name, B, H, W, Cin, Cout
SHAPES = (
    ("head_conv2 384x512 128->32", 8, 384, 512, 128, 32),
    ("head_conv1 192x256 256->128", 8, 192, 256, 256, 128),
    ("rcu1 96x128 256->256", 8, 96, 128, 256, 256),
    ("layer1_rn 96x128 96->256", 8, 96, 128, 96, 256),
    ("rcu2 48x64 256->256", 8, 48, 64, 256, 256),
    ("rcu3 24x32 256->256", 8, 24, 32, 256, 256),
)
POST_SHAPE = (8, 384, 512, 32)  # B, H, W, C of row 13's h
# max abs error over max |plain| of the tap-sum conv against its plain
# version: both round Z to bf16 after fp32 sums in another order, so a Z
# may sit one bf16 unit apart, and y (two bf16 adds) up to two units
CONV_RTOL = 1e-2
# dpt_post against its plain version: the same fp32 arithmetic (FMA
# contraction and the order of the 1x1's sums aside)
POST_RTOL = 1e-5


def conv_inputs(B, H, W, cin, cout, gen):
    """x (B, Cin, H, W) fp32 channels_last and w (Cout, Cin, 3, 3), as the
    scripts draw them (standard normal x, w times 0.05)."""
    x = torch.randn(B, cin, H, W, device="cuda", generator=gen).contiguous(
        memory_format=torch.channels_last)
    w = 0.05 * torch.randn(cout, cin, 3, 3, device="cuda", generator=gen)
    return x, w


def conv_bound(B, H, W, cin, cout):
    """(ms, what bounds it) of the conv: fp32 x and w read once, bf16 y
    written once, 2*M*9*Cin*Cout bf16 FLOPs."""
    M = B * H * W
    return bound(4 * M * cin + 4 * 9 * cin * cout + 2 * M * cout,
                 dict(bf16=2 * M * 9 * cin * cout))


def taps_bound(B, H, W, cin, cout, variant):
    """(ms, what bounds it) of the kernel alone: bf16 x read once (its three
    copies for "copies"), the packed weight read once, bf16 Z (3 * Cout
    channels) written once, the conv's 2*M*9*Cin*Cout bf16 FLOPs."""
    M = B * H * W
    reads = 3 if variant == "copies" else 1
    return bound(2 * (reads * M * cin + 9 * cin * cout + 3 * M * cout),
                 dict(bf16=2 * M * 9 * cin * cout))


def bf16_unit(v):
    """One bf16 unit in the last place of a value of magnitude v > 0."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def _rel_err(out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    return err, err / ref.float().abs().max().item()


def measure_conv(x, w, variant, iters=20, row2=True):
    """One tap-sum variant at x's shape: the whole function on each kernel
    against its plain version (error), the sm90 kernel's Z against the mma.sync
    baseline's (`z_err` against `z_unit`, one bf16 unit of the largest Z),
    the kernel-alone times of both by CUDA-graph replay, and by CUDA events
    the whole function, the plain version, row 2's kernel (if `row2`, also
    by graph replay) and bf16 `F.conv2d` (also by graph replay)."""
    B, cin, H, W = x.shape
    cout = w.shape[0]
    ref = conv3x3_taps_ref(x, w, variant)
    errs = {}
    for core in CORES:
        out = conv3x3_taps_kernel(x, w, variant, core)
        torch.cuda.synchronize()
        if not (out.shape == ref.shape and out.dtype == torch.bfloat16
                and out.is_contiguous(memory_format=torch.channels_last)
                and torch.isfinite(out).all()):
            raise AssertionError(f"conv3x3_taps {variant} {core}: bad output "
                                 f"{tuple(out.shape)} {out.dtype}")
        errs[core] = _rel_err(out, ref)
        del out
    del ref
    (err, rel), (mma_err, mma_rel) = errs["sm90"], errs["mma"]
    taps = tap_inputs(x.permute(0, 2, 3, 1).to(torch.bfloat16), variant)
    wk, wt = pack_for(w), pack_for(w, "mma")
    z, z_mma = tap_sums(taps, wk, variant), tap_sums(taps, wt, variant, "mma")
    z_err = _rel_err(z, z_mma)[0]
    z_unit = bf16_unit(z_mma.float().abs().max().item())
    del z, z_mma
    xb = x.to(torch.bfloat16)
    wb = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wp = pack_weight(w) if row2 else None
    bound_ms, bound_by = conv_bound(B, H, W, cin, cout)
    kernel_bound_ms, kernel_bound_by = taps_bound(B, H, W, cin, cout, variant)
    return dict(kernel_ms=graph_ms(lambda: tap_sums(taps, wk, variant), iters),
                mma_kernel_ms=graph_ms(lambda: tap_sums(taps, wt, variant, "mma"), iters),
                ms=time_ms(lambda: conv3x3_taps_kernel(x, w, variant), iters),
                plain_ms=time_ms(lambda: conv3x3_taps_ref(x, w, variant), iters),
                row2_ms=time_ms(lambda: conv3x3_kernel(x, w), iters) if row2 else None,
                row2_graph_ms=(graph_ms(lambda: conv3x3_kernel(x, w, packed=wp), iters)
                               if row2 else None),
                library_ms=time_ms(lambda: F.conv2d(xb, wb, padding=1), iters),
                library_graph_ms=graph_ms(lambda: F.conv2d(xb, wb, padding=1), iters),
                bound_ms=bound_ms, bound_by=bound_by, kernel_bound_ms=kernel_bound_ms,
                kernel_bound_by=kernel_bound_by, max_abs_err=err, rel=rel,
                mma_max_abs_err=mma_err, mma_rel=mma_rel, z_err=z_err,
                z_unit=z_unit, tflops=2 * B * H * W * 9 * cin * cout)


def post_inputs(B, H, W, gen):
    """h (B, 32, H, W) fp32 channels_last (a ReLU'd conv output), w3
    (4, 32, 1, 1) and b3 (4,), as exp_tailk2_r2.py draws its tail's."""
    h = torch.relu(0.5 * torch.randn(B, 32, H, W, device="cuda", generator=gen)).contiguous(
        memory_format=torch.channels_last)
    w3 = 0.2 * torch.randn(4, 32, 1, 1, device="cuda", generator=gen)
    b3 = 0.1 * torch.randn(4, device="cuda", generator=gen)
    return h, w3, b3


def post_bound(B, H, W):
    """(ms, what bounds it) of the epilogue: h read once (128 bytes a
    pixel), pts and conf written once (16), ~276 fp32 operations a pixel
    (the 1x1's 128 multiply-adds and ~20 of the postprocess)."""
    M = B * H * W
    return bound(4 * (M * 32 + 32 * 4 + 4 + M * 3 + M), dict(fp32=M * (2 * 32 * 4 + 20)))


def measure_post(h, w3, b3, iters=20, tail=True, gen=None):
    """dpt_post against its plain version (errors on pts and conf) and the
    times of the kernel (a CUDA-graph replay, `graph_ms`: it runs about as
    long as its wrapper's launch), the plain version and, if `tail`, row
    12's fused tail on the (B, 128, H, W) input that ends in outputs of
    this size."""
    B, _, H, W = h.shape
    pts, conf = dpt_post_kernel(h, w3, b3, 1.0)
    torch.cuda.synchronize()
    want = dpt_post_ref(h, w3, b3, 1.0)
    errs = []
    for key, got, ref in (("pts3d", pts, want[0]), ("conf", conf, want[1])):
        if not (got.shape == ref.shape and got.is_contiguous() and torch.isfinite(got).all()):
            raise AssertionError(f"dpt_post: bad {key} {tuple(got.shape)}")
        errs.append((key, *_rel_err(got, ref)))
    del want
    tail_ms = None
    if tail:
        y = (0.3 * torch.randn(B, 128, H, W, device="cuda", generator=gen)).contiguous(
            memory_format=torch.channels_last)
        w2 = 0.05 * torch.randn(32, 128, 3, 3, device="cuda", generator=gen)
        b2 = 0.05 * torch.randn(32, device="cuda", generator=gen)
        tail_ms = time_ms(lambda: dpt_tail_kernel(y, w2, b2, w3, b3, 1.0), iters)
        del y
    bound_ms, bound_by = post_bound(B, H, W)
    return dict(ms=graph_ms(lambda: dpt_post_kernel(h, w3, b3, 1.0), iters),
                plain_ms=time_ms(lambda: dpt_post_ref(h, w3, b3, 1.0), iters),
                tail_ms=tail_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=max(e for _, e, _ in errs), rel=max(r for _, _, r in errs),
                errs=errs)


def conv_line(label, shape, variant, r):
    return (f"[row {10 if variant == 'slices' else 11}] {variant} {label} x{shape}: kernel "
            f"alone (graph) {r['kernel_ms']:.4f} ms ({r['tflops'] / r['kernel_ms'] / 1e9:.1f} "
            f"TFLOP/s, {100 * r['kernel_bound_ms'] / r['kernel_ms']:.1f} % of its bound "
            f"{r['kernel_bound_ms']:.4f} ms, {r['kernel_bound_by']}), mma.sync baseline "
            f"{r['mma_kernel_ms']:.4f} ms ({r['mma_kernel_ms'] / r['kernel_ms']:.2f}x); whole "
            f"function {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            + ("" if r["row2_ms"] is None else
               f"row-2 conv3x3 {r['row2_ms']:.4f} ms (graph {r['row2_graph_ms']:.4f}), ")
            + f"bf16 F.conv2d {r['library_ms']:.4f} ms (graph {r['library_graph_ms']:.4f}), "
            f"conv bound {r['bound_ms']:.4f} ms ({r['bound_by']}); max_abs_err "
            f"{r['max_abs_err']:.3e} rel {r['rel']:.3e} (baseline {r['mma_rel']:.3e}; limit "
            f"{CONV_RTOL:g}); Z against the baseline's {r['z_err']:.3e} (limit one bf16 unit "
            f"{r['z_unit']:.3e})")


def check_conv(label, variant, r):
    """Raise if either kernel disagrees with its plain version or the sm90
    kernel's Z with the baseline's."""
    if not (max(r["rel"], r["mma_rel"]) <= CONV_RTOL and r["z_err"] <= r["z_unit"]):
        raise AssertionError(f"conv3x3_taps {variant} {label}: the kernels disagree (rel err "
                             f"{r['rel']:.3e}, baseline {r['mma_rel']:.3e}, Z against the "
                             f"baseline's {r['z_err']:.3e} of "
                             f"{r['z_unit']:.3e})")


SUMMED = ("kernel_ms", "mma_kernel_ms", "kernel_bound_ms", "ms", "plain_ms", "row2_ms",
          "row2_graph_ms", "library_ms", "library_graph_ms", "bound_ms")


def sum_line(variant, rows):
    total = {k: sum(r[k] or 0.0 for r in rows) for k in SUMMED}
    return (f"[row {10 if variant == 'slices' else 11}] {variant}, the {len(rows)} shapes "
            f"summed: kernel alone (graph) {total['kernel_ms']:.4f} ms "
            f"({100 * total['kernel_bound_ms'] / total['kernel_ms']:.1f} % of its bound "
            f"{total['kernel_bound_ms']:.4f} ms), mma.sync baseline {total['mma_kernel_ms']:.4f} "
            f"ms ({total['mma_kernel_ms'] / total['kernel_ms']:.2f}x); whole function "
            f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, row-2 conv3x3 "
            f"{total['row2_ms']:.4f} ms (graph {total['row2_graph_ms']:.4f}), bf16 F.conv2d "
            f"{total['library_ms']:.4f} ms (graph {total['library_graph_ms']:.4f}), conv bound "
            f"{total['bound_ms']:.4f} ms")


def post_line(shape, r):
    return (f"[row 13] dpt_post h{shape}: kernel {r['ms']:.4f} ms, plain (fp32 cuDNN 1x1 + "
            f"postprocess, the chain it stands for) {r['plain_ms']:.4f} ms, "
            + ("" if r["tail_ms"] is None else
               f"row-12 fused dpt_tail (from y (B, 128, H, W)) {r['tail_ms']:.4f} ms, ")
            + f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
            + ", ".join(f"{k} max_abs_err {e:.3e} rel {rel:.3e}" for k, e, rel in r["errs"])
            + f" (limit {POST_RTOL:g})")


def run(iters=20, log=print):
    """Every row at its script's shapes; raises if a kernel disagrees with
    its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    for n, (label, B, H, W, cin, cout) in enumerate(SHAPES):
        x, w = conv_inputs(B, H, W, cin, cout, gen)
        if n == 0:
            warm_up(lambda: conv3x3_taps_kernel(x, w, "slices"))
        for variant in VARIANTS:
            r = measure_conv(x, w, variant, iters)
            log(conv_line(label, (B, cin, H, W), variant, r))
            check_conv(label, variant, r)
            results.append(dict(label=label, variant=variant, **r))
        del x, w
    for variant in VARIANTS:
        log(sum_line(variant, [r for r in results if r["variant"] == variant]))
    B, H, W, C = POST_SHAPE
    h, w3, b3 = post_inputs(B, H, W, gen)
    r = measure_post(h, w3, b3, iters, gen=gen)
    log(post_line((B, C, H, W), r))
    if not r["rel"] <= POST_RTOL:
        raise AssertionError(f"dpt_post: the kernel disagrees ({r})")
    results.append(dict(label="dpt_post", **r))
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_variants: no CUDA device (torch.cuda.is_available() is False)")
    print(card_name())
    _build.build(["conv3x3_taps", "conv3x3_taps_mma", "dpt_post", "conv3x3", "dpt_tail"])
    run(args.iters)


if __name__ == "__main__":
    sys.exit(main())
