"""Measure the 512_dpt slice on one CUDA card.

    python -m dust3r_tpu_torch.tools.measure ab [--reps 3]
    python -m dust3r_tpu_torch.tools.measure profile [--out build/profile]
    python -m dust3r_tpu_torch.tools.measure align [--iters 20]

`ab` and `profile` serve the request of `chip_smoke.py` request (c): 4 images at 512x384,
`complete` graph, symmetrized (12 pairs), batch 8, through make_pairs ->
InferenceEngine -> inference, at full width with seeded random weights
(bf16 body, fp32 heads).

  ab       the kernels against their plain versions, end to end: three
           models with the same weights, "kernels" (all four kernels),
           "plain attention" (plain bf16 attention, the DPT head kernels)
           and "ref heads" (attention kernel; the DPT heads' plain fp32
           versions: cuDNN 3x3 convs, the plain upsample and tail, i.e.
           conv_impl="ref"), warmed, then timed in the order kernels, plain
           attention, ref heads, ref heads, plain attention, kernels,
           `--reps` times; prints pairs/s of every run and the medians.
  profile  one warm request under torch.profiler: the device's busy share
           of the request's wall time, device time by kernel class and by
           kernel; the Chrome trace goes to `--out`. The classes match
           kernel names by substring, so a renamed kernel may land in
           "other".
  align    the aligner's loop on the scene phase's synthetic scene under
           torch.profiler: per iteration, wall, device busy share and
           device time by class and by kernel.
"""
from __future__ import annotations

import argparse
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from dust3r_tpu_torch.image_pairs import make_pairs
from dust3r_tpu_torch.inference import InferenceEngine, inference
from dust3r_tpu_torch.model import dust3r_512_dpt
from dust3r_tpu_torch.utils.image import views_from_arrays

from .card import card_name

SEED = 0
BATCH_SIZE = 8


def _request():
    rng = np.random.default_rng(SEED)
    views = views_from_arrays([rng.integers(0, 256, (384, 512, 3), dtype=np.uint8)
                               for _ in range(4)])
    return make_pairs(views, "complete", symmetrize=True)


def _pairs_per_s(pairs, engine):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inference(pairs, engine, verbose=False)
    return len(pairs) / (time.perf_counter() - t0)


AB_VARIANTS = {  # name: (attn_impl, conv_impl) of the model
    "kernels": ("kernel", "kernel"),
    "plain attention": ("plain", "kernel"),
    "ref heads": ("kernel", "ref"),
}


def ab(reps):
    pairs = _request()
    engines, weights = {}, None
    for n, (name, (attn, conv)) in enumerate(AB_VARIANTS.items()):
        model = dust3r_512_dpt(dtype=torch.bfloat16, device="cuda", seed=SEED + n,
                               attn_impl=attn, conv_impl=conv)
        if weights is None:
            weights = model.state_dict()
        else:
            model.load_state_dict(weights)
        engines[name] = InferenceEngine(model, BATCH_SIZE)
    for engine in engines.values():  # warm-up
        inference(pairs, engine, verbose=False)
    runs = {name: [] for name in engines}
    order = list(engines)
    for name in (order + order[::-1]) * reps:
        runs[name].append(_pairs_per_s(pairs, engines[name]))
    for name, r in runs.items():
        print(f"[ab] {name}: pairs/s median {statistics.median(r):.3f}, "
              f"min {min(r):.3f}, max {max(r):.3f}; runs {[round(x, 3) for x in r]}")


def _kernel_class(name):
    n = name.lower()
    if "attn_" in n:
        return "attention kernel"
    if "conv3x3_sm90" in n or "conv3x3_igemm" in n:
        return "conv3x3 kernel"
    if "up2x_align_corners" in n:
        return "up2x kernel"
    if "dpt_tail" in n:
        return "dpt_tail kernel"
    if "conv" in n or "cudnn" in n or "implicit" in n or "winograd" in n:
        return "conv (cuDNN)"
    if any(s in n for s in ("gemm", "xmma", "cutlass", "nvjet")):
        return "gemm (cuBLAS)"
    if "copy" in n or "memcpy" in n or "memset" in n:
        return "copy/cast"
    return "elementwise/norm/other"


def _device_summary(prof, wall_us, what, per=1):
    """Print the device's busy share of `wall_us` and its kernel time by
    class and by kernel, divided by `per` (the runs the trace holds)."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("[profile] the profiler saw no device events")
    busy, end = 0, None
    for s, e in sorted((k.time_range.start, k.time_range.end) for k in kernels):
        if end is None or s > end:  # union of the kernels' intervals
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    by_name, by_class = {}, {}
    for k in kernels:
        us = k.time_range.elapsed_us()
        by_name[k.name] = by_name.get(k.name, 0) + us
        cls = _kernel_class(k.name)
        by_class[cls] = by_class.get(cls, 0) + us
    total = sum(by_name.values())
    print(f"[profile] {what}: wall {wall_us / per / 1e3:.3f} ms, device busy "
          f"{busy / per / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), kernel time "
          f"{total / per / 1e3:.3f} ms in {len(kernels) / per:g} launches")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"[profile] class {cls}: {us / per / 1e3:.3f} ms ({100 * us / total:.1f}%)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[profile] kernel {us / per / 1e3:9.3f} ms  {name[:110]}")


def profile(out_dir):
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    pairs = _request()
    engine = InferenceEngine(dust3r_512_dpt(dtype=torch.bfloat16, device="cuda",
                                            seed=SEED), BATCH_SIZE)
    inference(pairs, engine, verbose=False)  # warm-up
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inference(pairs, engine, verbose=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "slice_request_trace.json"))
    _device_summary(prof, wall_us, f"request of {len(pairs)} pairs")


def align(iters):
    """`iters` iterations of the aligner's loop on the synthetic scene of
    chip_smoke.py's scene phase (6 images at 512x384, 30 edges, bf16
    observations), warmed, under torch.profiler: per iteration."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from dust3r_tpu_torch.cloud_opt import global_aligner
    from dust3r_tpu_torch.tools.scenes import synthetic_scene

    out, _, _ = synthetic_scene(6, 384, 512, 1.2 * 512, seed=SEED)
    scene = global_aligner(out, device="cuda", verbose=False)
    scene.compute_global_alignment(init=None, niter=iters)  # warm-up
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scene.compute_global_alignment(init=None, niter=iters)
        wall_us = (time.perf_counter() - t0) * 1e6
    _device_summary(prof, wall_us, f"aligner iteration ({scene.n_edges} edges, mean of "
                                   f"{iters}, final forward included)", per=iters)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("ab").add_argument("--reps", type=int, default=3)
    sub.add_parser("profile").add_argument("--out", type=Path, default=Path("build/profile"))
    sub.add_parser("align").add_argument("--iters", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("measure: no CUDA device")
    print(card_name())
    if args.cmd == "ab":
        ab(args.reps)
    elif args.cmd == "profile":
        profile(args.out)
    else:
        align(args.iters)


if __name__ == "__main__":
    main()
