#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port once on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as a check of the port
    python3 chip_smoke.py --kernels-only  # build and check the kernels, then stop

Phases (each prints its lines; a failed phase raises and the exit code is 1):
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the kernels from `dust3r_tpu_torch/csrc/` (nvcc, sm_90a);
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the main path gives it, with times;
  4. slice: `DUSt3R_ViTLarge_BaseDecoder_512_dpt` at full width (seeded random
     weights, bf16 body, fp32 heads) serves three requests through
     make_pairs -> InferenceEngine -> inference; checks outputs, both
     kernels' launch counts, and a bf16-kernel vs fp32-plain pointmap parity;
  5. scene: the global aligner (global_aligner -> compute_global_alignment,
     MST init, 300 cosine iterations, bf16 observations) on (i) a synthetic
     6-image 512x384 scene with a known answer, which it must recover
     (focals to 1 %, relative rotations to 1 degree), and (ii) the README's
     quick start on request (a)'s pairs served again on the device
     (`infer_pairs(..., to_cpu=False)`, both kernels' launches counted from
     0 and checked): finite, falling losses, poses and positive focals.
The second-to-last line is a JSON object of the kernels, with the launches
of the slice's run; the last line is {"ok": true, "device": {...}}. With
`--kernels-only` neither line is printed. Without a CUDA device, or outside
a checkout of the repo, it exits non-zero and prints no result.
Throughput A/B, a profile of the slice and one of the aligner's loop:
`dust3r_tpu_torch/tools/measure.py`.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
BATCH_SIZE = 8
# relative tolerance of a bf16 kernel against the fp32 plain version:
# bf16 keeps an 8-bit mantissa and P is rounded to bf16 before P.v
KERNEL_RTOL = 1e-2
# normalized pointmap RMSE budget, bf16 kernel forward vs fp32 plain forward
# (the parity budget of BASELINE.json)
PARITY_RMSE = 1e-2
H384, H336, W = 384, 336, 512  # the 512x384 and 512x336 buckets
KERNELS = ("fused_attention", "conv3x3")
# max abs error of conv3x3 against conv3x3_bf16_ref over max |ref|: both
# take the same bf16-rounded operands, whose products are exact in fp32;
# only the order of the fp32 sums differs
CONV_RTOL = 1e-3
# the scene phase: 6 images (a complete symmetrized graph of 30 edges),
# focal 1.2 x the width; recovery limits on that exact scene
SCENE_IMAGES = 6
SCENE_FOCAL = 1.2
FOCAL_RTOL = 1e-2
ROT_DEG = 1.0
ALIGN_ITERS = 300
# the 3x3 convs of one DPT head at 512x384 (a 24x32 patch grid):
# name, Cin, Cout, H, W, bias, how many of the head's 20 convs have it
CONV_CASES = (
    ("layer1_rn", 96, 256, 96, 128, False, 1),
    ("layer2_rn", 192, 256, 48, 64, False, 1),
    ("layer3_rn", 384, 256, 24, 32, False, 1),
    ("layer4_rn", 768, 256, 12, 16, False, 1),
    ("refinenet4", 256, 256, 12, 16, True, 2),
    ("refinenet3", 256, 256, 24, 32, True, 4),
    ("refinenet2", 256, 256, 48, 64, True, 4),
    ("refinenet1", 256, 256, 96, 128, True, 4),
    ("head.0", 256, 128, 192, 256, True, 1),
    ("head.2", 128, 32, 384, 512, True, 1),
)


def log(msg):
    print(msg, flush=True)


def device_phase(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    return card


def build_phase():
    from dust3r_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(KERNELS)  # one nvcc per source, all started together
    for name in KERNELS:
        _build.load_library(name)
    log(f"[build] {', '.join(k + '.cu' for k in KERNELS)}: {time.perf_counter() - t0:.2f} s "
        f"in all (nvcc: " + ", ".join(f"{k} {_build.build_seconds.get(k, 0.0):.2f} s"
                                      for k in KERNELS)
        + "; 0 means the library was already built)")
    for name in KERNELS:
        for line in _build.ptxas_log(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def time_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_kernel_phase(torch):
    """fused_attention against attention_ref at the main path's shapes. The
    kernel gets its RoPE tables built once, as the model hands them to every
    layer; the plain version builds its own on each call, as on its path."""
    from dust3r_tpu_torch.models.blocks import token_positions
    from dust3r_tpu_torch.ops.fused_attention import attention_ref, fused_attention
    from dust3r_tpu_torch.ops.rope import rope_tables

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"

    def pos(B, h, w):
        return token_positions(B, h // 16, w // 16, dev).contiguous()

    cases = [  # name, (B, H, Nq, Nk, d), positions_q, positions_k
        ("encoder_self", (8, 16, 768, 768, 64), pos(8, H384, W), pos(8, H384, W)),
        ("decoder_self", (8, 12, 768, 768, 64), pos(8, H384, W), pos(8, H384, W)),
        ("decoder_cross_768x672", (8, 12, 768, 672, 64), pos(8, H384, W),
         pos(8, H336, W)),
        ("no_rope_196", (2, 12, 196, 196, 64), None, None),
    ]
    rows = []
    for name, (B, Hh, Nq, Nk, d), pq, pk in cases:
        def rnd(n):
            return torch.randn(B, Hh, n, d, device=dev, generator=gen).to(torch.bfloat16)

        q, k, v = rnd(Nq), rnd(Nk), rnd(Nk)
        tq, tk = ((None, None) if pq is None else
                  (rope_tables(pq, d), rope_tables(pk, d)))

        def kernel():
            return fused_attention(q, k, v, pq, pk, 100.0, tq, tk)

        out = kernel()
        torch.cuda.synchronize()
        ref = attention_ref(q.float(), k.float(), v.float(), pq, pk)
        err = (out.float() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        if not (out.shape == ref.shape and torch.isfinite(out).all()):
            raise AssertionError(f"{name}: bad kernel output {tuple(out.shape)}")
        ms = time_ms(torch, kernel)
        plain_ms = time_ms(torch, lambda: attention_ref(q, k, v, pq, pk))
        log(f"[kernel] fused_attention {name} q{(B, Hh, Nq, d)} k{(B, Hh, Nk, d)} bf16 "
            f"rope={pq is not None}: max_abs_err {err:.3e} rel {rel:.3e} "
            f"(limit {KERNEL_RTOL:g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not rel <= KERNEL_RTOL:
            raise AssertionError(f"{name}: kernel disagrees with the plain version, "
                                 f"rel err {rel:.3e} > {KERNEL_RTOL:g}")
        rows.append(dict(name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms))
    return rows


def conv_kernel_phase(torch):
    """conv3x3 against conv3x3_bf16_ref (its plain version) at each 3x3 conv
    shape of a DPT head at 512x384, batch 8; also timed against the fp32
    cuDNN conv it replaces on the path. Returns the rows and the three
    times summed over one head's 20 convs."""
    from dust3r_tpu_torch.ops.conv3x3 import conv3x3_bf16_ref, conv3x3_kernel, conv3x3_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, total = [], dict(ms=0.0, plain_ms=0.0, fp32_ms=0.0)
    for name, cin, cout, h, w, bias, count in CONV_CASES:
        x = torch.randn(BATCH_SIZE, cin, h, w, device="cuda", generator=gen).contiguous(
            memory_format=torch.channels_last)
        wt = torch.randn(cout, cin, 3, 3, device="cuda", generator=gen) * (9 * cin) ** -0.5
        b = torch.randn(cout, device="cuda", generator=gen) if bias else None
        out = conv3x3_kernel(x, wt, b)
        torch.cuda.synchronize()
        ref = conv3x3_bf16_ref(x, wt, b)
        ref32 = conv3x3_ref(x, wt, b)
        if not (out.shape == ref.shape and torch.isfinite(out).all()):
            raise AssertionError(f"conv3x3 {name}: bad kernel output {tuple(out.shape)}")
        err = (out - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        rel32 = (out - ref32).abs().max().item() / ref32.abs().max().item()
        del ref, ref32
        t = dict(ms=time_ms(torch, lambda: conv3x3_kernel(x, wt, b)),
                 plain_ms=time_ms(torch, lambda: conv3x3_bf16_ref(x, wt, b)),
                 fp32_ms=time_ms(torch, lambda: conv3x3_ref(x, wt, b)))
        tflops = 2 * BATCH_SIZE * h * w * 9 * cin * cout / t["ms"] / 1e9
        log(f"[kernel] conv3x3 {name} x{(BATCH_SIZE, cin, h, w)} -> {cout} "
            f"bias={bias} x{count}/head: max_abs_err {err:.3e} rel {rel:.3e} (limit "
            f"{CONV_RTOL:g}; vs fp32 conv rel {rel32:.3e}); kernel {t['ms']:.4f} ms "
            f"({tflops:.1f} TFLOP/s), bf16 plain {t['plain_ms']:.4f} ms, fp32 cuDNN "
            f"{t['fp32_ms']:.4f} ms")
        if not rel <= CONV_RTOL:
            raise AssertionError(f"conv3x3 {name}: kernel disagrees with its plain "
                                 f"version, rel err {rel:.3e} > {CONV_RTOL:g}")
        for k in total:
            total[k] += count * t[k]
        rows.append(dict(name=name, max_abs_err=err, **t))
    log(f"[kernel] conv3x3, one DPT head's 20 convs at batch 8: kernel {total['ms']:.4f} ms, "
        f"bf16 plain {total['plain_ms']:.4f} ms, fp32 cuDNN {total['fp32_ms']:.4f} ms")
    return rows, total


def _check_request(name, out, n_pairs, shapes):
    """Shapes, finiteness and conf >= 1 of one inference() result."""
    import numpy as np

    for side, key in (("pred1", "pts3d"), ("pred2", "pts3d_in_other_view")):
        pts, conf = out[side][key], out[side]["conf"]
        if len(pts) != n_pairs or len(conf) != n_pairs:
            raise AssertionError(f"{name}: {side} holds {len(pts)} pairs, not {n_pairs}")
        for n in range(n_pairs):
            hw = shapes[n][0 if side == "pred1" else 1]
            p, c = np.asarray(pts[n]), np.asarray(conf[n])
            if p.shape != (*hw, 3) or c.shape != hw:
                raise AssertionError(f"{name}: pair {n} {side} shapes {p.shape}, {c.shape}")
            if not (np.isfinite(p).all() and np.isfinite(c).all()):
                raise AssertionError(f"{name}: pair {n} {side} is not finite")
            if not (c >= 1).all():
                raise AssertionError(f"{name}: pair {n} {side} conf below 1")
    for side in ("view1", "view2"):
        if len(out[side]["img"]) != n_pairs:
            raise AssertionError(f"{name}: {side} holds {len(out[side]['img'])} views")


def slice_phase(torch):
    import numpy as np

    from dust3r_tpu_torch.image_pairs import make_pairs
    from dust3r_tpu_torch.inference import InferenceEngine, inference
    from dust3r_tpu_torch.model import dust3r_512_dpt
    from dust3r_tpu_torch.models.heads import Conv3x3
    from dust3r_tpu_torch.ops.conv3x3 import conv3x3_kernel
    from dust3r_tpu_torch.ops.fused_attention import fused_attention
    from dust3r_tpu_torch.utils.image import views_from_arrays

    t0 = time.perf_counter()
    model = dust3r_512_dpt(dtype=torch.bfloat16, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[slice] dust3r_512_dpt: {n_params} fp32 params, enc {model.enc_depth} / "
        f"dec {model.dec_depth} layers, bf16 body, fp32 heads; built in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED)

    def images(*heights):
        return views_from_arrays([rng.integers(0, 256, (h, W, 3), dtype=np.uint8)
                                  for h in heights])

    req_a = make_pairs(images(H384, H384, H384, H384), "complete", symmetrize=True)
    req_b = make_pairs(images(H384, H384, H336, H336), "complete", symmetrize=True)
    engine = InferenceEngine(model, batch_size=BATCH_SIZE)

    def shapes(pairs):
        return [tuple(tuple(v["img"].shape[1:3]) for v in p) for p in pairs]

    # the main path: every launch count starts at 0 here
    fused_attention.launches = 0
    conv3x3_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t_a = time.perf_counter()
    out_a = inference(req_a, engine, verbose=False)
    t_a = time.perf_counter() - t_a
    t_b = time.perf_counter()
    out_b = inference(req_b, engine, verbose=False)
    t_b = time.perf_counter() - t_b
    torch.cuda.synchronize()
    t_c = time.perf_counter()
    out_c = inference(req_a, engine, verbose=False)
    t_c = time.perf_counter() - t_c
    launches = dict(fused_attention=fused_attention.launches,
                    conv3x3=conv3x3_kernel.launches)
    peak = torch.cuda.max_memory_allocated()

    for name, out, pairs in (("a", out_a, req_a), ("b", out_b, req_b), ("c", out_c, req_a)):
        _check_request(f"request {name}", out, len(pairs), shapes(pairs))
    expected = (model.enc_depth * engine.encoder_batches
                + 4 * model.dec_depth * engine.pair_batches)
    convs_per_pair_batch = sum(isinstance(m, Conv3x3) for m in model.modules())  # both heads
    expected_conv = convs_per_pair_batch * engine.pair_batches
    log(f"[slice] request a: {len(req_a)} pairs 512x384 in {t_a:.3f} s (cold); "
        f"request b: {len(req_b)} pairs, buckets {sorted(set(shapes(req_b)))}, "
        f"in {t_b:.3f} s; request c (= a, warm): {t_c:.3f} s, "
        f"{len(req_a) / t_c:.3f} pairs/s")
    log(f"[slice] engine: {engine.encoder_batches} encoder batches, "
        f"{engine.pair_batches} pair batches -> {expected} attention calls, "
        f"{convs_per_pair_batch} x {engine.pair_batches} = {expected_conv} 3x3 conv calls; "
        f"launches {launches}; peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    if launches["fused_attention"] != expected:
        raise AssertionError(f"attention launches {launches['fused_attention']} != "
                             f"{expected}: some attention call of the main path "
                             f"bypassed the kernel")
    if launches["conv3x3"] != expected_conv:
        raise AssertionError(f"conv3x3 launches {launches['conv3x3']} != {expected_conv}: "
                             f"some 3x3 conv of the main path bypassed the kernel")
    drift = float(np.abs(out_a["pred1"]["pts3d"] - out_c["pred1"]["pts3d"]).max()
                  / np.abs(out_a["pred1"]["pts3d"]).max())
    if not drift <= 1e-3:
        raise AssertionError(f"request c differs from request a by {drift:.3e}")

    # bf16 kernel forward vs fp32 plain forward (plain attention, fp32
    # cuDNN convs), same weights
    model32 = dust3r_512_dpt(dtype=torch.float32, attn_impl="plain", conv_impl="ref",
                             device="cuda", seed=SEED + 1)
    model32.load_state_dict(model.state_dict())
    out32 = inference(req_a[:1], InferenceEngine(model32, batch_size=1), verbose=False)
    worst = 0.0
    for side, key in (("pred1", "pts3d"), ("pred2", "pts3d_in_other_view")):
        a = out_a[side][key][0].astype(np.float64)
        b = out32[side][key][0].astype(np.float64)
        rmse = float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))
        worst = max(worst, rmse)
        log(f"[slice] parity {side}.{key}: normalized RMSE bf16-kernel vs "
            f"fp32-plain {rmse:.3e} (limit {PARITY_RMSE:g})")
    if not worst <= PARITY_RMSE:
        raise AssertionError(f"pointmap parity {worst:.3e} > {PARITY_RMSE:g}")
    del model32
    return launches, engine, req_a


def rotation_error_deg(R1, R2):
    import numpy as np

    return float(np.degrees(np.arccos(np.clip((np.trace(R1.T @ R2) - 1) / 2, -1, 1))))


def _align(torch, name, out, device):
    """global_aligner -> compute_global_alignment as the README's quick start
    calls it; prints init seconds, iterations/s, final loss, peak memory."""
    import numpy as np

    from dust3r_tpu_torch.cloud_opt import global_aligner

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scene = global_aligner(out, device=device, verbose=False)
    build_s = time.perf_counter() - t0
    final = scene.compute_global_alignment(init="mst", niter=ALIGN_ITERS, schedule="cosine",
                                           lr=0.01)
    peak = torch.cuda.max_memory_allocated()
    losses = scene.last_losses
    log(f"[scene] {name}: {scene.n_imgs} images {scene.imshapes[0]}, {scene.n_edges} edges, "
        f"{scene.obs_pred_i.dtype} observations; scene built in {build_s:.3f} s, init "
        f"(host) {scene.seconds['init']:.3f} s, {ALIGN_ITERS} iterations in "
        f"{scene.seconds['align']:.3f} s = {ALIGN_ITERS / scene.seconds['align']:.1f} it/s; "
        f"loss {losses[0]:.6g} -> {losses[-1]:.6g}, final {final:.6g}; peak device memory "
        f"{peak} bytes ({peak / 2**30:.3f} GiB)")
    if not (np.isfinite(losses).all() and np.isfinite(final)):
        raise AssertionError(f"{name}: non-finite losses")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: the loss did not fall ({losses[0]} -> {losses[-1]})")
    poses = scene.get_im_poses().cpu().numpy()
    focals = scene.get_focals().cpu().numpy().ravel()
    if poses.shape != (scene.n_imgs, 4, 4) or not np.isfinite(poses).all():
        raise AssertionError(f"{name}: bad poses {poses.shape}")
    if not (np.isfinite(focals).all() and (focals > 0).all()):
        raise AssertionError(f"{name}: bad focals {focals}")
    pts = scene.get_pts3d()
    if [tuple(p.shape) for p in pts] != [(*hw, 3) for hw in scene.imshapes]:
        raise AssertionError(f"{name}: bad pointmaps")
    return scene, poses, focals


def scene_phase(torch, engine, pairs):
    import numpy as np

    from dust3r_tpu_torch.models.heads import Conv3x3
    from dust3r_tpu_torch.ops.conv3x3 import conv3x3_kernel
    from dust3r_tpu_torch.ops.fused_attention import fused_attention
    from dust3r_tpu_torch.tools.scenes import synthetic_scene

    # (i) a synthetic scene with a known answer, at full resolution
    out, poses, focal = synthetic_scene(SCENE_IMAGES, H384, W, SCENE_FOCAL * W, seed=SEED)
    _, est, focals = _align(torch, "synthetic", out, "cuda")
    focal_err = float(np.abs(focals / focal - 1).max())
    rot_err = max(rotation_error_deg((np.linalg.inv(poses[0]) @ poses[k])[:3, :3],
                                     (np.linalg.inv(est[0]) @ est[k])[:3, :3])
                  for k in range(1, SCENE_IMAGES))
    log(f"[scene] synthetic: focal {focal:.1f} px recovered to {focal_err:.3e} relative "
        f"(limit {FOCAL_RTOL:g}); relative rotations to {rot_err:.4f} deg (limit "
        f"{ROT_DEG:g})")
    if not (focal_err <= FOCAL_RTOL and rot_err <= ROT_DEG):
        raise AssertionError("synthetic scene not recovered")

    # (ii) the README's quick start: request (a)'s pairs, kept on the device;
    # its launch counts start at 0 here
    model = engine.model
    batches = (engine.encoder_batches, engine.pair_batches)
    fused_attention.launches = 0
    conv3x3_kernel.launches = 0
    t0 = time.perf_counter()
    out = engine.infer_pairs(pairs, to_cpu=False)
    torch.cuda.synchronize()
    launches = dict(fused_attention=fused_attention.launches,
                    conv3x3=conv3x3_kernel.launches)
    enc, pair = engine.encoder_batches - batches[0], engine.pair_batches - batches[1]
    expected = dict(fused_attention=model.enc_depth * enc + 4 * model.dec_depth * pair,
                    conv3x3=sum(isinstance(m, Conv3x3) for m in model.modules()) * pair)
    log(f"[scene] quick start: {len(pairs)} pairs served on the device in "
        f"{time.perf_counter() - t0:.3f} s; launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"quick start launches {launches} != {expected}: some call "
                             f"of its path bypassed a kernel")
    _align(torch, "quick start", out, None)


def main(argv):
    if not (ROOT / "dust3r_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repo (dust3r_tpu_torch/ missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch

    import dust3r_tpu_torch  # noqa: F401  (sets the TF32 policy)

    device_phase(torch)
    build_phase()
    attn_rows = attention_kernel_phase(torch)
    conv_rows, conv_total = conv_kernel_phase(torch)
    if "--kernels-only" in argv:
        return 0
    launches, engine, pairs = slice_phase(torch)
    scene_phase(torch, engine, pairs)
    enc = attn_rows[0]
    kernels = [dict(name="fused_attention", route="cuda",
                    source="dust3r_tpu_torch/csrc/fused_attention.cu",
                    replaces="dust3r_tpu/ops/pallas_attention.py:142",
                    launches=launches["fused_attention"],
                    max_abs_err=max(r["max_abs_err"] for r in attn_rows),
                    ms=enc["ms"], plain_ms=enc["plain_ms"]),
               dict(name="conv3x3", route="cuda",
                    source="dust3r_tpu_torch/csrc/conv3x3.cu",
                    replaces="dust3r_tpu/ops/conv3x3.py:74",
                    launches=launches["conv3x3"],
                    max_abs_err=max(r["max_abs_err"] for r in conv_rows),
                    ms=conv_total["ms"], plain_ms=conv_total["plain_ms"])]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
