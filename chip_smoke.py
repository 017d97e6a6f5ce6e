#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port once on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as a check of the port
    python3 chip_smoke.py --kernels-only  # build and check the kernels, then stop

Phases (each prints its lines; a failed phase raises and the exit code is 1):
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the nine kernel sources from `dust3r_tpu_torch/csrc/`
     (one nvcc per source, all started together, sm_90a);
  3. kernels: each kernel of the main path (fused_attention's sm90 kernel,
     conv3x3, up2x, dpt_tail) against its plain PyTorch version on the card,
     at the shapes the main path gives it (attention in the main path's
     layouts: heads read as strided views of the projections, each call's
     bits held to the same kernel on contiguous copies, and its distance
     from the mma.sync core's, the baseline; conv3x3 on the weight packed
     once, as the model's modules keep it; dpt_tail on W2 packed once, as
     the model's adapter keeps it), with the times of the kernel,
     the plain version and the one PyTorch call that computes the same
     function (where there is one), each by CUDA events over a loop of calls
     and, for the kernels, the baseline and the library calls, also as
     replays of a CUDA graph (the device's time without the host's
     launches), and the least time the card could take (bytes at 3.35 TB/s
     or operations at 989 TFLOP/s bf16 / 67 TFLOP/s fp32, whichever is
     larger);
  3b. variants: the attention-variants entry point (fused_attention with 2,
     4 and 8 heads a block on the sm90 kernel and with 2 and 4 on the
     mma.sync core, attention_variant's three softmax variants on the sm90
     kernel, nomax at row 9's G = 2, and on the mma.sync core) driven once
     at the encoder shape with its launch counts from 0, then each against
     its plain version (and G > 1 against G = 1 of the same kernel, bit for
     bit; whether each sm90 variant's bits equal the core's);
  3c. experiments: the other TPU experiments' entry points, each driven
     once with its launch counts from 0: the tap-sum conv (rows 10 and 11,
     `conv3x3_taps_kernel` "slices" and "copies", on the sm90 kernel and on
     its mma.sync baseline, `core="mma"`) at two DPT shapes, the
     DPT tail's epilogue (row 13, `dpt_post_kernel`) at 512x384, and row
     3's five floor modes (`attention_floor`: nosmax, qkonly, copy,
     copynr, copymm) at the encoder shape with 1 and 4 heads a block, on
     the sm90 kernel and on their baseline, `csrc/attention_floor.cu`;
     then each against its plain version with its times, bound and library
     call (G = 4 bit for bit against G = 1; each copy floor on the sm90
     kernel against the baseline's bits: copynr equal, copy and copymm at
     most one bf16 unit apart; the tap-sum conv's kernel alone
     by CUDA-graph replay on both kernels, "slices" bit for bit against
     "copies", the sm90 kernel's Z within one bf16 unit of the largest Z of
     the baseline's), and qkonly's time at 64 keys beside 768 on both
     kernels;
  4. slice: `DUSt3R_ViTLarge_BaseDecoder_512_dpt` at full width (seeded random
     weights, bf16 body, fp32 heads) serves three requests through
     make_pairs -> InferenceEngine -> inference; checks outputs, the four
     kernels' launch counts, and a bf16-kernel vs fp32-plain pointmap parity;
  5. scene: the global aligner (global_aligner -> compute_global_alignment,
     MST init, 300 cosine iterations, bf16 observations) on (i) a synthetic
     6-image 512x384 scene with a known answer, which it must recover
     (focals to 1 %, relative rotations to 1 degree), and (ii) the README's
     quick start on request (a)'s pairs served again on the device
     (`infer_pairs(..., to_cpu=False)`, the four kernels' launches counted
     from 0 and checked): finite, falling losses, poses and positive focals.
The second-to-last line is a JSON object of the kernels, with the launches
of the slice's run (of the variants and experiments phases for theirs); the
last line is {"ok": true, "device": {...}}. With
`--kernels-only` neither line is printed. Without a CUDA device, or outside
a checkout of the repo, it exits non-zero and prints no result.
Throughput A/B, a profile of the slice and one of the aligner's loop:
`dust3r_tpu_torch/tools/measure.py`; the TPU experiments' rows at their
scripts' shapes: `dust3r_tpu_torch/tools/attn_variants.py` (attention,
rows 3-9) and `dust3r_tpu_torch/tools/conv_variants.py` (rows 10, 11, 13).
"""
from __future__ import annotations

import json
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
SOURCES = ("fused_attention_sm90", "conv3x3", "up2x", "dpt_tail", "fused_attention",
           "conv3x3_taps", "conv3x3_taps_mma", "dpt_post", "attention_floor")
# max abs error of conv3x3 against conv3x3_bf16_ref over max |ref|: both
# take the same bf16-rounded operands, whose products are exact in fp32;
# only the order of the fp32 sums differs. The same for dpt_tail against
# dpt_tail_bf16_ref, on each output (the 1x1 and the exp are fp32 in both)
CONV_RTOL = 1e-3
TAIL_RTOL = 1e-3
# up2x against up2x_ref: the same two fp32 lerps (FMA contraction aside)
UP2X_RTOL = 1e-5
# launches of each kernel per DPT head: 19 of its 20 stride-1 3x3 convs (the
# 20th, head.2, is read by the tail kernel), its 5 upsamples (4 fusion
# blocks, 1 in the head) and its tail
PER_HEAD = dict(conv3x3=19, up2x=5, dpt_tail=1)
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
)
# the upsamples of one DPT head at batch 8: name, C, Hc, Wc, how many of the
# head's 5 calls at 512x384 have it (0: the 512x336 bucket's ragged grids)
UP2X_CASES = (
    ("refinenet4", 256, 12, 16, 1),
    ("refinenet3", 256, 24, 32, 1),
    ("refinenet2", 256, 48, 64, 1),
    ("refinenet1", 256, 96, 128, 1),
    ("head.1", 128, 192, 256, 1),
    ("refinenet4_336", 256, 11, 16, 0),
    ("refinenet3_336", 256, 21, 32, 0),
    ("head.1_336", 128, 168, 256, 0),
)
# the tail of one DPT head at batch 8: name, H, W, calls per head at 512x384
TAIL_CASES = (("384x512", H384, W, 1), ("336x512", H336, W, 0))
# the experiments phase: the tap-sum conv's shapes (name, Cin, Cout, H, W,
# batch 8), the epilogue's h (B, H, W, C) and row 3's floors (mode, G)
TAP_CASES = (("layer1_rn 96x128 96->256", 96, 256, 96, 128),
             ("head_conv2 384x512 128->32", 128, 32, H384, W))
POST_CASE = (BATCH_SIZE, H384, W, 32)
# (mode, G, core): every floor on the sm90 kernel (core None) and on
# attention_floor.cu (core "mma"), its baseline
FLOOR_CASES = tuple((m, G, core) for core in (None, "mma")
                    for m in ("nosmax", "qkonly", "copy", "copynr", "copymm") for G in (1, 4))


def log(msg):
    print(msg, flush=True)


def device_phase(torch):
    from dust3r_tpu_torch.tools.card import card_name

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    card = card_name()
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    return card


def build_phase():
    from dust3r_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(SOURCES)  # one nvcc per source, all started together
    for name in SOURCES:
        _build.load_library(name)
    log(f"[build] {', '.join(k + '.cu' for k in SOURCES)}: {time.perf_counter() - t0:.2f} s "
        f"in all (nvcc: " + ", ".join(f"{k} {_build.build_seconds.get(k, 0.0):.2f} s"
                                      for k in SOURCES)
        + "; 0 means the library was already built)")
    for name in SOURCES:
        for line in _build.ptxas_log(name).splitlines():
            if "Used" in line or "spill" in line or "arning" in line:
                log(f"[build] {name}: {line.strip()}")


def summed(rows, count_key="count"):
    """Times and bounds of a kernel's calls summed with their counts; the
    bound is named by the larger share of the summed bound."""
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    by = dict(bytes=0.0, operations=0.0)
    for r in rows:
        for k in total:
            total[k] += r[count_key] * (r[k] or 0.0)
        by[r["bound_by"]] += r[count_key] * r["bound_ms"]
    total["bound_by"] = max(by, key=by.get)
    if all(r["library_ms"] is None for r in rows):
        total["library_ms"] = None
    total["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return total


def _rel_err(out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    return err, err / ref.float().abs().max().item()


def attention_kernel_phase(torch):
    """fused_attention (its sm90 kernel on the main path's calls) against
    attention_ref at the main path's shapes and in its layouts:
    self-attention reads its heads as (B, H, N, d) views of the (B, N, 3C)
    qkv projection, cross-attention of three (B, N, C) projections; each
    call's bits are held to the same kernel on contiguous copies, and its
    output to the mma.sync core's (`core="mma"`, the baseline). The kernels
    get their RoPE tables built once, as the model hands them to every
    layer; the plain version builds its own on each call, as on its path.
    The library call is `F.scaled_dot_product_attention` on bf16 q, k, v in
    the same layout: the same function for the no-RoPE shape, and on q and k
    rotated beforehand (outside the timing) for the RoPE shapes."""
    import torch.nn.functional as F

    from dust3r_tpu_torch.ops.fused_attention import attention_ref, fused_attention
    from dust3r_tpu_torch.ops.rope import rope_tables
    from dust3r_tpu_torch.tools.attn_variants import make_qkv, positions, rotated_like
    from dust3r_tpu_torch.tools.card import attention_bound, graph_ms, time_ms, warm_up

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    g384, g336 = (H384 // 16, W // 16), (H336 // 16, W // 16)
    cases = [  # name, (B, H, Nq, Nk, d), layout, token grids of q and k (None: no RoPE)
        ("encoder_self", (8, 16, 768, 768, 64), "qkv", g384, g384),
        ("decoder_self", (8, 12, 768, 768, 64), "qkv", g384, g384),
        ("decoder_cross_768x672", (8, 12, 768, 672, 64), "packed", g384, g336),
        ("no_rope_196", (2, 12, 196, 196, 64), "contiguous", None, None),
    ]
    rows = []
    for name, (B, Hh, Nq, Nk, d), layout, grid_q, grid_k in cases:
        q, k, v = make_qkv(B, Hh, Nq, Nk, d, layout, gen)
        pq, pk = ((None, None) if grid_q is None else
                  (positions(B, grid_q, "grid", gen), positions(B, grid_k, "grid", gen)))
        tq, tk = ((None, None) if pq is None else (rope_tables(pq, d), rope_tables(pk, d)))

        def kernel():
            return fused_attention(q, k, v, pq, pk, 100.0, tq, tk)

        def baseline():
            return fused_attention(q, k, v, pq, pk, 100.0, tq, tk, core="mma")

        out = kernel()
        contiguous = fused_attention(q.contiguous(), k.contiguous(), v.contiguous(), pq, pk,
                                     100.0, tq, tk)
        base = baseline()
        torch.cuda.synchronize()
        identical = torch.equal(out, contiguous)
        ref = attention_ref(q.float(), k.float(), v.float(), pq, pk)
        err, rel = _rel_err(out, ref)
        base_err = _rel_err(base, ref)[0]
        from_base = (out.float() - base.float()).abs().max().item()
        if not (out.shape == ref.shape and torch.isfinite(out).all()):
            raise AssertionError(f"{name}: bad kernel output {tuple(out.shape)}")
        qr, kr = (q, k) if pq is None else (rotated_like(q, pq), rotated_like(k, pk))

        def library():
            return F.scaled_dot_product_attention(qr, kr, v)

        if not rows:  # the run's first timed kernel: the clocks settle first
            warm_up(kernel)
        t = dict(ms=time_ms(kernel), graph_ms=graph_ms(kernel),
                 baseline_ms=time_ms(baseline), baseline_graph_ms=graph_ms(baseline),
                 plain_ms=time_ms(lambda: attention_ref(q, k, v, pq, pk)),
                 library_ms=time_ms(library), library_graph_ms=graph_ms(library))
        bound_ms, bound_by = attention_bound(B, Hh, Nq, Nk, d, rope=pq is not None)
        flops = 4 * B * Hh * Nq * Nk * d
        log(f"[kernel] fused_attention {name} q{(B, Hh, Nq, d)} k{(B, Hh, Nk, d)} bf16 "
            f"{layout} (strides q{q.stride()} k{k.stride()}) rope={pq is not None}: sm90 "
            f"kernel's bits equal the contiguous call's: {identical}; max_abs_err {err:.3e} rel "
            f"{rel:.3e} (limit {KERNEL_RTOL:g}; the mma.sync baseline's {base_err:.3e}, max "
            f"|sm90 - baseline| {from_base:.3e}); sm90 kernel {t['ms']:.4f} ms, graph "
            f"{t['graph_ms']:.4f} ms ({flops / t['graph_ms'] / 1e9:.1f} TFLOP/s); mma.sync "
            f"baseline {t['baseline_ms']:.4f} ms, graph {t['baseline_graph_ms']:.4f} ms; plain "
            f"{t['plain_ms']:.4f} ms; sdpa{'' if pq is None else ' (q, k rotated beforehand)'} "
            f"{t['library_ms']:.4f} ms, graph {t['library_graph_ms']:.4f} ms; bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        if not identical:
            raise AssertionError(f"{name}: the strided call's bits differ from the "
                                 f"contiguous call's")
        if not rel <= KERNEL_RTOL:
            raise AssertionError(f"{name}: kernel disagrees with the plain version, "
                                 f"rel err {rel:.3e} > {KERNEL_RTOL:g}")
        rows.append(dict(name=name, max_abs_err=err, baseline_err=base_err, bound_ms=bound_ms,
                         bound_by=bound_by, **t))
    return rows


def variants_phase(torch):
    """The attention-variants entry point at the encoder shape (8,16,768,64),
    q, k, v as views of a (B, N, 3C) qkv: fused_attention with 2, 4 and 8
    heads a block on the sm90 kernel and with 2 and 4 on the mma.sync core
    (`core="mma"`, the baseline), and attention_variant's three softmax
    variants on the sm90 kernel ("nomax" at row 9's G = 2 heads a block)
    and on the mma.sync core, each called once with the launch counts from
    0 (the counts of this path), then each against its plain version
    (tools/attn_variants.measure: G > 1 bit for bit against G = 1 of the
    same kernel, whether an sm90 variant's bits equal the core's, with
    times, library call and bound). Returns the measured rows and the
    launch counts."""
    from dust3r_tpu_torch.ops.attention_variants import SOFTMAXES, attention_variant
    from dust3r_tpu_torch.ops.fused_attention import fused_attention
    from dust3r_tpu_torch.ops.rope import rope_tables
    from dust3r_tpu_torch.tools.attn_variants import RTOL, make_qkv, measure, positions

    B, Hh, N, d = 8, 16, 768, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = make_qkv(B, Hh, N, N, d, "qkv", gen)
    pos = positions(B, (H384 // 16, W // 16), "grid", gen)
    tables = rope_tables(pos, d)
    configs = ([(f"G={G}", G, None, None) for G in (2, 4, 8)]
               + [(f"G={G} mma", G, None, "mma") for G in (2, 4)]
               + [("nomax G=2", 2, "nomax", None), ("bf16_logits", 1, "bf16_logits", None),
                  ("bf16_exp", 1, "bf16_exp", None)]
               + [(f"{s} mma", 1, s, "mma") for s in SOFTMAXES])

    reset_launches()
    for _, G, softmax, core in configs:
        if softmax is None:
            fused_attention(q, k, v, pos, pos, 100.0, tables, tables, G, core=core)
        else:
            attention_variant(q, k, v, pos, pos, 100.0, softmax=softmax, heads_per_program=G,
                              tables_q=tables, tables_k=tables, core=core)
    torch.cuda.synchronize()
    launches = read_launches()
    expected = dict.fromkeys(launches, 0)
    expected.update(fused_attention=3, fused_attention_grouped=3, fused_attention_core=2,
                    fused_attention_grouped_mma=2, attention_variant=3,
                    attention_variant_core=3)
    log(f"[variants] entry point at {(B, Hh, N, d)}: launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"variants launches {launches} != {expected}")

    rows = {}
    for label, G, softmax, core in configs:
        r = measure(q, k, v, pos, pos, G, softmax, core=core)
        log(f"[variants] {label} {(B, Hh, N, d)} qkv views: kernel graph {r['ms']:.4f} ms "
            f"({r['wrapper_ms']:.4f}), the mma.sync core G=1 contiguous (row-1 baseline) "
            f"{r['baseline_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa (q, k rotated "
            f"beforehand) {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); max_abs_err {r['max_abs_err']:.3e} rel {r['rel']:.3e} "
            f"(limit {RTOL:g})"
            + ("" if r["from_baseline"] is None else
               f"; max |out - row-1 baseline| {r['from_baseline']:.3e}")
            + ("" if r["identical"] is None else
               f"; bits equal its kernel's G=1: {r['identical']}")
            + ("" if r["equals_mma"] is None else
               f"; bits equal the mma.sync core's: {r['equals_mma']}"))
        if not r["rel"] <= RTOL or r["identical"] is False:
            raise AssertionError(f"variants {label}: the kernel disagrees ({r})")
        rows[label] = dict(r, count=1)
    return rows, launches


def experiments_phase(torch):
    """The other TPU experiments' entry points: the tap-sum conv (rows 10,
    11, on the sm90 kernel and its mma.sync baseline) at TAP_CASES, the DPT
    tail's epilogue (row 13) at POST_CASE and row
    3's floors at the encoder shape (8,16,768,64) at FLOOR_CASES (every
    floor on the sm90 kernel and on attention_floor.cu), each
    called once with the launch counts from 0 (the counts of this path),
    then each against its plain version with times, bound and library call
    (tools/conv_variants.measure_conv, which also holds the sm90 kernel's Z
    to the baseline's, and measure_post; tools/attn_variants.
    measure: G = 4 bit for bit against G = 1, beside the exact kernel of
    the same core, a copy floor on the sm90 kernel against the baseline's
    bits, `check_floor`), and qkonly at 64 keys beside 768 on both kernels (its
    time must grow with the keys). Returns the measured rows by kernel and
    the launch counts."""
    from dust3r_tpu_torch.ops.attention_floors import attention_floor
    from dust3r_tpu_torch.ops.conv3x3_taps import CORES, VARIANTS, conv3x3_taps_kernel
    from dust3r_tpu_torch.ops.dpt_post import dpt_post_kernel
    from dust3r_tpu_torch.ops.rope import rope_tables
    from dust3r_tpu_torch.tools import attn_variants as av
    from dust3r_tpu_torch.tools import conv_variants as cv

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    convs = {name: cv.conv_inputs(BATCH_SIZE, h, w, cin, cout, gen)
             for name, cin, cout, h, w in TAP_CASES}
    post = cv.post_inputs(*POST_CASE[:3], gen)
    B, Hh, N, d = 8, 16, 768, 64
    q, k, v = av.make_qkv(B, Hh, N, N, d, "contiguous", gen)
    pos = av.positions(B, (H384 // 16, W // 16), "grid", gen)
    tables = rope_tables(pos, d)

    reset_launches()
    taps_out = {}
    for name, (x, wt) in convs.items():
        for variant in VARIANTS:
            for core in CORES:
                taps_out[name, variant, core] = conv3x3_taps_kernel(x, wt, variant, core)
    dpt_post_kernel(*post, 1.0)
    for mode, G, core in FLOOR_CASES:
        attention_floor(q, k, v, pos, pos, 100.0, mode=mode, heads_per_program=G,
                        tables_q=tables, tables_k=tables, core=core)
    torch.cuda.synchronize()
    launches = read_launches()
    expected = dict.fromkeys(launches, 0)
    sm90_floors = sum(core is None for _, _, core in FLOOR_CASES)
    expected.update(conv3x3_taps_slices=len(TAP_CASES), conv3x3_taps_copies=len(TAP_CASES),
                    conv3x3_taps_mma=2 * len(TAP_CASES), dpt_post=1,
                    attention_floor=sm90_floors, attention_floor_mma=len(FLOOR_CASES) - sm90_floors)
    log(f"[experiments] entry points: launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"experiments launches {launches} != {expected}")

    rows = dict(conv3x3_taps_slices=[], conv3x3_taps_copies=[], conv3x3_taps_mma=[],
                dpt_post=[], attention_floor=[], attention_floor_mma=[])
    for name, cin, cout, h, w in TAP_CASES:
        x, wt = convs.pop(name)
        for core in CORES:
            same = torch.equal(taps_out.pop((name, "slices", core)),
                               taps_out.pop((name, "copies", core)))
            log(f"[experiments] conv3x3_taps {core} {name}: slices bits equal copies': {same}")
            if not same:
                raise AssertionError(f"conv3x3_taps {core} {name}: slices and copies differ")
        for variant in VARIANTS:
            r = cv.measure_conv(x, wt, variant, row2=False)
            log("[experiments] " + cv.conv_line(name, (BATCH_SIZE, cin, h, w), variant, r))
            cv.check_conv(name, variant, r)
            # the kernel alone by graph replay, against its own bound and
            # the library call's graph replay
            kept = dict(plain_ms=r["plain_ms"], library_ms=r["library_graph_ms"],
                        bound_ms=r["kernel_bound_ms"], bound_by=r["kernel_bound_by"], count=1)
            rows[f"conv3x3_taps_{variant}"].append(
                dict(kept, ms=r["kernel_ms"], max_abs_err=r["max_abs_err"]))
            rows["conv3x3_taps_mma"].append(
                dict(kept, ms=r["mma_kernel_ms"], max_abs_err=r["mma_max_abs_err"]))
        del x, wt
    r = cv.measure_post(*post, tail=False)
    log("[experiments] " + cv.post_line(POST_CASE, r))
    if not r["rel"] <= cv.POST_RTOL:
        raise AssertionError(f"dpt_post: the kernel disagrees with its plain version: "
                             f"{r['errs']}")
    rows["dpt_post"].append(dict(r, count=1))
    del post
    for mode, G, core in FLOOR_CASES:
        r = av.measure(q, k, v, pos, pos, G, mode, core=core)
        kernel = core or "sm90"
        log(f"[experiments] floor {mode} {kernel} G={G} {(B, Hh, N, d)}: kernel "
            f"{r['ms']:.4f} ms ({r['wrapper_ms']:.4f} ms a call through the wrapper's "
            f"launches), the {kernel} exact kernel G=1 {r['baseline_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, "
            f"{av.library_label(mode, r['library_ms'])}, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); max_abs_err {r['max_abs_err']:.3e} rel {r['rel']:.3e} "
            f"(limit {av.RTOL:g})"
            + ("" if r["identical"] is None else f"; bits equal G=1's: {r['identical']}")
            + av.floor_line(r))
        av.check_floor(f"floor {mode} {kernel} G={G}", mode, r)
        rows["attention_floor" if core is None else "attention_floor_mma"].append(
            dict(r, count=1))
    for core in (None, "mma"):
        growth = av.qkonly_growth(log=lambda m: log("[experiments] " + m), core=core)
        if not growth[768] > 2 * growth[64]:
            raise AssertionError(f"qkonly ({core or 'sm90'}) takes {growth[768]:.4f} ms at "
                                 f"768 keys and {growth[64]:.4f} at 64: its later key tiles' "
                                 f"work is gone")
    return rows, launches


def conv_kernel_phase(torch):
    """conv3x3 against conv3x3_bf16_ref (its plain version) at each 3x3 conv
    shape of a DPT head at 512x384, batch 8; also timed against the fp32
    cuDNN conv it replaces on the path and against `F.conv2d` on bf16
    channels_last x and w (the library call of the same function). Returns
    the rows and their sums over one head's 19 conv3x3 calls."""
    import torch.nn.functional as F

    from dust3r_tpu_torch.ops.conv3x3 import (conv3x3_bf16_ref, conv3x3_kernel, conv3x3_ref,
                                              pack_weight, plan)
    from dust3r_tpu_torch.tools.card import bound, graph_ms, time_ms

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for name, cin, cout, h, w, bias, count in CONV_CASES:
        x = torch.randn(BATCH_SIZE, cin, h, w, device="cuda", generator=gen).contiguous(
            memory_format=torch.channels_last)
        wt = torch.randn(cout, cin, 3, 3, device="cuda", generator=gen) * (9 * cin) ** -0.5
        b = torch.randn(cout, device="cuda", generator=gen) if bias else None
        wp = pack_weight(wt)  # once, as the model's Conv3x3 modules keep it

        def kernel():
            return conv3x3_kernel(x, wt, b, packed=wp)

        out = kernel()
        torch.cuda.synchronize()
        ref = conv3x3_bf16_ref(x, wt, b)
        ref32 = conv3x3_ref(x, wt, b)
        if not (out.shape == ref.shape and torch.isfinite(out).all()):
            raise AssertionError(f"conv3x3 {name}: bad kernel output {tuple(out.shape)}")
        err, rel = _rel_err(out, ref)
        rel32 = _rel_err(out, ref32)[1]
        del ref, ref32
        xb = x.to(torch.bfloat16)
        wb = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        bb = None if b is None else b.to(torch.bfloat16)
        def library():
            return F.conv2d(xb, wb, bb, padding=1)

        t = dict(ms=time_ms(kernel), graph_ms=graph_ms(kernel),
                 plain_ms=time_ms(lambda: conv3x3_bf16_ref(x, wt, b)),
                 fp32_ms=time_ms(lambda: conv3x3_ref(x, wt, b)),
                 library_ms=time_ms(library), library_graph_ms=graph_ms(library))
        M = BATCH_SIZE * h * w
        flops = 2 * M * cout * 9 * cin
        bound_ms, bound_by = bound(4 * (M * cin + 9 * cin * cout + cout + M * cout),
                                   dict(bf16=flops))
        bn, tiles, splits = plan(BATCH_SIZE, h, w, cin, cout, sms)
        log(f"[kernel] conv3x3 {name} x{(BATCH_SIZE, cin, h, w)} -> {cout} "
            f"bias={bias} x{count}/head ({tiles} tiles of 128 x {bn}, {splits} splits): "
            f"max_abs_err {err:.3e} rel {rel:.3e} (limit {CONV_RTOL:g}; vs fp32 conv rel "
            f"{rel32:.3e}); kernel {t['ms']:.4f} ms, graph {t['graph_ms']:.4f} ms "
            f"({flops / t['graph_ms'] / 1e9:.1f} TFLOP/s), bf16 plain {t['plain_ms']:.4f} ms, "
            f"fp32 cuDNN {t['fp32_ms']:.4f} ms, bf16 F.conv2d {t['library_ms']:.4f} ms, graph "
            f"{t['library_graph_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        if not rel <= CONV_RTOL:
            raise AssertionError(f"conv3x3 {name}: kernel disagrees with its plain "
                                 f"version, rel err {rel:.3e} > {CONV_RTOL:g}")
        rows.append(dict(name=name, count=count, max_abs_err=err, bound_ms=bound_ms,
                         bound_by=bound_by, **t))
    total = summed(rows)
    extra = {k: sum(r["count"] * r[k] for r in rows)
             for k in ("fp32_ms", "graph_ms", "library_graph_ms")}
    log(f"[kernel] conv3x3, one DPT head's {sum(r['count'] for r in rows)} conv3x3 calls at "
        f"batch 8: kernel {total['ms']:.4f} ms, graph {extra['graph_ms']:.4f} ms, bf16 plain "
        f"{total['plain_ms']:.4f} ms, fp32 cuDNN {extra['fp32_ms']:.4f} ms, bf16 F.conv2d "
        f"{total['library_ms']:.4f} ms, graph {extra['library_graph_ms']:.4f} ms, bound "
        f"{total['bound_ms']:.4f} ms ({total['bound_by']})")
    total.update(extra)
    return rows, total


def up2x_kernel_phase(torch):
    """up2x against up2x_ref (its plain version) at each upsample of a DPT
    head, batch 8, at 512x384 and at the 512x336 bucket's ragged grids; the
    library call is `F.interpolate(..., "bilinear", align_corners=True)` on
    the same fp32 channels_last x. Times by CUDA-graph replay (the smaller
    calls last well under 0.1 ms, where a loop of wrapper calls reads the
    launch rate) and, in brackets, by CUDA events over a loop of calls.
    Returns the rows and their sums over one head's 5 calls at 512x384."""
    import torch.nn.functional as F

    from dust3r_tpu_torch.ops.upsample import up2x_kernel, up2x_ref
    from dust3r_tpu_torch.tools.card import bound, graph_ms, time_ms

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for name, c, h, w, count in UP2X_CASES:
        x = torch.randn(BATCH_SIZE, c, h, w, device="cuda", generator=gen).contiguous(
            memory_format=torch.channels_last)
        out = up2x_kernel(x)
        torch.cuda.synchronize()
        ref = up2x_ref(x)
        if not (out.shape == ref.shape and torch.isfinite(out).all()
                and out.is_contiguous(memory_format=torch.channels_last)):
            raise AssertionError(f"up2x {name}: bad kernel output {tuple(out.shape)}")
        err, rel = _rel_err(out, ref)
        del ref, out

        def library():
            return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)

        t = dict(ms=graph_ms(lambda: up2x_kernel(x)), time_ms=time_ms(lambda: up2x_kernel(x)),
                 plain_ms=graph_ms(lambda: up2x_ref(x)),
                 plain_time_ms=time_ms(lambda: up2x_ref(x)),
                 library_ms=graph_ms(library), library_time_ms=time_ms(library))
        # x read once, 4x its bytes written; 4 multiplies and 2 adds a value
        bound_ms, bound_by = bound(5 * 4 * x.numel(), dict(fp32=6 * 4 * x.numel()))
        log(f"[kernel] up2x {name} x{(BATCH_SIZE, c, h, w)} x{count}/head: max_abs_err "
            f"{err:.3e} rel {rel:.3e} (limit {UP2X_RTOL:g}); kernel graph {t['ms']:.4f} ms "
            f"({t['time_ms']:.4f}; {5 * 4 * x.numel() / t['ms'] / 1e6:.1f} GB/s, "
            f"{100 * bound_ms / t['ms']:.1f} % of the bound), plain {t['plain_ms']:.4f} ms "
            f"({t['plain_time_ms']:.4f}), F.interpolate {t['library_ms']:.4f} ms "
            f"({t['library_time_ms']:.4f}), bound {bound_ms:.4f} ms ({bound_by})")
        if not rel <= UP2X_RTOL:
            raise AssertionError(f"up2x {name}: kernel disagrees with its plain version, "
                                 f"rel err {rel:.3e} > {UP2X_RTOL:g}")
        rows.append(dict(name=name, count=count, max_abs_err=err, bound_ms=bound_ms,
                         bound_by=bound_by, **t))
    total = summed(rows)
    extra = {k: sum(r["count"] * r[k] for r in rows)
             for k in ("time_ms", "plain_time_ms", "library_time_ms")}
    log(f"[kernel] up2x, one DPT head's 5 calls at batch 8: kernel graph {total['ms']:.4f} ms "
        f"({extra['time_ms']:.4f}; {100 * total['bound_ms'] / total['ms']:.1f} % of the "
        f"bound), plain {total['plain_ms']:.4f} ms ({extra['plain_time_ms']:.4f}), "
        f"F.interpolate {total['library_ms']:.4f} ms ({extra['library_time_ms']:.4f}), bound "
        f"{total['bound_ms']:.4f} ms ({total['bound_by']})")
    return rows, total


def tail_kernel_phase(torch):
    """dpt_tail against dpt_tail_bf16_ref (its plain version) at the head's
    tail, batch 8, 512x384 and 512x336, the kernel reading W2 packed once
    (as the model's adapter keeps it). No one PyTorch call computes the
    tail; beside it is timed the chain it replaces on the path (conv3x3
    kernel at 128 -> 32, ReLU, fp32 cuDNN 1x1, postprocess). Times by
    CUDA-graph replay and, in brackets, by CUDA events over a loop of
    calls."""
    import torch.nn.functional as F

    from dust3r_tpu_torch.models.heads import postprocess
    from dust3r_tpu_torch.ops.conv3x3 import conv3x3_kernel
    from dust3r_tpu_torch.ops.dpt_tail import dpt_tail_bf16_ref, dpt_tail_kernel, pack_w2
    from dust3r_tpu_torch.tools.card import bound, graph_ms, time_ms

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    modes = (("exp", -float("inf"), float("inf")), ("exp", 1.0, float("inf")))
    rows = []
    for name, h, w, count in TAIL_CASES:
        y = (0.3 * torch.randn(BATCH_SIZE, 128, h, w, device="cuda", generator=gen)
             ).contiguous(memory_format=torch.channels_last)
        w2 = torch.randn(32, 128, 3, 3, device="cuda", generator=gen) * (9 * 128) ** -0.5
        b2 = 0.1 * torch.randn(32, device="cuda", generator=gen)
        w3 = 0.2 * torch.randn(4, 32, 1, 1, device="cuda", generator=gen)
        b3 = 0.1 * torch.randn(4, device="cuda", generator=gen)
        args = (y, w2, b2, w3, b3, modes[1][1])
        w2p = pack_w2(w2)
        pts, conf = dpt_tail_kernel(*args, packed=w2p)
        torch.cuda.synchronize()
        want = dpt_tail_bf16_ref(*args)
        errs = []
        for key, got, ref in (("pts3d", pts, want[0]), ("conf", conf, want[1])):
            if not (got.shape == ref.shape and got.is_contiguous()
                    and torch.isfinite(got).all()):
                raise AssertionError(f"dpt_tail {name}: bad {key} {tuple(got.shape)}")
            errs.append((key, *_rel_err(got, ref)))
        del want, pts, conf

        def kernel():
            return dpt_tail_kernel(*args, packed=w2p)

        def plain():
            return dpt_tail_bf16_ref(*args)

        def unfused():
            h32 = F.relu(conv3x3_kernel(y, w2, b2))
            return postprocess(F.conv2d(h32, w3, b3).permute(0, 2, 3, 1), *modes)

        t = dict(ms=graph_ms(kernel), time_ms=time_ms(kernel), plain_ms=graph_ms(plain),
                 plain_time_ms=time_ms(plain), unfused_ms=graph_ms(unfused),
                 unfused_time_ms=time_ms(unfused))
        # y read once, pts and conf written once; conv2 on bf16 tensor cores,
        # conv3 and ~20 operations a pixel of postprocess in fp32
        M = BATCH_SIZE * h * w
        nbytes = 4 * (M * 128 + 32 * 128 * 9 + 32 + 4 * 32 + 4 + M * 3 + M)
        bound_ms, bound_by = bound(nbytes, dict(bf16=2 * M * 32 * 9 * 128,
                                                fp32=M * (2 * 32 * 4 + 20)))
        log(f"[kernel] dpt_tail {name} y{(BATCH_SIZE, 128, h, w)} x{count}/head: "
            + ", ".join(f"{k} max_abs_err {e:.3e} rel {r:.3e}" for k, e, r in errs)
            + f" (limit {TAIL_RTOL:g}); kernel graph {t['ms']:.4f} ms ({t['time_ms']:.4f}; "
            f"{nbytes / t['ms'] / 1e6:.1f} GB/s, {100 * bound_ms / t['ms']:.1f} % of the "
            f"bound), bf16 plain {t['plain_ms']:.4f} ms ({t['plain_time_ms']:.4f}), the "
            f"unfused chain (conv3x3 kernel, ReLU, cuDNN 1x1, postprocess) "
            f"{t['unfused_ms']:.4f} ms ({t['unfused_time_ms']:.4f}), bound {bound_ms:.4f} ms "
            f"({bound_by})")
        if not all(r <= TAIL_RTOL for _, _, r in errs):
            raise AssertionError(f"dpt_tail {name}: kernel disagrees with its plain "
                                 f"version: {errs}")
        rows.append(dict(name=name, count=count, max_abs_err=max(e for _, e, _ in errs),
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=None, **t))
    return rows, summed(rows)


def kernel_counters():
    """Each kernel's wrapper and the attribute that counts its launches:
    fused_attention's sm90 kernel and, of those, its launches with more than
    one head a block; its mma.sync core (`core_launches`) and the core's
    launches with more than one head a block; attention_variant's sm90
    kernel and its mma.sync core (`core_launches`); attention_floor's sm90
    floors and those of `csrc/attention_floor.cu` (`core_launches`)."""
    from dust3r_tpu_torch.ops.attention_floors import attention_floor
    from dust3r_tpu_torch.ops.attention_variants import attention_variant
    from dust3r_tpu_torch.ops.conv3x3 import conv3x3_kernel
    from dust3r_tpu_torch.ops.conv3x3_taps import tap_sums
    from dust3r_tpu_torch.ops.dpt_post import dpt_post_kernel
    from dust3r_tpu_torch.ops.dpt_tail import dpt_tail_kernel
    from dust3r_tpu_torch.ops.fused_attention import fused_attention
    from dust3r_tpu_torch.ops.upsample import up2x_kernel

    return dict(fused_attention=(fused_attention, "launches"),
                fused_attention_core=(fused_attention, "core_launches"),
                fused_attention_grouped=(fused_attention, "grouped_launches"),
                fused_attention_grouped_mma=(fused_attention, "core_grouped_launches"),
                attention_variant=(attention_variant, "launches"),
                attention_variant_core=(attention_variant, "core_launches"),
                conv3x3=(conv3x3_kernel, "launches"), up2x=(up2x_kernel, "launches"),
                dpt_tail=(dpt_tail_kernel, "launches"),
                conv3x3_taps_slices=(tap_sums, "slices_launches"),
                conv3x3_taps_copies=(tap_sums, "copies_launches"),
                conv3x3_taps_mma=(tap_sums, "mma_launches"),
                dpt_post=(dpt_post_kernel, "launches"),
                attention_floor=(attention_floor, "launches"),
                attention_floor_mma=(attention_floor, "core_launches"))


def reset_launches():
    for fn, attr in kernel_counters().values():
        setattr(fn, attr, 0)


def read_launches():
    return {name: getattr(fn, attr) for name, (fn, attr) in kernel_counters().items()}


def expected_launches(model, encoder_batches, pair_batches):
    """Each kernel's launches for the engine's batches: attention in every
    encoder layer of an encoder batch and 4 calls (self and cross, two
    streams) in every decoder layer of a pair batch, all on the sm90
    kernel (none on the mma.sync core); conv3x3 once a call, split or not;
    the DPT kernels PER_HEAD times in each of a pair batch's two
    heads; the softmax variants and the other experiments' kernels never
    (the model does not call them)."""
    expected = dict.fromkeys(kernel_counters(), 0)
    expected.update(fused_attention=model.enc_depth * encoder_batches
                    + 4 * model.dec_depth * pair_batches)
    expected.update({k: 2 * n * pair_batches for k, n in PER_HEAD.items()})
    return expected


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
    from dust3r_tpu_torch.models.heads import Conv3x3, Upsample2x
    from dust3r_tpu_torch.utils.image import views_from_arrays

    t0 = time.perf_counter()
    model = dust3r_512_dpt(dtype=torch.bfloat16, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[slice] dust3r_512_dpt: {n_params} fp32 params, enc {model.enc_depth} / "
        f"dec {model.dec_depth} layers, bf16 body, fp32 heads; built in "
        f"{time.perf_counter() - t0:.2f} s")
    head = model.downstream_head1
    modules = dict(conv3x3=sum(isinstance(m, Conv3x3) for m in head.modules()) - 1,
                   up2x=sum(isinstance(m, Upsample2x) for m in head.modules()), dpt_tail=1)
    if modules != PER_HEAD:  # head.2 is a Conv3x3 the tail kernel reads
        raise AssertionError(f"a DPT head holds {modules} kernel calls, not {PER_HEAD}")
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
    reset_launches()
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
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    for name, out, pairs in (("a", out_a, req_a), ("b", out_b, req_b), ("c", out_c, req_a)):
        _check_request(f"request {name}", out, len(pairs), shapes(pairs))
    expected = expected_launches(model, engine.encoder_batches, engine.pair_batches)
    log(f"[slice] request a: {len(req_a)} pairs 512x384 in {t_a:.3f} s (cold); "
        f"request b: {len(req_b)} pairs, buckets {sorted(set(shapes(req_b)))}, "
        f"in {t_b:.3f} s; request c (= a, warm): {t_c:.3f} s, "
        f"{len(req_a) / t_c:.3f} pairs/s")
    log(f"[slice] engine: {engine.encoder_batches} encoder batches, "
        f"{engine.pair_batches} pair batches; per DPT head {PER_HEAD}; launches "
        f"{launches} (expected {expected}); peak device memory {peak} bytes "
        f"({peak / 2**30:.3f} GiB)")
    if launches != expected:
        raise AssertionError(f"launches {launches} != {expected}: some call of the main "
                             f"path bypassed its kernel")
    drift = float(np.abs(out_a["pred1"]["pts3d"] - out_c["pred1"]["pts3d"]).max()
                  / np.abs(out_a["pred1"]["pts3d"]).max())
    if not drift <= 1e-3:
        raise AssertionError(f"request c differs from request a by {drift:.3e}")

    # bf16 kernel forward vs fp32 plain forward (plain attention, fp32
    # cuDNN convs, the plain fp32 upsample and tail), same weights
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
    reset_launches()
    t0 = time.perf_counter()
    out = engine.infer_pairs(pairs, to_cpu=False)
    torch.cuda.synchronize()
    launches = read_launches()
    expected = expected_launches(model, engine.encoder_batches - batches[0],
                                 engine.pair_batches - batches[1])
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
    variant_rows, variant_launches = variants_phase(torch)
    experiment_rows, experiment_launches = experiments_phase(torch)
    _, conv_total = conv_kernel_phase(torch)
    _, up_total = up2x_kernel_phase(torch)
    _, tail_total = tail_kernel_phase(torch)
    if "--kernels-only" in argv:
        return 0
    launches, engine, pairs = slice_phase(torch)
    scene_phase(torch, engine, pairs)
    # attention: the encoder's self-attention shape, read from the qkv
    # projection, on the sm90 kernel; its mma.sync core (the baseline) at
    # the same call; its grouped form: the variants phase's G = 2, 4 and 8
    # calls on the sm90 kernel, summed, and its G = 2 and 4 calls on the
    # core, summed; attention_variant: its three softmax variants' calls on
    # the sm90 kernel, summed, and attention_variant_mma the three on the
    # mma.sync core, summed; conv3x3 and up2x: one DPT head's calls at batch 8, summed;
    # dpt_tail: the head's one call; the floors: the sm90 kernel's and
    # attention_floor.cu's calls of the experiments phase, each summed; the
    # tap-sum conv: each variant's kernel alone at TAP_CASES on the sm90
    # kernel, summed, and conv3x3_taps_mma both variants' on the mma.sync
    # baseline, summed, against the kernel-alone bound. Device times:
    # CUDA-graph replays where the phase took them (the attention kernels,
    # the floors, conv3x3, up2x, dpt_tail, the tap-sum conv), else CUDA
    # events over a loop of calls. Launches: the slice's run (requests
    # (a)-(c)); the variants phase's for the variants; the conv variants,
    # the epilogue and the floors: the experiments phase's
    launches.update({k: variant_launches[k]
                     for k in ("fused_attention_grouped", "fused_attention_grouped_mma",
                               "attention_variant", "attention_variant_core")})
    launches.update({k: experiment_launches[k] for k in experiment_rows})
    enc = attn_rows[0]
    rows = dict(
        fused_attention=dict(enc, ms=enc["graph_ms"], library_ms=enc["library_graph_ms"],
                             max_abs_err=max(r["max_abs_err"] for r in attn_rows)),
        fused_attention_mma=dict(enc, ms=enc["baseline_graph_ms"],
                                 library_ms=enc["library_graph_ms"],
                                 max_abs_err=max(r["baseline_err"] for r in attn_rows)),
        fused_attention_grouped=summed([variant_rows[k] for k in ("G=2", "G=4", "G=8")]),
        fused_attention_grouped_mma=summed([variant_rows[k] for k in ("G=2 mma", "G=4 mma")]),
        attention_variant=summed([variant_rows[k] for k in
                                  ("nomax G=2", "bf16_logits", "bf16_exp")]),
        attention_variant_mma=summed([variant_rows[f"{k} mma"] for k in
                                      ("nomax", "bf16_logits", "bf16_exp")]),
        conv3x3=dict(conv_total, ms=conv_total["graph_ms"],
                     library_ms=conv_total["library_graph_ms"]),
        up2x=up_total, dpt_tail=tail_total,
        **{k: summed(v) for k, v in experiment_rows.items()})
    for name in ("attention_floor", "attention_floor_mma"):
        rows[name]["library_ms"] = None  # no one call computes every floor
    where = dict(
        fused_attention=("fused_attention_sm90.cu", "dust3r_tpu/ops/pallas_attention.py:142, "
                         "scripts/exp_attn_dma_r2.py:103, scripts/exp_attn_layout_r2.py:89"),
        fused_attention_mma=("fused_attention.cu", "dust3r_tpu/ops/pallas_attention.py:142, "
                             "scripts/bench_attn3.py:19"),
        fused_attention_grouped=("fused_attention_sm90.cu", "scripts/exp_attn_r2.py:144, "
                                 "scripts/exp_attn_vmem_r2.py:104"),
        fused_attention_grouped_mma=("fused_attention.cu", "scripts/exp_attn_r2.py:144, "
                                     "scripts/exp_attn_vmem_r2.py:104"),
        attention_variant=("fused_attention_sm90.cu", "scripts/exp_attn_variants.py:83, "
                           "scripts/exp_softmax_r2.py:65"),
        attention_variant_mma=("fused_attention.cu", "scripts/exp_attn_variants.py:83, "
                               "scripts/exp_softmax_r2.py:65"),
        conv3x3=("conv3x3.cu", "dust3r_tpu/ops/conv3x3.py:74"),
        up2x=("up2x.cu", "scripts/exp_up_pallas_r2.py:79"),
        dpt_tail=("dpt_tail.cu", "scripts/exp_tailk_r2.py:78, scripts/exp_tailk2_r2.py:113"),
        conv3x3_taps_slices=("conv3x3_taps.cu", "scripts/exp_convk_r3.py:67"),
        conv3x3_taps_copies=("conv3x3_taps.cu", "scripts/exp_convk2_r3.py:67"),
        conv3x3_taps_mma=("conv3x3_taps_mma.cu", "scripts/exp_convk_r3.py:67, "
                          "scripts/exp_convk2_r3.py:67"),
        dpt_post=("dpt_post.cu", "scripts/exp_tailk2_r2.py:52"),
        attention_floor=("fused_attention_sm90.cu", "scripts/exp_attn_r2.py:144"),
        attention_floor_mma=("attention_floor.cu", "scripts/exp_attn_r2.py:144"))
    launches["fused_attention_mma"] = launches.pop("fused_attention_core")
    launches["attention_variant_mma"] = launches.pop("attention_variant_core")
    kernels = [dict(name=name, route="cuda", source=f"dust3r_tpu_torch/csrc/{src}",
                    replaces=replaces, launches=launches[name],
                    **{k: rows[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                  "bound_by", "library_ms")})
               for name, (src, replaces) in where.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
