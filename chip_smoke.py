#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port once on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as a check of the port
    python3 chip_smoke.py --kernels-only  # build and check the kernels, then stop

Phases (each prints its lines; a failed phase raises and the exit code is 1):
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the ten kernel sources from `dust3r_tpu_torch/csrc/`
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
  3d. serving kernels: the bf16 modes of conv3x3, up2x and dpt_tail (bf16
     x or y, fp32 sums, bf16 y out; the tail's outputs fp32) at phase 3's
     shapes, and the int8 mode's quantize and dequant kernels
     (`csrc/quant_int8.cu`) at the 512_dpt projections' shapes (6144
     tokens, K, N in {768, 1024, 2304, 3072, 4096}), each against its plain
     version (one bf16 unit of max |y| for a bf16 output, TAIL_RTOL for
     the tail's, the quantize bit for bit), timed by CUDA-graph replay
     beside the plain version, the library call (bf16 channels_last
     `F.conv2d`, bf16 `F.interpolate`, the tail's bf16 chain) and the bound
     (int8 operations at 1979 TOPS); each projection's chain (quantize,
     `torch._int_mm`, dequant) beside bf16 `F.linear` and `_int_mm` alone;
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
  6. demo: from checkpoint files to scene files at full width. The slice's
     model (its dec_blocks copied into dec_blocks2; its heads' last 1x1 conv
     fitted by least squares so that the demo's images give a plane seen by
     a camera: `fit_heads_to_a_plane`) is written as a released `.pth` lays
     it out ({args, model}: one decoder, the DPT heads' dead
     refinenet4.resConfUnit1, a mask_token; ~1.8 GB) and loaded with
     `load_model`, then as a hub snapshot (model.safetensors + config.json)
     loaded with `from_pretrained`: every tensor and one pair batch's
     pointmaps and confidences must equal the source's bit for bit. Then the
     demo's `get_reconstructed_scene` on the loaded model's engine at 4
     synthetic 640x480 PNG files (512x384 views: colour ramps, a sky band on
     top; `complete`, 100 linear iterations, point cloud, mask_sky, clean_depth),
     at 2 (PairViewer) and at 1 (duplicated): the PLY must parse, hold the
     masked points plus the frusta, all finite; mask_sky must zero some
     confidence in every image; the gallery 3 entries an image; each
     kernel's launches exactly what the run's batches imply. Prints the
     seconds to write and load each file, of each demo stage, peak device
     memory, and the phase's total.
  7. visloc: three synthetic COLMAP scenes (`tools/visloc_scenes.py`):
     Cambridge-like 1920x1080 SIMPLE_RADIAL queries and maps (the 512x288
     grid), InLoc-like 1200x1600 portrait queries against 1600x1200 maps
     (384x512 beside 512x384 in one pair), and an exact plane; each a
     textured height field, its map dense at the bucket's grid. (a) An
     oracle of exact pointmaps drives the port's loop
     (`visloc.cli.localize_dataset`: matching, undistortion, `to_orig`,
     the numpy RANSAC-PnP at up to 100k points): every query within 0.01
     units and 0.2 degrees. (b) The slice's model on the card through the
     same loop, the first query of each scene (confidence threshold 1: the
     seeded weights give conf < 3 everywhere): each map view's launches
     exactly 96 / 38 / 10 / 2 (one pair at batch 1: two encoder batches),
     its pointmaps within the 1e-2 RMSE of the fp32 plain forward per grid;
     poses printed, not gated. (c) The PnP's worst case on the host:
     100k correspondences, 1 % inliers. Prints the host seconds of
     inference, matching and PnP, matches, inliers, RANSAC iterations and
     peak memory per query, then its JSON line {"visloc": ...}.
  8. train: training at full width through `python -m dust3r_tpu_torch.train`'s
     `train(args)`. (a) Each kernel's backward alone at the training path's
     shapes against the autograd of its plain version (attention from its
     strided views at the encoder, decoder and 768|672 cross shapes;
     conv3x3 at the head's 3x3 shapes; up2x at its upsamples; dpt_tail at
     (8, 128, 384, 512)), its ms beside its forward kernel's. (b) Co3d-layout
     scenes written by `tools/train_scenes.py` (two 640x480 sequences, one
     480x640). (c) One micro-batch's gradients through the kernels and
     through the plain route (plain attention, fp32 cuDNN convs, the plain
     upsample and tail) in bf16, per top-level module (relative L2 <=
     2e-2, cosine >= 0.999; every gradient finite, none all zero where the
     plain route's is not), and against an fp32 plain run for information.
     (d) The released 512_dpt (ManyAR patch embed, seeded weights) on
     Co3d at its five 512 buckets with ColorJitter, ConfLoss(Regr3D(L21)),
     --amp 1, batch 4 x accum 2, 3 steps: each step's loss, grad norm, LR,
     wall seconds, peak memory and forward launches (exactly 72 attention
     calls a micro-batch, 19 conv3x3 / 5 up2x / 1 dpt_tail a head pass, 2
     head passes, 4 with ManyAR flags); every gradient of the first
     backward finite and non-zero. (d2) After (f), with nothing of that run
     left on the card: the same model and run on the published mix of the
     nine datasets (Habitat, BlendedMVS, MegaDepth, ARKitScenes, Co3d,
     StaticThings3D, ScanNetpp at docs/TRAINING.md's arguments, Waymo and
     WildRGBD beside them) on `tools/train_scenes.py`'s layouts at their
     preprocess sizes (EXR depths among them), evaluated on the published
     test mix (Habitat, BlendedMVS, MegaDepth at 512x336, Co3d, a few
     pairs each; Regr3D_ScaleShiftInv) with spawned loader workers: each
     step's forward launches and the test pass's exact, every loss, grad
     norm and test loss finite, all nine datasets among the trained views,
     every view with valid pixels; each dataset's host ms to make one pair
     printed. (d3) The nine datasets' download layouts (`tools/raw_scenes.py`
     at their sources' sizes: Co3d 1920x1080, BlendedMVS 768x576, MegaDepth
     1600x1200, StaticThings3D 960x540, ARKitScenes 640x480 with 256x192
     depth, Waymo's stage-1 output at 1920x1280, ScanNet++ 1752x1168
     fisheye and a 1920x1440 iPhone frame, Habitat 1024x2048 envmaps)
     through the port's preprocess scripts (no JAX, no cv2; Waymo's stage 1,
     the ScanNet++ mesh render and habitat-sim take the layout's stand-ins,
     named in the log), each dataset's host seconds and files printed; each
     published loader's views on the plane (median |z - PLANE_Z| / PLANE_Z
     <= 1e-2); two steps at batch 4 x accum 2 on the mix of those outputs,
     no checkpoint: launches exact, losses finite, step seconds and peak
     memory printed. (e) After the updates, the kept conv and
     tail packings give the bits of packings made anew. (f)
     checkpoint-final.pth -> load_model -> InferenceEngine gives the trained
     module's outputs bit for bit. (g) 10 steps on one repeated batch with a
     fresh AdamW: from the trained model on the kernel route and on the
     plain route at lr 1e-4, the plain route with its weights nudged by
     1e-7 of themselves, and the kernel route at 1e-5, printed with each
     step's distance from the plain route; from a freshly seeded model at
     lr 1e-4, the loss falls. (h) A second train(args) in the directory resumes
     at epoch 1. (i) One step of train.py's default model, 224_linear, at
     batch 8. Prints the phase's seconds.
  9. serving: the 512_dpt at full width in the serving configuration (bf16
     body, bf16 heads, `InferenceEngine(quantize="int8")`) serves requests
     (a)-(c) with every launch count from 0: each kernel's launches exact
     (the bf16 modes 19 / 5 / 1 a head, quantize and dequant once a
     projection: 96 an encoder batch, 194 a pair batch); request (a)'s first
     pair against the fp32 plain forward as tests/test_quant.py gates it
     (relative L2 of pts3d within max(4x the default configuration's, 2e-2),
     of conf within 2e-2), with the default, bf16-heads-only and int8-only
     configurations printed beside; request (c)'s pairs/s for the default
     and the serving configuration in turns (not gated); peak memory. Then
     `python -m dust3r_tpu_torch.demo --serving` headless at the demo's 4
     images on the demo phase's fitted model written as a `.pth`, and
     `python -m dust3r_tpu_torch.visloc --serving` on the plane scene, each
     through its `main`, its launches exact for its engine's batches.
  10. parallel: the data axis (`--mesh`) at full width, on one card: (a)
     request (c) on `InferenceEngine(mesh=[cuda:0, cuda:0])` (two replicas,
     each batch of 8 split in two shards run from a thread each): every
     kernel's launches exactly twice a one-device batch's, pointmaps within
     PARITY_RMSE of the slice phase's fp32 plain forward, the distance to
     the one-device engine's outputs and both pairs/s printed; (b) scene
     (i) on `global_aligner(mesh=[cuda:0, cuda:0])` (two shards of 15
     edges): recovered as in phase 5, its loss after 300 iterations beside
     the one-device run's; (c) two ranks of `train(args)` (`--mesh 2
     --dist_backend gloo`, both on cuda:0: NCCL refuses two ranks on one
     device), spawned by `parallel.distributed.launch`, one step each at
     batch 2 x accum 2 on Co3d-layout scenes at 512x384, against one
     process at batch 4 x accum 2 on the ranks' joined global batch: the
     all-reduced gradients per top-level module (rel L2 <= 2e-2, cosine >=
     0.999), the losses within 1e-2, the ranks' parameters equal (SHA-256),
     checkpoint-final.pth written by rank 0 alone, each rank's forward
     launches exact; each rank's step seconds, peak memory and the share of
     an all-reduce of the gradients' size printed; (d) `train(args)` at
     `--mesh 1` over NCCL in this process: one step, exact launches, the
     checkpoint; (e) with two cards, (a)-(c) across cuda:0 and cuda:1, (c)
     over NCCL; with one, a line that says they were not run.
The visloc phase's JSON line comes before the kernels' line. The
second-to-last line is a JSON object of the kernels, with the launches
of the slice's run (of the variants and experiments phases for theirs, of
the serving phase's requests for the bf16 modes and the int8 kernels); the
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
           "conv3x3_taps", "conv3x3_taps_mma", "dpt_post", "attention_floor", "quant_int8")
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
# the demo phase: the published arch string of the released 512_dpt file,
# its demo scenes (images, aligner iterations) and the source images' size
PUBLISHED_ARCH = ("AsymmetricCroCo3DStereo(pos_embed='RoPE100', "
                  "patch_embed_cls='ManyAR_PatchEmbed', img_size=(512, 512), head_type='dpt', "
                  "output_mode='pts3d', depth_mode=('exp', -inf, inf), "
                  "conf_mode=('exp', 1, inf), enc_embed_dim=1024, enc_depth=24, "
                  "enc_num_heads=16, dec_embed_dim=768, dec_depth=12, dec_num_heads=12, "
                  "landscape_only=False)")
DEMO_SCENES = (4, 2, 1)
DEMO_ITERS = 100
DEMO_PNG = (480, 640)
# the plane the heads' last 1x1 conv is fitted to: depth (model units) and
# focal (pixels) of a camera facing it
PLANE_DEPTH = 2.0
PLANE_FOCAL = 1.2 * W
# the visloc phase: each scene of `tools/visloc_scenes.SCENES` against its
# top-k map images; the oracle's limits (tests/test_visloc_colmap_e2e.py's);
# the model run's confidence threshold: the seeded weights give conf < 3 at
# every pixel, so the CLI's 3.0 would leave nothing to match; each map view
# is one pair at batch 1, as the root visloc.py runs it, so its two images are
# two encoder batches: 2 x 24 + 4 x 12 attention launches, 2 x 19 conv3x3,
# 2 x 5 up2x, 2 dpt_tail
VISLOC_TOPK = 2
VISLOC_TE, VISLOC_AE = 0.01, 0.2
VISLOC_MODEL_CONF = 1.0
VISLOC_MAX_POINTS = 100_000  # the CLI's --pnp_max_points
VISLOC_PER_MAP_VIEW = dict(fused_attention=96, conv3x3=38, up2x=10, dpt_tail=2)
# the train phase: the released 512_dpt's training data and run (Co3d at the
# five 512 buckets with ColorJitter, aug_crop 16, the background masked
# half of the time), cut to 3 steps of batch 4 x accum 2; 224_linear at 224
TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS, TRAIN_LR = 4, 2, 3, 1e-4
TRAIN_CRITERION = "ConfLoss(Regr3D(L21, norm_mode='avg_dis'), alpha=0.2)"
TRAIN_DATASET = ("{n} @ Co3d(split='train', ROOT='{root}', aug_crop=16, mask_bg='rand', "
                 "resolution=[(512, 384), (512, 336), (512, 288), (512, 256), (512, 160)], "
                 "transform=ColorJitter, seed=777)")
TRAIN_DATASET_224 = ("8 @ Co3d(split='train', ROOT='{root}', aug_crop=16, mask_bg='rand', "
                     "resolution=224, transform=ColorJitter, seed=777)")
# step (d2): the published 512 stage's mix (docs/TRAINING.md:41, :60: its seven
# datasets at their published arguments, then Waymo and WildRGBD, so that every
# loader is on the path) on `tools/train_scenes.py`'s layouts, cut to the 3
# steps' 24 pairs; the published test mix (:61) cut to a few pairs each
TRAIN_RESOLUTIONS = [(512, 384), (512, 336), (512, 288), (512, 256), (512, 160)]
MIX_COUNTS = dict(Habitat=3, BlendedMVS=3, MegaDepth=3, ARKitScenes=3, Co3d=3,
                  StaticThings3D=3, ScanNetpp=2, Waymo=2, WildRGBD=2)
MIX_FRAMES, MIX_TEST_PAIRS, MIX_LOADER_PAIRS = 6, 4, 3
TEST_CRITERION = "Regr3D_ScaleShiftInv(L21, gt_scale=True)"
# step (d3): the nine raw layouts of `tools/raw_scenes.py` at their sources'
# sizes, D3_FRAMES frames a sequence, through the port's preprocess scripts,
# then the published loaders: every view of every pair (D3_GATE_PAIRS evenly
# spaced where a loader has more) within D3_PLANE_RTOL of the plane (median
# |z - PLANE_Z| / PLANE_Z), and D3_STEPS steps of batch 4 x accum 2 on the
# mix (D3_COUNTS: 16 pairs)
D3_FRAMES, D3_GATE_PAIRS, D3_STEPS, D3_PLANE_RTOL = 3, 6, 2, 1e-2
D3_COUNTS = dict(Habitat=2, BlendedMVS=2, MegaDepth=2, ARKitScenes=2, Co3d=2,
                 StaticThings3D=2, ScanNetpp=2, Waymo=1, WildRGBD=1)
# each backward alone against the autograd of its plain version: attention's
# dq, dk, dv over their max |.| (bf16 q, k, v and rotations, dq, dk, dv
# rounded to bf16); the fp32 recomputes (conv3x3, up2x, dpt_tail) over theirs
TRAIN_ATTN_RTOL = 1e-2
TRAIN_RTOL = 1e-3
# the gradient parity per top-level module, bf16 kernels vs bf16 plain
GRAD_REL_L2, GRAD_COSINE = 2e-2, 0.999
# the serving phase. A bf16 mode's output against its plain version, both
# rounded to bf16 once from fp32 sums taken in another order: one bf16 unit
# of max |y| (2^-7 of it); the tail's outputs are fp32 (TAIL_RTOL)
BF16_RTOL = 2.0 ** -7
# the int8 projections of a request (c) (one encoder batch and two pair
# batches of 8 images or pairs at 512x384: 6144 tokens a call): name, K, N,
# calls
QUANT_TOKENS = BATCH_SIZE * (H384 // 16) * (W // 16)
QUANT_CASES = (
    ("enc qkv", 1024, 3072, 24), ("enc proj", 1024, 1024, 24), ("enc fc1", 1024, 4096, 24),
    ("enc fc2", 4096, 1024, 24), ("decoder_embed", 1024, 768, 4), ("dec qkv", 768, 2304, 48),
    ("dec proj, projq, projk, projv", 768, 768, 240), ("dec fc1", 768, 3072, 48),
    ("dec fc2", 3072, 768, 48),
)
# the parallel phase: the data axis on one card (two shards, two replicas,
# two ranks over gloo: NCCL refuses two ranks on one device), and on two
# cards where there are; step (c)'s ranks at batch 2 x accum 2 on Co3d at
# 512x384, one step, against one process at batch 4 x accum 2 on the same
# global batch (GRAD_REL_L2 / GRAD_COSINE per top-level module, the losses
# within PARALLEL_LOSS_RTOL); step (d) --mesh 1 over NCCL at batch 2 x accum 2
PARALLEL_BATCH, PARALLEL_ACCUM, PARALLEL_FRAMES = 2, 2, 12
PARALLEL_DATASET = ("{n} @ Co3d(split='train', ROOT='{root}', aug_crop=16, mask_bg='rand', "
                    "resolution=[(512, 384)], transform=ColorJitter, seed=777)")
PARALLEL_LOSS_RTOL = 1e-2
# the int8 serving pointmaps against the fp32 plain forward, as
# tests/test_quant.py gates them: relative L2 of pts3d within max(4x the
# default bf16 body's, 2e-2), of conf within 2e-2
QUANT_BODY_FACTOR, QUANT_FLOOR, QUANT_CONF = 4.0, 2e-2, 2e-2


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
    floors and those of `csrc/attention_floor.cu` (`core_launches`); of
    conv3x3's, up2x's and dpt_tail's launches, those of their bf16 modes
    (`bf16_launches`); the int8 mode's quantize and dequant kernels."""
    from dust3r_tpu_torch.ops.attention_floors import attention_floor
    from dust3r_tpu_torch.ops.attention_variants import attention_variant
    from dust3r_tpu_torch.ops.conv3x3 import conv3x3_kernel
    from dust3r_tpu_torch.ops.conv3x3_taps import tap_sums
    from dust3r_tpu_torch.ops.dpt_post import dpt_post_kernel
    from dust3r_tpu_torch.ops.dpt_tail import dpt_tail_kernel
    from dust3r_tpu_torch.ops.fused_attention import fused_attention
    from dust3r_tpu_torch.ops.quant import dequant, quantize_rows
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
                attention_floor_mma=(attention_floor, "core_launches"),
                conv3x3_bf16=(conv3x3_kernel, "bf16_launches"),
                up2x_bf16=(up2x_kernel, "bf16_launches"),
                dpt_tail_bf16=(dpt_tail_kernel, "bf16_launches"),
                quantize_rows=(quantize_rows, "launches"), dequant=(dequant, "launches"))


def reset_launches():
    for fn, attr in kernel_counters().values():
        setattr(fn, attr, 0)


def read_launches():
    return {name: getattr(fn, attr) for name, (fn, attr) in kernel_counters().items()}


def expected_launches(model, encoder_batches, pair_batches, shards=1):
    """Each kernel's launches for the engine's batches (each split into
    `shards` on a mesh, every shard launching what a whole batch does):
    attention in every
    encoder layer of an encoder batch and 4 calls (self and cross, two
    streams) in every decoder layer of a pair batch, all on the sm90
    kernel (none on the mma.sync core); conv3x3 once a call, split or not;
    the DPT kernels PER_HEAD times in each of a pair batch's two
    heads, in their bf16 modes too when the heads run in bf16; with the int8
    mode, the quantize and the dequant kernel once a projection: 4 an
    encoder layer, 8 a decoder layer of each stream and decoder_embed
    twice; the softmax variants and the other experiments' kernels never
    (the model does not call them)."""
    import torch

    from dust3r_tpu_torch.ops.quant import is_quantized

    expected = dict.fromkeys(kernel_counters(), 0)
    expected.update(fused_attention=model.enc_depth * encoder_batches
                    + 4 * model.dec_depth * pair_batches)
    expected.update({k: 2 * n * pair_batches for k, n in PER_HEAD.items()})
    if model.head_dtype == torch.bfloat16:
        expected.update({f"{k}_bf16": 2 * n * pair_batches for k, n in PER_HEAD.items()})
    if is_quantized(model):
        n = 4 * model.enc_depth * encoder_batches + (2 + 16 * model.dec_depth) * pair_batches
        expected.update(quantize_rows=n, dequant=n)
    return {k: shards * n for k, n in expected.items()}


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
    return launches, engine, req_a, dict(out_c=out_c, out32=out32, seconds_c=t_c)


def rotation_error_deg(R1, R2):
    import numpy as np

    return float(np.degrees(np.arccos(np.clip((np.trace(R1.T @ R2) - 1) / 2, -1, 1))))


def _align(torch, name, out, device, mesh=None, tag="[scene]"):
    """global_aligner -> compute_global_alignment as the README's quick start
    calls it (its edges split over `mesh`, a list of devices, when given);
    prints init seconds, iterations/s, final loss, peak memory."""
    import numpy as np

    from dust3r_tpu_torch.cloud_opt import global_aligner

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scene = global_aligner(out, device=device, verbose=False, mesh=mesh)
    build_s = time.perf_counter() - t0
    final = scene.compute_global_alignment(init="mst", niter=ALIGN_ITERS, schedule="cosine",
                                           lr=0.01)
    peak = torch.cuda.max_memory_allocated()
    losses = scene.last_losses
    log(f"{tag} {name}: {scene.n_imgs} images {scene.imshapes[0]}, {scene.n_edges} edges, "
        f"{scene.obs_pred_i.dtype} observations"
        + ("" if mesh is None else f" in {len(scene.shards)} shards of "
           f"{[sh['edges'].stop - sh['edges'].start for sh in scene.shards]} edges on "
           f"{[str(sh['device']) for sh in scene.shards]}")
        + f"; scene built in {build_s:.3f} s, init "
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


def synthetic_scene_run(torch, mesh=None, tag="[scene]"):
    """Scene (i): the synthetic 6-image scene with a known answer at full
    resolution, aligned on the card (its edges split over `mesh` when
    given), which must be recovered. Returns the scene."""
    import numpy as np

    from dust3r_tpu_torch.tools.scenes import synthetic_scene

    out, poses, focal = synthetic_scene(SCENE_IMAGES, H384, W, SCENE_FOCAL * W, seed=SEED)
    scene, est, focals = _align(torch, "synthetic", out, "cuda", mesh=mesh, tag=tag)
    focal_err = float(np.abs(focals / focal - 1).max())
    rot_err = max(rotation_error_deg((np.linalg.inv(poses[0]) @ poses[k])[:3, :3],
                                     (np.linalg.inv(est[0]) @ est[k])[:3, :3])
                  for k in range(1, SCENE_IMAGES))
    log(f"{tag} synthetic: focal {focal:.1f} px recovered to {focal_err:.3e} relative "
        f"(limit {FOCAL_RTOL:g}); relative rotations to {rot_err:.4f} deg (limit "
        f"{ROT_DEG:g})")
    if not (focal_err <= FOCAL_RTOL and rot_err <= ROT_DEG):
        raise AssertionError("synthetic scene not recovered")
    return scene


def scene_phase(torch, engine, pairs):
    """Phase 5; returns scene (i)'s per-iteration losses."""
    # (i) a synthetic scene with a known answer, at full resolution
    synthetic = synthetic_scene_run(torch)

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
    return synthetic.last_losses


def _checkpoint_files(torch, model, tmp):
    """The released `.pth` layout and a hub snapshot of `model`'s weights:
    yields (label, path, loader) after writing each, and deletes each file
    once the caller has checked it."""
    import argparse
    import os

    from dust3r_tpu_torch.checkpoint import arch_string, from_pretrained, parse_arch_string
    from dust3r_tpu_torch.model import load_model
    from safetensors.torch import save_file

    published = parse_arch_string(PUBLISHED_ARCH)
    if any(parse_arch_string(arch_string(model))[k] != v for k, v in published.items()
           if k != "landscape_only"):
        raise AssertionError(f"the source model is not {PUBLISHED_ARCH}")
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    release = {k: v for k, v in sd.items() if not k.startswith("dec_blocks2.")}
    gen = torch.Generator().manual_seed(SEED)
    release["mask_token"] = torch.randn(1, 1, model.enc_embed_dim, generator=gen)
    for n in (1, 2):
        for conv in ("conv1", "conv2"):
            unit = f"downstream_head{n}.dpt.scratch.refinenet4.resConfUnit"
            w = sd[f"{unit}2.{conv}.weight"]
            release[f"{unit}1.{conv}.weight"] = 0.02 * torch.randn(w.shape, generator=gen)
            release[f"{unit}1.{conv}.bias"] = torch.zeros(w.shape[0])
    pth = os.path.join(tmp, "DUSt3R_ViTLarge_BaseDecoder_512_dpt.pth")
    t0 = time.perf_counter()
    torch.save({"args": argparse.Namespace(model=PUBLISHED_ARCH), "model": release}, pth)
    yield ("pth", pth, time.perf_counter() - t0,
           lambda: load_model(pth, device="cuda", dtype=torch.bfloat16, verbose=False))
    os.remove(pth)
    del release

    snap = os.path.join(tmp, "snapshot")
    os.makedirs(snap)
    # as the hub mixin writes it: the constructor's kwargs, JSON infinities
    config = dict(output_mode=model.output_mode, head_type=model.head_type,
                  depth_mode=list(model.depth_mode), conf_mode=list(model.conf_mode),
                  freeze="none", landscape_only=False, patch_embed_cls="ManyAR_PatchEmbed",
                  img_size=list(model.img_size), pos_embed=model.pos_embed,
                  **{k: getattr(model, k) for k in ("enc_embed_dim", "enc_depth",
                                                    "enc_num_heads", "dec_embed_dim",
                                                    "dec_depth", "dec_num_heads")})
    t0 = time.perf_counter()
    save_file({k: v.contiguous() for k, v in sd.items()}, os.path.join(snap, "model.safetensors"),
              metadata={"format": "pt"})
    with open(os.path.join(snap, "config.json"), "w") as f:
        json.dump(config, f)
    yield ("hub snapshot", snap, time.perf_counter() - t0,
           lambda: from_pretrained(snap, device="cuda", dtype=torch.bfloat16, verbose=False))
    for name in os.listdir(snap):
        os.remove(os.path.join(snap, name))


def demo_images(directory):
    """The demo's PNG files: a horizontal ramp in red and a vertical ramp in
    green over seeded noise (so the pixels carry their position), under a
    bright, low-saturation sky band a third of the height."""
    import os

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(SEED)
    h, w = DEMO_PNG
    files = []
    for i in range(max(DEMO_SCENES)):
        v, u = np.mgrid[:h, :w] / np.float32([[[h]], [[w]]])
        img = np.stack([230 * u + 10 * i, 230 * v, 60 + 0 * u], -1)
        img = img + rng.normal(0, 4, img.shape)
        band = h // 3
        img[:band] = np.stack([195 + 20 * u[:band], 205 + 20 * u[:band],
                               235 + 0 * u[:band]], -1)
        files.append(os.path.join(directory, f"view{i}.png"))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(files[-1])
    return files


def fit_heads_to_a_plane(torch, model, files):
    """Least squares on each DPT head's last 1x1 conv (its x, y, z rows):
    seeded weights give pointmaps with no camera in them (PairViewer's
    Weiszfeld focal clips to 0 and its points are not finite, as in the JAX
    package), so the heads are fitted to map the features of the demo's
    views (every pair of the complete graph) to a plane at PLANE_DEPTH seen
    by a camera of focal PLANE_FOCAL, as raw outputs before the exp
    postprocess. The confidence row stays as it was. Returns the fit's RMS
    error in raw units."""
    import torch.nn.functional as F

    from dust3r_tpu_torch.image_pairs import make_pairs
    from dust3r_tpu_torch.inference import InferenceEngine
    from dust3r_tpu_torch.utils.image import load_images

    views = load_images(files, size=512, verbose=False)
    pairs = make_pairs(views, "complete", symmetrize=True)
    H, Wd = views[0]["img"].shape[1:3]
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float64),
                          torch.arange(Wd, dtype=torch.float64), indexing="ij")
    z = torch.full_like(u, PLANE_DEPTH)
    pts = torch.stack([(u - Wd / 2) * z / PLANE_FOCAL, (v - H / 2) * z / PLANE_FOCAL, z], -1)
    norm = pts.norm(dim=-1, keepdim=True)
    raw = (pts / norm * torch.log1p(norm)).reshape(-1, 3)  # the exp postprocess, inverted
    dev = next(model.parameters()).device
    raw = raw.to(dev)
    heads = [model.downstream_head1.dpt, model.downstream_head2.dpt]
    # per head: A^T A, A^T t, t^T t summed and the rows, A = [features, 1]
    normal = [[torch.zeros(33, 33, dtype=torch.float64, device=dev),
               torch.zeros(33, 3, dtype=torch.float64, device=dev), 0.0, 0] for _ in heads]

    def hook(n):
        def accumulate(module, args, y):
            conv2 = heads[n].head[2]
            h = F.relu(F.conv2d(y.float(), conv2.weight, conv2.bias, padding=1))
            a = torch.cat([h.permute(0, 2, 3, 1).reshape(-1, 32),
                           torch.ones(h.numel() // 32, 1, device=dev)], 1).double()
            t = raw.repeat(h.shape[0], 1)
            normal[n][0] += a.T @ a
            normal[n][1] += a.T @ t
            normal[n][2] += float((t * t).sum())
            normal[n][3] += t.numel()
        return accumulate

    handles = [hd.head[1].register_forward_hook(hook(n)) for n, hd in enumerate(heads)]
    try:
        InferenceEngine(model, batch_size=BATCH_SIZE).infer_pairs(pairs, to_cpu=False)
    finally:
        for handle in handles:
            handle.remove()
    rms = []
    with torch.no_grad():
        for hd, (ata, atb, ttt, count) in zip(heads, normal):
            sol = torch.linalg.solve(ata + 1e-6 * torch.eye(33, dtype=ata.dtype, device=dev), atb)
            hd.head[4].weight[:3, :, 0, 0] = sol[:32].T.float()
            hd.head[4].bias[:3] = sol[32].float()
            sse = ttt - 2 * float((atb * sol).sum()) + float((sol * (ata @ sol)).sum())
            rms.append((max(sse, 0.0) / count) ** 0.5)
    return rms


def _read_ply(path):
    """(vertex count in the header, (n,) records of xyz float32 and rgb)."""
    import numpy as np

    with open(path, "rb") as f:
        raw = f.read()
    header, body = raw.split(b"end_header\n", 1)
    lines = header.decode().splitlines()
    if lines[:2] != ["ply", "format binary_little_endian 1.0"]:
        raise AssertionError(f"{path}: not a binary PLY ({lines[:2]})")
    n = int(next(ln for ln in lines if ln.startswith("element vertex")).split()[-1])
    rec = np.frombuffer(body, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    if len(rec) != n:
        raise AssertionError(f"{path}: {len(rec)} vertices in the body, {n} in the header")
    return n, rec


def demo_phase(torch, model, pairs):
    """From checkpoint files to scene files (phase 6 of the module's
    docstring). `model` is the slice's; `pairs` request (a)'s, whose first
    BATCH_SIZE pairs are the pair batch held bit for bit."""
    import os
    import tempfile

    import numpy as np

    from dust3r_tpu_torch.demo import get_reconstructed_scene
    from dust3r_tpu_torch.inference import InferenceEngine

    t_phase = time.perf_counter()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    loaded = None
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        files = demo_images(tmp)
        model.dec_blocks2.load_state_dict(model.dec_blocks.state_dict())  # a one-decoder file
        t0 = time.perf_counter()
        rms = fit_heads_to_a_plane(torch, model, files)
        log(f"[demo] the heads' last 1x1 conv fitted to a plane at depth {PLANE_DEPTH:g}, "
            f"focal {PLANE_FOCAL:g} px, over the demo's {len(files)} views' pairs in "
            f"{time.perf_counter() - t0:.3f} s: RMS error of the raw x, y, z {rms[0]:.4g} "
            f"(head 1), {rms[1]:.4g} (head 2)")
        source = model.state_dict()
        batch = pairs[:BATCH_SIZE]
        want = InferenceEngine(model, batch_size=BATCH_SIZE).infer_pairs(batch, to_cpu=False)
        for label, path, write_s, load in _checkpoint_files(torch, model, tmp):
            size = sum(os.path.getsize(os.path.join(root, n)) for root, _, names in
                       os.walk(path) for n in names) if os.path.isdir(path) \
                else os.path.getsize(path)
            del loaded
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loaded = load()
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            got = loaded.state_dict()
            differ = [k for k, v in source.items() if not torch.equal(got[k], v)]
            if sorted(got) != sorted(source) or differ:
                raise AssertionError(f"{label}: tensors differ from the source: {differ[:5]}")
            out = InferenceEngine(loaded, batch_size=BATCH_SIZE).infer_pairs(batch, to_cpu=False)
            same = all(torch.equal(out[side][key], want[side][key]) for side, key in
                       (("pred1", "pts3d"), ("pred1", "conf"),
                        ("pred2", "pts3d_in_other_view"), ("pred2", "conf")))
            log(f"[demo] {label}: {size} bytes written in {write_s:.3f} s, loaded to the card "
                f"in {load_s:.3f} s ({size / load_s / 1e9:.2f} GB/s); {len(got)} tensors "
                f"bit-identical to the source; one pair batch ({len(batch)} pairs) of "
                f"pointmaps and confidences bit-identical: {same}")
            if not same:
                raise AssertionError(f"{label}: the loaded model's outputs differ")

        engine = InferenceEngine(loaded, batch_size=BATCH_SIZE)
        for n_images in DEMO_SCENES:
            outdir = os.path.join(tmp, f"scene{n_images}")
            os.makedirs(outdir)
            batches = (engine.encoder_batches, engine.pair_batches)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            scene, outfile, gallery = get_reconstructed_scene(
                outdir, engine, "cuda", True, 512, files[:n_images], schedule="linear",
                niter=DEMO_ITERS, min_conf_thr=3.0, as_pointcloud=True, mask_sky=True,
                clean_depth=True, transparent_cams=False, cam_size=0.05,
                scenegraph_type="complete", winsize=1, refid=0)
            total = time.perf_counter() - t0
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated()
            expected = expected_launches(loaded, engine.encoder_batches - batches[0],
                                         engine.pair_batches - batches[1])
            n_verts, rec = _read_ply(outfile)
            masked = scene.mask_sky()
            masked.min_conf_thr = float(scene.conf_trf(torch.tensor(3.0)))
            n_masked = int(sum(m.sum() for m in masked.get_masks()))
            sky = [int((a == 0).sum() - (b == 0).sum()) for a, b in
                   zip(masked.im_conf, scene.im_conf)]
            stages = ", ".join(f"{k} {v:.3f} s" for k, v in scene.demo_seconds.items())
            log(f"[demo] {n_images} image(s): {type(scene).__name__}, {scene.n_imgs} images "
                f"{scene.imshapes[0]}, {scene.n_edges} edges; {stages}"
                + (f" (init {scene.seconds['init']:.3f} s, {DEMO_ITERS} iterations "
                   f"{scene.seconds['align']:.3f} s)" if hasattr(scene, "seconds") else "")
                + f"; focals {[round(float(f), 2) for f in scene.get_focals().ravel()]} px"
                f"; {total:.3f} s in all; {os.path.basename(outfile)} {n_verts} vertices "
                f"({n_masked} masked points + {scene.n_imgs} x 128 frustum points); sky "
                f"zeroed {sky} confidences; gallery {len(gallery)}; launches {launches} "
                f"(expected {expected}); peak device memory {peak} bytes "
                f"({peak / 2**30:.3f} GiB)")
            if not outfile.endswith(".ply") or n_verts != n_masked + scene.n_imgs * 8 * 16:
                raise AssertionError(f"{n_images} images: {n_verts} vertices, not {n_masked} "
                                     f"masked points + the frusta")
            if not np.isfinite(rec["xyz"]).all():
                raise AssertionError(f"{n_images} images: non-finite vertices")
            if min(sky) < 1:
                raise AssertionError(f"{n_images} images: mask_sky zeroed nothing in some "
                                     f"image ({sky})")
            if len(gallery) != 3 * scene.n_imgs:
                raise AssertionError(f"{n_images} images: {len(gallery)} gallery entries")
            if launches != expected:
                raise AssertionError(f"{n_images} images: launches {launches} != {expected}: "
                                     f"some call of the demo's path bypassed its kernel")
            del scene, masked
    log(f"[demo] phase: {time.perf_counter() - t_phase:.3f} s")


class _CountedEngine:
    """The visloc loop's engine on the card: each `infer_pairs` call (one
    map view) runs the InferenceEngine with every launch count set to 0
    just before and read just after, and keeps the pair and its output for
    the parity check that follows the loop."""

    def __init__(self, engine):
        self.engine = engine
        self.calls = []  # (pairs, output, launches)

    def infer_pairs(self, pairs, verbose=False):
        batches = (self.engine.encoder_batches, self.engine.pair_batches)
        reset_launches()
        out = self.engine.infer_pairs(pairs, verbose=verbose)
        launches = read_launches()
        expected = expected_launches(self.engine.model, self.engine.encoder_batches - batches[0],
                                     self.engine.pair_batches - batches[1])
        if launches != expected or {k: v for k, v in launches.items() if v} != \
                VISLOC_PER_MAP_VIEW:
            raise AssertionError(f"a visloc map view launched {launches}, not {expected} "
                                 f"({VISLOC_PER_MAP_VIEW}): some call bypassed its kernel")
        self.calls.append((pairs, out, launches))
        return out


def visloc_phase(torch):
    """Visual localization from COLMAP maps to poses (phase 7 of the module's
    docstring). Returns the phase's report, printed as its JSON line."""
    import os
    import random
    import tempfile

    import numpy as np

    from dust3r_tpu_torch.inference import InferenceEngine, inference
    from dust3r_tpu_torch.model import dust3r_512_dpt
    from dust3r_tpu_torch.tools.visloc_scenes import (SCENES, OracleEngine,
                                                      SyntheticColmapDataset, write_scene)
    from dust3r_tpu_torch.visloc.cli import localize_dataset
    from dust3r_tpu_torch.visloc.localization import ransac_pnp, run_pnp

    t_phase = time.perf_counter()
    model = dust3r_512_dpt(dtype=torch.bfloat16, device="cuda", seed=SEED)
    engine = _CountedEngine(InferenceEngine(model, batch_size=1))
    report = dict(oracle=[], model=[], parity={}, per_map_view=VISLOC_PER_MAP_VIEW)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)

    def row(scene, rows, on_card):
        def on_query(name, success, pose, stats):
            rows.append(dict(scene=scene, query=name, success=bool(success), **stats))
            if on_card:
                rows[-1]["peak_bytes"] = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
        return on_query

    with tempfile.TemporaryDirectory(dir=build) as tmp:
        for spec in SCENES:
            t0 = time.perf_counter()
            root = os.path.join(tmp, spec.name)
            cams, surface, queries = write_scene(root, spec, seed=SEED)
            t1 = time.perf_counter()
            dataset = SyntheticColmapDataset(root, cams, queries, topk=VISLOC_TOPK)
            dataset.set_resolution(model)
            oracle = OracleEngine(cams, surface, maxdim=dataset.maxdim)
            oracle.register(dataset)
            n_points = len(dataset.points3D)
            log(f"[visloc] {spec.name}: {len(queries)} queries {spec.query_size[0]}x"
                f"{spec.query_size[1]} ({spec.query_model}, k1 {spec.query_k1:g}), "
                f"{spec.n_maps} map images {spec.map_size[0]}x{spec.map_size[1]}, relief "
                f"{spec.relief:g}, {n_points} map points; written in {t1 - t0:.3f} s, read "
                f"in {time.perf_counter() - t1:.3f} s")

            # (a) the oracle's exact pointmaps through the port's loop
            rows = []
            random.seed(SEED)
            _, _, te, ae = localize_dataset(oracle, dataset,
                                            on_query=row(spec.name, rows, on_card=False))
            for r, t, a in zip(rows, te, ae):
                r.update(te=t, ae=a)
                log(f"[visloc] oracle {spec.name} {r['query']}: pose error {t:.3e} units, "
                    f"{a:.4f} deg (limits {VISLOC_TE:g}, {VISLOC_AE:g}); {r['matches']} "
                    f"matches, {r.get('inliers', 0)} inliers after {r.get('iterations', 0)} "
                    f"RANSAC iterations; host seconds: matching {r['matching']:.3f}, PnP "
                    f"{r['pnp']:.3f} (the oracle's ray casting {r['inference']:.3f})")
                if not (r["success"] and t < VISLOC_TE and a < VISLOC_AE):
                    raise AssertionError(f"oracle {spec.name} {r['query']}: not localized "
                                         f"({t}, {a} deg)")
            report["oracle"] += rows

            # (b) the network on the card, its first query
            rows = []
            random.seed(SEED)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            first = len(engine.calls)
            _, _, te, ae = localize_dataset(engine, dataset, conf_thr=VISLOC_MODEL_CONF,
                                            queries=[0], on_query=row(spec.name, rows, True))
            r = rows[0]
            r.update(te=te[0] if np.isfinite(te[0]) else None,
                     ae=ae[0] if np.isfinite(ae[0]) else None)
            grids = sorted({"|".join("x".join(map(str, v["img"].shape[1:3])) for v in p[0])
                            for p, _, _ in engine.calls[first:]})
            r.update(grids=grids, map_views=len(engine.calls) - first)
            log(f"[visloc] model {spec.name} {r['query']}: grids {grids}, {r['map_views']} map "
                f"views, launches per view {VISLOC_PER_MAP_VIEW}; host seconds: inference "
                f"{r['inference']:.3f}, matching {r['matching']:.3f}, PnP {r['pnp']:.3f}; "
                f"{r['matches']} matches, {r.get('inliers', 0)} inliers after "
                f"{r.get('iterations', 0)} RANSAC iterations, success {r['success']} (pose "
                f"error {r['te']}, {r['ae']} deg: random weights, not gated); peak "
                f"device memory {r['peak_bytes']} bytes ({r['peak_bytes'] / 2**30:.3f} GiB)")
            report["model"] += rows

    # (c) the host PnP's worst case: pnp_max_points correspondences, 99 %
    # of them outliers, so that RANSAC runs all its iterations
    rng = np.random.default_rng(SEED)
    n = VISLOC_MAX_POINTS
    K = np.float32([[1600, 0, 959.5], [0, 1600, 539.5], [0, 0, 1]])
    X = np.concatenate([rng.uniform(-3, 3, (n, 2)), rng.uniform(6, 10, (n, 1))], 1)
    px = X[:, :2] / X[:, 2:] * K[0, 0] + K[:2, 2]
    px[n // 100:] = rng.uniform(0, 1920, (n - n // 100, 2)) * [1, 1080 / 1920]
    t0 = time.perf_counter()
    ok, _ = run_pnp(px.astype(np.float32), X.astype(np.float32), K, [0, 0, 0, 0])
    report["pnp_worst"] = dict(points=n, inlier_share=0.01, success=bool(ok),
                               seconds=time.perf_counter() - t0, **ransac_pnp.last_stats)
    log(f"[visloc] PnP at {n} correspondences, 1 % inliers: {report['pnp_worst']['iterations']} "
        f"RANSAC iterations in {report['pnp_worst']['seconds']:.3f} s (host)")

    # each map view's pointmaps against the fp32 plain forward, same weights
    model32 = dust3r_512_dpt(dtype=torch.float32, attn_impl="plain", conv_impl="ref",
                             device="cuda", seed=SEED + 1)
    model32.load_state_dict(model.state_dict())
    engine32 = InferenceEngine(model32, batch_size=1)
    for pairs, out, _ in engine.calls:
        out32 = inference(pairs, engine32, verbose=False)
        grid = "|".join("x".join(map(str, v["img"].shape[1:3])) for v in pairs[0])
        for side, key in (("pred1", "pts3d"), ("pred2", "pts3d_in_other_view")):
            a = np.asarray(out[side][key][0], np.float64)
            b = np.asarray(out32[side][key][0], np.float64)
            rmse = float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))
            report["parity"][grid] = max(report["parity"].get(grid, 0.0), rmse)
    log(f"[visloc] parity, worst normalized RMSE of pts3d / pts3d_in_other_view bf16-kernel vs "
        f"fp32-plain per grid over {len(engine.calls)} map views: {report['parity']} (limit "
        f"{PARITY_RMSE:g})")
    if not max(report["parity"].values()) <= PARITY_RMSE:
        raise AssertionError(f"visloc pointmap parity {report['parity']} > {PARITY_RMSE:g}")
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[visloc] phase: {report['seconds']:.3f} s")
    del model32, engine
    return report


# ---------------------------------------------------------------------- #
# phase 8: training
# ---------------------------------------------------------------------- #

def backward_phase(torch):
    """Each kernel's backward (the recompute of its autograd Function) alone
    at the training path's shapes, against the autograd of its plain version
    on the same inputs and output gradient: attention from the strided
    views it reads (the gradient lands in the (B, N, 3C) qkv projection or
    the (B, N, C) head-packed ones) at the encoder's, the decoder's self and
    the 512x384|512x336 cross shapes, bf16, against the fp64 autograd of
    the plain version's math (its rotations' values in bf16; dq, dk, dv
    within TRAIN_ATTN_RTOL of their max |.|);
    conv3x3 at a DPT head's 3x3 shapes, up2x at its upsamples and dpt_tail
    at its tail, against the fp32 plain versions' autograd (TRAIN_RTOL).
    Prints each backward's ms beside its forward kernel's, both by
    CUDA-graph replay (`tools/card.py::graph_ms`). Returns the rows."""
    from dust3r_tpu_torch.models.blocks import token_positions
    from dust3r_tpu_torch.ops.attention import attention, attention_backward
    from dust3r_tpu_torch.ops.conv3x3 import (conv3x3, conv3x3_backward, conv3x3_ref,
                                              pack_weight)
    from dust3r_tpu_torch.ops.dpt_tail import dpt_tail, dpt_tail_backward, dpt_tail_ref, pack_w2
    from dust3r_tpu_torch.ops.fused_attention import fused_attention
    from dust3r_tpu_torch.ops.rope import apply_rope2d, rope_tables
    from dust3r_tpu_torch.ops.upsample import up2x, up2x_backward, up2x_ref
    from dust3r_tpu_torch.tools.card import graph_ms

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    rows = []

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(*shape, device="cuda", generator=gen)).to(dtype)

    def check(name, got, want, rtol, fwd_ms, bwd_ms):
        errs = []
        for g, w in zip(got, want):
            errs.append((g.float() - w.float()).abs().max().item()
                        / max(w.float().abs().max().item(), 1e-30))
        worst = max(errs)
        log(f"[train] backward {name}: rel err " + ", ".join(f"{e:.3e}" for e in errs)
            + f" (limit {rtol:g}); forward kernel {fwd_ms:.4f} ms, backward {bwd_ms:.4f} ms "
            f"(graph replay)")
        if not worst <= rtol:
            raise AssertionError(f"backward {name}: rel err {worst:.3e} > {rtol:g}")
        rows.append(dict(name=name, rel_err=worst, ms=fwd_ms, backward_ms=bwd_ms))

    grid384, grid336 = (H384 // 16, W // 16), (H336 // 16, W // 16)
    for name, B, Hh, grid_q, grid_k, layout in (
            ("attention encoder_self", BATCH_SIZE, 16, grid384, grid384, "qkv"),
            ("attention decoder_self", BATCH_SIZE, 12, grid384, grid384, "qkv"),
            ("attention decoder_cross_768x672", BATCH_SIZE, 12, grid384, grid336, "packed")):
        d = 64
        C = Hh * d
        nq, nk = grid_q[0] * grid_q[1], grid_k[0] * grid_k[1]
        pq, pk = token_positions(B, *grid_q, "cuda"), token_positions(B, *grid_k, "cuda")
        if layout == "qkv":
            bases = [randn(B, nq, 3 * C, dtype=torch.bfloat16).requires_grad_()]

            def views(bases):
                return bases[0].view(B, nq, 3, Hh, d).permute(2, 0, 3, 1, 4)
        else:
            bases = [randn(B, n, C, dtype=torch.bfloat16).requires_grad_() for n in (nq, nk, nk)]

            def views(bases):
                return [t.view(B, -1, Hh, d).transpose(1, 2) for t in bases]
        g = randn(B, Hh, nq, d, dtype=torch.bfloat16)
        q, k, v = views(bases)
        got = torch.autograd.grad(attention(q, k, v, pq, pk, 100.0, "kernel"), bases, g)
        # autograd of the plain version's math in fp64, from fp64 copies of
        # the bases: each rotation's value is the plain version's bf16 one,
        # its gradient the fp64 rotation's (a straight-through rounding),
        # then softmax(q kᵀ / √d) v; nothing of the backward under test
        leaves = [t.detach().double().requires_grad_() for t in bases]
        q64, k64, v64 = views(leaves)

        def rotated(t64, t, pos):
            r = apply_rope2d(t64, pos)
            return r + (apply_rope2d(t.detach(), pos).double() - r).detach()

        logits = rotated(q64, q, pq) @ rotated(k64, k, pk).transpose(-1, -2) * d ** -0.5
        want = torch.autograd.grad(torch.softmax(logits, -1) @ v64, leaves, g.double())
        del leaves, q64, k64, v64, logits
        bf16 = torch.autograd.grad(attention(q, k, v, pq, pk, 100.0, "plain"), bases, g)
        log(f"[train] backward {name}: the bf16 plain version's own autograd (dP rounded to "
            f"bf16) from the fp64 one: rel err " + ", ".join(
                f"{(a.double() - b).abs().max().item() / b.abs().max().item():.3e}"
                for a, b in zip(bf16, want)) + " (information)")
        del bf16
        qd, kd, vd = (t.detach() for t in (q, k, v))
        tq, tk = rope_tables(pq, d), rope_tables(pk, d)
        check(name + f" q{(B, Hh, nq, d)} k{(B, Hh, nk, d)}", got, want, TRAIN_ATTN_RTOL,
              graph_ms(lambda: fused_attention(qd, kd, vd, pq, pk, 100.0, tq, tk)),
              graph_ms(lambda: attention_backward(qd, kd, vd, pq, pk, 100.0, g)))

    for name, cin, cout, h, w, bias, count in CONV_CASES:
        x = randn(BATCH_SIZE, cin, h, w).contiguous(memory_format=torch.channels_last)
        wt = randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
        b = randn(cout) if bias else None
        leaves = [t.requires_grad_() for t in (x, wt, b) if t is not None]
        g = randn(BATCH_SIZE, cout, h, w).contiguous(memory_format=torch.channels_last)
        wp = pack_weight(wt)
        got = torch.autograd.grad(conv3x3(x, wt, b, "kernel", packed=wp), leaves, g)
        want = torch.autograd.grad(conv3x3_ref(x, wt, b), leaves, g)
        xd, wd = x.detach(), wt.detach()
        check(f"conv3x3 {name} x{(BATCH_SIZE, cin, h, w)} -> {cout} x{count}/head", got, want,
              TRAIN_RTOL,
              graph_ms(lambda: conv3x3(xd, wd, None if b is None else b.detach(), "kernel",
                                       packed=wp)),
              graph_ms(lambda: conv3x3_backward(xd, wd, g, bias)))
    for name, c, h, w, count in UP2X_CASES:
        if not count:
            continue
        x = randn(BATCH_SIZE, c, h, w).contiguous(memory_format=torch.channels_last)
        x.requires_grad_()
        g = randn(BATCH_SIZE, c, 2 * h, 2 * w).contiguous(memory_format=torch.channels_last)
        got = torch.autograd.grad(up2x(x, "kernel"), x, g)
        want = torch.autograd.grad(up2x_ref(x), x, g)
        xd = x.detach()
        check(f"up2x {name} x{(BATCH_SIZE, c, h, w)}", got, want, TRAIN_RTOL,
              graph_ms(lambda: up2x(xd, "kernel")), graph_ms(lambda: up2x_backward(g)))
    y = randn(BATCH_SIZE, 128, H384, W, scale=0.3).contiguous(memory_format=torch.channels_last)
    params = [randn(32, 128, 3, 3, scale=(9 * 128) ** -0.5), randn(32, scale=0.1),
              randn(4, 32, 1, 1, scale=0.2), randn(4, scale=0.1)]
    inputs = [t.requires_grad_() for t in (y, *params)]
    gp, gc = randn(BATCH_SIZE, H384, W, 3), randn(BATCH_SIZE, H384, W)
    w2p = pack_w2(params[0])
    got = torch.autograd.grad(dpt_tail(*inputs, 1.0, "kernel", packed=w2p), inputs, (gp, gc))
    want = torch.autograd.grad(dpt_tail_ref(*inputs, 1.0), inputs, (gp, gc))
    detached = [t.detach() for t in inputs]
    check(f"dpt_tail y{(BATCH_SIZE, 128, H384, W)}", got, want, TRAIN_RTOL,
          graph_ms(lambda: dpt_tail(*detached, 1.0, "kernel", packed=w2p)),
          graph_ms(lambda: dpt_tail_backward(detached, 1.0, gp, gc)))
    return rows


def _groups(torch, model):
    """The model's parameters by top-level module, as the gradient parity
    reads them."""
    groups = {}
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        key = {"enc_norm": "enc_blocks", "decoder_embed": "decoder", "dec_blocks": "decoder",
               "dec_blocks2": "decoder", "dec_norm": "decoder"}.get(top, top)
        groups.setdefault(key, []).append((name, p))
    return groups


def _grads(torch, model, criterion, batch):
    from dust3r_tpu_torch.training import loss_of_one_batch

    model.zero_grad(set_to_none=True)
    (loss, _), _ = loss_of_one_batch(model, criterion, batch, symmetrized=True)
    loss.backward()
    grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def _compare_grads(torch, model, ours, ref, what, limit):
    """Per top-level module: relative L2 error and cosine of `ours` against
    `ref`; raises past the limits when `limit`."""
    worst = {}
    for group, named in _groups(torch, model).items():
        a = torch.cat([ours[n].flatten() for n, _ in named])
        b = torch.cat([ref[n].flatten() for n, _ in named])
        rel = float((a - b).norm() / b.norm().clamp(min=1e-30))
        cos = float(torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=0))
        worst[group] = (rel, cos)
        log(f"[train] gradient parity {what} {group}: rel L2 {rel:.3e}, cosine {cos:.6f}"
            + (f" (limits {GRAD_REL_L2:g}, {GRAD_COSINE:g})" if limit else " (information)"))
        if limit and not (rel <= GRAD_REL_L2 and cos >= GRAD_COSINE):
            raise AssertionError(f"gradient parity {what} {group}: rel L2 {rel:.3e}, cosine "
                                 f"{cos:.6f}")
    return worst


def _micro_batches(torch, dataset, batch_size):
    """One step's device micro-batch: the single batch of a loader of
    `dataset` (epoch 0)."""
    from dust3r_tpu_torch.datasets import get_data_loader
    from dust3r_tpu_torch.training import symmetric_micro_batches

    loader = get_data_loader(dataset, batch_size=batch_size, num_workers=0)
    loader.set_epoch(0)
    group = list(loader)
    return symmetric_micro_batches(group, torch.device("cuda"), torch.bfloat16)


def forward_launches(model, flagged):
    """Each kernel's launches for symmetrized forwards, one a batch (flagged:
    whether each batch carries ManyAR flags): the encoder once (view1 and
    view2 ride one batch) and the decoder's 4 attention calls a layer; two
    head passes a batch, four with ManyAR flags, PER_HEAD each."""
    heads = 2 * sum(2 if f else 1 for f in flagged)
    return dict(fused_attention=(model.enc_depth + 4 * model.dec_depth) * len(flagged),
                **{k: n * heads for k, n in PER_HEAD.items()})


def step_gate(torch, tag, steps, last, first_grads):
    """An on_step for train(args): each optimizer step's forward launches
    (since `last`) must be what its micro-batches imply; prints its loss,
    grad norm, LR, wall seconds and peak memory; appends it to `steps`; the
    first backward's gradients (finite, non-zero) go to `first_grads`."""
    def on_step(model, epoch, i, metrics, micro_batches):
        torch.cuda.synchronize()
        now = dict(read_launches(), time=time.perf_counter())
        got = {k: now[k] - last[k] for k in ("fused_attention", "conv3x3", "up2x", "dpt_tail")}
        want = forward_launches(model, ["is_portrait" in mb[0] for mb in micro_batches])
        peak = torch.cuda.max_memory_allocated()
        log(f"{tag} step {len(steps)} (epoch {epoch}, iter {i}): loss {metrics['loss']:.6f}, "
            f"grad norm {metrics['grad_norm']:.6f}, lr {metrics['lr']:.3e}, "
            f"{now['time'] - last['time']:.3f} s wall, peak device memory {peak} bytes "
            f"({peak / 2**30:.3f} GiB); forward launches {got} (expected {want}: "
            f"{len(micro_batches)} micro-batches)")
        if got != want:
            raise AssertionError(f"{tag} train step launches {got} != {want}")
        if not steps:  # the first backward: every parameter trains
            for name, p in model.named_parameters():
                first_grads[name] = (bool(torch.isfinite(p.grad).all()), bool(p.grad.any()))
        steps.append(dict(metrics, seconds=now["time"] - last["time"], peak=peak))
        last.update(now)
    return on_step


def mix_train_phase(torch, work):
    """Step (d2) of the train phase: train(args) on the published mix of
    the nine datasets (MIX_COUNTS over `tools/train_scenes.py`'s layouts at
    their preprocess sizes, the five 512 buckets, ColorJitter), evaluated on
    the published test mix (Habitat, BlendedMVS, MegaDepth at 512x336,
    Co3d) with TEST_CRITERION, spawned loader workers. Each step's forward
    launches exact (`step_gate`), the test pass's too (its batches read
    again in the main process), every loss, grad norm and test loss finite,
    every dataset among the trained views and every view with valid pixels.
    Prints each dataset's host ms to make a pair (`__getitem__` in this
    process, EXR decoding included) and the step's seconds and memory."""
    import shutil

    import numpy as np

    import dust3r_tpu_torch.training as training
    from dust3r_tpu_torch.datasets import DATASET_CLASSES, build_dataset, collate_views
    from dust3r_tpu_torch.tools.train_scenes import mix_dsl, test_mix_dsl, write_mix
    from dust3r_tpu_torch.train import get_args_parser

    t_phase = time.perf_counter()
    roots = write_mix(str(work / "mix"), frames=MIX_FRAMES, seed=SEED)
    log(f"[train] (d2) the nine layouts ({MIX_FRAMES} frames a sequence, each at its "
        f"preprocess size) written in {time.perf_counter() - t_phase:.2f} s")
    for name, n in MIX_COUNTS.items():
        ds = build_dataset(mix_dsl(roots, {name: n}, TRAIN_RESOLUTIONS, seed=SEED))
        ds.set_epoch(0)
        ms = []
        for i in range(MIX_LOADER_PAIRS):
            t0 = time.perf_counter()
            views = ds[i % len(ds), i % len(TRAIN_RESOLUTIONS)]
            ms.append(1e3 * (time.perf_counter() - t0))
        log(f"[train] (d2) loader {name}: one pair in " + ", ".join(f"{t:.1f}" for t in ms)
            + f" ms (host, this process; {views[0]['true_shape'].tolist()} "
            f"{views[1]['true_shape'].tolist()} at the last)")

    seen = []  # (dataset, valid pixels) of every trained view
    tested = []  # (name, loader, launches, stats) of every test pass
    symmetric, test_one_epoch = training.symmetric_micro_batches, training.test_one_epoch

    def recording(group, device, img_dtype):
        for views in group:
            for v in views:
                seen.extend(zip(v["dataset"], v["valid_mask"].flatten(1).sum(1).tolist()))
        return symmetric(group, device, img_dtype)

    def counted(model, criterion, loader, epoch, device, **kw):
        torch.cuda.synchronize()
        before = read_launches()
        stats = test_one_epoch(model, criterion, loader, epoch, device, **kw)
        torch.cuda.synchronize()
        tested.append((kw["prefix"], loader, {k: v - before[k] for k, v in
                                              read_launches().items()}, stats))
        return stats

    out = work / "mix_run"
    argv = ["--model", PUBLISHED_ARCH,
            "--train_dataset", mix_dsl(roots, MIX_COUNTS, TRAIN_RESOLUTIONS, seed=SEED),
            "--test_dataset", test_mix_dsl(roots, MIX_TEST_PAIRS),
            "--train_criterion", TRAIN_CRITERION, "--test_criterion", TEST_CRITERION,
            "--batch_size", str(TRAIN_BATCH), "--accum_iter", str(TRAIN_ACCUM), "--epochs", "1",
            "--warmup_epochs", "0", "--lr", str(TRAIN_LR), "--amp", "1", "--eval_freq", "1",
            "--num_workers", "4", "--print_freq", "1", "--seed", str(SEED),
            "--output_dir", str(out)]
    steps, last = [], dict(read_launches(), time=time.perf_counter())
    first_grads = {}
    torch.cuda.reset_peak_memory_stats()
    training.symmetric_micro_batches, training.test_one_epoch = recording, counted
    try:
        t_run = time.perf_counter()
        model, _ = training.train(get_args_parser().parse_args(argv),
                                  on_step=step_gate(torch, "[train] (d2)", steps, last,
                                                    first_grads))
        run_s = time.perf_counter() - t_run
    finally:
        training.symmetric_micro_batches, training.test_one_epoch = symmetric, test_one_epoch
    if len(steps) != TRAIN_STEPS:
        raise AssertionError(f"(d2): {len(steps)} optimizer steps, not {TRAIN_STEPS}")
    if not all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in steps):
        raise AssertionError("(d2): a non-finite loss or grad norm")
    bad = [n for n, (finite, _) in first_grads.items() if not finite]
    if bad:
        raise AssertionError(f"(d2) first backward: non-finite gradients {bad[:8]}")
    labels = {}
    for label, valid in seen:
        labels.setdefault(label, []).append(valid)
    log(f"[train] (d2) trained views by dataset (count, fewest valid pixels): "
        + ", ".join(f"{k} {len(v)} {min(v)}" for k, v in sorted(labels.items())))
    if len(labels) != len(DATASET_CLASSES) or min(min(v) for v in labels.values()) == 0:
        raise AssertionError(f"(d2): trained views from {sorted(labels)}, each of the "
                             f"{len(DATASET_CLASSES)} datasets needed, every view with valid "
                             f"pixels")

    # the test pass: its batches read again here, its launches what they imply
    for name, loader, got, stats in tested:
        ds = loader.dataset
        flagged = []
        for b in range(0, len(ds), loader.batch_size):
            batch = collate_views([ds[i] for i in range(b, min(b + loader.batch_size,
                                                                len(ds)))])
            if not all(bool(v["valid_mask"].flatten(1).any(1).all()) for v in batch):
                raise AssertionError(f"(d2) test set {name}: a view without valid pixels")
            flagged.append("is_portrait" in training.add_manyar_flags(
                *training.make_batch_symmetric(*batch))[0])
        want = forward_launches(model, flagged)
        got = {k: got[k] for k in want}
        log(f"[train] (d2) test {name}: {len(ds)} pairs in {len(flagged)} batches (ManyAR "
            f"flags {flagged}): loss avg {stats['loss_avg']:.6f}, med {stats['loss_med']:.6f}; "
            f"forward launches {got} (expected {want})")
        if got != want:
            raise AssertionError(f"(d2) test set {name}: launches {got} != {want}")
        if not all(np.isfinite(v) for v in stats.values()):
            raise AssertionError(f"(d2) test set {name}: non-finite stats {stats}")
    if len(tested) != 4:
        raise AssertionError(f"(d2): {len(tested)} test sets evaluated, not 4")
    del model
    shutil.rmtree(out, ignore_errors=True)
    log(f"[train] (d2) train(args) {run_s:.3f} s (3 checkpoints written); the step added "
        f"{time.perf_counter() - t_phase:.3f} s to the phase")


def preprocess_train_phase(torch, work):
    """Step (d3) of the train phase: raw layouts -> the port's preprocess
    scripts -> the published loaders -> the 512_dpt. `tools/raw_scenes.py`
    writes each dataset's download layout at its source's size and runs its
    script through the script's entry point (the nine on threads of their
    own); the stages that need what neither machine has (Waymo's stage 1,
    the ScanNet++ mesh render, habitat-sim) take the layout's stand-ins, and
    MegaDepth's .h5 read runs where h5py imports. Gate: every view of each
    loader's pairs (at most D3_GATE_PAIRS, evenly spaced; the published
    arguments, the five 512 buckets in turn) within D3_PLANE_RTOL of the
    plane. Then D3_STEPS steps of batch 4 x accum 2 on
    the mix, no checkpoint: the launch counts set to 0 before them and read
    after, exact for their micro-batches; every loss finite. Prints each
    dataset's host seconds and files, each step's seconds, the peak
    memory."""
    import shutil

    import numpy as np

    from dust3r_tpu_torch.checkpoint import model_from_arch_string
    from dust3r_tpu_torch.datasets import build_dataset, get_data_loader
    from dust3r_tpu_torch.losses import build_criterion
    from dust3r_tpu_torch.tools import raw_scenes
    from dust3r_tpu_torch.tools.train_scenes import mix_dsl
    from dust3r_tpu_torch.training import (TrainSpec, make_optimizer, symmetric_micro_batches,
                                           train_step)

    t_phase = time.perf_counter()
    done = raw_scenes.run_all(str(work / "raw"), frames=D3_FRAMES, seed=SEED)
    host_s = time.perf_counter() - t_phase
    for name, (out, raw_s, prep_s, files, info) in done.items():
        log(f"[train] (d3) {name}: raw layout {raw_s:.2f} s, preprocess {prep_s:.2f} s (host), "
            f"{files} files written")
    for name, what in raw_scenes.NOT_DRIVEN.items():
        log(f"[train] (d3) {name}: not driven here, {what}")
    h5 = done["MegaDepth"][4]["h5"]
    log("[train] (d3) MegaDepth: the .h5 depth read " + (
        "ran (h5py imports)" if h5 else "did not run (no h5py): the core ran on the arrays"))
    log(f"[train] (d3) the nine raw layouts and their preprocessing: {host_s:.2f} s of wall "
        f"(one thread a dataset)")

    roots = {name: out for name, (out, *_rest) in done.items()}
    args = raw_scenes.mix_args(roots["Habitat"])
    for i, name in enumerate(D3_COUNTS):
        ds = build_dataset(f"{name}({args[name]}, ROOT='{roots[name]}', "
                           f"resolution={TRAIN_RESOLUTIONS}, seed={SEED})")
        pairs = np.unique(np.linspace(0, len(ds) - 1, min(len(ds), D3_GATE_PAIRS)).astype(int))
        errs = [raw_scenes.plane_error(v) for k in pairs
                for v in ds[int(k), (i + int(k)) % len(TRAIN_RESOLUTIONS)]]
        log(f"[train] (d3) {name} loader: {len(pairs)} of its {len(ds)} pairs, {len(errs)} "
            f"views, plane error (median |z - "
            f"{raw_scenes.PLANE_Z}| / {raw_scenes.PLANE_Z}) " + " ".join(f"{e:.3e}" for e in errs)
            + f" (limit {D3_PLANE_RTOL:g})")
        if not max(errs) <= D3_PLANE_RTOL:
            raise AssertionError(f"(d3) {name}: a view off the plane ({max(errs):.3e})")

    model = model_from_arch_string(PUBLISHED_ARCH, landscape_only=True, dtype=torch.bfloat16,
                                   device="cuda", seed=SEED)
    spec = TrainSpec(lr=TRAIN_LR, min_lr=0.0, warmup_epochs=0, epochs=1,
                     accum_iter=TRAIN_ACCUM)
    opt = make_optimizer(model, spec)
    criterion = build_criterion(TRAIN_CRITERION)
    loader = get_data_loader(mix_dsl(roots, D3_COUNTS, TRAIN_RESOLUTIONS, seed=SEED, args=args),
                             batch_size=TRAIN_BATCH, num_workers=0)
    loader.set_epoch(0)
    batches = list(loader)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    want = dict.fromkeys(("fused_attention", "conv3x3", "up2x", "dpt_tail"), 0)
    losses = []
    for step in range(D3_STEPS):
        t0 = time.perf_counter()
        group = batches[step * TRAIN_ACCUM:(step + 1) * TRAIN_ACCUM]
        mbs = symmetric_micro_batches(group, torch.device("cuda"), torch.bfloat16)
        m = train_step(model, opt, criterion, mbs, step / D3_STEPS, spec)
        torch.cuda.synchronize()
        flagged = ["is_portrait" in mb[0] for mb in mbs]
        for k, n in forward_launches(model, flagged).items():
            want[k] += n
        losses.append(m["loss"])
        labels = sorted({d for views in group for v in views for d in v["dataset"]})
        log(f"[train] (d3) step {step}: loss {m['loss']:.6f}, grad norm {m['grad_norm']:.6f}, "
            f"{time.perf_counter() - t0:.3f} s wall, ManyAR flags {flagged}, datasets {labels}")
    got = {k: v for k, v in read_launches().items() if k in want}
    peak = torch.cuda.max_memory_allocated()
    log(f"[train] (d3) {D3_STEPS} steps of batch {TRAIN_BATCH} x accum {TRAIN_ACCUM} on the "
        f"preprocessed mix: forward launches {got} (expected {want}); peak device memory {peak} "
        f"bytes ({peak / 2**30:.3f} GiB)")
    if got != want:
        raise AssertionError(f"(d3) launches {got} != {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"(d3) a non-finite loss: {losses}")
    del model, opt, batches, group, mbs
    shutil.rmtree(work / "raw", ignore_errors=True)
    log(f"[train] (d3) the step added {time.perf_counter() - t_phase:.3f} s to the phase")


def train_phase(torch):
    """Training at full width (phase 8 of the module's docstring). Returns
    the launches of the train run."""
    import shutil

    import numpy as np

    from dust3r_tpu_torch.checkpoint import model_from_arch_string
    from dust3r_tpu_torch.inference import InferenceEngine, inference
    from dust3r_tpu_torch.losses import build_criterion
    from dust3r_tpu_torch.model import load_model
    from dust3r_tpu_torch.models.heads import Conv3x3, DPTOutputAdapter
    from dust3r_tpu_torch.tools.train_scenes import write_scenes
    from dust3r_tpu_torch.train import get_args_parser
    from dust3r_tpu_torch.training import (TrainSpec, make_optimizer, train, train_step)
    from dust3r_tpu_torch.utils.image import views_from_arrays

    t_phase = time.perf_counter()
    backward_phase(torch)
    work = ROOT / "build" / "train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    root = write_scenes(str(work / "co3d"), frames=100, seed=SEED)
    log(f"[train] Co3d-layout scenes (2 x 640x480, 1 x 480x640, 100 frames each) written in "
        f"{time.perf_counter() - t0:.2f} s")
    dataset = TRAIN_DATASET.format(n=TRAIN_BATCH * TRAIN_ACCUM * TRAIN_STEPS, root=root)
    criterion = build_criterion(TRAIN_CRITERION)

    # the kernels' gradients against the plain route's, one micro-batch
    one_batch = TRAIN_DATASET.format(n=TRAIN_BATCH, root=root)
    batch = _micro_batches(torch, one_batch, TRAIN_BATCH)[0]
    model = model_from_arch_string(PUBLISHED_ARCH, landscape_only=True, dtype=torch.bfloat16,
                                   device="cuda", seed=SEED)
    # remat: the plain route keeps one block's activations at a time (its
    # attention holds fp32 logits); the recompute gives the same values
    plain = model_from_arch_string(PUBLISHED_ARCH, dtype=torch.bfloat16, attn_impl="plain",
                                   conv_impl="ref", device="cuda", seed=SEED + 1, remat=True)
    plain.load_state_dict(model.state_dict())
    manyar = "is_portrait" in batch[0]
    loss_k, g_kernel = _grads(torch, model, criterion, batch)
    loss_p, g_plain = _grads(torch, plain, criterion, batch)
    del plain
    log(f"[train] one micro-batch ({batch[0]['img'].shape[0]} pairs "
        f"{tuple(batch[0]['img'].shape[1:3])}, ManyAR flags {manyar}): loss kernels "
        f"{loss_k:.6f}, plain {loss_p:.6f}")
    bad = [n for n, g in g_kernel.items() if not torch.isfinite(g).all()]
    dead = [n for n, g in g_kernel.items() if not g.any() and g_plain[n].any()]
    if bad or dead:
        raise AssertionError(f"parameters with a non-finite gradient {bad[:8]}, with a zero "
                             f"gradient where the plain route's is not {dead[:8]}")
    _compare_grads(torch, model, g_kernel, g_plain, "bf16 kernels vs bf16 plain", True)
    ref32 = model_from_arch_string(PUBLISHED_ARCH, attn_impl="plain", conv_impl="ref",
                                   device="cuda", seed=SEED + 2, remat=True)
    ref32.load_state_dict(model.state_dict())
    batch32 = tuple(dict(v, img=v["img"].float()) for v in batch)
    _compare_grads(torch, model, g_kernel, _grads(torch, ref32, criterion, batch32)[1],
                   "bf16 kernels vs fp32 plain", False)
    del ref32, g_kernel, g_plain, batch32, model

    # the train run: python -m dust3r_tpu_torch.train's train(args)
    out = work / "run"
    argv = ["--model", PUBLISHED_ARCH, "--train_dataset", dataset,
            "--train_criterion", TRAIN_CRITERION, "--batch_size", str(TRAIN_BATCH),
            "--accum_iter", str(TRAIN_ACCUM), "--epochs", "1", "--warmup_epochs", "0",
            "--lr", str(TRAIN_LR), "--amp", "1", "--num_workers", "4", "--print_freq", "1",
            "--seed", str(SEED), "--output_dir", str(out)]
    args = get_args_parser().parse_args(argv)
    steps, last = [], dict(read_launches(), time=time.perf_counter())
    first_grads = {}
    on_step = step_gate(torch, "[train]", steps, last, first_grads)
    reset_launches()
    last.update(read_launches())
    torch.cuda.reset_peak_memory_stats()
    trained, optimizer = train(args, on_step=on_step)
    launches = read_launches()
    if len(steps) < TRAIN_STEPS:
        raise AssertionError(f"{len(steps)} optimizer steps, not {TRAIN_STEPS}")
    if not all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in steps):
        raise AssertionError("a non-finite loss or grad norm")
    bad = [n for n, (finite, _) in first_grads.items() if not finite]
    dead = [n for n, (_, nonzero) in first_grads.items() if not nonzero]
    watched = [n for n in first_grads if n.endswith(("qkv.weight", "projq.weight",
                                                     "projk.weight", "projv.weight"))
               or ".dpt.head.2." in n or ".dpt.head.4." in n]
    log(f"[train] first backward: {len(first_grads)} parameters, {len(bad)} non-finite, "
        f"{len(dead)} all-zero gradients; of them {len(watched)} qkv / projq / projk / projv "
        f"/ head.2 / head.4 tensors, all non-zero: "
        f"{all(first_grads[n][1] for n in watched)}")
    if bad or dead:
        raise AssertionError(f"first backward: non-finite {bad[:8]}, all zero {dead[:8]}")

    # the packed weights follow the optimizer: a forward after the update
    # equals a forward with every packing made anew, bit for bit
    rng = np.random.default_rng(SEED)
    pair = views_from_arrays([rng.integers(0, 256, (H384, W, 3), dtype=np.uint8)
                              for _ in range(2)])
    pairs = [(pair[0], pair[1])]
    trained.eval()
    kept = inference(pairs, InferenceEngine(trained, batch_size=1), verbose=False)
    for m in trained.modules():
        if isinstance(m, Conv3x3):
            m._packed = None
        elif isinstance(m, DPTOutputAdapter):
            m._packed_w2 = None
    fresh = inference(pairs, InferenceEngine(trained, batch_size=1), verbose=False)
    same = all(np.array_equal(kept[s][k], fresh[s][k]) for s, k in (
        ("pred1", "pts3d"), ("pred1", "conf"), ("pred2", "pts3d_in_other_view")))
    log(f"[train] after the optimizer's updates, the kept packings give the bits of packings "
        f"made anew: {same}")
    if not same:
        raise AssertionError("a kept packing missed an optimizer update")

    # checkpoint-final.pth -> load_model -> InferenceEngine, bit for bit
    t0 = time.perf_counter()
    loaded = load_model(str(out / "checkpoint-final.pth"), device="cuda",
                        dtype=torch.bfloat16, verbose=False)
    again = inference(pairs, InferenceEngine(loaded, batch_size=1), verbose=False)
    same = all(np.array_equal(kept[s][k], again[s][k]) for s, k in (
        ("pred1", "pts3d"), ("pred1", "conf"), ("pred2", "pts3d_in_other_view"),
        ("pred2", "conf")))
    log(f"[train] checkpoint-final.pth ({(out / 'checkpoint-final.pth').stat().st_size} bytes) "
        f"through load_model and InferenceEngine in {time.perf_counter() - t0:.2f} s: one pair's "
        f"outputs equal the trained module's bit for bit: {same}")
    if not same:
        raise AssertionError("checkpoint-final.pth does not give the trained module's outputs")
    del loaded, kept, fresh, again

    # 10 steps on one repeated batch with a fresh AdamW, no warmup, from the
    # trained model (information): the kernel route and the plain route at
    # lr 1e-4, the plain route again with its fp32 weights nudged by 1e-7
    # of themselves (how far the steps alone part two runs), and the kernel
    # route at 1e-5; then from a freshly seeded model at lr 1e-4, the loss
    # falls
    state = {k: v.detach().cpu() for k, v in trained.state_dict().items()}
    del optimizer, trained

    # (d2) the nine-dataset mix, with nothing of the Co3d run left on the card
    mix_train_phase(torch, work)
    # (d3) raw layouts through the port's preprocess scripts to two steps
    preprocess_train_phase(torch, work)

    repeated = _micro_batches(torch, one_batch, TRAIN_BATCH)

    def ten_steps(lr, seed, state=None, nudge=0.0, **route):
        spec = TrainSpec(lr=lr, min_lr=0.0, warmup_epochs=0, epochs=1, accum_iter=1)
        model = model_from_arch_string(PUBLISHED_ARCH, dtype=torch.bfloat16, device="cuda",
                                       seed=seed, **route)
        if state is not None:
            model.load_state_dict(state)
        if nudge:
            gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
            with torch.no_grad():
                for p in model.parameters():
                    p.addcmul_(p, torch.randn(p.shape, device="cuda", generator=gen),
                               value=nudge)
        opt = make_optimizer(model, spec)
        return [train_step(model, opt, criterion, repeated, 0.0, spec)["loss"]
                for _ in range(10)]

    plain = dict(attn_impl="plain", conv_impl="ref", remat=True)
    witness = {"kernels, lr 1e-4": ten_steps(TRAIN_LR, SEED + 3, state),
               "plain, lr 1e-4": ten_steps(TRAIN_LR, SEED + 3, state, **plain),
               "plain nudged 1e-7, lr 1e-4": ten_steps(TRAIN_LR, SEED + 3, state, 1e-7,
                                                       **plain),
               "kernels, lr 1e-5": ten_steps(TRAIN_LR / 10, SEED + 3, state)}
    del state
    for what, losses in witness.items():
        log(f"[train] the trained model, {what}, 10 steps on one repeated batch: loss "
            + " ".join(f"{x:.5f}" for x in losses) + " (information)")
    ref = witness["plain, lr 1e-4"]
    for what in ("kernels, lr 1e-4", "plain nudged 1e-7, lr 1e-4"):
        log(f"[train] {what} from plain, lr 1e-4, step by step: relative " + " ".join(
            f"{abs(a - b) / abs(b):.1e}" for a, b in zip(witness[what], ref))
            + " (information)")
    losses = ten_steps(TRAIN_LR, SEED + 3)
    log(f"[train] a fresh model, 10 steps on one repeated batch, lr {TRAIN_LR:g}: loss "
        + " ".join(f"{x:.5f}" for x in losses))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses[0]} -> {losses[-1]}")

    # resume: a second train(args) in the directory starts at the next epoch
    resumed = []
    args = get_args_parser().parse_args(argv[:argv.index("--epochs") + 1] + ["2"]
                                        + argv[argv.index("--epochs") + 2:])
    last.update(read_launches(), time=time.perf_counter())
    steps.clear()
    train(args, on_step=lambda model, epoch, i, m, mb: (resumed.append(epoch),
                                                        on_step(model, epoch, i, m, mb)))
    log(f"[train] resumed run: {len(resumed)} steps, epochs {sorted(set(resumed))}")
    if set(resumed) != {1}:
        raise AssertionError(f"the resumed run trained epochs {sorted(set(resumed))}, not [1]")

    # train.py's default model (224_linear) at full width: one step at batch 8
    args = get_args_parser().parse_args(["--train_dataset", "x"])
    model = model_from_arch_string(args.model, landscape_only=True, dtype=torch.bfloat16,
                                   device="cuda", seed=SEED)
    mbs = _micro_batches(torch, TRAIN_DATASET_224.format(root=root), 8)
    spec = TrainSpec(lr=TRAIN_LR, min_lr=0.0, warmup_epochs=0, epochs=1, accum_iter=1)
    opt = make_optimizer(model, spec)
    before = read_launches()["fused_attention"]
    t0 = time.perf_counter()
    m = train_step(model, opt, criterion, mbs, 0.0, spec)
    torch.cuda.synchronize()
    n_attn = read_launches()["fused_attention"] - before
    want = model.enc_depth + 4 * model.dec_depth
    log(f"[train] 224_linear ({sum(p.numel() for p in model.parameters())} params): one step at "
        f"batch 8 ({mbs[0][0]['img'].shape[0]} pairs {tuple(mbs[0][0]['img'].shape[1:3])}, 196 "
        f"tokens): loss {m['loss']:.6f}, grad norm {m['grad_norm']:.6f}, "
        f"{time.perf_counter() - t0:.3f} s, attention launches {n_attn} (expected {want})")
    if n_attn != want or not np.isfinite(m["loss"]):
        raise AssertionError("the 224_linear step failed")
    del model, opt
    shutil.rmtree(work, ignore_errors=True)
    log(f"[train] phase: {time.perf_counter() - t_phase:.3f} s")
    return launches


# ---------------------------------------------------------------------- #
# phase 9: serving (--serving: bf16 body, bf16 heads, int8 block GEMMs)
# ---------------------------------------------------------------------- #

def _mode_check(name, got, ref, limit):
    """(max abs error, that over max |ref|) of a mode's output against its
    plain version's; raises on another shape or dtype, a value that is not
    finite, or an error past `limit`."""
    if not (got.shape == ref.shape and got.dtype == ref.dtype and got.float().isfinite().all()):
        raise AssertionError(f"{name}: bad kernel output {got.dtype} {tuple(got.shape)}")
    err, rel = _rel_err(got, ref)
    if not rel <= limit:
        raise AssertionError(f"{name}: kernel disagrees with its plain version, rel err "
                             f"{rel:.3e} > {limit:g}")
    return err, rel


def serving_kernel_phase(torch):
    """The bf16 modes of conv3x3, up2x and dpt_tail at the shapes of phase
    3, and the int8 mode's quantize and dequant kernels at QUANT_CASES, each
    against its plain version, timed by CUDA-graph replay beside the plain
    version, the library call (bf16 channels_last `F.conv2d`, bf16
    `F.interpolate`, the bf16 chain of the tail: `dpt_tail_ref` on bf16 y;
    none for the quant kernels alone) and the bound; then each projection's
    whole chain (quantize, `torch._int_mm`, dequant) beside bf16 `F.linear`
    and `_int_mm` alone. Returns the rows summed over one head's calls
    (conv3x3, up2x), the head's one tail call, and request (c)'s 484
    projections (quantize, dequant)."""
    import torch.nn.functional as F

    from dust3r_tpu_torch.ops.conv3x3 import conv3x3_bf16_ref, conv3x3_kernel, pack_weight
    from dust3r_tpu_torch.ops.dpt_tail import (dpt_tail_bf16_ref, dpt_tail_kernel, dpt_tail_ref,
                                               pack_w2)
    from dust3r_tpu_torch.ops.quant import (dequant, dequant_ref, int8_matmul, quant_linear,
                                            quant_linear_ref, quantize_linear, quantize_rows,
                                            quantize_rows_ref)
    from dust3r_tpu_torch.ops.upsample import up2x_kernel, up2x_ref
    from dust3r_tpu_torch.tools.card import bound, graph_ms

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)

    def cl(t):
        return t.contiguous(memory_format=torch.channels_last)

    rows = dict(conv3x3_bf16=[], up2x_bf16=[], dpt_tail_bf16=[], quantize_rows=[], dequant=[])
    for name, cin, cout, h, w, bias, count in CONV_CASES:
        x = cl(randn(BATCH_SIZE, cin, h, w)).to(bf16)
        wt = randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
        b = randn(cout) if bias else None
        wp = pack_weight(wt)
        wb, bb = cl(wt.to(bf16)), None if b is None else b.to(bf16)
        out = conv3x3_kernel(x, wt, b, packed=wp)
        torch.cuda.synchronize()
        err, rel = _mode_check(f"conv3x3 bf16 {name}", out, conv3x3_bf16_ref(x, wt, b),
                                    BF16_RTOL)
        M = BATCH_SIZE * h * w
        t = dict(ms=graph_ms(lambda: conv3x3_kernel(x, wt, b, packed=wp)),
                 plain_ms=graph_ms(lambda: conv3x3_bf16_ref(x, wt, b)),
                 library_ms=graph_ms(lambda: F.conv2d(x, wb, bb, padding=1)))
        bound_ms, bound_by = bound(2 * (M * cin + 9 * cin * cout + M * cout) + 4 * cout,
                                   dict(bf16=2 * M * cout * 9 * cin))
        log(f"[serving] conv3x3 bf16 {name} x{(BATCH_SIZE, cin, h, w)} -> {cout} x{count}/head: "
            f"max_abs_err {err:.3e} rel {rel:.3e} (limit {BF16_RTOL:g}); kernel graph "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bf16 F.conv2d "
            f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        rows["conv3x3_bf16"].append(dict(name=name, count=count, max_abs_err=err,
                                         bound_ms=bound_ms, bound_by=bound_by, **t))
    for name, c, h, w, count in UP2X_CASES:
        x = cl(randn(BATCH_SIZE, c, h, w)).to(bf16)
        out = up2x_kernel(x)
        torch.cuda.synchronize()
        err, rel = _mode_check(f"up2x bf16 {name}", out, up2x_ref(x), BF16_RTOL)

        def library():
            return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)

        t = dict(ms=graph_ms(lambda: up2x_kernel(x)), plain_ms=graph_ms(lambda: up2x_ref(x)),
                 library_ms=graph_ms(library))
        bound_ms, bound_by = bound(5 * 2 * x.numel(), dict(fp32=6 * 4 * x.numel()))
        log(f"[serving] up2x bf16 {name} x{(BATCH_SIZE, c, h, w)} x{count}/head: max_abs_err "
            f"{err:.3e} rel {rel:.3e} (limit {BF16_RTOL:g}); kernel graph {t['ms']:.4f} ms "
            f"({100 * bound_ms / t['ms']:.1f} % of the bound), plain {t['plain_ms']:.4f} ms, "
            f"bf16 F.interpolate {t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        rows["up2x_bf16"].append(dict(name=name, count=count, max_abs_err=err,
                                      bound_ms=bound_ms, bound_by=bound_by, **t))
    for name, h, w, count in TAIL_CASES:
        y = cl(randn(BATCH_SIZE, 128, h, w, scale=0.3)).to(bf16)
        w2 = randn(32, 128, 3, 3, scale=(9 * 128) ** -0.5)
        b2, w3, b3 = randn(32, scale=0.1), randn(4, 32, 1, 1, scale=0.2), randn(4, scale=0.1)
        args = (y, w2, b2, w3, b3, 1.0)
        w2p = pack_w2(w2)
        pts, conf = dpt_tail_kernel(*args, packed=w2p)
        torch.cuda.synchronize()
        want = dpt_tail_bf16_ref(*args)
        errs = [(key, *_mode_check(f"dpt_tail bf16 {name} {key}", got, ref, TAIL_RTOL))
                for key, got, ref in (("pts3d", pts, want[0]), ("conf", conf, want[1]))]
        del want, pts, conf
        t = dict(ms=graph_ms(lambda: dpt_tail_kernel(*args, packed=w2p)),
                 plain_ms=graph_ms(lambda: dpt_tail_bf16_ref(*args)),
                 library_ms=graph_ms(lambda: dpt_tail_ref(*args)))
        M = BATCH_SIZE * h * w
        nbytes = 2 * M * 128 + 4 * (32 * 128 * 9 + 32 + 4 * 32 + 4 + M * 3 + M)
        bound_ms, bound_by = bound(nbytes, dict(bf16=2 * M * 32 * 9 * 128,
                                                fp32=M * (2 * 32 * 4 + 20)))
        log(f"[serving] dpt_tail bf16 {name} y{(BATCH_SIZE, 128, h, w)} x{count}/head: "
            + ", ".join(f"{k} max_abs_err {e:.3e} rel {r:.3e}" for k, e, r in errs)
            + f" (limit {TAIL_RTOL:g}); kernel graph {t['ms']:.4f} ms "
            f"({100 * bound_ms / t['ms']:.1f} % of the bound), plain {t['plain_ms']:.4f} ms, "
            f"the bf16 chain (cuDNN conv2, ReLU, 1x1, fp32 postprocess) {t['library_ms']:.4f} "
            f"ms, bound {bound_ms:.4f} ms ({bound_by})")
        rows["dpt_tail_bf16"].append(dict(name=name, count=count,
                                          max_abs_err=max(e for _, e, _ in errs),
                                          bound_ms=bound_ms, bound_by=bound_by, **t))
    T = QUANT_TOKENS
    chain = dict(ms=0.0, library_ms=0.0, int_mm_ms=0.0, bound_ms=0.0)
    for name, K, N, count in QUANT_CASES:
        x = randn(T, K).to(bf16)
        lin = torch.nn.Linear(K, N, device="cuda")
        lin.weight.data = randn(N, K, scale=K ** -0.5)
        lin.bias.data = randn(N, scale=0.1)
        q = quantize_linear(lin)
        xq, inv_r = quantize_rows(x)
        acc = int8_matmul(xq, q.weight_q)
        y = dequant(acc, inv_r, q.weight_scale, q.bias, bf16)
        torch.cuda.synchronize()
        want_q, want_inv = quantize_rows_ref(x)
        if not (torch.equal(xq, want_q) and torch.equal(inv_r, want_inv)):
            raise AssertionError(f"quantize {name}: {(xq != want_q).sum().item()} of xq and "
                                 f"{(inv_r != want_inv).sum().item()} of inv_r differ from the "
                                 f"plain version's")
        d_err, d_rel = _mode_check(f"dequant {name}", y, dequant_ref(
            acc, inv_r, q.weight_scale, q.bias, bf16), BF16_RTOL)
        whole = quant_linear(x, q.weight_q, q.weight_scale, q.bias, bf16)
        c_rel = _rel_err(whole, quant_linear_ref(x, q.weight_q, q.weight_scale, q.bias, bf16))[1]
        lin_rel = _rel_err(whole, F.linear(x.float(), lin.weight, lin.bias))[1]
        wb, bb = lin.weight.to(bf16), lin.bias.to(bf16)
        tq = dict(ms=graph_ms(lambda: quantize_rows(x)),
                  plain_ms=graph_ms(lambda: quantize_rows_ref(x)), library_ms=None)
        td = dict(ms=graph_ms(lambda: dequant(acc, inv_r, q.weight_scale, q.bias, bf16)),
                  plain_ms=graph_ms(lambda: dequant_ref(acc, inv_r, q.weight_scale, q.bias,
                                                        bf16)), library_ms=None)
        tc = dict(ms=graph_ms(lambda: quant_linear(x, q.weight_q, q.weight_scale, q.bias, bf16)),
                  library_ms=graph_ms(lambda: F.linear(x, wb, bb)),
                  int_mm_ms=graph_ms(lambda: int8_matmul(xq, q.weight_q)))
        bq = bound(2 * T * K + T * K + 4 * T, {})
        bd = bound(4 * T * N + 4 * T + 8 * N + 2 * T * N, {})
        bc = bound(2 * T * K + N * K + 8 * N + 2 * T * N, dict(int8=2 * T * K * N))
        log(f"[serving] int8 {name} ({T}, {K}) -> {N} x{count}/request (c): quantize "
            f"{tq['ms']:.4f} ms (bits of the plain version's; plain {tq['plain_ms']:.4f}, bound "
            f"{bq[0]:.4f} {bq[1]}), dequant {td['ms']:.4f} ms (rel {d_rel:.3e}; plain "
            f"{td['plain_ms']:.4f}, bound {bd[0]:.4f} {bd[1]}); the chain {tc['ms']:.4f} ms "
            f"(_int_mm alone {tc['int_mm_ms']:.4f}, {2 * T * K * N / tc['int_mm_ms'] / 1e9:.1f} "
            f"TOPS; rel {c_rel:.3e} of the plain chain, {lin_rel:.3e} of fp32 F.linear) vs bf16 "
            f"F.linear {tc['library_ms']:.4f} ms; bound {bc[0]:.4f} ms ({bc[1]})")
        rows["quantize_rows"].append(dict(name=name, count=count, max_abs_err=0.0,
                                          bound_ms=bq[0], bound_by=bq[1], **tq))
        rows["dequant"].append(dict(name=name, count=count, max_abs_err=d_err,
                                    bound_ms=bd[0], bound_by=bd[1], **td))
        for k in ("ms", "library_ms", "int_mm_ms"):
            chain[k] += count * tc[k]
        chain["bound_ms"] += count * bc[0]
        del x, xq, acc, y, whole, lin, q
    totals = {k: summed(v) for k, v in rows.items()}
    for k, tot in totals.items():
        over = "request (c)'s calls" if k in ("quantize_rows", "dequant") else "one head's calls"
        log(f"[serving] {k}, summed over {over}: kernel {tot['ms']:.4f} ms, plain "
            f"{tot['plain_ms']:.4f} ms, library {tot['library_ms']} ms, bound "
            f"{tot['bound_ms']:.4f} ms ({tot['bound_by']})")
    log(f"[serving] request (c)'s 484 int8 projections: the chains {chain['ms']:.4f} ms "
        f"(_int_mm alone {chain['int_mm_ms']:.4f}) vs bf16 F.linear {chain['library_ms']:.4f} ms; "
        f"bound {chain['bound_ms']:.4f} ms")
    return totals


def _relerr(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


class _RecordingEngines:
    """Within the block, every `InferenceEngine` built (as the CLIs build
    theirs) is kept in `engines`."""

    def __enter__(self):
        import dust3r_tpu_torch.inference as inference

        self.module, self.real, self.engines = inference, inference.InferenceEngine, []
        engines, real = self.engines, self.real

        class Recording(real):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                engines.append(self)

        inference.InferenceEngine = Recording
        return self

    def __exit__(self, *exc):
        self.module.InferenceEngine = self.real

    def expected(self):
        """Each kernel's launches for the recorded engines' batches."""
        total = None
        for e in self.engines:
            exp = expected_launches(e.model, e.encoder_batches, e.pair_batches)
            total = exp if total is None else {k: total[k] + v for k, v in exp.items()}
        return total


def serving_phase(torch, fitted):
    """The serving configuration (phase 9 of the module's docstring).
    `fitted`: the demo phase's model (heads fitted to a plane), written as
    the CLIs' weights file. Returns the launches of its requests."""
    import builtins
    import os
    import tempfile

    import numpy as np

    from dust3r_tpu_torch.checkpoint import save_torch_checkpoint
    from dust3r_tpu_torch.demo import main as demo_main
    from dust3r_tpu_torch.image_pairs import make_pairs
    from dust3r_tpu_torch.inference import InferenceEngine, inference
    from dust3r_tpu_torch.model import dust3r_512_dpt
    from dust3r_tpu_torch.ops.quant import is_quantized
    from dust3r_tpu_torch.utils.image import views_from_arrays
    from dust3r_tpu_torch.visloc.cli import main as visloc_main

    t_phase = time.perf_counter()
    bf16, fp32 = torch.bfloat16, torch.float32
    model = dust3r_512_dpt(dtype=bf16, head_dtype=bf16, device="cuda", seed=SEED)
    model32 = dust3r_512_dpt(dtype=fp32, attn_impl="plain", conv_impl="ref", device="cuda",
                             seed=SEED + 1)
    model32.load_state_dict(model.state_dict())
    default = dust3r_512_dpt(dtype=bf16, device="cuda", seed=SEED + 2)
    default.load_state_dict(model.state_dict())
    rng = np.random.default_rng(SEED)  # the slice phase's images

    def images(*heights):
        return views_from_arrays([rng.integers(0, 256, (h, W, 3), dtype=np.uint8)
                                  for h in heights])

    req_a = make_pairs(images(H384, H384, H384, H384), "complete", symmetrize=True)
    req_b = make_pairs(images(H384, H384, H336, H336), "complete", symmetrize=True)
    one = req_a[:1]

    def first_pair(m):
        return inference(one, InferenceEngine(m, batch_size=1), verbose=False)

    outs = dict(fp32_plain=first_pair(model32), bf16_heads=first_pair(model))
    del model32
    model.head_dtype = fp32
    outs["default"] = first_pair(model)
    model.head_dtype = bf16
    engine = InferenceEngine(model, batch_size=BATCH_SIZE, quantize="int8")  # in place
    if engine.model is not model or not is_quantized(model):
        raise AssertionError("InferenceEngine(quantize='int8') did not convert the model")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # the main path: every launch count starts at 0 here
    t0 = time.perf_counter()
    out_a = inference(req_a, engine, verbose=False)
    t_a = time.perf_counter() - t0
    out_b = inference(req_b, engine, verbose=False)
    t0 = time.perf_counter()
    out_c = inference(req_a, engine, verbose=False)
    t_c = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    shapes = [[tuple(tuple(v["img"].shape[1:3]) for v in p) for p in req] for req in
              (req_a, req_b)]
    for name, out, pairs, sh in (("a", out_a, req_a, shapes[0]), ("b", out_b, req_b, shapes[1]),
                                 ("c", out_c, req_a, shapes[0])):
        _check_request(f"serving request {name}", out, len(pairs), sh)
    expected = expected_launches(model, engine.encoder_batches, engine.pair_batches)
    log(f"[serving] 512_dpt, bf16 body, bf16 heads, int8 block GEMMs (InferenceEngine("
        f"quantize='int8')): request a {t_a:.3f} s (cold), request c {t_c:.3f} s, "
        f"{len(req_a) / t_c:.3f} pairs/s; {engine.encoder_batches} encoder and "
        f"{engine.pair_batches} pair batches; launches {launches} (expected {expected}); peak "
        f"device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    if launches != expected:
        raise AssertionError(f"serving launches {launches} != {expected}: some call of the "
                             f"serving path bypassed its kernel")
    outs["serving"] = {side: {k: v[:1] for k, v in out_a[side].items()}
                       for side in ("pred1", "pred2")}
    model.head_dtype = fp32
    outs["int8"] = first_pair(model)
    model.head_dtype = bf16

    ref = outs["fp32_plain"]
    errs = {}
    for cfg in ("default", "bf16_heads", "int8", "serving"):
        errs[cfg] = dict(
            pts3d=max(_relerr(outs[cfg]["pred1"]["pts3d"], ref["pred1"]["pts3d"]),
                      _relerr(outs[cfg]["pred2"]["pts3d_in_other_view"],
                              ref["pred2"]["pts3d_in_other_view"])),
            conf=max(_relerr(outs[cfg][s]["conf"], ref[s]["conf"]) for s in ("pred1", "pred2")))
    limit = max(QUANT_BODY_FACTOR * errs["default"]["pts3d"], QUANT_FLOOR)
    log("[serving] relative L2 against the fp32 plain forward, request a's first pair: "
        + "; ".join(f"{k} pts3d {v['pts3d']:.3e} conf {v['conf']:.3e}" for k, v in errs.items())
        + f" (serving limits: pts3d {limit:.3e} = max({QUANT_BODY_FACTOR:g} x default, "
        f"{QUANT_FLOOR:g}), conf {QUANT_CONF:g})")
    if not (errs["serving"]["pts3d"] < limit and errs["serving"]["conf"] < QUANT_CONF):
        raise AssertionError(f"serving pointmaps off the fp32 plain forward: {errs['serving']}")

    # request (c)'s pairs/s, the default configuration and the serving one in turns
    engine_default = InferenceEngine(default, batch_size=BATCH_SIZE)
    inference(req_a, engine_default, verbose=False)  # warm
    rates = dict(default=[], serving=[])
    for cfg, eng in (("default", engine_default), ("serving", engine), ("serving", engine),
                     ("default", engine_default)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inference(req_a, eng, verbose=False)
        rates[cfg].append(len(req_a) / (time.perf_counter() - t0))
    log(f"[serving] request (c) pairs/s in turns (default, serving, serving, default): "
        f"default {rates['default']}, serving {rates['serving']} (not gated)")
    del engine_default, default

    # the CLIs with --serving, from a weights file of the demo phase's model
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        weights = os.path.join(tmp, "fitted.pth")
        save_torch_checkpoint(weights, fitted)
        files = demo_images(tmp)
        outdir = os.path.join(tmp, "demo")
        printer = builtins.print  # the demo's main stamps print; put it back after
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        try:
            with _RecordingEngines() as rec:
                demo_main(["--weights", weights, "--images", *files, "--outdir", outdir,
                           "--serving", "--silent"])
        finally:
            builtins.print = printer
        demo_s = time.perf_counter() - t0
        launches_demo, expected_demo = read_launches(), rec.expected()
        n_verts, recs = _read_ply(os.path.join(outdir, "scene.ply"))
        served = rec.engines[0].model
        log(f"[serving] demo --serving at {len(files)} images: {demo_s:.3f} s (load, inference, "
            f"300 iterations, export); model {served.dtype} body, {served.head_dtype} heads, "
            f"quantized {is_quantized(served)}; scene.ply {n_verts} vertices; launches "
            f"{launches_demo} (expected {expected_demo})")
        if not (served.head_dtype == bf16 and is_quantized(served)):
            raise AssertionError("demo --serving did not build the serving configuration")
        if launches_demo != expected_demo or not np.isfinite(recs["xyz"]).all():
            raise AssertionError(f"demo --serving: launches {launches_demo} != {expected_demo} "
                                 f"or non-finite vertices")
        del rec, served

        root = os.path.join(tmp, "plane")
        dataset = ("__import__('dust3r_tpu_torch.tools.visloc_scenes', fromlist=['_'])."
                   f"synthetic_dataset({root!r}, 'plane', {SEED})")
        reset_launches()
        t0 = time.perf_counter()
        with _RecordingEngines() as rec:
            visloc_main(["--dataset", dataset, "--weights", weights, "--serving",
                         "--confidence_threshold", str(VISLOC_MODEL_CONF),
                         "--output_dir", os.path.join(tmp, "visloc")])
        visloc_s = time.perf_counter() - t0
        launches_visloc, expected_visloc = read_launches(), rec.expected()
        e = rec.engines[0]
        log(f"[serving] visloc --serving on the plane scene: {visloc_s:.3f} s; "
            f"{e.encoder_batches} encoder and {e.pair_batches} pair batches; launches "
            f"{launches_visloc} (expected {expected_visloc})")
        if not (e.model.head_dtype == bf16 and is_quantized(e.model)):
            raise AssertionError("visloc --serving did not build the serving configuration")
        if launches_visloc != expected_visloc or e.pair_batches == 0:
            raise AssertionError(f"visloc --serving: launches {launches_visloc} != "
                                 f"{expected_visloc}")
        del rec, e
    del engine, model
    log(f"[serving] phase: {time.perf_counter() - t_phase:.3f} s")
    return launches


# ---------------------------------------------------------------------- #
# phase 10: the data axis (--mesh): engine shards, aligner shards, DDP ranks
# ---------------------------------------------------------------------- #

def engine_shards(torch, devices, pairs, refs, tag):
    """(a) Request (c) on InferenceEngine(mesh=devices): every launch count
    from 0, each kernel's launches exactly the shards' (`expected_launches`
    with shards); pointmaps within PARITY_RMSE of the slice phase's fp32
    plain forward; the distance to the one-device engine's outputs and
    both engines' pairs/s printed."""
    import numpy as np

    from dust3r_tpu_torch.inference import InferenceEngine, inference
    from dust3r_tpu_torch.model import dust3r_512_dpt

    model = dust3r_512_dpt(dtype=torch.bfloat16, device=devices[0], seed=SEED)
    engine = InferenceEngine(model, batch_size=BATCH_SIZE, mesh=devices)
    reset_launches()
    t0 = time.perf_counter()
    out = inference(pairs, engine, verbose=False)
    cold = time.perf_counter() - t0
    launches = read_launches()
    expected = expected_launches(model, engine.encoder_batches, engine.pair_batches,
                                 shards=engine.n_shards)
    t0 = time.perf_counter()
    inference(pairs, engine, verbose=False)
    warm = time.perf_counter() - t0
    _check_request(f"{tag} request (c)", out, len(pairs),
                   [tuple(tuple(v["img"].shape[1:3]) for v in p) for p in pairs])
    log(f"{tag} request (c) on InferenceEngine(mesh={[str(d) for d in devices]}): "
        f"{engine.n_shards} replicas, {BATCH_SIZE // engine.n_shards} pairs a shard, "
        f"{engine.encoder_batches} encoder and {engine.pair_batches} pair batches; "
        f"{cold:.3f} s cold, {warm:.3f} s warm = {len(pairs) / warm:.3f} pairs/s (one device, "
        f"the slice phase: {len(pairs) / refs['seconds_c']:.3f}); launches {launches} "
        f"(expected {expected})")
    if launches != expected:
        raise AssertionError(f"{tag} launches {launches} != {expected}")
    worst = 0.0
    for side, key in (("pred1", "pts3d"), ("pred2", "pts3d_in_other_view")):
        a = out[side][key][0].astype(np.float64)
        b = refs["out32"][side][key][0].astype(np.float64)
        rmse = float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))
        worst = max(worst, rmse)
        one = refs["out_c"][side][key]
        dist = float(np.abs(out[side][key] - one).max() / np.abs(one).max())
        log(f"{tag} {side}.{key}: normalized RMSE vs fp32-plain {rmse:.3e} (limit "
            f"{PARITY_RMSE:g}); max |mesh - one device| / max |one device| {dist:.3e} "
            f"(information)")
    if not worst <= PARITY_RMSE:
        raise AssertionError(f"{tag} pointmap parity {worst:.3e} > {PARITY_RMSE:g}")
    del engine, model
    torch.cuda.empty_cache()


def aligner_shards(torch, devices, one_device_losses, tag):
    """(b) Scene (i) with its edges split over `devices`: recovered, its
    loss after ALIGN_ITERS iterations beside the one-device run's."""
    scene = synthetic_scene_run(torch, mesh=devices, tag=tag)
    a, b = float(scene.last_losses[-1]), float(one_device_losses[-1])
    log(f"{tag} synthetic: loss after {ALIGN_ITERS} iterations {a:.7g} on "
        f"{len(scene.shards)} shards, {b:.7g} on one device (relative {abs(a - b) / b:.3e}, "
        f"information)")


def parallel_train_rank(rank, world_size, device, args, grads_path):
    """Step (c) in a spawned rank: `train(args)` (`training.train_rank`)
    with its step timed and its checkpoint writes counted; after the step,
    the rank's loss, peak memory, forward launches, micro-batches (host
    copies) and the SHA-256 of its parameters; rank 0 writes its
    all-reduced gradients to `grads_path`; then an all-reduce of a buffer
    of the gradients' size alone, timed. Returns that report."""
    import hashlib

    import torch
    import torch.distributed as dist

    from dust3r_tpu_torch import checkpoint, training

    report = dict(saves=[])
    save, step = checkpoint.save_train_checkpoint, training.train_step

    def counted_save(path, *a, **kw):
        report["saves"].append(Path(path).name)
        return save(path, *a, **kw)

    def timed_step(*a, **kw):
        dist.barrier()  # from the same start: rank 0 alone opens the log writer
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        metrics = step(*a, **kw)
        torch.cuda.synchronize(device)
        report["step_s"] = time.perf_counter() - t0
        return metrics

    def on_step(module, epoch, i, metrics, micro_batches):
        report.update(metrics=metrics, peak=torch.cuda.max_memory_allocated(device),
                      launches=read_launches(),
                      expected=forward_launches(module, ["is_portrait" in mb[0]
                                                         for mb in micro_batches]),
                      micro_batches=[tuple({k: v.cpu() for k, v in view.items()} for view in mb)
                                     for mb in micro_batches])
        sha = hashlib.sha256()
        for p in module.parameters():
            sha.update(p.detach().cpu().numpy().tobytes())
        report["param_sha256"] = sha.hexdigest()
        if rank == 0:
            torch.save({n: p.grad.detach().cpu() for n, p in module.named_parameters()},
                       grads_path)
        flat = torch.cat([p.grad.detach().flatten() for p in module.parameters()])
        report["grad_bytes"] = flat.numel() * flat.element_size()
        dist.barrier()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        dist.all_reduce(flat)
        torch.cuda.synchronize(device)
        report["all_reduce_s"] = time.perf_counter() - t0

    checkpoint.save_train_checkpoint, training.train_step = counted_save, timed_step
    reset_launches()
    torch.cuda.set_device(device)  # CUDA's first use in this process
    torch.cuda.reset_peak_memory_stats(device)
    training.train_rank(rank, world_size, device, args, on_step)
    return report


def _parallel_argv(root, out, n_ranks, steps=1):
    n = PARALLEL_BATCH * PARALLEL_ACCUM * n_ranks * steps
    return ["--model", PUBLISHED_ARCH, "--train_dataset", PARALLEL_DATASET.format(n=n, root=root),
            "--train_criterion", TRAIN_CRITERION, "--batch_size", str(PARALLEL_BATCH),
            "--accum_iter", str(PARALLEL_ACCUM), "--epochs", "1", "--warmup_epochs", "0",
            "--lr", str(TRAIN_LR), "--amp", "1", "--num_workers", "0", "--print_freq", "1",
            "--save_freq", "0", "--seed", str(SEED), "--output_dir", str(out),
            "--mesh", str(n_ranks)]


def ddp_ranks(torch, devices, backend, root, work, tag):
    """(c) Two ranks of train(args) on `devices` over `backend`, spawned,
    one step at batch PARALLEL_BATCH x accum PARALLEL_ACCUM each, against
    one process at twice the batch on the same global batch (the ranks'
    micro-batches joined): the ranks' all-reduced gradients per top-level
    module (GRAD_REL_L2, GRAD_COSINE), the losses (PARALLEL_LOSS_RTOL), the
    ranks' parameters bit for bit, checkpoint-final.pth written by rank 0
    alone; each rank's forward launches exact; each rank's step seconds,
    peak memory and the all-reduce's share printed."""
    import gc

    import numpy as np

    from dust3r_tpu_torch.checkpoint import model_from_arch_string
    from dust3r_tpu_torch.losses import build_criterion
    from dust3r_tpu_torch.parallel.distributed import launch
    from dust3r_tpu_torch.train import get_args_parser
    from dust3r_tpu_torch.training import TrainSpec, make_optimizer, train_step

    out = work / f"run_{backend}"
    args = get_args_parser().parse_args(_parallel_argv(root, out, len(devices))
                                        + ["--dist_backend", backend])
    grads_path = work / "grads_rank0.pt"
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reports = launch(parallel_train_rank, devices, args=(args, str(grads_path)), timeout=900)
    launch_s = time.perf_counter() - t0
    for r, rep in enumerate(reports):
        got = {k: rep["launches"][k] for k in rep["expected"]}
        log(f"{tag} rank {r} on {devices[r]} ({backend}): loss {rep['metrics']['loss']:.6f}, "
            f"grad norm {rep['metrics']['grad_norm']:.6f}, step {rep['step_s']:.3f} s (its "
            f"first: cold), peak device memory {rep['peak']} bytes ({rep['peak'] / 2**30:.3f} "
            f"GiB); an all-reduce of {rep['grad_bytes']} bytes (the gradients' size) alone "
            f"{rep['all_reduce_s']:.3f} s = {rep['all_reduce_s'] / rep['step_s']:.3f} of the "
            f"step's seconds; forward launches {got} (expected {rep['expected']}); "
            f"checkpoints written {rep['saves']}")
        if got != rep["expected"]:
            raise AssertionError(f"{tag} rank {r} launches {got} != {rep['expected']}")
    log(f"{tag} the two ranks: {launch_s:.3f} s from spawn to exit")
    if reports[0]["metrics"] != reports[1]["metrics"]:
        raise AssertionError(f"{tag} the ranks' metrics differ")
    if reports[0]["param_sha256"] != reports[1]["param_sha256"]:
        raise AssertionError(f"{tag} the ranks' parameters differ after the step")
    if reports[0]["saves"] != ["checkpoint-final.pth"] or reports[1]["saves"] or sorted(
            f.name for f in out.glob("*.pth")) != ["checkpoint-final.pth"]:
        raise AssertionError(f"{tag} checkpoints {[r['saves'] for r in reports]}, files "
                             f"{sorted(f.name for f in out.glob('*.pth'))}")

    # one process on the joined global batch, from the same seeded weights
    def joined(k, side):
        views = [rep["micro_batches"][k][side] for rep in reports]
        keys = set().union(*views)
        view = {}
        for key in sorted(keys):
            parts = [v[key] if key in v else torch.zeros(len(v["img"]), dtype=torch.bool)
                     for v in views]  # is_portrait where one rank's batch had none
            view[key] = torch.cat(parts).to(devices[0])
        return view
    batches = [(joined(k, 0), joined(k, 1)) for k in range(PARALLEL_ACCUM)]
    model = model_from_arch_string(PUBLISHED_ARCH, landscape_only=True, dtype=torch.bfloat16,
                                   device=devices[0], seed=SEED)
    spec = TrainSpec(lr=args.lr, min_lr=args.min_lr, warmup_epochs=0, epochs=1,
                     weight_decay=args.weight_decay, accum_iter=PARALLEL_ACCUM, amp=True)
    m = train_step(model, make_optimizer(model, spec), build_criterion(TRAIN_CRITERION),
                   batches, 0.0, spec)
    ref = {n: p.grad.detach().float() for n, p in model.named_parameters()}
    ours = {n: g.to(devices[0]).float() for n, g in torch.load(grads_path).items()}
    grads_path.unlink()
    loss = reports[0]["metrics"]["loss"]
    rel = abs(loss - m["loss"]) / abs(m["loss"])
    log(f"{tag} one process at batch {PARALLEL_BATCH * len(devices)} x accum "
        f"{PARALLEL_ACCUM} on the ranks' global batch ({batches[0][0]['img'].shape[0]} images "
        f"a micro-batch): loss {m['loss']:.6f}, the ranks' {loss:.6f} (relative "
        f"{rel:.3e}, limit {PARALLEL_LOSS_RTOL:g}); grad norm {m['grad_norm']:.6f}")
    if not (np.isfinite(loss) and rel <= PARALLEL_LOSS_RTOL):
        raise AssertionError(f"{tag} loss {loss} vs one process {m['loss']}")
    _compare_grads(torch, model, ours, ref, f"{len(devices)} ranks ({backend}) vs one process",
                   True)
    del model, ref, ours, batches, reports
    gc.collect()
    torch.cuda.empty_cache()


def mesh_one_nccl(torch, root, work):
    """(d) train(args) at --mesh 1 over NCCL in this process (a group of
    one, DistributedDataParallel around the model): one step with exact
    forward launches and checkpoint-final.pth."""
    import numpy as np
    import torch.distributed as dist

    from dust3r_tpu_torch.train import get_args_parser
    from dust3r_tpu_torch.training import train

    out = work / "run_mesh1"
    args = get_args_parser().parse_args(_parallel_argv(root, out, 1)
                                        + ["--dist_backend", "nccl"])
    steps, last, first_grads = [], dict(read_launches(), time=time.perf_counter()), {}
    reset_launches()
    last.update(read_launches())
    torch.cuda.reset_peak_memory_stats()
    module, _ = train(args, on_step=step_gate(torch, "[parallel] (d) --mesh 1 (nccl)", steps,
                                               last, first_grads))
    final = out / "checkpoint-final.pth"
    log(f"[parallel] (d) --mesh 1 over NCCL: {len(steps)} step, checkpoint-final.pth "
        f"{final.stat().st_size if final.exists() else 0} bytes; the group is gone after "
        f"train(): {not dist.is_initialized()}")
    if len(steps) != 1 or not np.isfinite(steps[0]["loss"]) or not final.exists() \
            or dist.is_initialized():
        raise AssertionError("[parallel] (d) --mesh 1 over NCCL failed")
    del module
    torch.cuda.empty_cache()


def parallel_phase(torch, pairs, refs, scene_losses):
    """The data axis (phase 10 of the module's docstring): on one card, (a)
    the engine on two replicas, (b) the aligner on two edge shards, (c) two
    DDP ranks over gloo, (d) --mesh 1 over NCCL; with two cards, (a)-(c)
    again across them, (c) over NCCL."""
    import shutil

    from dust3r_tpu_torch.tools.train_scenes import write_scenes

    t_phase = time.perf_counter()
    one_card = [torch.device("cuda", 0)] * 2
    engine_shards(torch, one_card, pairs, refs, "[parallel] (a)")
    aligner_shards(torch, one_card, scene_losses, "[parallel] (b)")
    work = ROOT / "build" / "parallel"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    root = write_scenes(str(work / "co3d"), frames=PARALLEL_FRAMES, seed=SEED)
    ddp_ranks(torch, one_card, "gloo", root, work, "[parallel] (c)")
    mesh_one_nccl(torch, root, work)
    if torch.cuda.device_count() >= 2:
        two_cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
        engine_shards(torch, two_cards, pairs, refs, "[parallel] (e) (a)")
        aligner_shards(torch, two_cards, scene_losses, "[parallel] (e) (b)")
        ddp_ranks(torch, two_cards, "nccl", root, work, "[parallel] (e) (c)")
    else:
        log("[parallel] (e) one card visible: (a)-(c) across cuda:0 and cuda:1 (NCCL between "
            "the ranks) were not run; they need two cards")
    shutil.rmtree(work, ignore_errors=True)
    log(f"[parallel] phase: {time.perf_counter() - t_phase:.3f} s")


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
    serving_totals = serving_kernel_phase(torch)
    if "--kernels-only" in argv:
        return 0
    launches, engine, pairs, refs = slice_phase(torch)
    scene_losses = scene_phase(torch, engine, pairs)
    demo_phase(torch, engine.model, pairs)
    print(json.dumps({"visloc": visloc_phase(torch)}), flush=True)
    train_phase(torch)
    serving_launches = serving_phase(torch, engine.model)
    del engine
    parallel_phase(torch, pairs, refs, scene_losses)
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
    # the epilogue and the floors: the experiments phase's. The bf16 modes
    # and the int8 kernels: the serving kernel phase's graph replays summed
    # over one head's calls (conv3x3_bf16, up2x_bf16), the head's one tail
    # call, request (c)'s 484 projections (quantize_rows, dequant); their
    # launches those of the serving phase's requests (a)-(c)
    launches.update({k: variant_launches[k]
                     for k in ("fused_attention_grouped", "fused_attention_grouped_mma",
                               "attention_variant", "attention_variant_core")})
    launches.update({k: experiment_launches[k] for k in experiment_rows})
    launches.update({k: serving_launches[k] for k in serving_totals})
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
        **{k: summed(v) for k, v in experiment_rows.items()}, **serving_totals)
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
        attention_floor_mma=("attention_floor.cu", "scripts/exp_attn_r2.py:144"),
        conv3x3_bf16=("conv3x3.cu", "dust3r_tpu/ops/conv3x3.py:74"),
        up2x_bf16=("up2x.cu", "scripts/exp_up_pallas_r2.py:79"),
        dpt_tail_bf16=("dpt_tail.cu", "scripts/exp_tailk_r2.py:78, scripts/exp_tailk2_r2.py:113"),
        quantize_rows=("quant_int8.cu", "none: XLA in dust3r_tpu/ops/quant.py:72-81"),
        dequant=("quant_int8.cu", "none: XLA in dust3r_tpu/ops/quant.py:85-87"))
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
