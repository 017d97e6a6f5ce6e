"""The port's data axis (`dust3r_tpu_torch/parallel/`, the rank split of
the sampler and the loader, DDP training with the global batch's loss, the
engine's and the aligner's shards) against the JAX package on the CPU.

* The sampler and `get_data_loader` at world sizes 1-3, every rank, two
  epochs: the same (sample, bucket) tuples and batches as JAX's, bit for
  bit.
* `parse_mesh_arg`, `cli_pair_mesh` and `make_mesh` take JAX's arguments
  and give JAX's values and messages; an fsdp or model width above 1
  raises, naming ROADMAP.md A10b, through `train(args)` too.
* `InferenceEngine(mesh=["cpu", "cpu"])` against the one-device engine
  and JAX's engine on a mesh of two of its CPU devices, at 1e-5 as
  tests/test_inference.py holds JAX's mesh engine; a batch size the
  devices do not divide is refused.
* The aligner on two edge shards of the CPU against one: loss at rtol
  1e-6, gradients at rtol 1e-5 / atol 1e-6 (JAX's mesh tests,
  tests/test_cloud_opt.py:623-627); the loss also against JAX's aligner
  (its one-device path, which that test holds equal to its mesh path).
* Two gloo ranks, spawned, take two steps of accum 2 at the widths of
  tests/multihost_common.py's TINY model (JAX's weights) on a global batch
  whose samples have very different valid masks: the losses equal JAX's
  single-device step at rtol 2e-5 (step 0) and 2e-4 (step 1), the bounds
  of tests/test_multihost.py, and the two ranks' parameters are equal;
  the mean of the ranks' own means (the reference's DDP) misses JAX's
  step-0 loss by more than that tolerance. With the encoder frozen, the
  ranks' frozen matrices still decay, bit for bit as the one-process step
  does.
* Ranks of `train(args)`: rank 0 alone writes the checkpoints and the
  log, and a second run resumes at the next epoch on every rank. The int8
  engine is converted once, then replicated.
"""
import json
import os.path as osp
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

import dust3r_tpu.training as jtraining  # noqa: E402
from dust3r_tpu.cloud_opt import GlobalAlignerMode as JaxMode  # noqa: E402
from dust3r_tpu.cloud_opt import global_aligner as jax_global_aligner  # noqa: E402
from dust3r_tpu.cloud_opt.base_opt import alignment_value_and_grad  # noqa: E402
from dust3r_tpu.datasets import get_data_loader as jax_get_data_loader  # noqa: E402
from dust3r_tpu.datasets.base.batched_sampler import \
    BatchedRandomSampler as JaxSampler  # noqa: E402
from dust3r_tpu.datasets.base.easy_dataset import EasyDataset as JaxEasyDataset  # noqa: E402
from dust3r_tpu.inference import InferenceEngine as JaxEngine  # noqa: E402
from dust3r_tpu.parallel import mesh as jmesh  # noqa: E402
from dust3r_tpu_torch import training  # noqa: E402
from dust3r_tpu_torch.checkpoint import state_dict_from_jax  # noqa: E402
from dust3r_tpu_torch.cloud_opt import global_aligner  # noqa: E402
from dust3r_tpu_torch.datasets import get_data_loader  # noqa: E402
from dust3r_tpu_torch.datasets.base.batched_sampler import BatchedRandomSampler  # noqa: E402
from dust3r_tpu_torch.datasets.base.easy_dataset import EasyDataset  # noqa: E402
from dust3r_tpu_torch.image_pairs import make_pairs  # noqa: E402
from dust3r_tpu_torch.inference import InferenceEngine  # noqa: E402
from dust3r_tpu_torch.losses import build_criterion  # noqa: E402
from dust3r_tpu_torch.models.model import AsymmetricCroCo3DStereo  # noqa: E402
from dust3r_tpu_torch.parallel import distributed, mesh  # noqa: E402
from dust3r_tpu_torch.parallel.distributed import launch  # noqa: E402
from dust3r_tpu_torch.train import get_args_parser  # noqa: E402
from dust3r_tpu_torch.utils.image import views_from_arrays  # noqa: E402
from multihost_common import TINY  # noqa: E402
from test_cloud_opt import make_synthetic_scene  # noqa: E402
from test_torch_port_cloud_opt import OBS, _np, mixed_scene  # noqa: E402
from test_torch_port_model import CONFIGS, JaxModel, seeded_variables  # noqa: E402
from test_torch_port_train_step import _jax_step_batch, jax_decays  # noqa: E402,F401
from torch_port_ranks import ddp_steps, train_runs  # noqa: E402

# ---------------------------------------------------------------------- #
# the rank split of the sampler and the loader
# ---------------------------------------------------------------------- #


def _dummy(base):
    """A dataset of `base`'s package: sample i at bucket ar is a pair of
    views holding i and ar."""
    class Dummy(base):
        _resolutions = [(64, 48), (64, 32), (64, 16)]

        def __len__(self):
            return 23

        def __getitem__(self, idx):
            idx, ar = idx if isinstance(idx, tuple) else (idx, None)
            view = dict(idx=np.int64(idx), ar=np.int64(-1 if ar is None else ar),
                        img=np.full(2, idx, np.float32))
            return view, dict(view)
    return Dummy()


@pytest.mark.parametrize("world_size", [1, 2, 3])
def test_sampler_and_loader_split_ranks_as_jax(world_size):
    """Every rank's (sample, bucket) tuples and loader batches over two
    epochs, and the lengths, equal JAX's; the ranks' samples are disjoint
    runs of whole batches."""
    bs = 2
    seen = []
    for rank in range(world_size):
        ours = BatchedRandomSampler(list(range(23)), bs, 3, world_size=world_size, rank=rank)
        theirs = JaxSampler(list(range(23)), bs, 3, world_size=world_size, rank=rank)
        port_loader = get_data_loader(11 @ _dummy(EasyDataset), bs, num_workers=0,
                                      world_size=world_size, rank=rank)
        jax_loader = jax_get_data_loader(11 @ _dummy(JaxEasyDataset), bs, num_workers=0,
                                         world_size=world_size, rank=rank)
        assert len(ours) == len(theirs) and len(port_loader) == len(jax_loader)
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got = list(ours)
            assert got == list(theirs)
            seen.append((epoch, got))
            port_loader.set_epoch(epoch)
            jax_loader.set_epoch(epoch)
            batches = list(port_loader)
            want = list(jax_loader)
            assert len(batches) == len(want) > 0
            for (a1, a2), (b1, b2) in zip(batches, want):
                for a, b in ((a1, b1), (a2, b2)):
                    for k in ("idx", "ar", "img"):
                        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    for epoch in (0, 1):
        samples = [s for e, got in seen if e == epoch for s, _ in got]
        assert len(samples) == len(set(samples))  # disjoint over the ranks
    with pytest.raises(ValueError, match="drop the last batch"):
        BatchedRandomSampler(list(range(23)), bs, 3, world_size=2, drop_last=False)
    if world_size > 1:
        with pytest.raises(ValueError, match="set_epoch"):
            list(BatchedRandomSampler(list(range(23)), bs, 3, world_size=world_size))


# ---------------------------------------------------------------------- #
# mesh arguments
# ---------------------------------------------------------------------- #

def _count_free(msg):
    return re.sub(r"only \d+", "only N", msg)


def test_mesh_arguments_as_jax():
    for arg in ("", None, "8", "4,2", "2,2,2", "3,1", "1"):
        assert mesh.parse_mesh_arg(arg) == jtraining.parse_mesh_arg(arg), arg
    assert mesh.parse_mesh_arg("auto") == (torch.cuda.device_count(), 1, 1)
    assert mesh.cli_pair_mesh(0) == jmesh.cli_pair_mesh(0) == (None, 1)
    n = max(torch.cuda.device_count(), jax.device_count()) + 1
    with pytest.raises(ValueError) as ours:
        mesh.cli_pair_mesh(n)
    with pytest.raises(ValueError) as theirs:
        jmesh.cli_pair_mesh(n)
    assert _count_free(str(ours.value)) == _count_free(str(theirs.value))
    with pytest.raises(ValueError) as ours:
        mesh.make_mesh(n)
    with pytest.raises(AssertionError) as theirs:
        jmesh.make_mesh(n)
    assert _count_free(str(ours.value)) == _count_free(str(theirs.value))
    assert mesh.make_mesh(2, devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    for dims in ((2, 2, 1), (2, 1, 2)):
        with pytest.raises(NotImplementedError, match="A10b"):
            mesh.make_mesh(*dims)


def test_train_mesh_refusals_and_its_ranks(tmp_path, monkeypatch):
    """--mesh 2,2 names A10b; --mesh N with fewer cards raises JAX's
    make_mesh message; both before any data is read. Without a launcher,
    --mesh 2 --device cpu starts two CPU ranks of `train_rank` (stubbed
    here: tests below run ranks) and returns None."""
    def args(*extra):
        return get_args_parser().parse_args(["--train_dataset", "missing",
                                             "--output_dir", str(tmp_path), *extra])
    with pytest.raises(NotImplementedError, match="A10b"):
        training.train(args("--mesh", "2,2", "--device", "cpu"))
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"needs {n} devices but only {n - 1} are visible"):
        training.train(args("--mesh", str(n)))
    started = []
    monkeypatch.setattr(distributed, "launch", lambda fn, devices, args: started.append(
        (fn, devices, args)))
    run = args("--mesh", "2", "--device", "cpu", "--dist_backend", "gloo")
    assert training.train(run) is None
    assert started == [(training.train_rank, [torch.device("cpu")] * 2, (run, None))]


# ---------------------------------------------------------------------- #
# the engine's shards
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def tiny_models():
    jmodel = JaxModel(**CONFIGS["tiny_linear"], attn_impl="ref")
    variables = seeded_variables(jmodel, 41, (32, 32))
    cfg = CONFIGS["tiny_linear"]
    sd = state_dict_from_jax(variables, cfg["enc_depth"], cfg["dec_depth"], "linear")

    def port():
        model = AsymmetricCroCo3DStereo(**cfg, device="cpu")
        model.load_state_dict(sd, strict=True)
        return model
    return jmodel, variables, port


def test_engine_on_two_shards_matches_one_device_and_jax_mesh(tiny_models):
    jmodel, variables, port = tiny_models
    rng = np.random.default_rng(5)
    views = views_from_arrays([rng.integers(0, 256, hw + (3,), dtype=np.uint8)
                               for hw in [(32, 48)] * 3 + [(32, 32)] * 2])
    pairs = make_pairs(views, "complete", symmetrize=True)
    one = InferenceEngine(port(), batch_size=4)
    two = InferenceEngine(port(), batch_size=4, mesh=["cpu", "cpu"])
    assert two.mesh == [torch.device("cpu")] * 2 and len(two.replicas) == 2
    ref, out = one.infer_pairs(pairs), two.infer_pairs(pairs)
    assert (two.encoder_batches, two.pair_batches) == (one.encoder_batches, one.pair_batches)
    jeng = JaxEngine(jmodel, variables, batch_size=4,
                     mesh=jax.sharding.Mesh(np.array(jax.devices()[:2]), ("pairs",)))
    jout = jeng.infer_pairs(pairs)
    for side, key in (("pred1", "pts3d"), ("pred1", "conf"), ("pred2", "pts3d_in_other_view"),
                      ("pred2", "conf")):
        for a, b, c in zip(out[side][key], ref[side][key], jout[side][key]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
            scale = max(float(np.abs(c).mean()), 1e-6)  # seeded weights: values near 1e2
            np.testing.assert_allclose(a / scale, np.asarray(c) / scale, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="not divisible by 2 devices"):
        InferenceEngine(port(), batch_size=3, mesh=["cpu", "cpu"])
    with pytest.raises(TypeError, match="list of devices"):
        InferenceEngine(port(), batch_size=4, mesh=jax.sharding.Mesh(np.array(jax.devices()[:2]),
                                                                     ("pairs",)))


def test_int8_engine_replicates_after_converting(tiny_models):
    """quantize="int8" with a mesh: the model is converted once, then
    copied; each replica holds the int8 weights; the outputs equal the
    one-device int8 engine's."""
    from dust3r_tpu_torch.ops.quant import is_quantized

    _, _, port = tiny_models
    rng = np.random.default_rng(6)
    views = views_from_arrays([rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
                               for _ in range(3)])
    pairs = make_pairs(views, "complete", symmetrize=True)
    one = InferenceEngine(port(), batch_size=4, quantize="int8")
    two = InferenceEngine(port(), batch_size=4, quantize="int8", mesh=["cpu", "cpu"])
    assert all(is_quantized(m) for m in two.replicas) and two.replicas[0] is two.model
    ref, out = one.infer_pairs(pairs), two.infer_pairs(pairs)
    for side, key in (("pred1", "pts3d"), ("pred2", "pts3d_in_other_view"), ("pred2", "conf")):
        np.testing.assert_allclose(out[side][key], ref[side][key], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------- #
# the aligner's edge shards
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("layout", ["uniform", "mixed"])
@pytest.mark.parametrize("obs", ["fp32", "bf16", "int8"])
def test_aligner_on_two_shards_matches_one_device_and_jax(obs, layout):
    out = make_synthetic_scene(n_imgs=4)[0] if layout == "uniform" else mixed_scene()
    dtype = torch.int8 if obs == "int8" else OBS[obs][1]
    one = global_aligner(out, device="cpu", verbose=False, obs_dtype=dtype, edge_chunk=5)
    two = global_aligner(out, mesh=["cpu", "cpu"], verbose=False, obs_dtype=dtype,
                         edge_chunk=5)
    assert [sh["edges"] for sh in two.shards] == [slice(0, 6), slice(6, 12)]
    for name in ("obs_pred_i", "obs_pred_j", "obs_w_i", "obs_w_j", "idx_i", "idx_j"):
        assert torch.equal(getattr(two, name), getattr(one, name)), name
    losses, grads = [], []
    for scene in (one, two):
        params = {k: v.clone().requires_grad_(True) for k, v in one.params.items()}
        loss = scene.loss_fn(params)
        losses.append(loss.item())
        grads.append(torch.autograd.grad(loss, list(params.values())))
    assert losses[1] == pytest.approx(losses[0], rel=1e-6)
    for k, a, b in zip(one.params, *grads):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-5, atol=1e-6, err_msg=k)
    if obs != "int8":  # JAX's int8 observations: tests/test_torch_port_cloud_opt.py
        js = jax_global_aligner(out, mode=JaxMode.PointCloudOptimizer, verbose=False,
                                obs_dtype=OBS[obs][0])
        jloss, _ = alignment_value_and_grad(js.pts3d_fn, js.loss_spec, js.params, js.consts)
        assert losses[1] == pytest.approx(float(jloss), rel=1e-5)
    one.compute_global_alignment(init="mst", niter=30)
    two.compute_global_alignment(init="mst", niter=30)
    np.testing.assert_allclose(two.last_losses, one.last_losses, rtol=1e-4)


# ---------------------------------------------------------------------- #
# DDP training: two gloo ranks against JAX's single-device step
# ---------------------------------------------------------------------- #

HW = TINY["img_size"]
VALID = (0.95, 0.9, 0.35, 0.2)  # the valid share of each sample of a global batch
CRITERION = "ConfLoss(Regr3D(L21, norm_mode='avg_dis'), alpha=0.2)"


def _views(rng):
    """One loader batch (view1, view2) of 4 pairs with gt from depth: the
    first two samples (rank 0's) mostly valid, the last two (rank 1's)
    mostly not."""
    H, W = HW
    B = len(VALID)

    def view():
        K = np.float32([[40, 0, W / 2], [0, 38, H / 2], [0, 0, 1]])
        pose = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
        pose[:, :3, 3] = rng.standard_normal((B, 3))
        u = rng.uniform(size=(B, H, W))
        return dict(img=rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32),
                    depthmap=rng.uniform(0.5, 4, (B, H, W)).astype(np.float32),
                    camera_intrinsics=np.tile(K, (B, 1, 1)), camera_pose=pose,
                    valid_mask=u < np.float32(VALID)[:, None, None],
                    true_shape=np.tile(np.int32([H, W]), (B, 1)),
                    instance=[f"i{k}" for k in range(B)])
    return view(), view()


def _half(batch, rank, world=2):
    per = len(VALID) // world
    return tuple({k: v[rank * per:(rank + 1) * per] for k, v in view.items()}
                 for view in batch)


def test_two_gloo_ranks_step_as_jax_on_the_global_batch(jax_decays):
    jmodel = JaxModel(**TINY)
    variables = seeded_variables(jmodel, 43, HW)
    cfg = {k: v for k, v in TINY.items() if k != "attn_impl"}
    sd = state_dict_from_jax(variables, cfg["enc_depth"], cfg["dec_depth"], "linear")
    args = dict(lr=1e-3, min_lr=1e-6, warmup_epochs=0, epochs=2, weight_decay=0.05,
                accum_iter=2, amp=False)
    jspec = jtraining.TrainSpec(**args)
    rng = np.random.default_rng(9)
    steps = [[_views(rng) for _ in range(2)] for _ in range(2)]  # 2 steps of accum 2
    epochs_f = [0.25, 0.75]

    step_fn = jtraining.build_train_step(jmodel, jtraining.build_criterion(CRITERION), jspec,
                                         symmetrized=True)
    state = jtraining.init_train_state(variables, jspec)
    jlosses = []
    for group, epoch_f in zip(steps, epochs_f):
        state, jm = step_fn(state, _jax_step_batch(group), jnp.asarray(epoch_f))
        jlosses.append(float(jm["loss"]))

    groups_of_ranks = [[[_half(b, r) for b in group] for group in steps] for r in range(2)]
    ranks = launch(ddp_steps, ["cpu", "cpu"],
                   args=(cfg, sd, groups_of_ranks, epochs_f, args, CRITERION), timeout=120)
    for r, out in enumerate(ranks):
        got = [m["loss"] for m in out["metrics"]]
        np.testing.assert_allclose(got[0], jlosses[0], rtol=2e-5, err_msg=f"rank {r} step 0")
        np.testing.assert_allclose(got[1], jlosses[1], rtol=2e-4, err_msg=f"rank {r} step 1")
        assert out["metrics"] == ranks[0]["metrics"]
    for k, v in ranks[0]["params"].items():
        assert torch.equal(v, ranks[1]["params"][k]), k
    assert not any(torch.equal(v, sd[k]) for k, v in ranks[0]["params"].items()
                   if k.endswith("weight"))

    # the reference's DDP: each rank's own mean, averaged over the ranks
    model = AsymmetricCroCo3DStereo(**cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    crit = build_criterion(CRITERION)
    with torch.no_grad():
        naive = np.mean([float(training.loss_of_one_batch(model, crit, mb, True)[0][0])
                         for r in range(2) for mb in training.symmetric_micro_batches(
                             [_half(b, r) for b in steps[0]], torch.device("cpu"), None)])
    assert abs(naive - jlosses[0]) > 2e-5 * abs(jlosses[0])



def test_two_gloo_ranks_keep_decaying_frozen_parameters(tiny_models):
    """freeze="encoder" under DDP: the all-reduced gradients are masked after
    the reduction and AdamW still decays the frozen matrices, as in JAX and
    as the one-process step does (tests/test_torch_port_train_step.py holds
    that one to JAX): the ranks' frozen parameters equal the one-process
    step's bit for bit, each matrix its start times (1 - lr * wd), and the
    losses agree."""
    cfg = {k: v for k, v in TINY.items() if k != "attn_impl"}
    sd = tiny_models[2]().state_dict()  # TINY's widths
    args = dict(lr=1e-3, min_lr=1e-6, warmup_epochs=0, epochs=2, weight_decay=0.05,
                accum_iter=2, amp=False, freeze="encoder")
    group = [_views(np.random.default_rng(11)) for _ in range(2)]
    groups_of_ranks = [[[_half(b, r) for b in group]] for r in range(2)]
    ranks = launch(ddp_steps, ["cpu", "cpu"],
                   args=(cfg, sd, groups_of_ranks, [0.25], args, CRITERION), timeout=120)
    model = AsymmetricCroCo3DStereo(**cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    spec = training.TrainSpec(**args)
    m = training.train_step(model, training.make_optimizer(model, spec),
                            build_criterion(CRITERION),
                            training.symmetric_micro_batches(group, torch.device("cpu"), None),
                            0.25, spec, fmask=training.freeze_mask(model, "encoder"))
    frozen = [k for k in sd if k.split(".")[0] in ("patch_embed", "enc_blocks")]
    decay = 1 - m["lr"] * args["weight_decay"]
    for out in ranks:
        np.testing.assert_allclose(out["metrics"][0]["loss"], m["loss"], rtol=1e-5)
        for k in frozen:
            assert torch.equal(out["params"][k], model.state_dict()[k]), k
            if sd[k].dim() > 1:
                torch.testing.assert_close(out["params"][k], sd[k] * decay, rtol=1e-6, atol=0)
            else:
                assert torch.equal(out["params"][k], sd[k]), k

TINY_ARCH = ("AsymmetricCroCo3DStereo(pos_embed='RoPE100', img_size=(64, 64), "
             "head_type='linear', output_mode='pts3d', depth_mode=('exp', -inf, inf), "
             "conf_mode=('exp', 1, inf), enc_embed_dim=32, enc_depth=1, enc_num_heads=2, "
             "dec_embed_dim=32, dec_depth=1, dec_num_heads=2)")


def test_train_ranks_write_once_and_resume_together(tmp_path):
    """Two gloo ranks of `train(args)` (`train_rank`, as `--mesh 2` starts
    them) on a Co3d-layout set: each trains its half of every epoch's
    batches, rank 0 alone writes the checkpoints and log.txt, the ranks end
    with equal parameters, and a second run with one more epoch resumes at
    epoch 1 on both ranks."""
    from dust3r_tpu_torch.tools.train_scenes import write_scenes

    root = write_scenes(str(tmp_path / "co3d"), frames=4, seed=0)
    out = tmp_path / "run"
    args = get_args_parser().parse_args([
        "--model", TINY_ARCH, "--train_dataset",
        f"4 @ Co3d(split='train', ROOT='{root}', resolution=(64, 48), seed=777)",
        "--batch_size", "1", "--epochs", "1", "--warmup_epochs", "0", "--lr", "1e-4",
        "--num_workers", "0", "--print_freq", "1", "--output_dir", str(out),
        "--mesh", "2", "--dist_backend", "gloo", "--device", "cpu"])
    ranks = launch(train_runs, ["cpu", "cpu"], args=(args, [1, 2]), timeout=120)
    for r, rank in enumerate(ranks):
        first, second = rank["runs"]
        # 4 pairs over 2 ranks at batch 1: 2 steps an epoch on each
        assert [e for e, _ in first["trained"]] == [0, 0], r
        assert [e for e, _ in second["trained"]] == [1, 1], r
        assert first["trained"] == ranks[0]["runs"][0]["trained"]  # the global loss
        want = (["checkpoint-last.pth", "checkpoint-final.pth"] if r == 0 else [])
        assert first["saves"] == second["saves"] == want, r
    for k, v in ranks[0]["params"].items():
        assert torch.equal(v, ranks[1]["params"][k]), k
    lines = (out / "log.txt").read_text().splitlines()
    assert [json.loads(line)["epoch"] for line in lines] == [0, 1, 1, 2]  # rank 0's alone
