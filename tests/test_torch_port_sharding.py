"""The fsdp and model axes of `--mesh` (`dust3r_tpu_torch/parallel/mesh.py`:
`param_placements`, `shard_params`, the sharded train step and checkpoints)
against the JAX package on the CPU.

* `param_placements` equals JAX's `param_shardings` on the same model,
  read in the torch layout through `checkpoint.state_dict_from_jax` (each
  flax leaf a tiny array whose axis sizes name its axes), at meshes
  (4, 2, 1) and (2, 2, 2) for tests/multihost_common.py's TINY and for the
  512_dpt's shapes (`jax.eval_shape` of JAX's init; the port's model on
  the meta device). Every leaf takes JAX's choice: one JAX keeps whole on
  an fsdp width above 1 is left out of FSDP2 (its `ignored_params`).
* Four gloo ranks at `--mesh 2,2` and four at `--mesh 1,2,2` run
  `train_step` for two steps of accum 2 on a global batch with unequal
  valid masks (95 / 90 / 35 / 20 %): the loss and the grad norm of steps 0
  and 1 lie within 2e-5 and 2e-4 of JAX's single-device step, the same on
  every rank; fc1's and fc2's local weights have the shapes JAX's specs
  give. The `--mesh 1,2,2` case freezes the encoder: its frozen matrices
  decay as in JAX, its frozen vectors stay. A third case, `--mesh 1,2,2`
  with `--remat 1 --remat_policy dots`, holds the selective checkpointing
  under FSDP2 and the model axis's DTensors to JAX's step alike.
* `train(args)` at `--mesh 1,2 --device cpu`: rank 0 alone writes a
  `checkpoint-final.pth` with `--mesh 1`'s keys, shapes and optimizer
  numbering, values within 1e-5 of the `--mesh 1` run's on the same batches,
  loadable by `load_model`; a second run resumes from it at epoch 1.
* `make_mesh` and `train(args)` refuse N x F x M above the visible devices
  with JAX's message, before any data is read.
* The heads' packings, on a module whose `keep_packing` is cleared (as
  `shard_params` leaves a sharded model's), follow a write that keeps the
  weight's version and address (FSDP2's all-gather copy-out writes so).
"""
import functools
import os.path as osp
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

import dust3r_tpu.training as jtraining  # noqa: E402
from dust3r_tpu.models.model import AsymmetricCroCo3DStereo as JaxModel  # noqa: E402
from dust3r_tpu.parallel import mesh as jmesh  # noqa: E402
from dust3r_tpu_torch import training  # noqa: E402
from dust3r_tpu_torch.checkpoint import state_dict_from_jax  # noqa: E402
from dust3r_tpu_torch.model import load_model  # noqa: E402
from dust3r_tpu_torch.models.heads import Conv3x3, DPTOutputAdapter  # noqa: E402
from dust3r_tpu_torch.models.model import NAMED_MODELS, AsymmetricCroCo3DStereo  # noqa: E402
from dust3r_tpu_torch.ops.conv3x3 import pack_weight  # noqa: E402
from dust3r_tpu_torch.ops.dpt_tail import pack_w2  # noqa: E402
from dust3r_tpu_torch.parallel import mesh  # noqa: E402
from dust3r_tpu_torch.parallel.distributed import launch  # noqa: E402
from dust3r_tpu_torch.train import get_args_parser  # noqa: E402
from multihost_common import TINY  # noqa: E402
from test_torch_port_model import seeded_variables  # noqa: E402
from test_torch_port_parallel import (CRITERION, HW, TINY_ARCH, _half,  # noqa: E402
                                      _views)
from test_torch_port_train_step import _jax_step_batch, jax_decays  # noqa: E402,F401
from torch_port_ranks import sharded_steps, sharded_train_runs  # noqa: E402

CFG = {k: v for k, v in TINY.items() if k != "attn_impl"}
JAX_512 = dict(img_size=(512, 512), head_type="dpt")  # the rest: JAX's defaults (ViT-L)
PRIMES = (2, 3, 5, 7)  # a fake leaf's size along flax axis a: PRIMES[a]

# ---------------------------------------------------------------------- #
# placements
# ---------------------------------------------------------------------- #


@functools.lru_cache(maxsize=None)
def _jax_shapes(jmodel):
    img = jnp.zeros((1, 64, 64, 3), jnp.float32)
    return jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), img, img)


def _jax_placements(jmodel, dims, depths):
    """{torch name: (fsdp dim, model dim)} of JAX's `param_shardings` on
    jmodel's parameters over a (data, fsdp, model) mesh of `dims`, mapped to
    the torch layout by `state_dict_from_jax` on a tree of fake leaves."""
    shapes = _jax_shapes(jmodel)
    specs = jmesh.param_shardings(jmesh.make_mesh(*dims), shapes)
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    fake = treedef.unflatten([np.full(PRIMES[:leaf.ndim], i, np.float32)
                              for i, leaf in enumerate(leaves)])
    spec_leaves = [s.spec for s in jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))]
    out = {}
    for name, t in state_dict_from_jax(fake, *depths, jmodel.head_type).items():
        spec = tuple(spec_leaves[int(t.reshape(-1)[0])])
        spec = spec + (None,) * (t.dim() - len(spec))
        axis_of = [PRIMES.index(n) for n in t.shape]  # torch dim -> flax axis
        out[name] = tuple(next((d for d, a in enumerate(axis_of) if spec[a] == name_),
                               None) for name_ in ("fsdp", "model"))
    return out


@pytest.mark.parametrize("dims", [(4, 2, 1), (2, 2, 2)])
@pytest.mark.parametrize("which", ["tiny", "512_dpt"])
def test_param_placements_are_jax_param_shardings(which, dims):
    if which == "tiny":
        jmodel, port = JaxModel(**TINY), AsymmetricCroCo3DStereo(**CFG, device="meta")
        depths = (CFG["enc_depth"], CFG["dec_depth"])
    else:
        jmodel = JaxModel(**JAX_512)
        port = NAMED_MODELS["DUSt3R_ViTLarge_BaseDecoder_512_dpt"](device="meta")
        depths = (24, 12)
    want = _jax_placements(jmodel, dims, depths)
    got = mesh.param_placements(port, dims[1], dims[2])
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if v != want[k]} == {}
    fc = [k for k in got if ".mlp.fc" in k]
    if dims[2] > 1:  # the Megatron split: fc1 on its hidden dim, bias too; fc2's on its own
        assert all(got[k][1] == 0 for k in fc if ".fc1." in k)
        assert all(got[k][1] == 1 for k in fc if k.endswith("fc2.weight"))
        assert all(got[k][1] is None for k in fc if k.endswith("fc2.bias"))
        # fc1's bias: its only dim is TP's, so JAX keeps it whole on fsdp
        assert all(got[k][0] is None for k in fc if k.endswith("fc1.bias"))
    else:
        assert all(v[1] is None for v in got.values())


# ---------------------------------------------------------------------- #
# the sharded step against JAX's single-device step
# ---------------------------------------------------------------------- #

# (dims, freeze, remat policy or None), four ranks each; the last case runs
# the "dots" selective checkpointing under FSDP2 and the model axis's DTensors
STEP_CASES = [((2, 2, 1), "none", None), ((1, 2, 2), "encoder", None),
              ((1, 2, 2), "none", "dots")]
STEP_IDS = ["dims0-none", "dims1-encoder", "dims2-none-dots"]
EPOCHS_F = [0.25, 0.75]


def _step_args(freeze):
    return dict(lr=1e-3, min_lr=1e-6, warmup_epochs=0, epochs=2, weight_decay=0.05,
                accum_iter=2, amp=False, freeze=freeze)


@functools.lru_cache(maxsize=None)
def _step_inputs():
    """JAX's TINY model, its seeded variables, their torch state dict and
    two steps of accum 2 (each micro-batch a pair of views)."""
    jmodel = JaxModel(**TINY)
    variables = seeded_variables(jmodel, 43, HW)
    sd = state_dict_from_jax(variables, CFG["enc_depth"], CFG["dec_depth"], "linear")
    rng = np.random.default_rng(9)
    steps = [[_views(rng) for _ in range(2)] for _ in range(2)]
    return jmodel, variables, sd, steps


@pytest.fixture(scope="module")
def sharded_ranks():
    """Every case of STEP_CASES in one launch of four gloo ranks, started at
    the first request and run while JAX compiles its steps: a future of the
    ranks' outputs, a list of one output a case in each."""
    _, _, sd, steps = _step_inputs()
    cases = [(dims, _step_args(freeze),
              [[[_half(b, d, dims[0]) for b in group] for group in steps]
               for d in range(dims[0])],
              dict(remat=True, remat_policy=policy) if policy else {})
             for dims, freeze, policy in STEP_CASES]
    assert all(np.prod(dims) == 4 for dims, _, _ in STEP_CASES)
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(launch, sharded_steps, ["cpu"] * 4,
                          args=(cases, CFG, sd, EPOCHS_F, CRITERION), timeout=120)


@pytest.mark.parametrize("dims,freeze,policy", STEP_CASES, ids=STEP_IDS)
def test_sharded_ranks_step_as_jax_on_the_global_batch(jax_decays, sharded_ranks, dims,
                                                       freeze, policy):
    jmodel, variables, sd, steps = _step_inputs()
    args = _step_args(freeze)
    jspec = jtraining.TrainSpec(**args)
    step_fn = jtraining.build_train_step(jmodel, jtraining.build_criterion(CRITERION),
                                         jspec, symmetrized=True)
    state = jtraining.init_train_state(variables, jspec)
    jm = []
    for group, epoch_f in zip(steps, EPOCHS_F):
        state, m = step_fn(state, _jax_step_batch(group), jnp.asarray(epoch_f))
        jm.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
    case = STEP_CASES.index((dims, freeze, policy))
    ranks = [out[case] for out in sharded_ranks.result()]
    for r, out in enumerate(ranks):
        for k, (m, want) in enumerate(zip(out["metrics"], jm)):
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(m[key], want[key], rtol=(2e-5, 2e-4)[k],
                                           err_msg=f"rank {r} step {k} {key}")
        assert out["metrics"] == ranks[0]["metrics"]

    # the local shards JAX's specs name
    want = _jax_placements(jmodel, dims, (CFG["enc_depth"], CFG["dec_depth"]))
    size = dict(zip(("fsdp", "model"), dims[1:]))
    for name in ("enc_blocks.0.mlp.fc1.weight", "enc_blocks.0.mlp.fc2.weight",
                 "dec_blocks.1.mlp.fc1.weight", "dec_blocks2.0.mlp.fc2.weight"):
        shape = list(sd[name].shape)
        for axis, d in zip(("fsdp", "model"), want[name]):
            if d is not None:
                shape[d] //= size[axis]
        assert ranks[0]["local"][name][0] == tuple(shape), name
    if dims[2] > 1:  # fc1's bias: split on model alone, left out of FSDP as JAX keeps it
        assert ranks[0]["local"]["enc_blocks.0.mlp.fc1.bias"][1:] == (["S(0)"], ["model"])

    params = ranks[0]["params"]
    assert sorted(params) == sorted(sd) and all(r["params"] is None for r in ranks[1:])
    assert not any(torch.equal(params[k], sd[k]) for k in sd if k.startswith("dec_blocks.")
                   and k.endswith("weight"))
    if freeze == "encoder":  # frozen: matrices decay with the LR of each step, vectors stay
        decay = np.prod([1 - m["lr"] * args["weight_decay"] for m in jm])
        for k in sd:
            if k.split(".")[0] in ("patch_embed", "enc_blocks"):
                if sd[k].dim() > 1:
                    torch.testing.assert_close(params[k], sd[k] * float(decay), rtol=1e-6,
                                               atol=0)
                else:
                    assert torch.equal(params[k], sd[k]), k


# ---------------------------------------------------------------------- #
# train(args): the checkpoint and the resume
# ---------------------------------------------------------------------- #

def _run_args(root, out, mesh_arg):
    return get_args_parser().parse_args([
        "--model", TINY_ARCH, "--train_dataset",
        f"2 @ Co3d(split='train', ROOT='{root}', resolution=(64, 48), seed=777)",
        "--batch_size", "1", "--epochs", "1", "--warmup_epochs", "0", "--lr", "1e-4",
        "--num_workers", "0", "--print_freq", "1", "--output_dir", str(out),
        "--mesh", mesh_arg, "--dist_backend", "gloo", "--device", "cpu"])


def test_sharded_train_writes_the_mesh_1_checkpoint_and_resumes(tmp_path, monkeypatch):
    from dust3r_tpu_torch.tools.train_scenes import write_scenes

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # no log writer
    root = write_scenes(str(tmp_path / "co3d"), frames=4, seed=0)
    assert training.train(_run_args(root, tmp_path / "one", "1")) is not None
    ranks = launch(sharded_train_runs, ["cpu", "cpu"],
                   args=(_run_args(root, tmp_path / "two", "1,2"), [1, 2]), timeout=120)
    for r, rank in enumerate(ranks):
        first, second = rank["runs"]
        assert [e for e, _ in first["trained"]] == [0, 0], r  # 2 pairs at batch 1
        assert [e for e, _ in second["trained"]] == [1, 1], r  # resumed at epoch 1
        assert first["trained"] == ranks[0]["runs"][0]["trained"]
        want = ["checkpoint-last.pth", "checkpoint-final.pth"] if r == 0 else []
        assert first["saves"] == second["saves"] == want, r

    a = torch.load(tmp_path / "one" / "checkpoint-final.pth", weights_only=False)
    b = torch.load(tmp_path / "two" / "checkpoint-final.run0.pth", weights_only=False)
    assert (a["epoch"], b["epoch"]) == (1, 1)
    assert list(b["model"]) == list(a["model"])
    for k, v in a["model"].items():  # the same epoch on one process and on the ranks
        assert b["model"][k].shape == v.shape and b["model"][k].dtype == v.dtype, k
        torch.testing.assert_close(b["model"][k], v, rtol=1e-5, atol=1e-5, msg=k)
    assert b["optimizer"]["param_groups"] == a["optimizer"]["param_groups"]
    assert sorted(b["optimizer"]["state"]) == sorted(a["optimizer"]["state"])
    for i, st in a["optimizer"]["state"].items():
        assert sorted(b["optimizer"]["state"][i]) == sorted(st), i
        for k, v in st.items():
            torch.testing.assert_close(b["optimizer"]["state"][i][k], v, rtol=1e-5,
                                       atol=1e-5, msg=f"{i} {k}")
    final = tmp_path / "two" / "checkpoint-final.pth"  # the resumed run's
    c = torch.load(final, weights_only=False)
    assert c["epoch"] == 2 and float(c["optimizer"]["state"][0]["step"]) == 4
    model = load_model(str(final), device="cpu")
    assert all(torch.equal(v, c["model"][k]) for k, v in model.state_dict().items())


# ---------------------------------------------------------------------- #
# refusals
# ---------------------------------------------------------------------- #

def _count_free(msg):
    return re.sub(r"only \d+", "only N", msg)


def test_mesh_refuses_more_ranks_than_devices(tmp_path):
    n = torch.cuda.device_count()
    for dims in ((2, 2, 1), (2, 2, 2), (1, 1, n + 1)):
        with pytest.raises(ValueError) as ours:
            mesh.make_mesh(*dims)
        big = tuple(d * 8 for d in dims)  # past JAX's 8 virtual devices too
        with pytest.raises(ValueError) as ours_big:
            mesh.make_mesh(*big)
        with pytest.raises(AssertionError) as theirs:
            jmesh.make_mesh(*big)
        assert _count_free(str(ours_big.value)) == _count_free(str(theirs.value))
        assert f"needs {int(np.prod(dims))} devices" in str(ours.value)
    assert mesh.make_mesh(1, 2, 2, devices=["cpu"] * 5) == [torch.device("cpu")] * 4
    args = get_args_parser().parse_args(["--train_dataset", "missing", "--output_dir",
                                         str(tmp_path), "--mesh", "2,2,2"])
    with pytest.raises(ValueError, match=f"needs 8 devices but only {n} are visible"):
        training.train(args)  # before the (missing) dataset is read


# ---------------------------------------------------------------------- #
# the heads' kept packings
# ---------------------------------------------------------------------- #

def _write_keeping_version(w, fn):
    version, ptr = w._version, w.data_ptr()
    with torch.no_grad(), torch.autograd._unsafe_preserve_version_counter(w):
        fn(w)
    assert (w._version, w.data_ptr()) == (version, ptr)


@pytest.mark.parametrize("which", ["conv3x3", "tail"])
def test_kept_packing_follows_a_write_that_keeps_the_version(which):
    torch.manual_seed(0)
    if which == "conv3x3":
        owner = Conv3x3(64, 32)
        w, packed, pack = owner.weight, owner.packed_weight, pack_weight
    else:
        inf = float("inf")
        owner = DPTOutputAdapter((32,) * 4, (0, 1, 2, 3), 4, ("exp", -inf, inf),
                                 ("exp", 1.0, inf))
        w, packed, pack = owner.head[2].weight, owner.packed_w2, pack_w2
    owner.keep_packing = False  # as `shard_params` leaves a sharded model's modules
    before = packed()
    _write_keeping_version(w, lambda t: t.mul_(-0.5))
    again = packed()
    assert torch.equal(again, pack(w)) and not torch.equal(again, before)
    _write_keeping_version(w, lambda t: t.add_(1.0))
    assert torch.equal(packed(), pack(w)) and not torch.equal(packed(), again)
