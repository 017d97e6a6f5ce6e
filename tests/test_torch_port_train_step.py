"""The port's training forward, train step and schedule against the JAX
package, on the CPU, at tiny widths in fp32.

Weights cross from seeded JAX trees through `state_dict_from_jax`; inputs
are seeded numpy.
* The model's symmetrized and ManyAR forwards (linear and DPT heads) equal
  JAX's at the model tests' tolerance (1e-4 of mean |x|), and the gradient
  of a scalar of the outputs with respect to every parameter is within
  1e-5 of `jax.grad`'s (of the largest |gradient| of that parameter).
* The train step (`training.train_step`) equals `build_train_step` after 1
  and 3 steps with accum_iter 1 and 2, symmetrized batches with ManyAR
  flags, gt rebuilt from depth: loss and lr within 1e-6 relative, the grad
  norm within 2e-6 (JAX's own fp32 sum of squares is 7e-7 off), every
  parameter within 1e-6 of its largest |value| (but for the few elements
  whose gradient fell below 1e-4 of its tensor's largest, where an fp32
  gradient is float noise and AdamW still moves it by up to the LR: at
  most 1e-5 of all elements outside 1e-6, each within the LRs' sum). Weight
  decay takes the parameters of JAX's `wd_mask`; the JAX step is run with
  the decay it means to apply (its own optimizer decays nothing, a fault
  of the reference held by `test_jax_adamw_decays_nothing`). A batch that makes the
  loss NaN leaves the params and AdamW's state as they were (its moments
  and its step count), as in JAX; frozen parameters still decay, as in JAX.
* `cosine_warmup_lr` equals JAX's at 50 fractional epochs (within 1e-6
  relative, or 1e-6 of the peak LR where JAX's fp32 cosine cancels).
"""
import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

import dust3r_tpu.training as jtraining  # noqa: E402
from dust3r_tpu.models.model import AsymmetricCroCo3DStereo as JaxModel  # noqa: E402
from dust3r_tpu_torch import training  # noqa: E402
from dust3r_tpu_torch.checkpoint import state_dict_from_jax  # noqa: E402
from dust3r_tpu_torch.losses import build_criterion  # noqa: E402
from dust3r_tpu_torch.models.model import AsymmetricCroCo3DStereo  # noqa: E402
from test_torch_port_model import CONFIGS, assert_model_close, seeded_variables  # noqa: E402

HW = (32, 48)  # stored landscape; a portrait sample is 48x32 in truth
CRITERION = "ConfLoss(Regr3D(L21, norm_mode='avg_dis'), alpha=0.2)"


def _port(name, variables, **kw):
    cfg = CONFIGS[name]
    model = AsymmetricCroCo3DStereo(**cfg, device="cpu", **kw)
    model.load_state_dict(state_dict_from_jax(variables, cfg["enc_depth"], cfg["dec_depth"],
                                              cfg["head_type"]), strict=True)
    return model


_MODELS = {}


def _models(name):
    """(name, JAX model, its seeded variables, the port loaded with them),
    made once a module run."""
    if name not in _MODELS:
        jmodel = JaxModel(**CONFIGS[name], attn_impl="ref")
        variables = seeded_variables(jmodel, 17, HW)
        _MODELS[name] = name, jmodel, variables, _port(name, variables)
    return _MODELS[name]


def _forward_inputs(seed, B=4):
    rng = np.random.default_rng(seed)
    img1 = rng.standard_normal((B, *HW, 3)).astype(np.float32)
    img2 = img1.reshape(B // 2, 2, *HW, 3)[:, ::-1].reshape(img1.shape).copy()
    flags = np.array([False, True, True, False])[:B]
    return img1, img2, flags, flags.reshape(B // 2, 2)[:, ::-1].reshape(B).copy()


def _scalar(res1, res2, xp):
    """A scalar of all four outputs, weighted so no term cancels."""
    return (xp.sum(res1["pts3d"] * xp.sin(xp.arange(3.0))) + xp.sum(xp.log(res1["conf"]))
            + 0.5 * xp.sum(res2["pts3d_in_other_view"]) + 0.25 * xp.sum(xp.log(res2["conf"])))


@pytest.mark.parametrize("name,manyar", [("tiny_linear", False), ("tiny_linear", True),
                                          ("small_dpt", True)])
def test_training_forward_and_gradients_match_jax(name, manyar):
    """Symmetrized, with and without ManyAR flags (the DPT head with them:
    its double pass holds both orientations of the head)."""
    name, jmodel, variables, port = _models(name)
    img1, img2, f1, f2 = _forward_inputs(3)
    jflags = (jnp.asarray(f1), jnp.asarray(f2)) if manyar else (None, None)
    tflags = (torch.from_numpy(f1), torch.from_numpy(f2)) if manyar else (None, None)

    def jax_out(params):
        return jmodel.apply({"params": params}, jnp.asarray(img1), jnp.asarray(img2),
                            *jflags, symmetrized=True)

    def scalar_and_outputs(params):
        out = jax_out(params)
        return _scalar(*out, jnp), out

    (_, (jr1, jr2)), jgrad = jax.jit(jax.value_and_grad(scalar_and_outputs, has_aux=True))(
        variables["params"])
    r1, r2 = port(torch.from_numpy(img1), torch.from_numpy(img2), *tflags, symmetrized=True)
    for key, ours, theirs in (("pts3d", r1, jr1), ("conf", r1, jr1), ("conf", r2, jr2),
                              ("pts3d_in_other_view", r2, jr2)):
        assert_model_close(ours[key].detach().numpy(), theirs[key])
    # the symmetrized forward is the plain forward of the same pairs
    with torch.no_grad():
        p1, p2 = port(torch.from_numpy(img1), torch.from_numpy(img2), *tflags)
    assert_model_close(p2["conf"].numpy(), r2["conf"].detach().numpy())
    names = dict(port.named_parameters())
    grads = torch.autograd.grad(_scalar(r1, r2, torch), list(names.values()))
    cfg = CONFIGS[name]
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrad)}, cfg["enc_depth"],
                               cfg["dec_depth"], cfg["head_type"])
    assert sorted(want) == sorted(names)
    for (key, _), got in zip(names.items(), grads):
        w = want[key].numpy()
        assert np.abs(got.numpy() - w).max() <= 1e-5 * max(np.abs(w).max(), 1e-6), key


@pytest.mark.parametrize("name,policy", [
    *(pytest.param(name, "full", id=name) for name in sorted(CONFIGS)),
    pytest.param("tiny_linear", "dots", id="tiny_linear-dots")])  # heads run outside remat
def test_remat_gives_the_same_gradients(name, policy):
    name, _, variables, port = _models(name)
    remat = _port(name, variables, remat=True, remat_policy=policy)
    img1, img2, _, _ = _forward_inputs(4)
    grads = []
    for model in (port, remat):
        r1, r2 = model(torch.from_numpy(img1), torch.from_numpy(img2), symmetrized=True)
        grads.append(torch.autograd.grad(_scalar(r1, r2, torch), list(model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_dots_remat_gradients_match_jax():
    """The port's "dots" remat against JAX's TINY `remat=True,
    remat_policy="dots"` (tests/test_scan_layers.py's case, on the per-layer
    blocks): outputs and every gradient at
    test_training_forward_and_gradients_match_jax's tolerance."""
    name, _, variables, _ = _models("tiny_linear")
    jmodel = JaxModel(**CONFIGS[name], attn_impl="ref", remat=True, remat_policy="dots")
    port = _port(name, variables, remat=True, remat_policy="dots")
    img1, img2, _, _ = _forward_inputs(5)

    def scalar_and_outputs(params):
        out = jmodel.apply({"params": params}, jnp.asarray(img1), jnp.asarray(img2),
                           symmetrized=True)
        return _scalar(*out, jnp), out

    (_, (jr1, jr2)), jgrad = jax.jit(jax.value_and_grad(scalar_and_outputs, has_aux=True))(
        variables["params"])
    r1, r2 = port(torch.from_numpy(img1), torch.from_numpy(img2), symmetrized=True)
    for key, ours, theirs in (("pts3d", r1, jr1), ("conf", r1, jr1), ("conf", r2, jr2),
                              ("pts3d_in_other_view", r2, jr2)):
        assert_model_close(ours[key].detach().numpy(), theirs[key])
    names = dict(port.named_parameters())
    grads = torch.autograd.grad(_scalar(r1, r2, torch), list(names.values()))
    cfg = CONFIGS[name]
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrad)}, cfg["enc_depth"],
                               cfg["dec_depth"], cfg["head_type"])
    for (key, _), got in zip(names.items(), grads):
        w = want[key].numpy()
        assert np.abs(got.numpy() - w).max() <= 1e-5 * max(np.abs(w).max(), 1e-6), key


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dots_saves_the_block_gemms_and_nothing_else(dtype, monkeypatch):
    """The policy's own record: an encoder block saves its four GEMM
    outputs (qkv, proj, fc1, fc2), a decoder block its eight (qkv, proj,
    projq, projk, projv, proj, fc1, fc2), in the body's dtype; the heads
    and the rest of the model run outside remat. `--remat 0 --remat_policy
    dots` is no remat: no block is checkpointed and nothing is recorded."""
    import dust3r_tpu_torch.models.model as model_module

    cfg = dict(CONFIGS["tiny_linear"], enc_depth=1, dec_depth=1)
    B, (H, W) = 2, HW
    n_enc, n_dec = 2 * B * (H // 16) * (W // 16), B * (H // 16) * (W // 16)
    ce, cd = cfg["enc_embed_dim"], cfg["dec_embed_dim"]
    calls = []
    real = model_module.checkpoint
    monkeypatch.setattr(model_module, "checkpoint",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    img = torch.from_numpy(np.random.default_rng(0).standard_normal((B, H, W, 3),
                                                                   dtype=np.float32))
    for remat in (True, False):
        calls.clear()
        model = AsymmetricCroCo3DStereo(**cfg, device="cpu", dtype=dtype, remat=remat,
                                        remat_policy="dots")
        model.dots_policy.record = []
        r1, r2 = model(img, img.flip(0))
        record = list(model.dots_policy.record)
        (r1["pts3d"].sum() + r2["conf"].sum()).backward()
        assert model.dots_policy.record == record  # the recompute saves nothing more
        if not remat:
            assert calls == [] and record == []
            continue
        assert len(calls) == 3 and all("context_fn" in kw for kw in calls)
        mm = "aten.addmm.default"
        want = [(mm, (n_enc, 3 * ce), dtype), (mm, (n_enc, ce), dtype),
                (mm, (n_enc, 4 * ce), dtype), (mm, (n_enc, ce), dtype)]
        for _ in range(2):  # dec_blocks.0, then dec_blocks2.0
            want += [(mm, (n_dec, 3 * cd), dtype)] + [(mm, (n_dec, cd), dtype)] * 5 + [
                (mm, (n_dec, 4 * cd), dtype), (mm, (n_dec, cd), dtype)]
        assert record == want
        assert all(p.grad is not None for p in model.parameters())


def test_scan_layout_bridges_to_the_port():
    """A JAX TINY model built with scan_layers=True (its blocks stacked),
    seeded: the port loaded from its stacked tree gives its forward."""
    cfg = CONFIGS["tiny_linear"]
    jmodel = JaxModel(**cfg, attn_impl="ref", scan_layers=True)
    variables = seeded_variables(jmodel, 23, HW)
    assert "enc_blocks_scan" in variables["params"]
    port = AsymmetricCroCo3DStereo(**cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, cfg["enc_depth"], cfg["dec_depth"],
                                             cfg["head_type"]), strict=True)
    img1, img2, _, _ = _forward_inputs(6)
    jr1, jr2 = jmodel.apply(variables, jnp.asarray(img1), jnp.asarray(img2))
    with torch.no_grad():
        r1, r2 = port(torch.from_numpy(img1), torch.from_numpy(img2))
    for key, ours, theirs in (("pts3d", r1, jr1), ("conf", r1, jr1), ("conf", r2, jr2),
                              ("pts3d_in_other_view", r2, jr2)):
        assert_model_close(ours[key].numpy(), theirs[key])


# ---------------------------------------------------------------------- #
# the step
# ---------------------------------------------------------------------- #

def _view(rng, B, portrait):
    H, W = HW
    K = np.float32([[40, 0, W / 2], [0, 40, H / 2], [0, 0, 1]])
    pose = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    pose[:, :3, 3] = rng.standard_normal((B, 3))
    depth = rng.uniform(1, 3, (B, H, W)).astype(np.float32)
    true_shape = np.tile(np.int32([H, W]), (B, 1))
    true_shape[portrait] = [W, H]
    return dict(img=rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32), depthmap=depth,
                camera_intrinsics=np.tile(K, (B, 1, 1)), camera_pose=pose,
                valid_mask=rng.uniform(size=(B, H, W)) > 0.2, true_shape=true_shape,
                instance=[f"i{k}" for k in range(B)])


def _loader_batches(seed, n, B=2):
    """n loader batches (view1, view2) of B pairs, each with a portrait
    sample (so each step takes the ManyAR path, one JAX program)."""
    rng = np.random.default_rng(seed)
    return [(_view(rng, B, [True] + [False] * (B - 1)), _view(rng, B, [False] * B))
            for _ in range(n)]


def _jax_step_batch(group):
    sym = [jtraining.add_manyar_flags(*jtraining.make_batch_symmetric(v1, v2))
           for v1, v2 in group]
    if any("is_portrait" in v1 for v1, _ in sym):
        sym = [jtraining.add_manyar_flags(v1, v2, force=True) if "is_portrait" not in v1
               else (v1, v2) for v1, v2 in sym]
    return jtraining.stack_accum_batches(sym)


@pytest.fixture
def jax_decays(monkeypatch):
    """The JAX step with the weight decay it means to apply. Its
    `make_optimizer` hands `wd_mask` to `optax.inject_hyperparams`, which
    takes a callable argument for a schedule of the step count: the mask
    becomes wd_mask(count), a scalar False, and AdamW decays nothing
    (`test_jax_adamw_decays_nothing`). Passed as a static argument, the
    mask is the tree of wd_mask(params) it is meant to be."""
    def make_optimizer(spec):
        return optax.inject_hyperparams(optax.adamw, static_args=("mask",))(
            learning_rate=0.0, b1=spec.betas[0], b2=spec.betas[1],
            weight_decay=spec.weight_decay, mask=jtraining.wd_mask)

    monkeypatch.setattr(jtraining, "make_optimizer", make_optimizer)


_STEPS = {}


def _jax_step(jspec):
    """`build_train_step`'s jitted step of the tiny linear model for the
    spec's (accum_iter, freeze), built and compiled once a module run (the
    specs of this file differ in nothing else; every caller runs under
    `jax_decays`)."""
    key = jspec.accum_iter, jspec.freeze
    if key not in _STEPS:
        _STEPS[key] = jtraining.build_train_step(
            _models("tiny_linear")[1], jtraining.build_criterion(CRITERION), jspec,
            symmetrized=True)
    return _STEPS[key]


def _spec_pair(accum, **kw):
    args = dict(lr=1e-4, min_lr=1e-6, warmup_epochs=1, epochs=4, weight_decay=0.05,
                accum_iter=accum, amp=False, **kw)
    return jtraining.TrainSpec(**args), training.TrainSpec(**args)


# an fp32 gradient is float noise below ~1e-4 of its tensor's largest, and
# AdamW normalizes each element's update: such an element may move by up
# to the LR whatever the noise
NOISE_FLOOR = 1e-4


def _track_noisy(port, noisy):
    """Mark the elements whose gradient of this step is below the floor."""
    for k, p in port.named_parameters():
        mask = (p.grad.abs() < NOISE_FLOOR * p.grad.abs().max()).numpy()
        noisy[k] = mask if k not in noisy else noisy[k] | mask
    return noisy


def _params_close(port, jparams, name, lr_sum=0.0, noisy=None):
    """Every parameter within 1e-6 of its largest |value| of JAX's, but the
    elements in `noisy` (a gradient below NOISE_FLOOR of its tensor's
    largest at some step): those within `lr_sum`, the sum of the steps'
    LRs, and at most 1e-5 of all elements outside 1e-6."""
    cfg = CONFIGS[name]
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, jparams)},
                               cfg["enc_depth"], cfg["dec_depth"], cfg["head_type"])
    n_out = n_all = 0
    for key, got in port.state_dict().items():
        w = want[key].numpy()
        err = np.abs(got.numpy() - w)
        near = noisy[key] if noisy else np.zeros(w.shape, bool)
        tight = 1e-6 * max(np.abs(w).max(), 1e-6)
        assert err[~near].max(initial=0) <= tight, key
        assert err[near].max(initial=0) <= lr_sum, key
        n_out, n_all = n_out + (err[near] > tight).sum(), n_all + err.size
    assert n_out <= 1e-5 * n_all


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum, jax_decays):
    name = "tiny_linear"
    jmodel = JaxModel(**CONFIGS[name], attn_impl="ref")
    variables = seeded_variables(jmodel, 23, HW)
    port = _port(name, variables)
    jspec, spec = _spec_pair(accum)
    step_fn = _jax_step(jspec)
    state = jtraining.init_train_state(variables, jspec)
    optimizer = training.make_optimizer(port, spec)
    criterion = build_criterion(CRITERION)
    loader = _loader_batches(accum, 3 * accum)
    noisy = {k: np.zeros(p.shape, bool) for k, p in port.named_parameters()}
    lr_sum = 0.0
    for step in range(3):
        group = loader[step * accum:(step + 1) * accum]
        epoch_f = 0.3 * step + 0.1
        state, jm = step_fn(state, _jax_step_batch(group), jnp.asarray(epoch_f))
        batches = training.symmetric_micro_batches(group, torch.device("cpu"), None)
        assert "is_portrait" in batches[0][0]
        m = training.train_step(port, optimizer, criterion, batches, epoch_f, spec)
        # the grad norm 2e-6: JAX sums the squares in fp32 leaf after leaf,
        # 7e-7 relative off its fp64 sum on these gradients
        for key, rtol in (("loss", 1e-6), ("lr", 1e-6), ("grad_norm", 2e-6)):
            np.testing.assert_allclose(m[key], float(jm[key]), rtol=rtol, err_msg=key)
        assert m["skipped"] == 0.0
        lr_sum += m["lr"]
        _track_noisy(port, noisy)
        if step in (0, 2):
            _params_close(port, state["params"]["params"], name, 2 * lr_sum, noisy)
    # weight decay on exactly JAX's wd_mask
    mask = jax.tree.map(lambda p: np.full(p.shape, float(p.ndim > 1), np.float32),
                        variables["params"])
    cfg = CONFIGS[name]
    mask_sd = state_dict_from_jax({"params": mask}, cfg["enc_depth"], cfg["dec_depth"],
                                  cfg["head_type"])
    decayed = {id(p) for p in optimizer.param_groups[0]["params"]}
    for key, p in port.named_parameters():
        assert bool(mask_sd[key].all()) == (id(p) in decayed) == training.decays(p), key
        assert bool(mask_sd[key].any()) == bool(mask_sd[key].all())


def test_nan_batch_skips_the_step_as_jax_does(jax_decays):
    name = "tiny_linear"
    jmodel = JaxModel(**CONFIGS[name], attn_impl="ref")
    variables = seeded_variables(jmodel, 29, HW)
    port = _port(name, variables)
    jspec, spec = _spec_pair(1)
    optimizer = training.make_optimizer(port, spec)
    criterion = build_criterion(CRITERION)
    good, bad = _loader_batches(5, 2)
    bad[0]["img"][0, 0, 0, 0] = np.nan
    m = training.train_step(port, optimizer, criterion,
                            training.symmetric_micro_batches([good], "cpu", None), 0.5, spec)
    noisy = _track_noisy(port, {})
    params = {k: v.clone() for k, v in port.state_dict().items()}
    opt_state = {k: (v["step"].clone(), v["exp_avg"].clone(), v["exp_avg_sq"].clone())
                 for k, v in optimizer.state.items()}
    m = training.train_step(port, optimizer, criterion,
                            training.symmetric_micro_batches([bad], "cpu", None), 0.6, spec)
    assert m["skipped"] == 1.0 and not np.isfinite(m["loss"])
    for k, v in port.state_dict().items():
        assert torch.equal(v, params[k]), k
    for k, v in optimizer.state.items():
        assert all(torch.equal(a, b) for a, b in zip(
            (v["step"], v["exp_avg"], v["exp_avg_sq"]), opt_state[k]))
    # JAX: the same step leaves its state as it was
    step_fn = _jax_step(jspec)
    state = jtraining.init_train_state(variables, jspec)
    state, _ = step_fn(state, _jax_step_batch([good]), jnp.asarray(0.5))
    before = jax.tree.map(np.asarray, state["params"])
    state, jm = step_fn(state, _jax_step_batch([bad]), jnp.asarray(0.6))
    assert float(jm["skipped"]) == 1.0
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                 state["params"], before)
    _params_close(port, state["params"]["params"], name, 2 * m["lr"], noisy)


def test_frozen_encoder_still_decays_as_in_jax(jax_decays):
    name = "tiny_linear"
    jmodel = JaxModel(**CONFIGS[name], attn_impl="ref")
    variables = seeded_variables(jmodel, 31, HW)
    port = _port(name, variables)
    jspec, spec = _spec_pair(1, freeze="encoder")
    before = {k: v.clone() for k, v in port.state_dict().items()}
    w = "enc_blocks.0.attn.qkv.weight"
    optimizer = training.make_optimizer(port, spec)
    step_fn = _jax_step(jspec)
    state = jtraining.init_train_state(variables, jspec)
    fmask = training.freeze_mask(port, "encoder")
    noisy, lr_sum = {}, 0.0
    for step, group in enumerate(_loader_batches(7, 2)):
        state, _ = step_fn(state, _jax_step_batch([group]), jnp.asarray(1.5 + 0.1 * step))
        m = training.train_step(port, optimizer, build_criterion(CRITERION),
                                training.symmetric_micro_batches([group], "cpu", None),
                                1.5 + 0.1 * step, spec, fmask=fmask)
        lr_sum += m["lr"]
        if step == 0:
            after_one = port.state_dict()[w].clone()
        _track_noisy(port, noisy)
    _params_close(port, state["params"]["params"], name, 2 * lr_sum, noisy)
    assert float(fmask[w]) == 0.0
    # no gradient: each step decays it alone, by lr * weight_decay
    lr0 = training.cosine_warmup_lr(1.5, 1e-4, 1e-6, 1, 4)
    torch.testing.assert_close(after_one, before[w] * (1 - 0.05 * lr0))
    torch.testing.assert_close(port.state_dict()[w],
                               after_one * (1 - 0.05 * optimizer.param_groups[0]["lr"]))


def test_jax_adamw_decays_nothing():
    """A fault of the reference: the JAX optimizer's update of a zero
    gradient is 0 for every parameter, matrices included; the port's
    AdamW decays the matrices by lr * weight_decay, as the reference's
    torch AdamW does and as the JAX step means to."""
    spec_j, spec = _spec_pair(1)
    params = {"params": {"w": jnp.ones((2, 2)), "b": jnp.ones(2)}}
    opt = jtraining.make_optimizer(spec_j)
    state = opt.init(params)
    state.hyperparams["learning_rate"] = 0.1
    updates, _ = opt.update(jax.tree.map(jnp.zeros_like, params), state, params)
    assert all(not np.asarray(u).any() for u in jax.tree.leaves(updates))
    w, b = torch.nn.Parameter(torch.ones(2, 2)), torch.nn.Parameter(torch.ones(2))
    optimizer = training.make_optimizer(torch.nn.ParameterList([w, b]), spec)
    optimizer.param_groups[0]["lr"] = optimizer.param_groups[1]["lr"] = 0.1
    w.grad, b.grad = torch.zeros_like(w), torch.zeros_like(b)
    optimizer.step()
    assert torch.equal(w.detach(), torch.full((2, 2), 1 - 0.1 * 0.05))
    assert torch.equal(b.detach(), torch.ones(2))


def test_cosine_warmup_lr_matches_jax():
    for epoch_f in np.linspace(0, 6, 50):
        for warm in (0, 2):
            want = float(jtraining.cosine_warmup_lr(jnp.float32(epoch_f), 1e-3, 1e-6, warm, 6))
            np.testing.assert_allclose(training.cosine_warmup_lr(float(epoch_f), 1e-3, 1e-6,
                                                                 warm, 6), want, rtol=1e-6,
                                       atol=1e-6 * 1e-3)
