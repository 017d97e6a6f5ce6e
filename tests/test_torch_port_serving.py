"""The port's serving configuration (`--serving`: bf16 body, bf16 heads,
int8 block GEMMs) against the JAX package's on the CPU: the bf16 heads'
accuracy contract, the model against JAX at (bf16 body, bf16 heads), the
plain versions of the head kernels' bf16 modes against their JAX
counterparts at bf16, and the CLIs' flags.

Weights come from a seeded numpy fill of the JAX tree carried over by
`state_dict_from_jax`; inputs from seeded numpy generators. The port runs
its plain versions (CPU tensors). Tolerances, each with its reason:
  * the contract of `tests/test_heads.py:41-71` (bf16 heads at most double
    the bf16 body's pointmap noise; the head dtype alone costs at most 1.5x
    the body's), on the port;
  * port against JAX at (bf16, bf16): within max(2x JAX's own distance from
    the fp32 forward, 2e-3): both round at other places in bf16 (the fp32
    forward is the port's, which tests/test_torch_port_model.py holds to
    JAX's within 1e-4);
  * conv3x3 at bf16 against XLA's bf16 conv: 2 bf16 units of max |y| (both
    round y once; XLA's bf16 conv may also round its sums); against the
    Pallas kernel (interpret mode), which rounds its per-tap sums Z to bf16
    and sums the taps dy in bf16: 4 units;
  * up2x at bf16 against the JAX lerp, which rounds to bf16 between the two
    axes: 2 units; against the JAX default (bf16 interpolation matrices):
    6e-3 of max |y|, the bf16 rounding of the weights;
  * the tail at bf16 (the bf16 chain) against JAX's bf16 head chain: 2e-2
    relative RMS of pts3d after the exp postprocess amplifies the raw
    channels' bf16 rounding; the kernel's function (fp32 after conv2) within
    the same of it.
"""
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust3r_tpu.models import heads as jheads
from dust3r_tpu.models.model import AsymmetricCroCo3DStereo as JaxModel
from dust3r_tpu.ops.conv3x3 import conv3x3_ref as jax_conv3x3_ref
from dust3r_tpu_torch.checkpoint import save_torch_checkpoint, state_dict_from_jax
from dust3r_tpu_torch.models.model import AsymmetricCroCo3DStereo
from dust3r_tpu_torch.ops import quant
from dust3r_tpu_torch.ops.conv3x3 import conv3x3_bf16_ref
from dust3r_tpu_torch.ops.dpt_tail import dpt_tail_bf16_ref, dpt_tail_ref
from dust3r_tpu_torch.ops.upsample import up2x_ref

# tests/test_heads.py's TINY, cut to the fewest layers each head takes (the
# DPT hooks need dec_depth > 9), so that JAX compiles each forward in seconds
TINY = dict(img_size=(32, 48), patch_size=16, enc_embed_dim=64, enc_depth=1, enc_num_heads=2,
            dec_embed_dim=48, dec_num_heads=2)
DEC_DEPTH = dict(dpt=10, linear=2)
HW = (32, 48)
BF16_UNIT = 2.0 ** -7  # one bf16 unit of a value, relative to it (at most)
BF16 = torch.bfloat16


def _rel_rmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b ** 2)), 1e-12))


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _np(t):
    return t.float().numpy()


def seeded_params(model, seed):
    """The JAX tree filled from a seeded numpy generator: kernels N(0,
    1/fan_in), biases and LayerNorm offsets N(0, 0.1^2), scales 1 + N(0,
    0.1^2); shapes from `jax.eval_shape` (a trace, no compile)."""
    img = jnp.zeros((1, *HW, 3), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), img, img)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1].key == "kernel":
            std = float(np.prod(leaf.shape[:-1])) ** -0.5
            return (std * rng.standard_normal(leaf.shape)).astype(np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module", params=["dpt", "linear"])
def setup(request):
    head_type = request.param
    cfg = dict(TINY, head_type=head_type, dec_depth=DEC_DEPTH[head_type])
    jmodel = JaxModel(attn_impl="ref", **cfg)
    params = seeded_params(jmodel, 0)
    sd = state_dict_from_jax(params, cfg["enc_depth"], cfg["dec_depth"], head_type)
    rng = np.random.default_rng(1)
    img1, img2 = (rng.standard_normal((2, *HW, 3)).astype(np.float32) for _ in range(2))

    outs = {}

    def port(dtype, head_dtype):  # view 1's outputs, each configuration run once
        if (dtype, head_dtype) not in outs:
            model = AsymmetricCroCo3DStereo(dtype=dtype, head_dtype=head_dtype, device="cpu",
                                            **cfg)
            model.load_state_dict(sd)
            with torch.no_grad():
                outs[dtype, head_dtype] = model(torch.from_numpy(img1),
                                                torch.from_numpy(img2))[0]
        return outs[dtype, head_dtype]

    return head_type, jmodel, params, img1, img2, port


def test_bf16_heads_hold_the_contract_on_the_port(setup):
    """tests/test_heads.py:41-71 on the port: (bf16, bf16) within 2x the
    bf16 body's pointmap and confidence noise; bf16 heads on the fp32 body
    within 1.5x the body's (dpt only, as there)."""
    head_type, _, _, _, _, port = setup
    r_ff, r_bf, r_bb = port(torch.float32, torch.float32), port(BF16, torch.float32), \
        port(BF16, BF16)
    for r in (r_ff, r_bf, r_bb):
        assert r["pts3d"].dtype == r["conf"].dtype == torch.float32  # postprocess in fp32
    body = _rel_rmse(r_bf["pts3d"], r_ff["pts3d"])
    serving = _rel_rmse(r_bb["pts3d"], r_ff["pts3d"])
    assert serving <= max(2.0 * body, 2e-3), (serving, body)
    assert _rel_rmse(r_bb["conf"], r_ff["conf"]) <= max(
        2.0 * _rel_rmse(r_bf["conf"], r_ff["conf"]), 2e-3)
    if head_type == "dpt":
        head = _rel_rmse(port(torch.float32, BF16)["pts3d"], r_ff["pts3d"])
        assert head <= max(1.5 * body, 2e-3), (head, body)


def test_serving_dtypes_match_jax(setup):
    """(bf16 body, bf16 heads): the port within max(2x JAX's own distance
    from the fp32 forward, 2e-3) of JAX's, pointmaps and confidences."""
    _, jmodel, params, img1, img2, port = setup
    want_bb = jax.jit(jmodel.clone(dtype=jnp.bfloat16, head_dtype=jnp.bfloat16).apply)(
        params, jnp.asarray(img1), jnp.asarray(img2))[0]
    want, got = port(torch.float32, torch.float32), port(BF16, BF16)
    for key in ("pts3d", "conf"):
        own = _rel_rmse(want_bb[key], want[key])
        assert _rel_rmse(got[key], want_bb[key]) <= max(2.0 * own, 2e-3), key


@pytest.fixture(scope="module")
def pallas_conv():
    os.environ["DUST3R_TPU_PALLAS_INTERPRET"] = "1"
    import dust3r_tpu.ops.conv3x3 as jconv
    importlib.reload(jconv)
    yield jconv._conv3x3_pallas_raw
    del os.environ["DUST3R_TPU_PALLAS_INTERPRET"]
    importlib.reload(jconv)


@pytest.mark.parametrize("bias", [False, True])
def test_conv3x3_bf16_mode_matches_jax(pallas_conv, bias):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 10, 64)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 64, 32)) / np.sqrt(9 * 64)).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32) if bias else None
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(BF16)  # channels_last memory
    got = conv3x3_bf16_ref(xt, torch.from_numpy(w).permute(3, 2, 0, 1),
                           None if b is None else torch.from_numpy(b))
    assert got.dtype == BF16 and got.is_contiguous(memory_format=torch.channels_last)
    got = _np(got.permute(0, 2, 3, 1))
    xla = np.asarray(jax_conv3x3_ref(xj, jnp.asarray(w), None if b is None else jnp.asarray(b)),
                     np.float32)
    assert _max_rel(got, xla) <= 2 * BF16_UNIT
    pallas = np.asarray(pallas_conv(xj, jnp.asarray(w)), np.float32)
    if b is not None:
        pallas = np.asarray(jnp.asarray(pallas).astype(jnp.bfloat16)
                            + jnp.asarray(b).astype(jnp.bfloat16), np.float32)
    assert _max_rel(got, pallas) <= 4 * BF16_UNIT


@pytest.mark.parametrize("shape", [(1, 1, 8), (5, 3, 16), (12, 16, 8)])
def test_up2x_bf16_mode_matches_jax(shape):
    H, W, C = shape
    x = np.random.default_rng(H * 100 + W).standard_normal((2, H, W, C)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    got = up2x_ref(torch.from_numpy(x).permute(0, 3, 1, 2).to(BF16))
    assert got.dtype == BF16 and got.shape == (2, C, 2 * H, 2 * W)
    got = _np(got.permute(0, 2, 3, 1))
    fp32 = _np(up2x_ref(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    xr = np.asarray(xj, np.float32)  # the bf16 input, exactly
    fp32_of_bf16 = _np(up2x_ref(torch.from_numpy(xr).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    assert _max_rel(got, fp32_of_bf16) <= BF16_UNIT  # fp32 lerps, rounded once
    lerp = np.asarray(jheads.upsample2x_align_corners(xj, impl="lerp"), np.float32)
    assert _max_rel(got, lerp) <= 2 * BF16_UNIT
    matmul = np.asarray(jheads.upsample2x_align_corners(xj, impl="matmul"), np.float32)
    assert _max_rel(got, matmul) <= 6e-3
    assert _max_rel(got, fp32) <= 2 * BF16_UNIT


def test_tail_bf16_mode_matches_jax_head_chain():
    """JAX's bf16 head end: Conv3x3 (bf16) -> ReLU -> Conv1x1 (bf16) -> fp32
    postprocess (`heads.py:369-375`), against `dpt_tail_ref` on bf16 y (the
    same chain) and `dpt_tail_bf16_ref` (the kernel's function)."""
    rng = np.random.default_rng(4)
    y = (0.5 * rng.standard_normal((2, 12, 20, 128))).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, 128, 32)) / np.sqrt(9 * 128)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(32)).astype(np.float32)
    w3 = (0.3 * rng.standard_normal((1, 1, 32, 4))).astype(np.float32)
    b3 = (0.1 * rng.standard_normal(4)).astype(np.float32)
    yj = jnp.asarray(y).astype(jnp.bfloat16)
    h = jheads.Conv3x3(32, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": jnp.asarray(w2), "bias": jnp.asarray(b2)}}, yj)
    o = jheads.Conv1x1(4, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": jnp.asarray(w3), "bias": jnp.asarray(b3)}}, jax.nn.relu(h))
    want = jheads.postprocess(o.astype(jnp.float32), ("exp", -np.inf, np.inf),
                              ("exp", 1.0, np.inf))
    args = (torch.from_numpy(y).permute(0, 3, 1, 2).to(BF16),
            torch.from_numpy(w2).permute(3, 2, 0, 1), torch.from_numpy(b2),
            torch.from_numpy(w3).permute(3, 2, 0, 1), torch.from_numpy(b3), 1.0)
    for fn in (dpt_tail_ref, dpt_tail_bf16_ref):
        pts, conf = fn(*args)
        assert pts.dtype == conf.dtype == torch.float32
        assert _rel_rmse(pts, want["pts3d"]) <= 2e-2, fn.__name__
        assert _rel_rmse(conf, want["conf"]) <= 2e-2, fn.__name__


@pytest.fixture(scope="module")
def tiny_weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("serving") / "tiny.pth"
    model = AsymmetricCroCo3DStereo(img_size=(64, 64), enc_embed_dim=32, enc_depth=1,
                                    enc_num_heads=2, dec_embed_dim=32, dec_depth=1,
                                    dec_num_heads=2, head_type="linear", device="cpu")
    save_torch_checkpoint(str(path), model)
    return str(path)


class _Built(Exception):
    pass


def _engines(monkeypatch):
    """Record the engines the CLIs build, then stop them."""
    import dust3r_tpu_torch.inference as inference

    built, real = [], inference.InferenceEngine

    def engine(model, *args, **kw):
        built.append(real(model, *args, **kw))
        raise _Built
    monkeypatch.setattr(inference, "InferenceEngine", engine)
    return built


@pytest.mark.parametrize("flags, dtypes", [
    (["--serving"], (BF16, BF16)),
    (["--quantize", "int8"], (torch.float32, torch.float32)),
])
def test_clis_build_an_int8_engine(tiny_weights, monkeypatch, flags, dtypes):
    """With --device cpu, --serving gives a quantized engine on a bf16 body
    and bf16 heads (as the JAX CLIs do); --quantize int8 a quantized fp32
    model; --mesh 2 is refused where fewer than two cards are visible, with
    the JAX CLIs' message."""
    import builtins

    from dust3r_tpu_torch import demo
    from dust3r_tpu_torch.visloc import cli

    monkeypatch.setattr(builtins, "print", builtins.print)  # the demo stamps print
    built = _engines(monkeypatch)
    runs = ((demo.main, ["--weights", tiny_weights, "--device", "cpu", "--silent"]),
            (cli.main, ["--dataset", "None", "--weights", tiny_weights, "--device", "cpu"]))
    for main, argv in runs:
        with pytest.raises(_Built):
            main(argv + flags)
        model = built[-1].model
        assert quant.is_quantized(model)
        assert (model.dtype, model.head_dtype) == dtypes
        assert next(model.parameters()).device == torch.device("cpu")
        n = torch.cuda.device_count() + 1
        with pytest.raises(ValueError, match=f"--mesh {n} requested but only {n - 1} devices"):
            main(argv + flags + ["--mesh", str(n)])
    assert len(built) == 2
