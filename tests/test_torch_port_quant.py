"""The port's int8 serving mode (`dust3r_tpu_torch/ops/quant.py`) against
the JAX package's (`dust3r_tpu/ops/quant.py`) on the CPU.

Inputs and weights come from seeded numpy generators and go through both
packages; the port runs its plain versions (CPU tensors). The JAX side's
intermediates (xq, the int32 product) are its `QuantDense` steps written
out with the same jnp operations. Tolerances, each with its reason:
  * fp32 x: xq and the int32 product bit for bit (the same IEEE
    operations), y within 1e-6 relative (XLA may fuse the fp32 epilogue);
  * bf16 x: xq equal but where XLA's excess precision skips the rounding of
    x * inv_r to bf16 and moves a tie: at most 1e-3 of the entries, each
    off by 1; y within one bf16 unit of max |y| (2^-7 of it);
  * the conversion bit for bit (`quantize_linear` divides as JAX does);
  * the quantized model in fp32 within 1e-5 relative of JAX's;
  * the accuracy contract of `tests/test_quant.py` on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust3r_tpu.models.model import AsymmetricCroCo3DStereo as JaxModel
from dust3r_tpu.ops.quant import QuantDense, quantize_dense_params, quantize_params
from dust3r_tpu_torch.checkpoint import state_dict_from_jax
from dust3r_tpu_torch.inference import InferenceEngine
from dust3r_tpu_torch.models.model import AsymmetricCroCo3DStereo
from dust3r_tpu_torch.ops import quant

# tests/test_quant.py's `_tiny_model`
TINY = dict(img_size=(32, 32), enc_embed_dim=64, enc_depth=2, enc_num_heads=4,
            dec_embed_dim=48, dec_depth=2, dec_num_heads=4, head_type="linear")
BF16_UNIT = 2.0 ** -7  # one bf16 unit of a value, relative to it (at most)


def _relerr(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _jax_steps(x, kernel_q):
    """QuantDense's xq and int32 product (dust3r_tpu/ops/quant.py:72-84)."""
    amax = jnp.max(jnp.abs(x), axis=-1, keepdims=True)
    inv = 126.0 / jnp.maximum(amax.astype(jnp.float32), 1e-12)
    inv_r = inv.astype(x.dtype)
    xq = jnp.clip(jnp.round(x * inv_r), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(xq, kernel_q, (((x.ndim - 1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    return np.asarray(xq), np.asarray(acc)


def _dense(seed, K=64, N=96):
    rng = np.random.default_rng(seed)
    kernel = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    bias = (0.1 * rng.standard_normal(N)).astype(np.float32)
    return kernel, bias


def _port_linear(kernel, bias, dtype):
    from dust3r_tpu_torch.models.blocks import Linear

    lin = Linear(kernel.shape[0], kernel.shape[1], dtype=dtype)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(kernel.T))
        lin.bias.copy_(torch.from_numpy(bias))
    return quant.quantize_linear(lin)


def test_quant_linear_matches_quant_dense_in_fp32():
    kernel, bias = _dense(0)
    x = np.random.default_rng(1).standard_normal((4, 17, 64)).astype(np.float32)
    qp = quantize_dense_params({"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)})
    want = np.asarray(QuantDense(96).apply({"params": qp}, jnp.asarray(x)))
    xq_j, acc_j = _jax_steps(jnp.asarray(x), qp["kernel_q"])

    q = _port_linear(kernel, bias, torch.float32)
    xt = torch.from_numpy(x).reshape(-1, 64)
    xq, inv_r = quant.quantize_rows(xt)
    acc = quant.int8_matmul(xq, q.weight_q)
    np.testing.assert_array_equal(xq.numpy(), xq_j.reshape(-1, 64))
    np.testing.assert_array_equal(acc.numpy(), acc_j.reshape(-1, 96))
    got = q(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # the plain chain is the wrappers' function on the CPU
    ref = quant.quant_linear_ref(torch.from_numpy(x), q.weight_q, q.weight_scale, q.bias,
                                 torch.float32)
    assert torch.equal(ref, torch.from_numpy(got))


def test_quant_linear_matches_quant_dense_in_bf16():
    kernel, bias = _dense(2)
    x32 = np.random.default_rng(3).standard_normal((8, 64, 64)).astype(np.float32)
    xj = jnp.asarray(x32).astype(jnp.bfloat16)
    qp = quantize_dense_params({"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)})
    want = np.asarray(QuantDense(96, dtype=jnp.bfloat16).apply({"params": qp}, xj),
                      np.float32)
    xq_j, _ = _jax_steps(xj, qp["kernel_q"])

    q = _port_linear(kernel, bias, torch.bfloat16)
    xt = torch.from_numpy(x32).to(torch.bfloat16)
    xq, _ = quant.quantize_rows(xt.reshape(-1, 64))
    diff = np.abs(xq.numpy().astype(np.int32) - xq_j.reshape(-1, 64).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, ((diff > 0).sum(), diff.max())
    got = q(xt)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - want).max() <= BF16_UNIT * np.abs(want).max()


def test_zero_token_stays_finite():
    kernel, bias = _dense(4, K=8, N=16)
    q = _port_linear(kernel, bias, torch.float32)
    for dt in (torch.float32, torch.bfloat16):
        out = q(torch.zeros(2, 3, 8, dtype=dt))
        assert torch.isfinite(out).all()
        assert torch.equal(out[0, 0], q.bias)  # a zero token gives the bias


def seeded_params(model, seed):
    """The JAX model's parameter tree filled from a seeded numpy generator
    (kernels N(0, 1/fan_in), biases and LayerNorm offsets N(0, 0.1^2),
    scales 1 + N(0, 0.1^2)); shapes from `jax.eval_shape`, a trace with no
    compile."""
    img = jnp.zeros((1, 32, 32, 3), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), img, img)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1].key == "kernel":
            std = float(np.prod(leaf.shape[:-1])) ** -0.5
            return jnp.asarray((std * rng.standard_normal(leaf.shape)).astype(np.float32))
        base = 1.0 if path[-1].key == "scale" else 0.0
        return jnp.asarray((base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def tiny():
    """The tiny JAX model, its fp32 params, two image batches, the port's
    fp32 model on the same weights, and JAX's quantized params."""
    jmodel = JaxModel(**TINY, attn_impl="ref")
    rng = np.random.default_rng(0)
    img1, img2 = (rng.standard_normal((2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    params = seeded_params(jmodel, 2)
    port = AsymmetricCroCo3DStereo(**TINY, device="cpu")
    port.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params),
                                             TINY["enc_depth"], TINY["dec_depth"], "linear"))
    # quantize_params as written, op by op: under jit XLA multiplies by 1/127
    # where it divides by 127, a unit of the last place away on some scales
    return jmodel, params, img1, img2, port, quantize_params(params)


def _port_copy(port, **kw):
    model = AsymmetricCroCo3DStereo(**TINY, device="cpu", **kw)
    model.load_state_dict(port.state_dict())
    return model


def test_conversion_equals_quantize_params_bit_for_bit(tiny):
    """41 int8 tensors on the tiny config (tests/test_quant.py:82-99), each
    with its scale and bias equal to the JAX conversion's; every tensor
    the conversion does not target left bit for bit."""
    _, _, _, _, port, qparams = tiny
    before = {k: v.clone() for k, v in port.state_dict().items()}
    qmodel = quant.quantize_for_inference(_port_copy(port))
    sd = qmodel.state_dict()
    want = state_dict_from_jax(jax.tree.map(np.asarray, qparams),
                               TINY["enc_depth"], TINY["dec_depth"], "linear")
    assert sorted(sd) == sorted(want)
    assert sum(v.dtype == torch.int8 for v in sd.values()) == 8 + 32 + 1
    for k, v in sd.items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
        if not k.endswith(("weight_q", "weight_scale")) and not (
                k.endswith(".bias") and k[:-len(".bias")] + ".weight_q" in sd):
            assert torch.equal(v, before[k]), k
    assert quant.is_quantized(qmodel) and not quant.is_quantized(port)


def test_quantized_model_matches_jax_and_holds_the_accuracy_contract(tiny):
    """Quantized by JAX and carried over by `state_dict_from_jax`, the
    port's forward matches JAX's quantized forward within 1e-5 relative in
    fp32; the int8 pointmaps lie within max(4x the bf16 body's error, 2e-2)
    of the fp32 forward, the confidence within 2e-2 (tests/test_quant.py)."""
    jmodel, _, img1, img2, port, qparams = tiny
    j1, j2 = jax.jit(jmodel.clone(quant=True).apply)(qparams, jnp.asarray(img1),
                                                     jnp.asarray(img2))
    qmodel = quant.quantize_for_inference(_port_copy(port))
    qmodel.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, qparams),
                                               TINY["enc_depth"], TINY["dec_depth"],
                                               "linear"))
    t1, t2 = torch.from_numpy(img1), torch.from_numpy(img2)
    with torch.no_grad():
        q1, q2 = qmodel(t1, t2)
        r1, r2 = port(t1, t2)
        b1, b2 = _port_copy(port, dtype=torch.bfloat16)(t1, t2)
    for key, ours, theirs in (("pts3d", q1, j1), ("conf", q1, j1),
                              ("pts3d_in_other_view", q2, j2), ("conf", q2, j2)):
        assert _relerr(ours[key].numpy(), theirs[key]) <= 1e-5, key
    for key, q, r, b in (("pts3d", q1, r1, b1), ("pts3d_in_other_view", q2, r2, b2)):
        e_q, e_b = _relerr(q[key], r[key]), _relerr(b[key].float(), r[key])
        assert e_q < max(4 * e_b, 2e-2), (key, e_q, e_b)
    assert _relerr(q1["conf"], r1["conf"]) < 2e-2


def test_engine_converts_keeps_and_refuses(tiny):
    _, _, _, _, port, _ = tiny
    model = _port_copy(port)
    engine = InferenceEngine(model, batch_size=2, quantize="int8")
    assert engine.model is model and quant.is_quantized(model)
    kept = dict(model.named_modules())
    again = InferenceEngine(model, batch_size=2, quantize="int8")  # already quantized
    assert all(again.model.get_submodule(k) is m for k, m in kept.items())
    with pytest.raises(ValueError, match="quantize mode"):
        InferenceEngine(_port_copy(port), quantize="int4")
    rng = np.random.default_rng(0)
    views = [dict(img=rng.standard_normal((1, 32, 32, 3)).astype(np.float32),
                  true_shape=np.int32([[32, 32]]), idx=i, instance=str(i)) for i in range(3)]
    from dust3r_tpu_torch.image_pairs import make_pairs

    pairs = make_pairs(views, "complete", symmetrize=True)
    out = engine.infer_pairs(pairs)
    assert out["pred1"]["pts3d"].shape == (len(pairs), 32, 32, 3)
    assert np.isfinite(out["pred1"]["pts3d"]).all()


def test_quantized_model_refuses_to_train(tiny):
    from dust3r_tpu_torch.training import TrainSpec, make_optimizer, train_step

    _, _, _, _, port, _ = tiny
    model = quant.quantize_for_inference(_port_copy(port))
    spec = TrainSpec(lr=1e-4, min_lr=0.0, warmup_epochs=0, epochs=1, weight_decay=0.05,
                     accum_iter=1, amp=False)
    with pytest.raises(ValueError, match="inference-only"):
        train_step(model, make_optimizer(model, spec), None, [{}], 0.0, spec)


@pytest.mark.parametrize("rows,K,N", [(16, 64, 64), (32, 60, 64), (32, 64, 60)])
def test_int8_matmul_names_what_int_mm_refuses(rows, K, N):
    """Off the CPU `int8_matmul` is `torch._int_mm`, which takes more than 16
    rows and K, N multiples of 8; another shape raises with that reason
    before the call (here on `meta` tensors: the check runs for any device
    but the CPU). JAX's `QuantDense` takes any shape (ROADMAP.md §C)."""
    xq = torch.empty(rows, K, dtype=torch.int8, device="meta")
    wq = torch.empty(N, K, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match=rf"more than 16 rows and K, N multiples of 8: got "
                                         rf"xq \({rows}, {K}\), wq \({N}, {K}\)"):
        quant.int8_matmul(xq, wq)
