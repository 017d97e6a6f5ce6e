"""The port's blocks, heads, weight bridge and whole model against the JAX
package on the CPU.

JAX parameter trees are filled from a seeded numpy generator and carried
into the port by `state_dict_from_jax`; inputs come from a seeded numpy
generator and go through both packages. The port runs its plain versions (CPU tensors).
Tolerances: 1e-5 for the blocks and the linear head; 2e-4 normalized by
mean |x| for the DPT head (as tests/test_golden.py holds its DPT goldens);
1e-4 normalized by mean |x| for the whole model, where the exp depth map
amplifies float noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust3r_tpu.checkpoint import to_torch_state_dict
from dust3r_tpu.models import blocks as jblocks
from dust3r_tpu.models import heads as jheads
from dust3r_tpu.models.model import AsymmetricCroCo3DStereo as JaxModel
from dust3r_tpu_torch.checkpoint import state_dict_from_jax
from dust3r_tpu_torch.models import blocks, heads
from dust3r_tpu_torch.models.model import AsymmetricCroCo3DStereo, NAMED_MODELS

TOL = dict(rtol=1e-5, atol=1e-5)


def assert_model_close(ours, theirs):
    """rtol = atol = 1e-4 on outputs scaled by their mean |x|: seeded random
    weights drive expm1(|xyz|) to values near 1e2, so float noise that is
    1e-5 of the largest value exceeds a fixed atol on the small ones."""
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    scale = max(float(np.abs(theirs).mean()), 1e-6)
    np.testing.assert_allclose(ours / scale, theirs / scale, rtol=1e-4, atol=1e-4)

# tests/test_golden.py TINY (linear head) and the DPT config of
# scripts/make_goldens.py (real DPT hooks at dec_depth 12), at 32x48
CONFIGS = {
    "tiny_linear": dict(img_size=(32, 32), patch_size=16, enc_embed_dim=64,
                        enc_depth=2, enc_num_heads=2, dec_embed_dim=48,
                        dec_depth=2, dec_num_heads=2, head_type="linear"),
    "small_dpt": dict(img_size=(512, 512), patch_size=16, head_type="dpt",
                      enc_embed_dim=128, enc_depth=4, enc_num_heads=4,
                      dec_embed_dim=96, dec_depth=12, dec_num_heads=4),
}
IMG_HW = (32, 48)


def jax_model(name):
    return JaxModel(**CONFIGS[name], attn_impl="ref")


def images(seed, B=1, hw=IMG_HW):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, *hw, 3)).astype(np.float32) for _ in range(2)]


def seeded_variables(model, seed, hw=IMG_HW):
    """The JAX model's parameter tree, filled from a seeded numpy generator:
    kernels N(0, 1/fan_in), biases and LayerNorm offsets N(0, 0.1^2), LayerNorm
    scales 1 + N(0, 0.1^2), so that a bias or a scale the bridge misplaces
    shows. Shapes come from `jax.eval_shape` (a trace, no compile)."""
    img = jnp.zeros((1, *hw, 3), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), img, img)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            std = float(np.prod(leaf.shape[:-1])) ** -0.5
            return (std * rng.standard_normal(leaf.shape)).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(config name, JAX model, JAX variables as numpy, loaded port model)."""
    name = request.param
    cfg = CONFIGS[name]
    model = jax_model(name)
    variables = seeded_variables(model, 12)
    port = AsymmetricCroCo3DStereo(**cfg, device="cpu").eval()
    sd = state_dict_from_jax(variables, cfg["enc_depth"], cfg["dec_depth"],
                             cfg["head_type"])
    port.load_state_dict(sd, strict=True)
    return name, model, variables, port


def test_state_dict_matches_jax_exporter(pair):
    name, _, variables, port = pair
    cfg = CONFIGS[name]
    ours = state_dict_from_jax(variables, cfg["enc_depth"], cfg["dec_depth"],
                               cfg["head_type"])
    theirs = to_torch_state_dict(variables, cfg["enc_depth"], cfg["dec_depth"],
                                 cfg["head_type"])
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    # the port's own names are the exporter's names, and nothing is left over
    assert sorted(port.state_dict()) == sorted(theirs)


def test_whole_model_matches_jax(pair):
    _, model, variables, port = pair
    img1, img2 = images(2, B=2)
    jr1, jr2 = jax.jit(model.apply)(variables, jnp.asarray(img1), jnp.asarray(img2))
    with torch.no_grad():
        r1, r2 = port(torch.from_numpy(img1), torch.from_numpy(img2))
    assert r1["pts3d"].shape == (2, *IMG_HW, 3) and r2["conf"].shape == (2, *IMG_HW)
    for ours, theirs in ((r1["pts3d"], jr1["pts3d"]), (r1["conf"], jr1["conf"]),
                         (r2["pts3d_in_other_view"], jr2["pts3d_in_other_view"]),
                         (r2["conf"], jr2["conf"])):
        assert_model_close(ours.numpy(), theirs)


def test_encode_decode_split_matches_forward(pair):
    """Mixed shapes take separate encoder batches; the stage methods the
    inference engine calls give the forward's result."""
    port = pair[3]
    rng = np.random.default_rng(3)
    img1 = torch.from_numpy(rng.standard_normal((1, 32, 48, 3)).astype(np.float32))
    img2 = torch.from_numpy(rng.standard_normal((1, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        r1, r2 = port(img1, img2)
        f1, p1 = port.encode(img1)
        f2, p2 = port.encode(img2)
        d1, d2 = port.decode(f1, p1, f2, p2)
        h1, h2 = port.head(1, d1, (32, 48)), port.head(2, d2, (32, 32))
    assert h1["pts3d"].shape == (1, 32, 48, 3) and h2["pts3d"].shape == (1, 32, 32, 3)
    torch.testing.assert_close(h1["pts3d"], r1["pts3d"], rtol=0, atol=0)
    torch.testing.assert_close(h2["pts3d"], r2["pts3d_in_other_view"], rtol=0, atol=0)
    torch.testing.assert_close(h2["conf"], r2["conf"], rtol=0, atol=0)


def test_encoder_block_matches_jax(pair):
    name, _, variables, port = pair
    cfg = CONFIGS[name]
    dim, heads_ = cfg["enc_embed_dim"], cfg["enc_num_heads"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, dim)).astype(np.float32)
    pos = np.array(jblocks.token_positions(2, 2, 3))
    jblk = jblocks.Block(dim, heads_, attn_impl="ref")
    want = jblk.apply({"params": variables["params"]["enc_blocks_1"]},
                      jnp.asarray(x), jnp.asarray(pos))
    with torch.no_grad():
        got = port.enc_blocks[1](torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(blocks.token_positions(2, 2, 3).numpy(), pos)


def test_decoder_block_matches_jax(pair):
    """Cross-attention between a 2x3 and a 2x2 token grid (Nq != Nk)."""
    name, _, variables, port = pair
    cfg = CONFIGS[name]
    dim, heads_ = cfg["dec_embed_dim"], cfg["dec_num_heads"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, dim)).astype(np.float32)
    y = rng.standard_normal((2, 4, dim)).astype(np.float32)
    xpos = np.array(jblocks.token_positions(2, 2, 3))
    ypos = np.array(jblocks.token_positions(2, 2, 2))
    jblk = jblocks.DecoderBlock(dim, heads_, attn_impl="ref")
    want, _ = jblk.apply({"params": variables["params"]["dec_blocks2_0"]},
                         *map(jnp.asarray, (x, y, xpos, ypos)))
    with torch.no_grad():
        got, same_y = port.dec_blocks2[0](*map(torch.from_numpy, (x, y, xpos, ypos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(same_y.numpy(), y)


def _decout(cfg, seed, B=2, hw=IMG_HW):
    n = (hw[0] // 16) * (hw[1] // 16)
    rng = np.random.default_rng(seed)
    dims = [cfg["enc_embed_dim"]] + [cfg["dec_embed_dim"]] * cfg["dec_depth"]
    return [rng.standard_normal((B, n, c)).astype(np.float32) for c in dims]


def test_head_matches_jax(pair):
    """LinearPts3d (tiny_linear) or DPTHead (small_dpt), head 2."""
    name, _, variables, port = pair
    cfg = CONFIGS[name]
    decout = _decout(cfg, 6)
    modes = dict(depth_mode=("exp", -np.inf, np.inf), conf_mode=("exp", 1, np.inf))
    if cfg["head_type"] == "linear":
        jhead = jheads.LinearPts3d(16, modes["depth_mode"], modes["conf_mode"])
        assert isinstance(port.downstream_head2, heads.LinearPts3d)
    else:
        jhead = jheads.DPTHead(16, modes["depth_mode"], modes["conf_mode"],
                               hooks=(0, 6, 9, 12))
        assert isinstance(port.downstream_head2, heads.DPTHead)
    want = jhead.apply({"params": variables["params"]["downstream_head2"]},
                       [jnp.asarray(t) for t in decout], IMG_HW)
    with torch.no_grad():
        got = port.downstream_head2([torch.from_numpy(t) for t in decout], IMG_HW)
    for key in ("pts3d", "conf"):
        a, b = got[key].numpy(), np.asarray(want[key])
        if cfg["head_type"] == "linear":
            np.testing.assert_allclose(a, b, **TOL)
        else:
            scale = max(float(np.abs(b).mean()), 1e-6)
            np.testing.assert_allclose(a / scale, b / scale, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mode", [("exp", -np.inf, np.inf), ("linear", -np.inf, np.inf),
                                  ("square", -np.inf, np.inf)])
def test_postprocess_matches_jax(mode):
    rng = np.random.default_rng(7)
    fmap = rng.standard_normal((2, 4, 5, 4)).astype(np.float32)
    conf_mode = ("exp", 1, np.inf)
    want = jheads.postprocess(jnp.asarray(fmap), mode, conf_mode)
    got = heads.postprocess(torch.from_numpy(fmap), mode, conf_mode)
    for key in ("pts3d", "conf"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gelu_and_layernorm_follow_the_dtype(dtype):
    """Exact-erf GELU in fp32 and tanh GELU in bf16, as the JAX blocks do;
    LayerNorm computes in fp32 and returns the input dtype."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jblocks.gelu(jnp.asarray(x, jdt)).astype(jnp.float32))
    got = blocks.gelu(torch.from_numpy(x).to(dtype)).float().numpy()
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got, want, **tol)
    ln = blocks.LayerNormF32(16)
    assert ln(torch.from_numpy(x).to(dtype)).dtype == dtype


def test_bf16_body_keeps_fp32_heads():
    """The body computes in bf16, the heads in fp32 on fp32 tokens."""
    cfg = CONFIGS["tiny_linear"]
    port = AsymmetricCroCo3DStereo(**cfg, dtype=torch.bfloat16, seed=3, device="cpu").eval()
    img1, img2 = (torch.from_numpy(a) for a in images(9))
    with torch.no_grad():
        f, pos = port.encode(img1)
        assert f.dtype == torch.bfloat16 and pos.dtype == torch.int32
        r1, r2 = port(img1, img2)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert r1["pts3d"].dtype == torch.float32 and r2["conf"].dtype == torch.float32
    assert torch.isfinite(r1["pts3d"]).all() and (r2["conf"] >= 1).all()


def test_seeded_init_is_reproducible():
    cfg = CONFIGS["tiny_linear"]
    a = AsymmetricCroCo3DStereo(**cfg, seed=5, device="cpu").state_dict()
    b = AsymmetricCroCo3DStereo(**cfg, seed=5, device="cpu").state_dict()
    c = AsymmetricCroCo3DStereo(**cfg, seed=6, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["enc_blocks.0.attn.qkv.weight"],
                           c["enc_blocks.0.attn.qkv.weight"])


def test_named_models_are_the_published_configs():
    assert sorted(NAMED_MODELS) == ["DUSt3R_ViTLarge_BaseDecoder_224_linear",
                                    "DUSt3R_ViTLarge_BaseDecoder_512_dpt",
                                    "DUSt3R_ViTLarge_BaseDecoder_512_linear"]
    # built on the meta device: full width without allocating it here
    m = NAMED_MODELS["DUSt3R_ViTLarge_BaseDecoder_512_dpt"](device="meta")
    assert (m.img_size, m.enc_depth, m.dec_depth, m.head_type) == ((512, 512), 24, 12, "dpt")
    assert m.enc_blocks[0].attn.qkv.weight.shape == (3 * 1024, 1024)
    assert m.dec_blocks2[0].cross_attn.projq.weight.shape == (768, 768)
    assert not hasattr(m.downstream_head1.dpt.scratch.refinenet4, "resConfUnit1")
