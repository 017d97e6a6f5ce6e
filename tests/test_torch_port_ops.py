"""The port's RoPE and attention against the JAX package on the CPU.

Inputs come from a seeded numpy generator and go through both packages:
the JAX `attention_ref`, the JAX Pallas `fused_attention` in interpret mode
(set up as tests/test_pallas_interpret.py does), and the port's plain
version, kernel wrapper and dispatcher. On CPU tensors the wrapper runs the
kernel's plain version; the CUDA kernel itself is checked on the card by
tests/test_torch_port_kernels.py and chip_smoke.py. Tolerance 1e-5 in fp32.
"""
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust3r_tpu.ops.attention import attention_ref as jax_attention_ref
from dust3r_tpu.ops.pallas_attention import _rope_tables as jax_rope_tables
from dust3r_tpu.ops.rope import apply_rope2d as jax_apply_rope2d
from dust3r_tpu_torch.ops.attention import attention
from dust3r_tpu_torch.ops.fused_attention import (CORES, _kernel_tables, attention_ref,
                                                 fused_attention, kernel_heads_per_program,
                                                 route)
from dust3r_tpu_torch.ops.rope import apply_rope2d, rope_tables

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def fused_interpret():
    os.environ["DUST3R_TPU_PALLAS_INTERPRET"] = "1"
    import dust3r_tpu.ops.pallas_attention as pa
    importlib.reload(pa)
    yield pa.fused_attention
    del os.environ["DUST3R_TPU_PALLAS_INTERPRET"]
    importlib.reload(pa)


def _inputs(seed, B, H, Nq, Nk, d, rope):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Nq, d)).astype(np.float32)
    k = rng.standard_normal((B, H, Nk, d)).astype(np.float32)
    v = rng.standard_normal((B, H, Nk, d)).astype(np.float32)
    if rope:
        pq = rng.integers(0, 8, (B, Nq, 2)).astype(np.int32)
        pk = rng.integers(0, 8, (B, Nk, 2)).astype(np.int32)
    else:
        pq = pk = None
    return q, k, v, pq, pk


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("d", [16, 24, 32])
def test_apply_rope2d_matches_jax(d):
    q, _, _, pq, _ = _inputs(d, 2, 3, 20, 20, d, rope=True)
    ours = apply_rope2d(torch.from_numpy(q), torch.from_numpy(pq)).numpy()
    theirs = np.asarray(jax_apply_rope2d(jnp.asarray(q), jnp.asarray(pq)))
    np.testing.assert_allclose(ours, theirs, **TOL)


@pytest.mark.parametrize("d", [16, 64])
def test_rope_tables_match_jax(d):
    _, _, _, pq, _ = _inputs(d, 2, 1, 30, 30, d, rope=True)
    cos, sin = rope_tables(torch.from_numpy(pq), d, 100.0)
    jcos, jsin = jax_rope_tables(jnp.asarray(pq), d, 100.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), **TOL)


CASES = {  # name: (Nq, Nk, rope)
    "self_rope": (40, 40, True),
    "cross_no_rope": (24, 56, False),
    "cross_rope": (24, 56, True),
}


@pytest.mark.parametrize("d", [16, 24, 32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_attention_matches_jax_ref_and_pallas(fused_interpret, case, d):
    Nq, Nk, rope = CASES[case]
    q, k, v, pq, pk = _inputs(100 * sorted(CASES).index(case) + d, 2, 3, Nq, Nk, d, rope)
    jax_ref = np.asarray(jax_attention_ref(_j(q), _j(k), _j(v), _j(pq), _j(pk)))
    pallas = np.asarray(fused_interpret(_j(q), _j(k), _j(v), _j(pq), _j(pk)))
    args = (_t(q), _t(k), _t(v), _t(pq), _t(pk))
    before = fused_attention.launches
    for ours in (attention_ref(*args), fused_attention(*args),
                 attention(*args, impl="kernel"), attention(*args, impl="plain"),
                 attention(*args)):
        assert ours.shape == (2, 3, Nq, d) and ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), jax_ref, **TOL)
        np.testing.assert_allclose(ours.numpy(), pallas, **TOL)
    # CPU tensors take the plain version: no kernel launch is counted
    assert fused_attention.launches == before


def test_dispatcher_rejects_unknown_impl():
    q = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError, match="impl"):
        attention(q, q, q, impl="pallas")


@pytest.mark.parametrize("bad", ["meta_device", "head_dim"])
def test_wrapper_raises_instead_of_falling_back(bad):
    """Off the CPU the wrapper launches the kernel or raises: a tensor that is
    neither on the CPU nor on a CUDA device is refused before anything runs
    (tests/test_torch_port_kernels.py checks the refusals on the card)."""
    d = 16 if bad == "meta_device" else 40
    q = torch.zeros(1, 2, 8, d, device="meta")
    before = fused_attention.launches
    with pytest.raises(ValueError):
        fused_attention(q, q, q)
    assert fused_attention.launches == before


def test_wrapper_builds_rope_tables_once_per_positions_tensor(monkeypatch):
    """The kernel's fp32 tables are rope_tables'; the wrapper takes a
    caller's tables as they are, and the model builds them once per
    positions tensor of a forward (encode: one; decode: one per view),
    whatever its depth."""
    from dust3r_tpu_torch.models import model as model_mod

    _, _, _, pos, _ = _inputs(7, 2, 1, 12, 12, 16, rope=True)
    pos = torch.from_numpy(pos)
    cos, sin = _kernel_tables(pos, None, 16, 100.0)
    want_cos, want_sin = rope_tables(pos, 16, 100.0)
    assert torch.equal(cos, want_cos) and torch.equal(sin, want_sin)
    assert _kernel_tables(pos, (want_cos, want_sin), 16, 100.0)[0] is want_cos
    with pytest.raises(ValueError, match="rope tables"):
        _kernel_tables(pos, rope_tables(pos, 32, 100.0), 16, 100.0)

    built = []

    def counting_rope_tables(positions, head_dim, base=100.0):
        built.append((tuple(positions.shape), head_dim))
        return rope_tables(positions, head_dim, base)

    monkeypatch.setattr(model_mod, "rope_tables", counting_rope_tables)
    model = model_mod.AsymmetricCroCo3DStereo(
        img_size=(32, 32), patch_size=16, enc_embed_dim=32, enc_depth=3,
        enc_num_heads=2, dec_embed_dim=48, dec_depth=4, dec_num_heads=2, device="cpu")
    img = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 32, 48, 3)).astype(np.float32))
    with torch.no_grad():
        model(img, img)
    assert built == [((2, 6, 2), 16), ((1, 6, 2), 24), ((1, 6, 2), 24)]


ROUTES = {  # (dtype, head dim, heads a block): the core that serves the call on the
    # card and the heads a block its kernel runs (the mma.sync core's bf16
    # kernel: the largest of 4, 2, 1 dividing G)
    ("bf16", 64, 1): ("sm90", 1),
    ("bf16", 64, 2): ("sm90", 2),
    ("bf16", 64, 4): ("sm90", 4),
    ("bf16", 64, 8): ("sm90", 8),
    ("bf16", 64, 3): ("sm90", 3),
    ("bf16", 32, 1): ("mma", 1),
    ("bf16", 32, 8): ("mma", 4),
    ("bf16", 32, 6): ("mma", 2),
    ("bf16", 24, 1): ("mma", 1),
    ("bf16", 16, 1): ("mma", 1),
    ("bf16", 16, 3): ("mma", 1),
    ("fp32", 64, 1): ("mma", 1),
    ("fp32", 16, 2): ("mma", 2),
}
DTYPES = dict(bf16=torch.bfloat16, fp32=torch.float32)


@pytest.mark.parametrize("key", sorted(ROUTES), ids=lambda k: "-".join(map(str, k)))
def test_route_sends_bf16_head_dim_64_single_heads_to_the_sm90_kernel(key):
    """bf16 at d = 64 goes to the sm90 kernel at any heads a block, the rest
    to the mma.sync core at the largest of 4, 2, 1 heads a block dividing
    G."""
    dtype, d, G = key
    core = route(DTYPES[dtype], d)
    assert (core, kernel_heads_per_program(core, G)) == ROUTES[key]


def test_the_published_models_attend_through_the_sm90_kernel():
    """Every attention call of the published models (bf16 body, head dim
    1024 / 16 and 768 / 12, one head a block) routes to the sm90 kernel."""
    from dust3r_tpu_torch.models.model import NAMED_MODELS

    for name, make in NAMED_MODELS.items():
        m = make(device="meta")
        for blk in list(m.enc_blocks) + list(m.dec_blocks) + list(m.dec_blocks2):
            for attn in [blk.attn] + ([blk.cross_attn] if hasattr(blk, "cross_attn") else []):
                dim = (attn.qkv.in_features if hasattr(attn, "qkv") else
                       attn.projq.in_features)
                assert route(torch.bfloat16, dim // attn.num_heads) == "sm90", name


@pytest.mark.parametrize("core", (None,) + CORES)
def test_every_core_takes_the_plain_version_on_the_cpu(core):
    """On CPU tensors a call asks no core to run: bf16 at d = 64 (the sm90
    kernel's calls) gives the plain version's bits, which hold to the JAX
    reference in fp32, and no launch is counted."""
    q, k, v, pq, pk = _inputs(11, 2, 3, 20, 28, 64, rope=True)
    args = [_t(x) for x in (q, k, v)]
    before = (fused_attention.launches, fused_attention.core_launches)
    bf16 = [a.to(torch.bfloat16) for a in args]
    got = fused_attention(*bf16, _t(pq), _t(pk), core=core)
    assert torch.equal(got, attention_ref(*bf16, _t(pq), _t(pk)))
    got32 = fused_attention(*args, _t(pq), _t(pk), core=core)
    want = np.asarray(jax_attention_ref(_j(q), _j(k), _j(v), _j(pq), _j(pk)))
    np.testing.assert_allclose(got32.numpy(), want, **TOL)
    assert (fused_attention.launches, fused_attention.core_launches) == before


def test_wrapper_refuses_an_unknown_core():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="core"):
        fused_attention(q, q, q, core="wgmma")
