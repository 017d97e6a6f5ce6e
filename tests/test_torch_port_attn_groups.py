"""heads_per_program as the JAX kernel resolves it, on the CPU.

The JAX `fused_attention` (dust3r_tpu/ops/pallas_attention.py) takes any
heads_per_program: None picks `_auto_heads_per_program` (the largest of 8,
4, 2 dividing H whose softmax tiles fit its VMEM budget), and any positive
G is halved until it divides H. The port copies that rule into
`resolve_heads_per_program`. Here it is held to the G the JAX kernel really
runs, read off its `pallas_call` (the grid is B * H / G programs) in a
traced jaxpr, over a grid of heads, token counts and G; and the port's
`fused_attention` is held to the JAX kernel run in TPU interpret mode at the
same G. On CPU tensors the wrapper returns its plain version, so what the
second test shows is that every G the JAX kernel serves is served, with the
JAX answer; the kernels' G are held bit for bit to G = 1 on the card by
tests/test_torch_port_kernels.py and chip_smoke.py.

Tolerances, max abs error over max |JAX output|, as `_held` in
tests/test_torch_port_attn_variants.py: fp32 1e-5, the same arithmetic with
fp32 sums in another order; bf16 2^-7, one bf16 unit of the largest output
(the JAX kernel sums P after rounding it to bf16, the plain versions
before). In bf16 the JAX kernel is held to `attention_variant_ref(...,
"exact")`, which rotates in fp32 as the kernels do (`attention_ref` rotates
in bf16, as the JAX `attention_ref` does).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dust3r_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from dust3r_tpu_torch.ops.attention_variants import attention_variant_ref
from dust3r_tpu_torch.ops.fused_attention import (attention_ref, fused_attention,
                                                 resolve_heads_per_program)

HEADS = (4, 6, 8, 12, 16)
TOKENS = (196, 672, 768)
GS = (None, 1, 2, 3, 4, 5, 6, 8, 16)
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": 1e-5, "bf16": 2.0 ** -7}


def _pallas_call(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            return eqn
        for param in eqn.params.values():
            found = _pallas_call(param.jaxpr) if hasattr(param, "jaxpr") else None
            if found is not None:
                return found
    return None


def _jax_heads_per_program(H, Nq, Nk, G):
    """The heads a program of the JAX kernel's `pallas_call`: B * H over its
    grid, from a trace (no compute)."""
    q = jax.ShapeDtypeStruct((1, H, Nq, 64), jnp.bfloat16)
    k = jax.ShapeDtypeStruct((1, H, Nk, 64), jnp.bfloat16)
    jaxpr = jax.make_jaxpr(
        lambda a, b, c: jax_fused_attention(a, b, c, heads_per_program=G))(q, k, k)
    (programs,) = _pallas_call(jaxpr.jaxpr).params["grid_mapping"].grid
    return H // programs


@pytest.mark.parametrize("N", TOKENS)
@pytest.mark.parametrize("H", HEADS)
def test_resolution_is_the_jax_kernels(H, N):
    """Self-attention at N tokens, and cross-attention of N queries on 672
    keys: every G of the grid resolves to the JAX kernel's."""
    for Nk in sorted({N, 672}):
        for G in GS:
            assert resolve_heads_per_program(H, N, Nk, G) == _jax_heads_per_program(H, N, Nk, G), \
                (H, N, Nk, G)


@pytest.mark.parametrize("G", [0, -1, -4, 2.0, 1.5, "2", True])
def test_resolution_refuses_what_jax_cannot_serve(G):
    with pytest.raises(ValueError, match="positive integer"):
        resolve_heads_per_program(6, 48, 48, G)


def _grid_positions(b, h=6, w=8):
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([ys.ravel(), xs.ravel()], -1)[None].repeat(b, 0).astype(np.int32)


def _rel(ours, theirs):
    ours = ours.float().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    theirs = np.asarray(theirs, np.float32)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    return float(np.abs(ours - theirs).max() / np.abs(theirs).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("G", [None, 3, 4, 5, 8])
@pytest.mark.parametrize("H", [6, 16])
def test_port_serves_every_heads_per_program_jax_serves(H, G, dtype):
    B, N, D = 2, 48, 64
    rng = np.random.default_rng(H * 10 + (G or 0))
    arrays = [rng.standard_normal((B, H, N, D)).astype(np.float32) for _ in range(3)]
    pos = _grid_positions(B)
    jdt, tdt = DTYPES[dtype]
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrays)
    tpos = torch.from_numpy(pos)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fused_attention(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos),
                                   heads_per_program=G)
    before = (fused_attention.launches, fused_attention.core_launches)
    ours = fused_attention(tq, tk, tv, tpos, tpos, heads_per_program=G)
    assert (fused_attention.launches, fused_attention.core_launches) == before
    assert ours.shape == (B, H, N, D) and ours.dtype == tdt
    assert torch.equal(ours, attention_ref(tq, tk, tv, tpos, tpos))
    assert _rel(attention_variant_ref(tq, tk, tv, tpos, tpos, 100.0, "exact"), want) <= TOL[dtype]
    if dtype == "fp32":  # attention_ref rotates in bf16 for bf16 tokens
        assert _rel(ours, want) <= TOL[dtype]
