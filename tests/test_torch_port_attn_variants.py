"""The TPU attention variants (kernel rows 3-9) against the port's plain
versions on the CPU, the plain attention against the JAX one in bf16, and
the model's attention modules handing the kernel views of their projections.

The TPU kernels are the experiment scripts' Pallas kernels, loaded from
`scripts/` by path (it is no package) and run in TPU interpret mode
(`pltpu.force_tpu_interpret_mode()`), with no edit to the scripts:
  * row 3, `exp_attn_r2.attn_g` (G heads a program; the attention modes);
  * row 4, `exp_attn_variants.build(kern)` for `kern_base`, `kern_bf16exp`
    and `kern_bf16s` (its module globals B, H, N, d set on the loaded
    module);
  * row 5, `exp_attn_vmem_r2.make_kernel(variant, G, scale)` under the
    `pallas_call` specs of its `run` (which times itself, so it is not
    called);
  * row 6, `exp_attn_dma_r2.attn_dma` on a raw (B, N, 3C) qkv;
  * row 7, `exp_attn_layout_r2.attn_qkv_layout` on the same;
  * row 8, `scripts/bench_attn3.py` runs at import and calls `_attn_kernel`
    without the arguments it now requires, so it is not loaded: its call
    meant `dust3r_tpu.ops.pallas_attention.fused_attention(...,
    heads_per_program=1)` on random positions in [0, 48), run here;
  * row 9, `exp_softmax_r2.attn` with safe=True and safe=False.
Their port counterparts run on CPU tensors, so the wrappers return their
plain versions (the kernels are checked on the card by
tests/test_torch_port_kernels.py and chip_smoke.py): `fused_attention`
with heads_per_program G and strided views for rows 3, 5, 6, 7 and 8 and
row 9's safe softmax, `attention_variant` for rows 4 and 9's variants.

Tolerances, max abs error over max |ref|:
  * fp32, 1e-5: the same arithmetic, fp32 sums in another order;
  * fp32, row 4's bf16 variants, 2^-8: those kernels round (s - max) (and
    bf16s the logits) to bf16 even for fp32 inputs, so a logit one fp32
    unit apart in the two packages flips a rounding (1 of 18,432 elements
    in these inputs), which moves that P by one bf16 unit, 2^-8 of it;
  * bf16, 2^-7, one bf16 unit of the largest output: the TPU kernels sum P
    after rounding it to bf16 (the ones-column fold, `pbf16`), the plain
    version before, a change of at most 2^-9 of the denominator, which can
    move a bf16 output by one unit in its last place. In bf16 the rows are
    held to `attention_variant_ref(..., softmax="exact")`, which rotates
    in fp32 as the TPU kernels do (`attention_ref` rotates in bf16, as the
    JAX `attention_ref` does).
"""
import importlib.util
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dust3r_tpu.ops.attention import attention_ref as jax_attention_ref
from dust3r_tpu.ops.pallas_attention import _rope_tables
from dust3r_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from dust3r_tpu_torch.models import blocks
from dust3r_tpu_torch.ops import attention_variants as variants
from dust3r_tpu_torch.ops.attention_variants import (SOFTMAXES, attention_variant,
                                                     attention_variant_ref)
from dust3r_tpu_torch.ops.fused_attention import (attention_ref, fused_attention,
                                                 resolve_heads_per_program)

SCRIPTS = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "scripts")
B, H, N, D = 2, 4, 48, 64  # a 6x8 token grid
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": 1e-5, "bf16": 2.0 ** -7}
BF16_ROUNDING_TOL = 2.0 ** -8  # row 4's bf16 variants in fp32


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_tpu_{name}", osp.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tpu():
    """The experiment scripts holding TPU rows 3, 4, 5, 6, 7 and 9."""
    return {row: _script(name) for row, name in (
        (3, "exp_attn_r2"), (4, "exp_attn_variants"), (5, "exp_attn_vmem_r2"),
        (6, "exp_attn_dma_r2"), (7, "exp_attn_layout_r2"), (9, "exp_softmax_r2"))}


def _grid_positions(b=B, h=6, w=8):
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([ys.ravel(), xs.ravel()], -1)[None].repeat(b, 0).astype(np.int32)


def _inputs(seed, heads=H, scale=1.0):
    rng = np.random.default_rng(seed)
    return [scale * rng.standard_normal((B, heads, N, D)).astype(np.float32) for _ in range(3)]


def _both(arrays, dtype):
    """The same values as JAX arrays and torch tensors of `dtype` (both
    round fp32 to bf16 to nearest even)."""
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _rel(ours, theirs):
    ours = ours.float().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    theirs = np.asarray(theirs, np.float32)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    return float(np.abs(ours - theirs).max() / np.abs(theirs).max())


def _held(tpu_out, dtype, tq, tk, tv, pos_q, pos_k=None, heads_per_program=1, softmax="exact",
          tol=None):
    """Hold a TPU row's output (B, H, N, d) to the port: the wrapper on CPU
    tensors (`fused_attention` for the exact softmax, else
    `attention_variant`) and `attention_variant_ref`."""
    pos_k = pos_q if pos_k is None else pos_k
    tol = TOL[dtype] if tol is None else tol
    ref = attention_variant_ref(tq, tk, tv, pos_q, pos_k, 100.0, softmax)
    if softmax == "exact":
        ours = fused_attention(tq, tk, tv, pos_q, pos_k, heads_per_program=heads_per_program)
    else:
        ours = attention_variant(tq, tk, tv, pos_q, pos_k, softmax=softmax,
                                 heads_per_program=heads_per_program)
    assert _rel(ref, tpu_out) <= tol
    if dtype == "fp32" or softmax != "exact":  # attention_ref rotates in bf16
        assert _rel(ours, tpu_out) <= tol


# ---------------------------------------------------------------------- #
# the repair: plain attention with fp32 logits, as the JAX one
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("onednn", [True, False], ids=["onednn", "native"])
@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_plain_attention_matches_jax_in_bf16(scale, onednn):
    """bf16 logits (a bf16 matmul) put the port's plain attention 5.7e-3
    (scale 1) and 2.1e-2 (scale 3) of max |out| away from the JAX one at
    these inputs; fp32 logits from the upcast rotated q and k, as the JAX
    einsum keeps them, bring it to 7.1e-4 and 2.9e-4 (one bf16 unit of an
    output, where a last rounding differs). P.v takes fp32 sums as the
    JAX einsum does, so the CPU's bf16 matmul path (oneDNN or not; the
    native one rounds differently) does not move the result."""
    rng = np.random.default_rng(int(scale))
    q, k, v = (scale * rng.standard_normal((2, 4, 96, 64)).astype(np.float32)
               for _ in range(3))
    pos = _grid_positions(2, 8, 12)
    (jq, jk, jv), (tq, tk, tv) = _both([q, k, v], "bf16")
    want = jax_attention_ref(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos))
    with torch.backends.mkldnn.flags(enabled=onednn):
        ours = attention_ref(tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(pos))
    assert ours.dtype == torch.bfloat16
    assert _rel(ours, want.astype(jnp.float32)) <= 1e-3


# ---------------------------------------------------------------------- #
# rows 3-9 in interpret mode
# ---------------------------------------------------------------------- #

ROW3_CASES = [(1, "plain"), (2, "plain"), (4, "plain"), (2, "ropemm"), (2, "sumcol"),
              (4, "pbf16")]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("G,mode", ROW3_CASES)
def test_row3_heads_per_program(tpu, G, mode, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(3), dtype)
    pos = _grid_positions()
    with pltpu.force_tpu_interpret_mode():
        out = tpu[3].attn_g(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos), G, mode=mode)
    _held(out, dtype, tq, tk, tv, torch.from_numpy(pos), heads_per_program=G)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kern,softmax", [("kern_base", "exact"), ("kern_bf16exp", "bf16_exp"),
                                          ("kern_bf16s", "bf16_logits")])
def test_row4_softmax_precision(tpu, kern, softmax, dtype):
    module = tpu[4]
    module.B, module.H, module.N, module.d = B, H, N, D  # build() reads them
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(4), dtype)
    pos = _grid_positions()
    cq, sq = _rope_tables(jnp.asarray(pos), D, 100.0)
    with pltpu.force_tpu_interpret_mode():
        out = module.build(getattr(module, kern))(jq, jk, jv, cq, sq, cq, sq)
    tol = BF16_ROUNDING_TOL if dtype == "fp32" and softmax != "exact" else None
    _held(out, dtype, tq, tk, tv, torch.from_numpy(pos), softmax=softmax, tol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant,G", [("A", 4), ("B", 4), ("C", 8)])
def test_row5_phase_orders(tpu, variant, G, dtype):
    """Row 5's kernels under its `run`'s specs, 8 heads so that G = 8 fits;
    the port serves each at the script's G."""
    heads = 8
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(5, heads), dtype)
    pos = _grid_positions()
    cq, sq = _rope_tables(jnp.asarray(pos), D, 100.0)
    spec = pl.BlockSpec((G, N, D), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    table = pl.BlockSpec((1, N, D), lambda i: (i // (heads // G), 0, 0),
                         memory_space=pltpu.VMEM)
    with pltpu.force_tpu_interpret_mode():  # read when the call is made
        call = pl.pallas_call(tpu[5].make_kernel(variant, G, D ** -0.5), grid=(B * heads // G,),
                              in_specs=[spec] * 3 + [table] * 4, out_specs=spec,
                              out_shape=jax.ShapeDtypeStruct((B * heads, N, D), jq.dtype))
        out = call(*(t.reshape(B * heads, N, D) for t in (jq, jk, jv)), cq, sq, cq, sq)
    _held(out.reshape(B, heads, N, D), dtype, tq, tk, tv, torch.from_numpy(pos),
          heads_per_program=G)


def _qkv(seed, dtype):
    """A raw (B, N, 3C) qkv projection, as JAX and torch arrays."""
    rng = np.random.default_rng(seed)
    (jqkv,), (tqkv,) = _both([rng.standard_normal((B, N, 3 * H * D)).astype(np.float32)], dtype)
    return jqkv, tqkv


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_row6_qkv_projection_in_place(tpu, dtype):
    """Row 6 reads q, k and v out of the (B, N, 3C) projection; the port
    takes (B, H, N, d) views of it, as `SelfAttention` does, and writes
    (B, N, C) through its output's transpose."""
    jqkv, tqkv = _qkv(6, dtype)
    pos = _grid_positions()
    with pltpu.force_tpu_interpret_mode():
        out = tpu[6].attn_dma(jqkv, jnp.asarray(pos), H)
    tq, tk, tv = tqkv.view(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
    assert not tq.is_contiguous() and tq.data_ptr() == tqkv.data_ptr()
    tpos = torch.from_numpy(pos)
    merged = out.reshape(B, N, H, D).transpose(0, 2, 1, 3)
    _held(merged, dtype, tq, tk, tv, tpos)
    ours = fused_attention(tq, tk, tv, tpos, tpos).transpose(1, 2).reshape(B, N, H * D)
    if dtype == "fp32":
        assert _rel(ours, out) <= TOL[dtype]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_row7_head_packed_projections(tpu, dtype):
    """Row 7 reads head-packed (B, N, C) q, k, v slices of the projection;
    the port takes (B, H, N, d) views of them, as `CrossAttention` does."""
    jqkv, tqkv = _qkv(7, dtype)
    pos = _grid_positions()
    with pltpu.force_tpu_interpret_mode():
        out = tpu[7].attn_qkv_layout(jqkv, jnp.asarray(pos), H)
    C = H * D
    tq, tk, tv = (tqkv[..., i * C:(i + 1) * C].view(B, N, H, D).transpose(1, 2)
                  for i in range(3))
    _held(out.reshape(B, N, H, D).transpose(0, 2, 1, 3), dtype, tq, tk, tv,
          torch.from_numpy(pos))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_row8_random_positions(dtype):
    rng = np.random.default_rng(8)
    pos = rng.integers(0, 48, (B, N, 2)).astype(np.int32)
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(8), dtype)
    with pltpu.force_tpu_interpret_mode():
        out = jax_fused_attention(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos),
                                  heads_per_program=1)
    _held(out, dtype, tq, tk, tv, torch.from_numpy(pos))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("safe", [True, False], ids=["safe", "nomax"])
def test_row9_softmax_without_max(tpu, safe, G, dtype):
    """Row 9 runs G = 2 heads a program; the port serves it at G = 1 and at
    the script's G = 2."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(9), dtype)
    pos = _grid_positions()
    with pltpu.force_tpu_interpret_mode():
        out = tpu[9].attn(jq, jk, jv, jnp.asarray(pos), safe=safe)
    _held(out, dtype, tq, tk, tv, torch.from_numpy(pos), heads_per_program=G,
          softmax="exact" if safe else "nomax")


# ---------------------------------------------------------------------- #
# the wrappers on the CPU
# ---------------------------------------------------------------------- #

def test_nomax_overflows_as_row_9_does():
    """Without the max, a logit past ~88 overflows exp in fp32: the plain
    version gives non-finite rows where the exact softmax does not."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(10, scale=1.0))
    q = q * 40.0
    assert torch.isfinite(attention_variant_ref(q, k, v, softmax="exact")).all()
    assert not torch.isfinite(attention_variant(q, k, v, softmax="nomax")).all()


def test_wrappers_refuse_what_they_cannot_serve():
    """Any positive heads_per_program is served, resolved as the JAX kernel
    resolves it (3 divides 6 heads; 8 and 4 halve to 2), on CPU tensors by
    the plain version; 0, negatives and non-integers are refused, and so are
    unknown softmax variants."""
    q = torch.zeros(1, 6, 8, 16)
    before = (fused_attention.launches, fused_attention.grouped_launches,
              fused_attention.core_launches, fused_attention.core_grouped_launches,
              attention_variant.launches)
    for G, served in ((3, 3), (8, 2), (4, 2)):
        assert resolve_heads_per_program(6, 8, 8, G) == served
        assert torch.equal(fused_attention(q, q, q, heads_per_program=G), attention_ref(q, q, q))
    for G in (0, -1, 2.0, True):
        with pytest.raises(ValueError, match="positive integer"):
            fused_attention(q, q, q, heads_per_program=G)
    for softmax in ("exact", "fast"):
        with pytest.raises(ValueError, match="softmax"):
            attention_variant(q, q, q, softmax=softmax)
    with pytest.raises(ValueError, match="softmax"):
        attention_variant_ref(q, q, q, softmax="fast")
    assert (fused_attention.launches, fused_attention.grouped_launches,
            fused_attention.core_launches, fused_attention.core_grouped_launches,
            attention_variant.launches) == before


VARIANT_ROUTES = [  # (d, heads a block, core) -> (launcher, heads a block it gets)
    ((64, 1, None), ("sm90", 1)),
    ((64, 2, None), ("sm90", 2)),
    ((32, 1, None), ("mma", 1)),
    ((32, 2, None), ("mma", 1)),
    ((64, 1, "mma"), ("mma", 1)),
    ((64, 2, "mma"), ("mma", 1)),
    ((64, 4, "sm90"), ("sm90", 4)),
]


@pytest.mark.parametrize("softmax", SOFTMAXES)
@pytest.mark.parametrize("call,want", VARIANT_ROUTES)
def test_variant_routes_each_call_to_its_kernel(monkeypatch, call, want, softmax):
    """On a tensor that is not on the CPU (here on the meta device, with the
    launchers and the device check replaced by recorders), bf16 at head
    dim 64 reaches the sm90 kernel with its G and the softmax's code; head
    dim 32 and `core="mma"` reach the mma.sync core at one head a block;
    each launch moves its own counter."""
    d, G, core = call
    seen = []

    def launcher(name):
        def record(q, k, v, *args, softmax, **kwargs):
            G = args[5] if len(args) > 5 else kwargs.get("heads_per_program", 1)
            seen.append((name, softmax, G))
            return torch.empty_like(q)
        return record

    monkeypatch.setattr(variants, "check", lambda *args: None)
    monkeypatch.setattr(variants, "launch_sm90", launcher("sm90"))
    monkeypatch.setattr(variants, "launch", launcher("mma"))
    q = torch.empty(1, 4, 8, d, dtype=torch.bfloat16, device="meta")
    before = (attention_variant.launches, attention_variant.core_launches)
    attention_variant(q, q, q, softmax=softmax, heads_per_program=G, core=core)
    assert seen == [(want[0], variants._CODES[softmax], want[1])]
    sm90 = want[0] == "sm90"
    assert (attention_variant.launches, attention_variant.core_launches) == (
        before[0] + sm90, before[1] + (not sm90))


@pytest.mark.parametrize("G", [3, 0, -2, 2.0, True, None])
def test_variant_refuses_heads_per_program_not_dividing_the_heads(G):
    """The script's rule (row 9's grid of H // G programs): G must be a
    positive integer dividing the heads, on CPU tensors as on the card;
    no counter moves."""
    q = torch.zeros(1, 4, 8, 64, dtype=torch.bfloat16)
    before = (attention_variant.launches, attention_variant.core_launches)
    with pytest.raises(ValueError, match="divisors"):
        attention_variant(q, q, q, softmax="nomax", heads_per_program=G)
    assert (attention_variant.launches, attention_variant.core_launches) == before


@pytest.mark.parametrize("softmax", SOFTMAXES)
def test_variants_on_cpu_tensors_are_their_plain_versions(softmax):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(11))
    pos = torch.from_numpy(_grid_positions())
    before = attention_variant.launches
    out = attention_variant(q, k, v, pos, pos, softmax=softmax)
    assert torch.equal(out, attention_variant_ref(q, k, v, pos, pos, 100.0, softmax))
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert attention_variant.launches == before


def test_attn_variants_tool_needs_a_card(monkeypatch):
    from dust3r_tpu_torch.tools import attn_variants

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        attn_variants.main([])


# ---------------------------------------------------------------------- #
# the model's modules hand over views
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("module", ["self", "cross"])
def test_attention_modules_hand_over_views_of_their_projections(monkeypatch, module):
    """q, k and v reach the attention as views of the projection outputs
    (no head-transposing copy), and the module's output is the one the
    contiguous copies gave."""
    torch.manual_seed(0)
    dim, heads, n, m = 64, 4, 12, 20
    seen, projected = [], []
    real = blocks.attention

    def recording(q, k, v, *args):
        seen.append((q, k, v))
        return real(q, k, v, *args)

    def copying(q, k, v, *args):  # what the modules handed over before
        return real(q.contiguous(), k.contiguous(), v.contiguous(), *args)

    if module == "self":
        mod = blocks.SelfAttention(dim, heads)
        x = torch.randn(2, n, dim)
        pos = blocks.token_positions(2, 3, 4)
        mod.qkv.register_forward_hook(lambda _m, _i, out: projected.append(out))
        run = lambda: mod(x, pos)  # noqa: E731
    else:
        mod = blocks.CrossAttention(dim, heads)
        x, y = torch.randn(2, n, dim), torch.randn(2, m, dim)
        qpos, kpos = blocks.token_positions(2, 3, 4), blocks.token_positions(2, 4, 5)
        for proj in (mod.projq, mod.projk, mod.projv):
            proj.register_forward_hook(lambda _m, _i, out: projected.append(out))
        run = lambda: mod(x, y, y, qpos, kpos)  # noqa: E731

    monkeypatch.setattr(blocks, "attention", recording)
    with torch.no_grad():
        out = run()
    (q, k, v), = seen
    sources = projected * 3 if module == "self" else projected
    for t, src in zip((q, k, v), sources):
        assert t.shape[1] == heads and not t.is_contiguous()
        assert t.untyped_storage().data_ptr() == src.untyped_storage().data_ptr()
    monkeypatch.setattr(blocks, "attention", copying)
    with torch.no_grad():
        before = run()
    torch.testing.assert_close(out, before, rtol=1e-6, atol=1e-6)
