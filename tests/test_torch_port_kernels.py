"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (marker `cuda`) and skip without one. They
import torch and the port only, so they also run where JAX is not
installed; there, skip the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels.py -q

Tolerances, against the plain version computed in fp32 from the same
inputs and scaled by its max |x|: attention 1e-2 for bf16 inputs (8-bit
mantissa, P rounded to bf16 before P.v; the sm90 kernel and the mma.sync
core alike), 1e-5 for fp32 inputs; strided views give the bits of the
contiguous call of the same core, and more than one head a block those of
one head a block of the same kernel (each head's arithmetic is the same):
any G that heads_per_program resolves to on the sm90 kernel, 2 or 4 on the
mma.sync core; the softmax
variants 1e-2 against their own plain version on the same bf16 inputs, on
either kernel (the bf16 ones round (s - max) at the running max and in
log2 units, so a P may sit one bf16 unit from the plain version's), G > 1
on the sm90 kernel bit-identical to G = 1; conv3x3
1e-3 against `conv3x3_bf16_ref` (the same bf16-rounded operands, products
exact in fp32, only the order of the fp32 sums differs), a split
reduction's calls bit-identical to each other; up2x 1e-5 against
`up2x_ref` (two fp32 lerps either way, FMA contraction aside); dpt_tail
1e-3 against `dpt_tail_bf16_ref` on each output (the same bf16-rounded
operands, then fp32 through the 1x1 and the exp; only the order of the fp32
sums differs), its calls bit-identical to each other and to the adapter's
call on its kept W2 packing. The TPU experiments' kernels: the tap-sum
conv (rows 10, 11) 1e-2 against `conv3x3_taps_ref` (both round Z to bf16
after fp32 sums in another order, then two bf16 adds) on the sm90 kernel
and its mma.sync baseline, its two variants bit-identical (the same sums in
the same order), its calls bit-identical to each other, and the sm90
kernel's Z within one bf16 unit of the largest Z of the baseline's (their
fp32 sums run in other orders); dpt_post (row 13) 1e-5
against `dpt_post_ref` (fp32 either way); the attention floors (row 3)
1e-2 against `attention_floor_ref` on the same bf16 inputs, on either
kernel, and the sm90 kernel's floors 1e-2 from the baseline's, each G > 1
call bit-identical to G = 1 of its kernel; the sm90 copy floors against
the baseline's bits: copynr equal (one fp32 add, one rounding), copy and
copymm at most one bf16 unit apart at any element (the same fp32
multiply-adds, which the compiler may fuse in another way).
"""
import math

import pytest
import torch

from dust3r_tpu_torch.models.blocks import token_positions
from dust3r_tpu_torch.models.heads import Conv3x3, DPTOutputAdapter
from dust3r_tpu_torch.ops.attention_floors import (COPY_MODES, MODES, attention_floor,
                                                   attention_floor_ref)
from dust3r_tpu_torch.ops.conv3x3_taps import (VARIANTS, conv3x3_taps_kernel, conv3x3_taps_ref,
                                               pack_for, tap_inputs, tap_sums)
from dust3r_tpu_torch.ops.dpt_post import dpt_post_kernel, dpt_post_ref
from dust3r_tpu_torch.ops.conv3x3 import (conv3x3, conv3x3_bf16_ref, conv3x3_kernel, pack_weight,
                                          plan)
from dust3r_tpu_torch.ops.dpt_tail import (dpt_tail, dpt_tail_bf16_ref, dpt_tail_kernel,
                                           pack_w2)
from dust3r_tpu_torch.ops.upsample import up2x, up2x_kernel, up2x_ref
from dust3r_tpu_torch.ops.attention_variants import (SOFTMAXES, attention_variant,
                                                     attention_variant_ref)
from dust3r_tpu_torch.ops.fused_attention import (SUPPORTED_HEAD_DIMS, attention_ref,
                                                  fused_attention, launch_sm90,
                                                  resolve_heads_per_program, route)
from dust3r_tpu_torch.tools.attn_variants import bf16_units_apart

pytestmark = pytest.mark.cuda

RTOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
CASES = {  # name: (B, H, (hq, wq) token grid of q, (hk, wk) of k, rope)
    "self_rope_ragged": (2, 3, (10, 13), (10, 13), True),  # 130 tokens
    "cross_rope": (2, 3, (6, 8), (7, 11), True),  # 48 queries, 77 keys
    "cross_no_rope": (1, 2, (14, 14), (3, 5), False),  # 196 queries, 15 keys
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launches():
    """(sm90 launches, mma.sync core launches, sm90 launches with G > 1,
    core bf16 launches with G > 1)"""
    return (fused_attention.launches, fused_attention.core_launches,
            fused_attention.grouped_launches, fused_attention.core_grouped_launches)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(card, case, d, dtype):
    B, H, gq, gk, rope = CASES[case]
    gen = torch.Generator(device=card).manual_seed(d)

    def rnd(grid):
        return torch.randn(B, H, grid[0] * grid[1], d, device=card, generator=gen).to(dtype)

    q, k, v = rnd(gq), rnd(gk), rnd(gk)
    pq = token_positions(B, *gq, card) if rope else None
    pk = token_positions(B, *gk, card) if rope else None
    before = _launches()
    out = fused_attention(q, k, v, pq, pk)
    torch.cuda.synchronize()
    sm90 = route(dtype, d) == "sm90"
    assert _launches() == (before[0] + sm90, before[1] + (not sm90), before[2], before[3])
    ref = attention_ref(q.float(), k.float(), v.float(), pq, pk)
    assert out.shape == ref.shape and out.dtype == dtype
    err = (out.float() - ref).abs().max().item() / ref.abs().max().item()
    assert err <= RTOL[dtype], f"{case} d={d} {dtype}: rel err {err:.3e}"


def test_kernel_refuses_what_it_cannot_serve(card):
    q = torch.zeros(1, 2, 8, 64, device=card, dtype=torch.bfloat16)
    before = fused_attention.launches
    with pytest.raises(ValueError, match="head dim"):
        fused_attention(q[..., :40].contiguous(), q[..., :40].contiguous(),
                        q[..., :40].contiguous())
    with pytest.raises(ValueError, match="unit stride"):
        fused_attention(q.transpose(2, 3).contiguous().transpose(2, 3), q, q)
    with pytest.raises(TypeError):
        fused_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="positions"):
        fused_attention(q, q, q, token_positions(1, 2, 4), token_positions(1, 2, 4))
    with pytest.raises(ValueError, match="both"):
        fused_attention(q, q, q, token_positions(1, 2, 4, card), None)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(2 * 8 * 64 + 1, device=card, dtype=torch.bfloat16)
        fused_attention(flat[1:].view(1, 2, 8, 64), q, q)
    assert fused_attention.launches == before


def _views(card, B, H, Nq, Nk, d, layout, dtype, seed):
    """q, k, v as the model hands them over: (B, H, N, d) views of one
    (B, N, 3C) qkv projection ("qkv") or of three (B, N, C) ones
    ("packed")."""
    gen = torch.Generator(device=card).manual_seed(seed)
    C = H * d

    def rnd(*shape):
        return torch.randn(*shape, device=card, generator=gen).to(dtype)

    if layout == "qkv":
        return tuple(rnd(B, Nq, 3 * C).view(B, Nq, 3, H, d).permute(2, 0, 3, 1, 4))
    return tuple(rnd(B, n, C).view(B, n, H, d).transpose(1, 2) for n in (Nq, Nk, Nk))


LAYOUTS = {  # the main path's: name: (H, token grid of q, of k, layout)
    "encoder_self_qkv": (16, (24, 32), (24, 32), "qkv"),
    "decoder_self_qkv": (12, (24, 32), (24, 32), "qkv"),
    "decoder_cross_768x672_packed": (12, (24, 32), (21, 32), "packed"),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_strided_views_give_the_contiguous_bits(card, case, dtype):
    H, gq, gk, layout = LAYOUTS[case]
    B, d = 2, 64
    q, k, v = _views(card, B, H, gq[0] * gq[1], gk[0] * gk[1], d, layout, dtype, seed=H)
    assert not q.is_contiguous()
    pq, pk = token_positions(B, *gq, card), token_positions(B, *gk, card)
    out = fused_attention(q, k, v, pq, pk)
    want = fused_attention(q.contiguous(), k.contiguous(), v.contiguous(), pq, pk)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    # written head-packed: merging the heads is a view
    merged = out.transpose(1, 2).reshape(B, q.shape[2], H * d)
    assert merged.data_ptr() == out.data_ptr() and merged.is_contiguous()
    ref = attention_ref(q.float(), k.float(), v.float(), pq, pk)
    err = (out.float() - ref).abs().max().item() / ref.abs().max().item()
    assert err <= RTOL[dtype], f"{case} {dtype}: rel err {err:.3e}"


GROUP_CASES = {  # name: (B, H, (hq, wq) token grid of q, (hk, wk) of k, rope)
    "cross_768x672": (2, 12, (24, 32), (21, 32), True),
    "ragged_196x672": (1, 4, (14, 14), (21, 32), True),
    "ragged_196x77_no_rope": (2, 8, (14, 14), (7, 11), False),
}


def _group_inputs(card, case, d, seed):
    B, H, gq, gk, rope = GROUP_CASES[case]
    gen = torch.Generator(device=card).manual_seed(seed)

    def rnd(grid):
        return torch.randn(B, H, grid[0] * grid[1], d, device=card, generator=gen).to(
            torch.bfloat16)

    q, k, v = rnd(gq), rnd(gk), rnd(gk)
    pq = token_positions(B, *gq, card) if rope else None
    pk = token_positions(B, *gk, card) if rope else None
    return q, k, v, pq, pk


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_heads_per_program_gives_the_bits_of_one_head_a_block(card, case, d, G):
    """The mma.sync core (`core="mma"`, the baseline) at 2 and 4 heads a
    block gives its one-head-a-block bits, at every head dim."""
    q, k, v, pq, pk = _group_inputs(card, case, d, seed=d + G)
    before = _launches()
    out = fused_attention(q, k, v, pq, pk, heads_per_program=G, core="mma")
    torch.cuda.synchronize()
    assert _launches() == (before[0], before[1] + 1, before[2], before[3] + 1)
    assert torch.equal(out, fused_attention(q, k, v, pq, pk, heads_per_program=1, core="mma"))


@pytest.mark.parametrize("G", [2, 3, 4, 6, 8])
@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_sm90_heads_per_program_gives_the_bits_of_one_head_a_block(card, case, G):
    """bf16 at d = 64 goes to the sm90 kernel at the G heads_per_program
    resolves to (3 and 6 halve to 1 at 4 and 8 heads, 8 to 4 at 12 heads):
    its one-head-a-block bits, within 1e-2 of the plain version."""
    q, k, v, pq, pk = _group_inputs(card, case, 64, seed=G)
    H, Nq, Nk = q.shape[1], q.shape[2], k.shape[2]
    resolved = resolve_heads_per_program(H, Nq, Nk, G)
    before = _launches()
    out = fused_attention(q, k, v, pq, pk, heads_per_program=G)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 1, before[1], before[2] + (resolved > 1), before[3])
    assert torch.equal(out, fused_attention(q, k, v, pq, pk))
    ref = attention_ref(q.float(), k.float(), v.float(), pq, pk)
    err = (out.float() - ref).abs().max().item() / ref.abs().max().item()
    assert err <= RTOL[torch.bfloat16], f"{case} G={G}: rel err {err:.3e}"


@pytest.mark.parametrize("G", [2, 4])
def test_fp32_runs_one_head_a_block_for_any_heads_per_program(card, G):
    gen = torch.Generator(device=card).manual_seed(G)
    q, k, v = (torch.randn(2, 4, 130, 64, device=card, generator=gen) for _ in range(3))
    before = _launches()
    out = fused_attention(q, k, v, heads_per_program=G)
    torch.cuda.synchronize()
    assert _launches() == (before[0], before[1] + 1, before[2], before[3])
    assert torch.equal(out, fused_attention(q, k, v))


SM90_CASES = {  # name: (B, H, (hq, wq) token grid of q, (hk, wk) of k, rope, layout)
    "encoder_self_768_qkv": (2, 16, (24, 32), (24, 32), True, "qkv"),
    "decoder_cross_768x672_packed": (2, 12, (24, 32), (21, 32), True, "packed"),
    "cross_672x768_packed": (2, 12, (21, 32), (24, 32), True, "packed"),
    "no_rope_196_packed": (2, 12, (14, 14), (14, 14), False, "packed"),
    "cross_130x77": (2, 3, (10, 13), (7, 11), True, "packed"),
    "cross_196x15_no_rope": (1, 2, (14, 14), (3, 5), False, "packed"),
    "one_query_one_key": (1, 1, (1, 1), (1, 1), True, "packed"),
}


@pytest.mark.parametrize("case", sorted(SM90_CASES))
def test_sm90_kernel_matches_plain_version_and_the_mma_core(card, case):
    """The main path's calls (bf16, d = 64, one head a block) go to the sm90
    kernel: within 1e-2 of the plain version, as the mma.sync core is, at
    the model's shapes and layouts and at ragged ones (672 keys, 196 tokens
    without RoPE, Nq != Nk, a single key)."""
    B, H, gq, gk, rope, layout = SM90_CASES[case]
    q, k, v = _views(card, B, H, gq[0] * gq[1], gk[0] * gk[1], 64, layout, torch.bfloat16,
                     seed=len(case))
    pq = token_positions(B, *gq, card) if rope else None
    pk = token_positions(B, *gk, card) if rope else None
    before = _launches()
    out = fused_attention(q, k, v, pq, pk)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 1, before[1], before[2], before[3])
    core = fused_attention(q, k, v, pq, pk, core="mma")
    assert _launches() == (before[0] + 1, before[1] + 1, before[2], before[3])
    ref = attention_ref(q.float(), k.float(), v.float(), pq, pk)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    for name, got in (("sm90", out), ("mma", core)):
        err = (got.float() - ref).abs().max().item() / ref.abs().max().item()
        assert err <= RTOL[torch.bfloat16], f"{case} {name}: rel err {err:.3e}"
    assert torch.equal(out, fused_attention(q, k, v, pq, pk))  # deterministic


def test_attention_routes_each_call_to_its_core(card):
    """bf16 at d = 64 goes to the sm90 kernel at any heads a block, the rest
    to the mma.sync core, and `core="mma"` asks for the core; asking the
    sm90 kernel for what it does not take raises, and so do strides TMA
    cannot address, before any launch."""
    q = torch.randn(1, 4, 64, 64, device=card).to(torch.bfloat16)
    before = _launches()
    fused_attention(q, q, q)
    fused_attention(q[..., :32].contiguous(), q[..., :32].contiguous(),
                    q[..., :32].contiguous())
    fused_attention(q.float(), q.float(), q.float())
    fused_attention(q, q, q, heads_per_program=2)
    fused_attention(q, q, q, heads_per_program=4, core="sm90")
    fused_attention(q, q, q, core="mma")
    fused_attention(q, q, q, heads_per_program=2, core="mma")
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 3, before[1] + 4, before[2] + 2, before[3] + 1)
    before = _launches()
    with pytest.raises(ValueError, match="sm90 kernel takes"):
        fused_attention(q[..., :32].contiguous(), q[..., :32].contiguous(),
                        q[..., :32].contiguous(), core="sm90")
    with pytest.raises(ValueError, match="sm90 kernel takes"):
        fused_attention(q.float(), q.float(), q.float(), core="sm90")
    with pytest.raises(ValueError, match="core"):
        fused_attention(q, q, q, core="wgmma")
    wide = torch.zeros(1, 4, 64, 68, device=card, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        fused_attention(wide, q, q)  # rows 136 bytes apart
    flat = torch.zeros(4 * 64 * 64 + 1, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        fused_attention(q, flat[1:].view(1, 4, 64, 64), q)
    assert _launches() == before


VARIANT_CASES = {  # name: (B, H, Nq grid, Nk grid, layout)
    "self_qkv_768": (2, 16, (24, 32), (24, 32), "qkv"),
    "cross_packed_768x672": (2, 12, (24, 32), (21, 32), "packed"),
    "ragged_130": (2, 3, (10, 13), (10, 13), "packed"),
}
VARIANT_RTOL = 1e-2


def _variant_launches():
    """(sm90 launches, mma.sync core launches) of attention_variant"""
    return attention_variant.launches, attention_variant.core_launches


@pytest.mark.parametrize("core", [None, "mma"], ids=["sm90", "mma"])
@pytest.mark.parametrize("softmax", SOFTMAXES)
@pytest.mark.parametrize("case", sorted(VARIANT_CASES))
def test_softmax_variant_matches_its_plain_version(card, case, softmax, core):
    """Each variant on the sm90 kernel (the route of bf16 d = 64) and on the
    mma.sync core (`core="mma"`): within 1e-2 of its plain version, at the
    encoder's self-attention from qkv views, the decoder's 768x672
    cross-attention and ragged 130 tokens."""
    B, H, gq, gk, layout = VARIANT_CASES[case]
    q, k, v = _views(card, B, H, gq[0] * gq[1], gk[0] * gk[1], 64, layout, torch.bfloat16,
                     seed=len(case))
    pq, pk = token_positions(B, *gq, card), token_positions(B, *gk, card)
    before = _variant_launches()
    out = attention_variant(q, k, v, pq, pk, softmax=softmax, core=core)
    torch.cuda.synchronize()
    sm90 = core is None
    assert _variant_launches() == (before[0] + sm90, before[1] + (not sm90))
    ref = attention_variant_ref(q, k, v, pq, pk, 100.0, softmax).float()
    assert out.shape == ref.shape and torch.isfinite(out).all()
    err = (out.float() - ref).abs().max().item() / ref.abs().max().item()
    assert err <= VARIANT_RTOL, f"{case} {softmax} {core or 'sm90'}: rel err {err:.3e}"


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("softmax", SOFTMAXES)
def test_sm90_softmax_variant_heads_per_program_gives_the_bits_of_one_head_a_block(
        card, softmax, G, record_property):
    """On the sm90 kernel G heads a block walk the heads in turn, each with
    the G = 1 arithmetic: the G = 1 bits, ragged keys included. Whether
    they also equal the mma.sync core's bits is recorded (`equals_mma`):
    the two kernels sum the products' fp32 terms in their own order."""
    B, H, gq, gk = 2, 8, (10, 13), (7, 11)
    q, k, v = _views(card, B, H, gq[0] * gq[1], gk[0] * gk[1], 64, "packed", torch.bfloat16,
                     seed=G)
    pq, pk = token_positions(B, *gq, card), token_positions(B, *gk, card)
    one = attention_variant(q, k, v, pq, pk, softmax=softmax)
    before = _variant_launches()
    out = attention_variant(q, k, v, pq, pk, softmax=softmax, heads_per_program=G)
    torch.cuda.synchronize()
    assert _variant_launches() == (before[0] + 1, before[1])
    assert torch.equal(out, one)
    record_property("equals_mma", torch.equal(
        out, attention_variant(q, k, v, pq, pk, softmax=softmax, core="mma")))


@pytest.mark.parametrize("core", [None, "mma"], ids=["sm90", "mma"])
def test_nomax_overflows_on_the_card(card, core):
    """Without the max a logit past ~88 overflows exp in fp32, on either
    kernel as in row 9: q x 40 gives non-finite rows where the exact
    softmax stays finite."""
    gen = torch.Generator(device=card).manual_seed(10)
    q, k, v = (torch.randn(2, 4, 130, 64, device=card, generator=gen) for _ in range(3))
    q, k, v = (q * 40.0).to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)
    assert torch.isfinite(fused_attention(q, k, v)).all()
    out = attention_variant(q, k, v, softmax="nomax", core=core)
    torch.cuda.synchronize()
    assert not torch.isfinite(out).all()


def test_softmax_variants_without_rope_launch_and_refuse_what_they_cannot_serve(card):
    """Without RoPE every variant launches on both kernels (within 1e-2 of
    its plain version), head dim 32 goes to the core; fp32 inputs, G not
    dividing the heads, G = 0, a non-integer G and the sm90 kernel at head
    dim 32 are refused before any launch."""
    gen = torch.Generator(device=card).manual_seed(7)
    q, k, v = (torch.randn(2, 4, 196, 64, device=card, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    for softmax in SOFTMAXES:
        ref = attention_variant_ref(q, k, v, softmax=softmax).float()
        for core in (None, "mma"):
            before = _variant_launches()
            out = attention_variant(q, k, v, softmax=softmax, core=core)
            torch.cuda.synchronize()
            assert _variant_launches() == (before[0] + (core is None), before[1] + (core == "mma"))
            err = (out.float() - ref).abs().max().item() / ref.abs().max().item()
            assert err <= VARIANT_RTOL, f"{softmax} {core or 'sm90'} no RoPE: rel err {err:.3e}"
    q32 = q[..., :32].contiguous()
    before = _variant_launches()
    attention_variant(q32, q32, q32, softmax="bf16_exp")
    torch.cuda.synchronize()
    assert _variant_launches() == (before[0], before[1] + 1)
    before = _variant_launches()
    with pytest.raises(TypeError, match="bf16"):
        attention_variant(q.float(), k.float(), v.float(), softmax="nomax")
    for G in (3, 0, 2.0):
        with pytest.raises(ValueError, match="divisors"):
            attention_variant(q, k, v, softmax="nomax", heads_per_program=G)
    with pytest.raises(ValueError, match="sm90 kernel takes"):
        attention_variant(q32, q32, q32, softmax="nomax", core="sm90")
    assert _variant_launches() == before


def test_kernel_refuses_strides_and_groupings_it_cannot_serve(card):
    """Strides TMA cannot address and G < 1 are refused before any launch;
    8 and 4 heads a block at 6 heads resolve as the JAX kernel resolves them
    (to 2) and give the one-head-a-block bits."""
    gen = torch.Generator(device=card).manual_seed(6)
    q = torch.randn(1, 6, 8, 64, device=card, generator=gen).to(torch.bfloat16)
    before = (_launches(), _variant_launches())
    wide = torch.zeros(1, 6, 8, 68, device=card, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        fused_attention(wide, q, q)  # rows 136 bytes apart
    with pytest.raises(ValueError, match="unit stride"):
        attention_variant(q.transpose(2, 3).contiguous().transpose(2, 3), q, q,
                          softmax="nomax")
    for G in (0, -1):
        with pytest.raises(ValueError, match="positive integer"):
            fused_attention(q, q, q, heads_per_program=G)
    with pytest.raises(TypeError, match="bf16"):
        attention_variant(q.float(), q.float(), q.float(), softmax="bf16_exp")
    assert (_launches(), _variant_launches()) == before
    one = fused_attention(q, q, q)
    for G in (8, 4):
        assert resolve_heads_per_program(6, 8, 8, G) == 2
        before = _launches()
        out = fused_attention(q, q, q, heads_per_program=G)
        torch.cuda.synchronize()
        assert _launches() == (before[0] + 1, before[1], before[2] + 1, before[3])
        assert torch.equal(out, one)


CONV_RTOL = 1e-3
CONV_CASES = {  # name: (Cin, Cout, H, W, bias); the DPT head's shapes at 512x384
    "layer1_rn": (96, 256, 96, 128, False),
    "layer2_rn": (192, 256, 48, 64, False),
    "layer3_rn": (384, 256, 24, 32, False),
    "layer4_rn": (768, 256, 12, 16, False),
    "refinenet4": (256, 256, 12, 16, True),
    "refinenet3": (256, 256, 24, 32, True),
    "refinenet2": (256, 256, 48, 64, True),
    "refinenet1": (256, 256, 96, 128, True),
    "head.0": (256, 128, 192, 256, True),
    "head.2": (128, 32, 384, 512, True),
    "ragged_21_rows": (384, 256, 21, 32, False),  # the 512x336 bucket
    "ragged_11_rows": (256, 256, 11, 16, True),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv3x3_kernel_matches_plain_version(card, case):
    cin, cout, h, w, bias = CONV_CASES[case]
    gen = torch.Generator(device=card).manual_seed(cin + cout + h)
    x = torch.randn(2, cin, h, w, device=card, generator=gen).contiguous(
        memory_format=torch.channels_last)
    wt = torch.randn(cout, cin, 3, 3, device=card, generator=gen) * (9 * cin) ** -0.5
    b = torch.randn(cout, device=card, generator=gen) if bias else None
    before = conv3x3_kernel.launches
    out = conv3x3(x, wt, b)  # auto: the kernel for CUDA tensors
    torch.cuda.synchronize()
    assert conv3x3_kernel.launches == before + 1
    ref = conv3x3_bf16_ref(x, wt, b)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert out.is_contiguous(memory_format=torch.channels_last)
    err = (out - ref).abs().max().item() / ref.abs().max().item()
    assert err <= CONV_RTOL, f"{case}: rel err {err:.3e}"


@pytest.mark.parametrize("case,batch", [("layer4_rn", 8), ("refinenet4", 8),
                                        ("ragged_11_rows", 8), ("ragged_21_rows", 2)])
def test_conv3x3_split_reduction_is_deterministic(card, case, batch):
    """The small grids split their reduction over several blocks a tile: the
    result stays within 1e-3 of the plain version and the same bits call
    after call (the partials are summed in split order), at batch 8 as on
    the model's path (batch 2 for the 21x32 grid, which splits only there)."""
    cin, cout, h, w, bias = CONV_CASES[case]
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert plan(batch, h, w, cin, cout, sms)[2] > 1
    gen = torch.Generator(device=card).manual_seed(cin + h)
    x = torch.randn(batch, cin, h, w, device=card, generator=gen).contiguous(
        memory_format=torch.channels_last)
    wt = torch.randn(cout, cin, 3, 3, device=card, generator=gen) * (9 * cin) ** -0.5
    b = torch.randn(cout, device=card, generator=gen) if bias else None
    outs = [conv3x3_kernel(x, wt, b) for _ in range(3)]
    torch.cuda.synchronize()
    ref = conv3x3_bf16_ref(x, wt, b)
    err = (outs[0] - ref).abs().max().item() / ref.abs().max().item()
    assert err <= CONV_RTOL, f"{case}: rel err {err:.3e}"
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


def test_conv3x3_module_packs_once_and_matches_the_wrapper(card):
    """A Conv3x3 on the card hands the kernel its kept packing; the result
    is the wrapper's on the unpacked weight, and after an in-place update
    of the weight the module packs again and follows it."""
    gen = torch.Generator(device=card).manual_seed(5)
    m = Conv3x3(64, 96).to(card)
    x = torch.randn(2, 64, 9, 20, device=card, generator=gen).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        got = m(x)
        packed = m._packed[1]
        assert torch.equal(got, conv3x3_kernel(x, m.weight, m.bias))
        assert torch.equal(packed, pack_weight(m.weight))
        m.weight.mul_(-0.5)
        got2 = m(x)
        assert m._packed[1] is not packed
        assert torch.equal(got2, conv3x3_kernel(x, m.weight, m.bias))
    before = conv3x3_kernel.launches
    with pytest.raises(ValueError, match="packed weight"):
        conv3x3_kernel(x, m.weight, m.bias, packed=packed[:, :8].contiguous())
    assert conv3x3_kernel.launches == before


def test_conv3x3_kernel_refuses_what_it_cannot_serve(card):
    x = torch.zeros(1, 64, 8, 8, device=card).contiguous(memory_format=torch.channels_last)
    w = torch.zeros(32, 64, 3, 3, device=card)
    before = conv3x3_kernel.launches
    with pytest.raises(ValueError, match="channels_last"):
        conv3x3_kernel(x.contiguous(), w)
    with pytest.raises(ValueError, match="multiples"):
        conv3x3_kernel(x[:, :48].contiguous(memory_format=torch.channels_last), w[:, :48])
    with pytest.raises(TypeError):
        conv3x3_kernel(x.half(), w.half())
    with pytest.raises(ValueError, match="bias"):
        conv3x3_kernel(x, w, torch.zeros(16, device=card))
    assert conv3x3_kernel.launches == before


UP2X_RTOL = 1e-5
UP2X_CASES = {  # name: (C, Hc, Wc); the DPT head's upsamples at 512x384 and 512x336
    "refinenet4": (256, 12, 16),
    "refinenet3": (256, 24, 32),
    "refinenet2": (256, 48, 64),
    "refinenet1": (256, 96, 128),
    "head.1": (128, 192, 256),
    "ragged_11_rows": (256, 11, 16),
    "ragged_21_rows": (256, 21, 32),
    "ragged_168_rows": (128, 168, 256),
    "single_row": (4, 1, 5),
    "single_column": (8, 3, 1),
}


@pytest.mark.parametrize("case", sorted(UP2X_CASES))
def test_up2x_kernel_matches_plain_version(card, case):
    c, h, w = UP2X_CASES[case]
    gen = torch.Generator(device=card).manual_seed(c + h + w)
    x = torch.randn(2, c, h, w, device=card, generator=gen).contiguous(
        memory_format=torch.channels_last)
    before = up2x_kernel.launches
    out = up2x(x)  # auto: the kernel for CUDA tensors
    torch.cuda.synchronize()
    assert up2x_kernel.launches == before + 1
    ref = up2x_ref(x)
    assert out.shape == ref.shape == (2, c, 2 * h, 2 * w) and out.dtype == torch.float32
    assert out.is_contiguous(memory_format=torch.channels_last)
    err = (out - ref).abs().max().item() / ref.abs().max().item()
    assert err <= UP2X_RTOL, f"{case}: rel err {err:.3e}"


def test_up2x_kernel_refuses_what_it_cannot_serve(card):
    x = torch.zeros(1, 8, 4, 4, device=card).contiguous(memory_format=torch.channels_last)
    before = up2x_kernel.launches
    with pytest.raises(ValueError, match="channels_last"):
        up2x_kernel(x.contiguous())
    with pytest.raises(ValueError, match="multiple"):
        up2x_kernel(x[:, :6].contiguous(memory_format=torch.channels_last))
    with pytest.raises(TypeError):
        up2x_kernel(x.half())
    assert up2x_kernel.launches == before


TAIL_RTOL = 1e-3
TAIL_CASES = {  # name: (B, H, W); the head's tail at 512x384 and 512x336, a portrait
    # image, and 16 x 16 tiles ragged at both image edges
    "384x512": (2, 384, 512),
    "336x512": (2, 336, 512),
    "portrait_512x384": (1, 512, 384),
    "ragged_13x7": (3, 13, 7),
    "ragged_21x37": (2, 21, 37),
    "ragged_17x16": (1, 17, 16),
    "single_pixel": (1, 1, 1),
}


def _tail_args(card, B, H, W, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    y = (0.3 * torch.randn(B, 128, H, W, device=card, generator=gen)).contiguous(
        memory_format=torch.channels_last)
    w2 = 0.05 * torch.randn(32, 128, 3, 3, device=card, generator=gen)
    b2 = 0.05 * torch.randn(32, device=card, generator=gen)
    w3 = 0.2 * torch.randn(4, 32, 1, 1, device=card, generator=gen)
    b3 = 0.1 * torch.randn(4, device=card, generator=gen)
    return y, w2, b2, w3, b3


@pytest.mark.parametrize("case", sorted(TAIL_CASES))
def test_dpt_tail_kernel_matches_plain_version(card, case):
    B, H, W = TAIL_CASES[case]
    args = _tail_args(card, B, H, W, seed=H + W)
    before = dpt_tail_kernel.launches
    pts, conf = dpt_tail(*args, 1.0)  # auto: the kernel for CUDA tensors
    torch.cuda.synchronize()
    assert dpt_tail_kernel.launches == before + 1
    want = dpt_tail_bf16_ref(*args, 1.0)
    assert pts.shape == (B, H, W, 3) and conf.shape == (B, H, W)
    assert pts.is_contiguous() and conf.is_contiguous()
    for name, got, ref in (("pts3d", pts, want[0]), ("conf", conf, want[1])):
        assert torch.isfinite(got).all()
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        assert err <= TAIL_RTOL, f"{case} {name}: rel err {err:.3e}"


@pytest.mark.parametrize("case", ["384x512", "ragged_21x37"])
def test_dpt_tail_kernel_gives_the_same_bits_call_to_call(card, case):
    B, H, W = TAIL_CASES[case]
    args = _tail_args(card, B, H, W, seed=3)
    outs = [dpt_tail_kernel(*args, 1.0) for _ in range(3)]
    torch.cuda.synchronize()
    for pts, conf in outs[1:]:
        assert torch.equal(pts, outs[0][0]) and torch.equal(conf, outs[0][1])


def test_dpt_tail_adapter_packs_once_and_matches_the_wrapper(card):
    """The DPT adapter hands the kernel its kept W2 packing; the result is
    the wrapper's on the unpacked weights, and after an in-place update of
    head.2's weight the adapter packs again and follows it."""
    inf = float("inf")
    adapter = DPTOutputAdapter((32,) * 4, (0, 1, 2, 3), 4, ("exp", -inf, inf),
                               ("exp", 1.0, inf)).to(card)
    y, *_ = _tail_args(card, 2, 19, 40, seed=4)
    conv2, conv3 = adapter.head[2], adapter.head[4]

    def wrapper():
        return dpt_tail_kernel(y, conv2.weight, conv2.bias, conv3.weight, conv3.bias, 1.0)

    with torch.no_grad():
        before = dpt_tail_kernel.launches
        got = adapter.tail(y)
        assert dpt_tail_kernel.launches == before + 1
        packed = adapter._packed_w2[1]
        assert torch.equal(packed, pack_w2(conv2.weight))
        want = wrapper()
        assert torch.equal(got["pts3d"], want[0]) and torch.equal(got["conf"], want[1])
        adapter.tail(y)
        assert adapter._packed_w2[1] is packed
        conv2.weight.mul_(-0.5)
        got2 = adapter.tail(y)
        assert adapter._packed_w2[1] is not packed
        want2 = wrapper()
        assert torch.equal(got2["pts3d"], want2[0]) and torch.equal(got2["conf"], want2[1])
    before = dpt_tail_kernel.launches
    with pytest.raises(ValueError, match="packed w2"):
        dpt_tail_kernel(y, conv2.weight, conv2.bias, conv3.weight, conv3.bias, 1.0,
                        packed=packed[:, :16].contiguous())
    with pytest.raises(ValueError, match="packed w2"):
        dpt_tail_kernel(y, conv2.weight, conv2.bias, conv3.weight, conv3.bias, 1.0,
                        packed=packed.float())
    assert dpt_tail_kernel.launches == before


def test_dpt_tail_kernel_refuses_what_it_cannot_serve(card):
    y, w2, b2, w3, b3 = _tail_args(card, 1, 4, 4, seed=0)
    before = dpt_tail_kernel.launches
    with pytest.raises(ValueError, match="channels_last"):
        dpt_tail_kernel(y.contiguous(), w2, b2, w3, b3, 1.0)
    with pytest.raises(ValueError, match="want"):
        dpt_tail_kernel(y, w2[:16], b2[:16], w3, b3, 1.0)
    with pytest.raises(TypeError):
        dpt_tail_kernel(y.half(), w2, b2, w3, b3, 1.0)
    assert dpt_tail_kernel.launches == before


TAPS_RTOL = 1e-2
TAPS_CASES = {  # name: (B, Cin, Cout, H, W)
    "layer1_rn": (2, 96, 256, 96, 128),  # Cin % 64 == 32: 32-channel chunks
    "head_conv2": (1, 128, 32, 384, 512),
    "rcu3": (2, 256, 256, 24, 32),
    "ragged_13x7": (3, 32, 64, 13, 7),  # 273 pixels: a ragged last M tile
    "w45": (2, 64, 64, 11, 45),  # W not a multiple of the 64-pixel patch width
    "w200_cin160": (1, 160, 96, 5, 200),  # two strips a row, the second 72 wide; N = 288
}


def _taps_inputs(card, case):
    B, cin, cout, h, w = TAPS_CASES[case]
    gen = torch.Generator(device=card).manual_seed(cin + cout + h)
    x = torch.randn(B, cin, h, w, device=card, generator=gen).contiguous(
        memory_format=torch.channels_last)
    wt = 0.05 * torch.randn(cout, cin, 3, 3, device=card, generator=gen)
    return x, wt


@pytest.mark.parametrize("case", sorted(TAPS_CASES))
def test_conv3x3_taps_kernel_matches_plain_version(card, case):
    x, wt = _taps_inputs(card, case)
    outs = {}
    for variant in VARIANTS:
        before = getattr(tap_sums, f"{variant}_launches")
        outs[variant] = conv3x3_taps_kernel(x, wt, variant)
        torch.cuda.synchronize()
        assert getattr(tap_sums, f"{variant}_launches") == before + 1
        ref = conv3x3_taps_ref(x, wt, variant).float()
        out = outs[variant]
        assert out.shape == ref.shape and out.dtype == torch.bfloat16
        assert out.is_contiguous(memory_format=torch.channels_last)
        err = (out.float() - ref).abs().max().item() / ref.abs().max().item()
        assert err <= TAPS_RTOL, f"{case} {variant}: rel err {err:.3e}"
    assert torch.equal(outs["slices"], outs["copies"])


@pytest.mark.parametrize("case", ["ragged_13x7", "w200_cin160", "rcu3"])
def test_conv3x3_taps_kernel_gives_the_same_bits_call_to_call(card, case):
    x, wt = _taps_inputs(card, case)
    first = conv3x3_taps_kernel(x, wt)
    for _ in range(3):
        again = conv3x3_taps_kernel(x, wt)
        torch.cuda.synchronize()
        assert torch.equal(first, again)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", sorted(TAPS_CASES))
def test_conv3x3_taps_sm90_z_is_within_one_bf16_unit_of_the_mma_baseline(card, case, variant):
    """The kernel alone on both cores: Z within one bf16 unit of the largest
    Z; the baseline's whole function within 1e-2 of the plain version."""
    x, wt = _taps_inputs(card, case)
    taps = tap_inputs(x.permute(0, 2, 3, 1).to(torch.bfloat16), variant)
    before = (getattr(tap_sums, f"{variant}_launches"), tap_sums.mma_launches)
    z = tap_sums(taps, pack_for(wt), variant)
    z_mma = tap_sums(taps, pack_for(wt, "mma"), variant, core="mma")
    torch.cuda.synchronize()
    assert (getattr(tap_sums, f"{variant}_launches"), tap_sums.mma_launches) == (
        before[0] + 1, before[1] + 1)
    assert z.shape == z_mma.shape == (*taps[0].shape[:3], 3 * wt.shape[0])
    top = z_mma.float().abs().max().item()
    unit = 2.0 ** (math.floor(math.log2(top)) - 7)
    assert (z.float() - z_mma.float()).abs().max().item() <= unit
    out = conv3x3_taps_kernel(x, wt, variant, core="mma")
    torch.cuda.synchronize()
    ref = conv3x3_taps_ref(x, wt, variant).float()
    assert (out.float() - ref).abs().max().item() <= TAPS_RTOL * ref.abs().max().item()


def test_conv3x3_taps_kernel_refuses_what_it_cannot_serve(card):
    x = torch.zeros(1, 64, 8, 8, device=card).contiguous(memory_format=torch.channels_last)
    w = torch.zeros(32, 64, 3, 3, device=card)
    before = (tap_sums.slices_launches, tap_sums.copies_launches, tap_sums.mma_launches)
    with pytest.raises(ValueError, match="one device"):
        conv3x3_taps_kernel(x, w.cpu())
    with pytest.raises(TypeError):
        conv3x3_taps_kernel(x.half(), w.half())
    with pytest.raises(ValueError, match="multiples"):
        conv3x3_taps_kernel(x, w[:16], "copies")
    with pytest.raises(ValueError, match="multiples"):
        conv3x3_taps_kernel(x, w[:16], core="mma")
    with pytest.raises(ValueError, match="core"):
        conv3x3_taps_kernel(x, w, core="tma")
    taps = tap_inputs(x.permute(0, 2, 3, 1).to(torch.bfloat16), "slices")
    with pytest.raises(ValueError, match="pack_for"):
        tap_sums(taps, pack_for(w, "mma"), "slices")
    buf = torch.zeros(taps[0].numel() + 8, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="aligned"):  # 2 bytes past a 16-byte boundary
        tap_sums((buf[1:1 + taps[0].numel()].view(taps[0].shape),), pack_for(w), "slices")
    assert (tap_sums.slices_launches, tap_sums.copies_launches, tap_sums.mma_launches) == before


POST_RTOL = 1e-5
POST_CASES = {"384x512": (2, 384, 512), "ragged_13x7": (3, 13, 7), "single_pixel": (1, 1, 1)}


@pytest.mark.parametrize("case", sorted(POST_CASES))
def test_dpt_post_kernel_matches_plain_version(card, case):
    B, H, W = POST_CASES[case]
    gen = torch.Generator(device=card).manual_seed(H + W)
    h = torch.relu(0.5 * torch.randn(B, 32, H, W, device=card, generator=gen)).contiguous(
        memory_format=torch.channels_last)
    w3 = 0.2 * torch.randn(4, 32, 1, 1, device=card, generator=gen)
    b3 = 0.1 * torch.randn(4, device=card, generator=gen)
    before = dpt_post_kernel.launches
    pts, conf = dpt_post_kernel(h, w3, b3, 1.0)
    torch.cuda.synchronize()
    assert dpt_post_kernel.launches == before + 1
    want = dpt_post_ref(h, w3, b3, 1.0)
    assert pts.shape == (B, H, W, 3) and conf.shape == (B, H, W)
    for name, got, ref in (("pts3d", pts, want[0]), ("conf", conf, want[1])):
        assert got.is_contiguous() and torch.isfinite(got).all()
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        assert err <= POST_RTOL, f"{case} {name}: rel err {err:.3e}"


FLOOR_RTOL = 1e-2
FLOOR_CASES = {  # name: (B, H, (hq, wq) token grid of q, (hk, wk) of k)
    "self_768": (2, 4, (24, 32), (24, 32)),
    "ragged_130": (2, 3, (10, 13), (10, 13)),
    "cross_130x77": (2, 4, (10, 13), (7, 11)),  # nosmax and qkonly (copies need Nq == Nk)
}


@pytest.mark.parametrize("case,mode", [
    (c, m) for c in sorted(FLOOR_CASES) for m in MODES
    if FLOOR_CASES[c][2] == FLOOR_CASES[c][3] or m in ("nosmax", "qkonly")])
def test_attention_floor_matches_plain_version(card, case, mode):
    """Each floor on the sm90 kernel (the default) and on its baseline,
    attention_floor.cu (`core="mma"`): within 1e-2 of the plain version,
    every G dividing the heads giving its kernel's G = 1 bits; the two
    kernels within 1e-2 of each other."""
    B, H, gq, gk = FLOOR_CASES[case]
    gen = torch.Generator(device=card).manual_seed(len(case) + MODES.index(mode))

    def rnd(grid):
        return torch.randn(B, H, grid[0] * grid[1], 64, device=card, generator=gen).to(
            torch.bfloat16)

    q, k, v = rnd(gq), rnd(gk), rnd(gk)
    pq, pk = token_positions(B, *gq, card), token_positions(B, *gk, card)
    ref = attention_floor_ref(q, k, v, pq, pk, 100.0, mode).float()
    scale = ref.abs().max().item()
    firsts = {}
    for core in (None, "mma"):
        sm90 = core is None
        outs = []
        for G in (g for g in (1, 2, 3, 4) if H % g == 0):
            before = (attention_floor.launches, attention_floor.core_launches)
            outs.append(attention_floor(q, k, v, pq, pk, mode=mode, heads_per_program=G,
                                        core=core))
            torch.cuda.synchronize()
            assert (attention_floor.launches, attention_floor.core_launches) == (
                before[0] + sm90, before[1] + (not sm90))
        out = firsts[core] = outs[0]
        assert out.shape == q.shape and out.dtype == torch.bfloat16 and torch.isfinite(out).all()
        err = (out.float() - ref).abs().max().item() / scale
        assert err <= FLOOR_RTOL, f"{case} {mode} {core or 'sm90'}: rel err {err:.3e}"
        assert all(torch.equal(o, out) for o in outs[1:])
    gap = (firsts[None].float() - firsts["mma"].float()).abs().max().item() / scale
    assert gap <= FLOOR_RTOL, f"{case} {mode}: sm90 vs attention_floor.cu {gap:.3e}"


@pytest.mark.parametrize("mode", COPY_MODES)
@pytest.mark.parametrize("case", ["self_768", "ragged_130"])
def test_sm90_copy_floors_give_the_baselines_bits(card, case, mode):
    """The copy floors on the sm90 kernel against attention_floor.cu, their
    baseline, at G = 1: copynr its bits; copy and copymm its bits or at
    most one bf16 unit apart at every element (the count of elements that
    differ is printed)."""
    B, H, gq, _ = FLOOR_CASES[case]
    gen = torch.Generator(device=card).manual_seed(7 + len(case) + COPY_MODES.index(mode))
    q, k, v = (torch.randn(B, H, gq[0] * gq[1], 64, device=card, generator=gen).to(
        torch.bfloat16) for _ in range(3))
    pos = token_positions(B, *gq, card)
    before = (attention_floor.launches, attention_floor.core_launches)
    sm90 = attention_floor(q, k, v, pos, pos, mode=mode)
    base = attention_floor(q, k, v, pos, pos, mode=mode, core="mma")
    torch.cuda.synchronize()
    assert (attention_floor.launches, attention_floor.core_launches) == (before[0] + 1,
                                                                         before[1] + 1)
    units = bf16_units_apart(sm90, base)
    print(f"{case} {mode}: {int((units > 0).sum())} of {units.numel()} elements differ from "
          f"the baseline's, at most {int(units.max())} bf16 unit(s)")
    if mode == "copynr":
        assert torch.equal(sm90, base)
    else:
        assert int(units.max()) <= 1


def test_attention_floor_refuses_what_it_cannot_serve(card):
    q = torch.zeros(1, 4, 64, 64, device=card, dtype=torch.bfloat16)
    pos = token_positions(1, 8, 8, card)
    before = (attention_floor.launches, attention_floor.core_launches)
    with pytest.raises(TypeError, match="bf16"):
        attention_floor(q.float(), q.float(), q.float(), pos, pos, mode="copynr")
    with pytest.raises(ValueError, match="head dim"):
        attention_floor(q[..., :32].contiguous(), q[..., :32].contiguous(),
                        q[..., :32].contiguous(), pos, pos, mode="nosmax")
    with pytest.raises(ValueError, match="Nk"):
        attention_floor(q, q[:, :, :48], q[:, :, :48], pos, token_positions(1, 6, 8, card),
                        mode="qkonly")
    for mode in COPY_MODES:  # q + v needs Nq == Nk: the wrapper refuses first
        with pytest.raises(ValueError, match="must agree"):
            attention_floor(q, q[:, :, :48], q[:, :, :48], pos, token_positions(1, 6, 8, card),
                            mode=mode, core="sm90")
    with pytest.raises(ValueError, match="not in the divisors"):
        attention_floor(q, q, q, pos, pos, mode="nosmax", heads_per_program=3)
    assert (attention_floor.launches, attention_floor.core_launches) == before
    # and the sm90 kernel's C entry refuses it too (returns -1)
    short = token_positions(1, 6, 8, card)
    for code in (6, 7, 8):
        with pytest.raises(RuntimeError, match="error -1"):
            launch_sm90(q, q[:, :, :48], q[:, :, :48], pos, short, 100.0, None, None,
                        softmax=code)
