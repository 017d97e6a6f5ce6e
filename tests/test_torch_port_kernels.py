"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (marker `cuda`) and skip without one. They
import torch and the port only, so they also run where JAX is not
installed; there, skip the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels.py -q

Tolerances, against the plain version computed in fp32 from the same
inputs and scaled by its max |x|: attention 1e-2 for bf16 inputs (8-bit
mantissa, P rounded to bf16 before P.v), 1e-5 for fp32 inputs; conv3x3
1e-3 against `conv3x3_bf16_ref` (the same bf16-rounded operands, products
exact in fp32, only the order of the fp32 sums differs); up2x 1e-5 against
`up2x_ref` (two fp32 lerps either way, FMA contraction aside); dpt_tail
1e-3 against `dpt_tail_bf16_ref` on each output (conv3x3's sums, then fp32
through the 1x1 and the exp).
"""
import pytest
import torch

from dust3r_tpu_torch.models.blocks import token_positions
from dust3r_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_bf16_ref, conv3x3_kernel
from dust3r_tpu_torch.ops.dpt_tail import dpt_tail, dpt_tail_bf16_ref, dpt_tail_kernel
from dust3r_tpu_torch.ops.upsample import up2x, up2x_kernel, up2x_ref
from dust3r_tpu_torch.ops.fused_attention import (SUPPORTED_HEAD_DIMS, attention_ref,
                                                  fused_attention)

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
    before = fused_attention.launches
    out = fused_attention(q, k, v, pq, pk)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
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
    with pytest.raises(ValueError, match="contiguous"):
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
TAIL_CASES = {  # name: (B, H, W); the head's tail at 512x384 and 512x336, and ragged
    "384x512": (2, 384, 512),
    "336x512": (2, 336, 512),
    "ragged_13x7": (3, 13, 7),
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
