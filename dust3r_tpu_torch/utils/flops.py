"""Analytic FLOP accounting for the pair forward (MFU reporting).

Counterpart of `dust3r_tpu/utils/flops.py`: the same counts for the same
arguments; only the peak is the card's. Counts multiply-accumulates as 2
FLOPs, matching the usual MFU convention. Dense-matmul formulations are
counted at their FULL matmul cost (e.g. the align-corners upsample as two
dense interpolation matmuls, `upsample="matmul"`; the port's up2x kernel
does lerps, no MACs: `upsample="lerp"`) - MFU here answers "what fraction
of peak is the hardware doing", not "how few FLOPs could an ideal
algorithm do". Structure mirrors models/model.py + models/heads.py;
reference architecture: dust3r/model.py, dust3r/heads/dpt_head.py:96-115.
"""
from __future__ import annotations

# published config (README.md:318)
ENC_DIM, ENC_DEPTH, ENC_HEADS = 1024, 24, 16
DEC_DIM, DEC_DEPTH, DEC_HEADS = 768, 12, 12
PATCH = 16
MLP_RATIO = 4

# dense bf16 peak of the NVIDIA H100 SXM5 (NVIDIA's data sheet, without
# sparsity; the NVIDIA H100 80GB HBM3 at its 700 W power limit); a card set
# below that limit runs slower: pass its own peak as `peak_tflops`
PEAK_TFLOPS_BF16 = 989.0


def _attn(n_tokens, dim):
    """QK^T + PV for one attention call over all heads."""
    return 2 * 2 * n_tokens * n_tokens * dim


def _block(n, c):
    """Encoder-style transformer block: qkv(3c^2) + proj(c^2) +
    mlp(2*4c^2) per token, plus attention."""
    return 2 * n * (3 + 1 + 2 * MLP_RATIO) * c * c + _attn(n, c)


def _dec_block(n, c):
    """Decoder block: self-attn (4c^2) + cross-attn (4c^2) + mlp (8c^2)
    per token, plus two attention calls."""
    return 2 * n * (4 + 4 + 2 * MLP_RATIO) * c * c + 2 * _attn(n, c)


def _conv(area, k, cin, cout):
    return 2 * area * k * k * cin * cout


def _up2x(h, w, c, upsample="matmul"):
    """upsample2x_align_corners as two dense matmuls (heads.py); the
    'lerp' impl does no MACs."""
    if upsample == "lerp":
        return 0
    return 2 * (2 * h) * h * (w * c) + 2 * (2 * w) * w * (2 * h * c)


def encoder_flops_per_image(H, W):
    n = (H // PATCH) * (W // PATCH)
    patchify = 2 * n * (PATCH * PATCH * 3) * ENC_DIM
    return patchify + ENC_DEPTH * _block(n, ENC_DIM)


def decoder_flops_per_image(H, W):
    n = (H // PATCH) * (W // PATCH)
    embed = 2 * n * ENC_DIM * DEC_DIM
    return embed + DEC_DEPTH * _dec_block(n, DEC_DIM)


def linear_head_flops_per_image(H, W, nch=4):
    n = (H // PATCH) * (W // PATCH)
    return 2 * n * DEC_DIM * (nch * PATCH * PATCH)


def dpt_head_flops_per_image(H, W, nch=4, upsample="matmul"):
    """Mirrors models/heads.py DPTHead exactly (feature_dim 256,
    layer_dims (96,192,384,768), hooks at token resolution).

    upsample: 'matmul' counts the dense interp-matmul formulation at full
    matmul cost; 'lerp' counts the shift+lerp formulation as ~zero MACs
    (elementwise work, not tensor-core FLOPs)."""
    nh, nw = H // PATCH, W // PATCH
    a = nh * nw
    feat = 256
    layer_dims = (96, 192, 384, 768)
    hook_dims = (ENC_DIM, DEC_DIM, DEC_DIM, DEC_DIM)
    total = 0
    # per-hook projections + reassembly + scratch 3x3 to feature_dim
    res_mult = (16, 4, 1, 0.25)  # area multiplier after re-assembly
    for idx in range(4):
        total += _conv(a, 1, hook_dims[idx], layer_dims[idx])  # act proj
        if idx == 0:  # patch-expand x4
            total += 2 * a * layer_dims[0] * layer_dims[0] * 16
        elif idx == 1:  # patch-expand x2
            total += 2 * a * layer_dims[1] * layer_dims[1] * 4
        elif idx == 3:  # 3x3 stride-2 downsample
            total += _conv(a / 4, 3, layer_dims[3], layer_dims[3])
        total += _conv(a * res_mult[idx], 3, layer_dims[idx], feat)
    # refinenets: RCU = 2 convs 3x3 feat->feat; refinenet4 has one RCU,
    # 1..3 have two (resConfUnit1 on the residual input + resConfUnit2);
    # each ends with a 1x1 out_conv and a 2x upsample
    for idx, mult in enumerate((0.25, 1, 4, 16)):  # refinenet4..1 areas
        n_rcu = 1 if idx == 0 else 2
        total += n_rcu * 2 * _conv(a * mult, 3, feat, feat)
        total += _conv(a * mult, 1, feat, feat)
        h = int((a * mult / (nw / nh)) ** 0.5)  # h at this level
        w = int(a * mult // max(h, 1))
        total += _up2x(h, w, feat, upsample)
    # regression head: refinenet1's output is already upsampled to
    # (8nh, 8nw) = 64a, so head_conv1 + the final up2x run there and
    # head_conv2/3 run at FULL image resolution (16nh, 16nw) = 256a.
    # (A round-1..3 version of this accounting ran the whole tail one
    # octave too low — 4x undercount on these four terms.)
    total += _conv(a * 64, 3, feat, feat // 2)
    total += _up2x(8 * nh, 8 * nw, feat // 2, upsample)
    total += _conv(a * 256, 3, feat // 2, 32)
    total += _conv(a * 256, 1, 32, nch)
    return total


def pair_forward_flops(H, W, head_type="dpt", upsample="matmul"):
    """Total FLOPs for one image pair through the full model."""
    if head_type == "dpt":
        head = dpt_head_flops_per_image(H, W, upsample=upsample)
    else:
        head = linear_head_flops_per_image(H, W)
    return 2 * (encoder_flops_per_image(H, W)
                + decoder_flops_per_image(H, W)
                + head)


def mfu_pct(pairs_per_sec, H, W, head_type="dpt",
            peak_tflops=PEAK_TFLOPS_BF16, upsample="matmul"):
    """Model FLOPs utilization vs the chip's nominal bf16 peak."""
    fl = pair_forward_flops(H, W, head_type, upsample=upsample)
    return 100.0 * pairs_per_sec * fl / (peak_tflops * 1e12)
