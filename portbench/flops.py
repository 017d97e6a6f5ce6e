"""The yardstick's arithmetic, frozen: FLOPs of the work a scene needs, the
operations and bytes of the attention and conv3x3 kernels' calls, and the
card's peaks.

The per-image terms are copied from `dust3r_tpu_torch/utils/flops.py`
(itself JAX's count): a multiply-accumulate is 2 FLOPs, and the DPT head's
five bilinear upsamples are counted as their dense interpolation matmuls,
as that count does. A scene's work is one encoder pass per unique image and
one decoder pass and one head per view of each pair; the slots the engine
pads its batches with are not work. Nothing here imports the program.
"""
from __future__ import annotations

# the NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, HBM bandwidth
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

PATCH = 16
MLP_RATIO = 4
DPT_FEATURES = 256
DPT_LAYER_DIMS = (96, 192, 384, 768)


def _attn(n, c):
    return 2 * 2 * n * n * c


def _conv(area, k, cin, cout):
    return 2 * area * k * k * cin * cout


def _up2x(h, w, c):
    return 2 * (2 * h) * h * (w * c) + 2 * (2 * w) * w * (2 * h * c)


def encoder_flops(arch, H, W):
    """One image through the patch embedding and the encoder."""
    n, c = (H // PATCH) * (W // PATCH), arch["enc_embed_dim"]
    block = 2 * n * (3 + 1 + 2 * MLP_RATIO) * c * c + _attn(n, c)
    return 2 * n * PATCH * PATCH * 3 * c + arch["enc_depth"] * block


def decoder_flops(arch, H, W):
    """One stream of one pair through the decoder."""
    n, e, c = (H // PATCH) * (W // PATCH), arch["enc_embed_dim"], arch["dec_embed_dim"]
    block = 2 * n * (4 + 4 + 2 * MLP_RATIO) * c * c + 2 * _attn(n, c)
    return 2 * n * e * c + arch["dec_depth"] * block


def head_flops(arch, H, W, nch=4):
    """One head on one view."""
    nh, nw = H // PATCH, W // PATCH
    a = nh * nw
    if arch["head_type"] == "linear":
        return 2 * a * arch["dec_embed_dim"] * nch * PATCH * PATCH
    e, c, f = arch["enc_embed_dim"], arch["dec_embed_dim"], DPT_FEATURES
    hook_dims = (e, c, c, c)
    total = 0
    for idx, (mult, dim) in enumerate(zip((16, 4, 1, 0.25), DPT_LAYER_DIMS)):
        total += _conv(a, 1, hook_dims[idx], dim)
        if idx == 0:
            total += 2 * a * dim * dim * 16
        elif idx == 1:
            total += 2 * a * dim * dim * 4
        elif idx == 3:
            total += _conv(a / 4, 3, dim, dim)
        total += _conv(a * mult, 3, dim, f)
    for idx, mult in enumerate((0.25, 1, 4, 16)):
        total += (1 if idx == 0 else 2) * 2 * _conv(a * mult, 3, f, f)
        total += _conv(a * mult, 1, f, f)
        h = int((a * mult / (nw / nh)) ** 0.5)
        w = int(a * mult // max(h, 1))
        total += _up2x(h, w, f)
    total += _conv(a * 64, 3, f, f // 2)
    total += _up2x(8 * nh, 8 * nw, f // 2)
    total += _conv(a * 256, 3, f // 2, 32)
    total += _conv(a * 256, 1, 32, nch)
    return total


def scene_flops(arch, n_images, n_pairs, H, W):
    """The work of one scene of `n_images` images of H x W and `n_pairs`
    pairs: each image encoded once, each pair decoded and both its heads."""
    return (n_images * encoder_flops(arch, H, W)
            + n_pairs * 2 * (decoder_flops(arch, H, W) + head_flops(arch, H, W)))


def bound_s(nbytes, flops):
    """The least time the card takes to move `nbytes` and to do `flops` bf16
    FLOPs, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def attention_calls(arch, H, W, batch, encoder_batches, pair_batches):
    """[(B, heads, Nq, Nk, d, count)] of the attention calls that
    `encoder_batches` encoder batches and `pair_batches` pair batches of one
    H x W bucket make (each batch padded to `batch`)."""
    n = (H // PATCH) * (W // PATCH)
    eh, dh = arch["enc_num_heads"], arch["dec_num_heads"]
    return [(batch, eh, n, n, arch["enc_embed_dim"] // eh, encoder_batches * arch["enc_depth"]),
            (batch, dh, n, n, arch["dec_embed_dim"] // dh, pair_batches * arch["dec_depth"] * 4)]


def attention_bound_s(B, h, nq, nk, d):
    """One bf16 attention call: q, k, v, o in bf16 and the four fp32 RoPE
    tables read once; 4 B h Nq Nk d FLOPs (q k^T and P v)."""
    nbytes = 2 * B * h * (2 * nq + 2 * nk) * d + 8 * B * (nq + nk) * d
    return bound_s(nbytes, 4 * B * h * nq * nk * d)


def conv3x3_calls(H, W, batch):
    """[(M, cin, cout, bias)] of the 19 conv3x3 calls of one DPT head on a
    batch of `batch` H x W views (the 20th 3x3 conv, head.2, is read by
    another kernel)."""
    nh, nw = H // PATCH, W // PATCH
    grids = [(4 * nh, 4 * nw), (2 * nh, 2 * nw), (nh, nw), ((nh + 1) // 2, (nw + 1) // 2)]
    f = DPT_FEATURES
    calls = [(batch * h * w, cin, f, False) for (h, w), cin in zip(grids, DPT_LAYER_DIMS)]
    calls += [(batch * grids[3][0] * grids[3][1], f, f, True)] * 2
    for h, w in grids[2::-1]:
        calls += [(batch * h * w, f, f, True)] * 4
    calls.append((batch * 8 * nh * 8 * nw, f, f // 2, True))
    return calls


def conv3x3_bound_s(M, cin, cout, bias):
    """One conv3x3 call on fp32 x: x, the weights, the bias and y in fp32
    read or written once; 2 M 9 Cin Cout FLOPs on bf16 tensor cores."""
    nbytes = 4 * (M * cin + 9 * cin * cout + (cout if bias else 0) + M * cout)
    return bound_s(nbytes, 2 * M * 9 * cin * cout)
