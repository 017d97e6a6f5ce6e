"""Transformer building blocks (encoder Block, DecoderBlock, PatchEmbed).

Counterpart of `dust3r_tpu/models/blocks.py`, with the reference's torch
tensor names. Conventions kept from the JAX package:
  * tokens are (B, N, C); positions are (B, N, 2) int32 (y, x), row-major;
  * LayerNorm eps 1e-6, computed in fp32 and cast back;
  * GELU is the exact erf form in fp32 and the tanh form in bf16;
  * self-attention has one fused qkv projection whose rows split as
    (3, heads, head_dim); cross-attention has projq/projk/projv;
  * `dtype` is the compute dtype of the projections; params stay fp32.
Casts are explicit (no autocast) so an fp32 run has the bf16 run's
structure.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention


def gelu(x):
    """Exact erf GELU in fp32, the tanh form under bf16 (as the JAX port)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


class Linear(nn.Linear):
    """nn.Linear computed in `dtype`: input, weight and bias are cast to it
    and the output stays in it, as flax `Dense(dtype=...)` does."""

    def __init__(self, in_features, out_features, bias=True, dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNormF32(nn.LayerNorm):
    """LayerNorm computed in fp32, output cast back to the input dtype."""

    def __init__(self, dim, eps=1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(x.dtype)


class Mlp(nn.Module):
    def __init__(self, dim, hidden_dim, dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(dim, hidden_dim, dtype=dtype)
        self.fc2 = Linear(hidden_dim, dim, dtype=dtype)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class SelfAttention(nn.Module):
    def __init__(self, dim, num_heads, rope_base=100.0, dtype=torch.float32,
                 attn_impl=None):
        super().__init__()
        self.num_heads = num_heads
        self.rope_base = rope_base
        self.attn_impl = attn_impl
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x, pos, rope=None):
        B, N, C = x.shape
        h = self.num_heads
        # (B, h, N, d) views of the (B, N, 3C) projection: the kernel reads
        # the heads in place and writes (B, N, h, d), so neither the split
        # nor the merge of the heads copies on its path
        q, k, v = self.qkv(x).view(B, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
        out = attention(q, k, v, pos, pos, self.rope_base, self.attn_impl, rope, rope)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class CrossAttention(nn.Module):
    def __init__(self, dim, num_heads, rope_base=100.0, dtype=torch.float32,
                 attn_impl=None):
        super().__init__()
        self.num_heads = num_heads
        self.rope_base = rope_base
        self.attn_impl = attn_impl
        self.projq = Linear(dim, dim, dtype=dtype)
        self.projk = Linear(dim, dim, dtype=dtype)
        self.projv = Linear(dim, dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, query, key, value, qpos, kpos, qrope=None, krope=None):
        B, Nq, C = query.shape
        Nk = key.shape[1]
        h = self.num_heads

        def heads(t, n):  # a (B, h, n, d) view of a (B, n, C) projection
            return t.view(B, n, h, C // h).transpose(1, 2)

        q = heads(self.projq(query), Nq)
        k = heads(self.projk(key), Nk)
        v = heads(self.projv(value), Nk)
        out = attention(q, k, v, qpos, kpos, self.rope_base, self.attn_impl, qrope, krope)
        return self.proj(out.transpose(1, 2).reshape(B, Nq, C))


class Block(nn.Module):
    """Encoder block: pre-LN self-attention (with 2D RoPE) + MLP.

    `rope`: optional fp32 `rope_tables` of `pos`, shared by the layers of a
    forward (see `ops.attention.attention`)."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, rope_base=100.0,
                 dtype=torch.float32, attn_impl=None):
        super().__init__()
        self.norm1 = LayerNormF32(dim)
        self.attn = SelfAttention(dim, num_heads, rope_base, dtype, attn_impl)
        self.norm2 = LayerNormF32(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x, pos, rope=None):
        x = x + self.attn(self.norm1(x), pos, rope)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    """Decoder block: self-attn + cross-attn to the other view + MLP.

    Called as blk(x, y, xpos, ypos) -> (x, y); norm_y normalizes the other
    view's tokens before cross-attention. `xrope` / `yrope`: optional fp32
    `rope_tables` of xpos / ypos, shared by the layers of a forward.
    """

    def __init__(self, dim, num_heads, mlp_ratio=4.0, rope_base=100.0,
                 dtype=torch.float32, attn_impl=None):
        super().__init__()
        self.norm1 = LayerNormF32(dim)
        self.attn = SelfAttention(dim, num_heads, rope_base, dtype, attn_impl)
        self.norm_y = LayerNormF32(dim)
        self.norm2 = LayerNormF32(dim)
        self.cross_attn = CrossAttention(dim, num_heads, rope_base, dtype,
                                         attn_impl)
        self.norm3 = LayerNormF32(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x, y, xpos, ypos, xrope=None, yrope=None):
        x = x + self.attn(self.norm1(x), xpos, xrope)
        y_ = self.norm_y(y)
        x = x + self.cross_attn(self.norm2(x), y_, y_, xpos, ypos, xrope, yrope)
        x = x + self.mlp(self.norm3(x))
        return x, y


class PatchEmbed(nn.Module):
    """Conv patchifier producing tokens and integer (y, x) positions.
    Images are NHWC at their true orientation."""

    def __init__(self, patch_size=16, embed_dim=1024, dtype=torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.compute_dtype = dtype
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, img):
        B, H, W, _ = img.shape
        p = self.patch_size
        if H % p or W % p:
            raise ValueError(f"image size {(H, W)} not divisible by patch size {p}")
        dt = self.compute_dtype
        x = F.conv2d(img.permute(0, 3, 1, 2).to(dt), self.proj.weight.to(dt),
                     self.proj.bias.to(dt), stride=p)
        x = x.flatten(2).transpose(1, 2)  # (B, Ht*Wt, C), row-major
        return x, token_positions(B, H // p, W // p, img.device)


def token_positions(B, Ht, Wt, device=None):
    """(B, Ht*Wt, 2) int32 (y, x) positions, row-major."""
    yy, xx = torch.meshgrid(torch.arange(Ht, dtype=torch.int32, device=device),
                            torch.arange(Wt, dtype=torch.int32, device=device),
                            indexing="ij")
    pos = torch.stack([yy, xx], dim=-1).reshape(1, Ht * Wt, 2)
    return pos.expand(B, -1, -1)
