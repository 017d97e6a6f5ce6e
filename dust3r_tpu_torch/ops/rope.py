"""2D rotary position embedding (RoPE2D, frequency base 100).

Counterpart of `dust3r_tpu/ops/rope.py`. Per-token integer (y, x)
positions; the head dim splits into two halves [y | x], the first rotated
by the y-position frequencies and the second by the x-position
frequencies, each half with rotate-half pairing.
"""
from __future__ import annotations

import torch


def rope_cos_sin(positions, dim, base=100.0, dtype=torch.float32):
    """Per-coordinate cos/sin tables.

    positions: (B, N) integer positions of ONE coordinate.
    dim: the (even) subspace this coordinate rotates (head_dim // 2).
    Returns cos, sin of shape (B, N, dim), computed in fp32 and cast.
    """
    if dim % 2:
        raise ValueError(f"rope subspace dim must be even, got {dim}")
    inv_freq = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                            device=positions.device) / dim))
    freqs = positions.to(torch.float32)[..., None] * inv_freq  # (B, N, dim/2)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _apply_rope1d(tokens, cos, sin):
    """tokens (B, H, N, d); cos/sin (B, N, d) broadcast over heads."""
    return tokens * cos[:, None] + rotate_half(tokens) * sin[:, None]


def rope_tables(positions, head_dim, base=100.0, dtype=torch.float32):
    """cos/sin of shape (B, N, head_dim), halves laid out [y | x]."""
    d = head_dim // 2
    cos_y, sin_y = rope_cos_sin(positions[..., 0], d, base, dtype)
    cos_x, sin_x = rope_cos_sin(positions[..., 1], d, base, dtype)
    return torch.cat([cos_y, cos_x], dim=-1), torch.cat([sin_y, sin_x], dim=-1)


def apply_rope2d(tokens, positions, base=100.0):
    """Apply 2D RoPE in the token dtype (as the JAX `apply_rope2d` does).

    tokens: (B, num_heads, N, head_dim), head_dim % 4 == 0.
    positions: (B, N, 2) integer (y, x) token positions.
    """
    head_dim = tokens.shape[-1]
    if head_dim % 4:
        raise ValueError(f"head_dim must be divisible by 4 for 2D RoPE, "
                         f"got {head_dim}")
    d = head_dim // 2
    cos_y, sin_y = rope_cos_sin(positions[..., 0], d, base, tokens.dtype)
    cos_x, sin_x = rope_cos_sin(positions[..., 1], d, base, tokens.dtype)
    y_tok = _apply_rope1d(tokens[..., :d], cos_y, sin_y)
    x_tok = _apply_rope1d(tokens[..., d:], cos_x, sin_x)
    return torch.cat([y_tok, x_tok], dim=-1)


def apply_rope2d_inverse(tokens, positions, base=100.0):
    """The adjoint (and inverse) of `apply_rope2d`: each half rotated by the
    negative angle, t·cos − rotate_half(t)·sin, with the tables in the
    token dtype (the JAX `_apply_rope2d_inverse`)."""
    d = tokens.shape[-1] // 2
    halves = []
    for c, part in enumerate((tokens[..., :d], tokens[..., d:])):
        cos, sin = rope_cos_sin(positions[..., c], d, base, tokens.dtype)
        halves.append(part * cos[:, None] - rotate_half(part) * sin[:, None])
    return torch.cat(halves, dim=-1)
