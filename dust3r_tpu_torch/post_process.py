"""Focal estimation from pointmaps (median / Weiszfeld-IRLS).

Counterpart of `dust3r_tpu/post_process.py`: torch, 10 fixed IRLS
iterations, on the device of the pointmap.
"""
from __future__ import annotations

import numpy as np
import torch

from .utils.geometry import xy_grid

FOCAL_BASE_TAN = 2 * np.tan(np.deg2rad(60) / 2)  # 60 deg FOV base


def masked_median(x, mask, dim=-1):
    """Median of the masked entries along `dim`, the lower middle for an
    even count (torch.nanmedian's convention)."""
    filled = torch.where(mask, x, torch.full_like(x, float("inf")))
    sorted_x = filled.sort(dim=dim).values
    idx = (mask.sum(dim=dim, keepdim=True) - 1).clamp(min=0) // 2
    return sorted_x.gather(dim, idx).squeeze(dim)


@torch.no_grad()
def estimate_focal_knowing_depth(pts3d, pp, focal_mode="median", min_focal=0.0,
                                 max_focal=np.inf):
    """One focal per image from a (B, H, W, 3) pointmap; pp: (B, 2) principal
    points in pixels. Returns (B,) focals, clipped around the 60-degree-FOV
    base focal."""
    B, H, W, _ = pts3d.shape
    pixels = (xy_grid(W, H, dtype=pts3d.dtype, device=pts3d.device).reshape(1, -1, 2)
              - pp.reshape(-1, 1, 2).to(pts3d.dtype))  # (B, HW, 2)
    pts = pts3d.reshape(B, -1, 3)
    if focal_mode == "median":
        u, v = pixels.unbind(-1)
        x, y, z = pts.unbind(-1)
        votes = torch.cat([(u * z) / x, (v * z) / y], dim=-1)
        focal = masked_median(votes, torch.isfinite(votes))
    elif focal_mode == "weiszfeld":
        xy_over_z = torch.nan_to_num(pts[..., :2] / pts[..., 2:3], nan=0.0, posinf=0.0,
                                     neginf=0.0)
        dot_xy_px = (xy_over_z * pixels).sum(-1)  # (B, HW)
        dot_xy_xy = (xy_over_z * xy_over_z).sum(-1)
        focal = dot_xy_px.mean(1) / dot_xy_xy.mean(1)
        for _ in range(10):
            dis = torch.linalg.norm(pixels - focal[:, None, None] * xy_over_z, dim=-1)
            w = 1.0 / dis.clamp(min=1e-8)
            focal = (w * dot_xy_px).mean(1) / (w * dot_xy_xy).mean(1)
    else:
        raise ValueError(f"bad focal_mode {focal_mode}")
    focal_base = max(H, W) / FOCAL_BASE_TAN
    return focal.clamp(min_focal * focal_base, max_focal * focal_base)
