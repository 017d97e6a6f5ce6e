"""Shared pieces of the global aligner: edge bookkeeping, confidence
transforms, weighted distances, LR schedules.

Counterpart of `dust3r_tpu/cloud_opt/commons.py`.
"""
from __future__ import annotations

import numpy as np
import torch


def edge_str(i, j):
    return f"{i}_{j}"


def compute_edge_scores(edges, conf_i, conf_j):
    """{(i, j): mean(conf_i of the edge) * mean(conf_j of the edge)}, the
    MST's weights."""
    return {(i, j): float(np.mean(conf_i[e]) * np.mean(conf_j[e]))
            for e, (i, j) in enumerate(edges)}


def get_imshapes(edges, pred_i, pred_j):
    n_imgs = max(max(e) for e in edges) + 1
    imshapes = [None] * n_imgs
    for e, (i, j) in enumerate(edges):
        shape_i = tuple(pred_i[e].shape[0:2])
        shape_j = tuple(pred_j[e].shape[0:2])
        if imshapes[i] is not None:
            assert imshapes[i] == shape_i, f"incorrect shape for image {i}"
        if imshapes[j] is not None:
            assert imshapes[j] == shape_j, f"incorrect shape for image {j}"
        imshapes[i] = shape_i
        imshapes[j] = shape_j
    return imshapes


def get_conf_trf(mode):
    """Confidence transform on torch tensors."""
    if mode == "log":
        return torch.log
    if mode == "sqrt":
        return torch.sqrt
    if mode == "m1":
        return lambda x: x - 1
    if mode in ("id", "none"):
        return lambda x: x
    raise ValueError(f"bad conf mode {mode}")


def get_conf_trf_np(mode):
    """Host numpy twin of get_conf_trf."""
    if mode == "log":
        return np.log
    if mode == "sqrt":
        return np.sqrt
    if mode == "m1":
        return lambda x: x - 1
    if mode in ("id", "none"):
        return lambda x: x
    raise ValueError(f"bad conf mode {mode}")


def l2_dist(a, b, weight):
    return (a - b).square().sum(-1) * weight


def l1_dist(a, b, weight):
    # the squared norm is clamped so that the gradient stays finite (and 0)
    # at zero distance, which a near-perfect MST init reaches
    return (a - b).square().sum(-1).clamp(min=1e-16).sqrt() * weight


ALL_DISTS = dict(l1=l1_dist, l2=l2_dist)


def cosine_schedule(t, lr_start, lr_end):
    return lr_end + (lr_start - lr_end) * (1 + np.cos(t * np.pi)) / 2


def linear_schedule(t, lr_start, lr_end):
    return lr_start + (lr_end - lr_start) * t


def make_lr_schedule(schedule, niter, lr_base, lr_min):
    """The per-iteration learning rates, host float32."""
    t = np.arange(niter) / niter
    if schedule == "cosine":
        lrs = cosine_schedule(t, lr_base, lr_min)
    elif schedule == "linear":
        lrs = linear_schedule(t, lr_base, lr_min)
    else:
        raise ValueError(f"bad lr schedule {schedule}")
    return lrs.astype(np.float32)
