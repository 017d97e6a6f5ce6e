"""Batch symmetry, interleaving, default arguments and freezing.

Counterpart of `dust3r_tpu/utils/misc.py`. `freeze_mask` is the JAX
package's gradient mask, one 0-dim tensor a parameter name: the train step
multiplies the gradients by it and still runs AdamW, as JAX does (a frozen
matrix keeps decaying; the reference sets requires_grad=False instead).
"""
from __future__ import annotations

import inspect

import numpy as np
import torch

FREEZE_MODES = ("none", "mask", "encoder")


def fill_default_args(kwargs, func):
    """kwargs with every defaulted parameter of func filled in."""
    for k, v in inspect.signature(func).parameters.items():
        if v.default is not inspect.Parameter.empty:
            kwargs.setdefault(k, v.default)
    return kwargs


def is_symmetrized(gt1, gt2):
    """Whether the batch is (a, b), (b, a) interleaved, by its instances."""
    x, y = gt1["instance"], gt2["instance"]
    if len(x) == len(y) == 1:
        return False
    return all(x[i] == y[i + 1] and x[i + 1] == y[i] for i in range(0, len(x), 2))


def flip(arr):
    """Swap even and odd batch entries (numpy)."""
    arr = np.asarray(arr)
    out = np.empty_like(arr)
    out[0::2], out[1::2] = arr[1::2], arr[0::2]
    return out


def interleave(t1, t2):
    """(t1[0], t2[0], t1[1], ...) and (t2[0], t1[0], ...): numpy arrays or
    torch tensors."""
    if isinstance(t1, torch.Tensor):
        return (torch.stack([t1, t2], 1).reshape(-1, *t1.shape[1:]),
                torch.stack([t2, t1], 1).reshape(-1, *t2.shape[1:]))
    t1, t2 = np.asarray(t1), np.asarray(t2)
    return (np.stack([t1, t2], axis=1).reshape((-1,) + t1.shape[1:]),
            np.stack([t2, t1], axis=1).reshape((-1,) + t2.shape[1:]))


def transposed(dic):
    """Swap the two spatial axes of every (B, H, W, ...) map in a dict."""
    return {k: np.swapaxes(np.asarray(v), 1, 2) for k, v in dic.items()}


def freeze_mask(model, freeze="none"):
    """{parameter name: 0-dim tensor 0 or 1} of the reference's freeze
    modes: 'none', 'mask' (nothing: the model has no mask token) and
    'encoder' (the patch embed and the encoder blocks frozen)."""
    if freeze not in FREEZE_MODES:
        raise ValueError(f"freeze {freeze!r} not in {FREEZE_MODES}")

    def frozen(name):
        return freeze == "encoder" and name.split(".")[0] in ("patch_embed", "enc_blocks")

    return {name: torch.zeros((), dtype=p.dtype, device=p.device) if frozen(name)
            else torch.ones((), dtype=p.dtype, device=p.device)
            for name, p in model.named_parameters()}
