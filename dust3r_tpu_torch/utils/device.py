"""Where the port's entry points put their tensors when the caller names no
device (the CUDA card, or an error that says how to ask for the CPU), and
the structure-recursive transfer and collation helpers (the counterparts of
`dust3r_tpu/utils/device.py:13-60`, on torch tensors and numpy arrays)."""
from __future__ import annotations

import numpy as np
import torch


def default_device(what):
    """torch.device("cuda"); raises when there is no CUDA device, naming
    the `device="cpu"` argument of `what`, so nothing lands on the CPU
    unless the caller asks for it."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device (torch.cuda.is_available() is False); "
                           f"pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def todevice(batch, device, non_blocking=False):
    """Move every array of a nested dict / list / tuple: device 'numpy'
    gives numpy arrays, any torch device (or 'cpu') torch tensors there."""
    if isinstance(batch, dict):
        return {k: todevice(v, device, non_blocking) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(todevice(x, device, non_blocking) for x in batch)
    if isinstance(batch, torch.Tensor):
        if device == "numpy":
            return batch.detach().cpu().numpy()
        return batch.to(device, non_blocking=non_blocking)
    if isinstance(batch, np.ndarray):
        if device == "numpy":
            return batch
        return torch.from_numpy(batch).to(device, non_blocking=non_blocking)
    return batch


def to_numpy(x):
    return todevice(x, "numpy")


def to_cpu(x):
    return todevice(x, "cpu")


def to_device(x, device=None):
    """To `device`, the card when none is named."""
    return todevice(x, device or default_device("to_device"))


def collate_with_cat(whatever, lists=False):
    """Concatenate samples or result dicts along the batch dim: dicts merge
    per key, arrays concatenate (or stay a list of entries with `lists`,
    for mixed shapes), tuples of dicts collate pointwise, lists chain."""
    if isinstance(whatever, dict):
        return {k: collate_with_cat(vals, lists=lists) for k, vals in whatever.items()}
    if isinstance(whatever, (tuple, list)):
        if len(whatever) == 0:
            return whatever
        elem = whatever[0]
        if isinstance(elem, dict):
            return {k: collate_with_cat([d[k] for d in whatever], lists=lists)
                    for k in elem.keys()}
        if isinstance(elem, tuple):
            return type(elem)(collate_with_cat(x, lists=lists) for x in zip(*whatever))
        if isinstance(elem, torch.Tensor):
            if lists:
                return [x for t in whatever
                        for x in ([t] if t.dim() == elem.dim() - 1 else list(t))]
            return torch.cat([torch.atleast_1d(t) for t in whatever])
        if hasattr(elem, "shape"):
            if lists:
                return [x for arr in whatever
                        for x in ([arr] if arr.ndim == elem.ndim - 1 else list(arr))]
            return np.concatenate([np.atleast_1d(np.asarray(a)) for a in whatever])
        if isinstance(elem, list):
            return [x for lst in whatever for x in lst]
        return list(whatever)
    return whatever
