"""The axes of `--mesh`: device lists for the data axis, and the
parameter shardings of the `fsdp` and `model` axes in training.

Counterpart of `dust3r_tpu/parallel/mesh.py`, with JAX's names. A JAX mesh
is a grid of devices whose shardings XLA turns into collectives; here:

* the data axis is a list of `torch.device`s: one rank a device in
  training (`DistributedDataParallel` over a process group), one model
  replica a device in `InferenceEngine(mesh=)`, one shard of the aligner's
  edges a device in `global_aligner(mesh=)`. A device may repeat in a list
  given by a caller (one more replica or shard on that card); the CLIs
  build lists of distinct cards.
* training with an `fsdp` or `model` width above 1 runs one rank a device
  of a `DeviceMesh` named ("data", "fsdp", "model") (`train_mesh`), rank
  r at (r // (F M), r // M % F, r % M), as JAX reshapes its devices.
  `shard_params` splits each block's MLP over `model` (the Megatron split:
  fc1 column-parallel, fc2 row-parallel, `parallelize_module`), then
  shards every parameter over `fsdp` on the axis JAX's `_fsdp_spec`
  picks and replicates it over `data` (FSDP2's `fully_shard` on the
  ("data", "fsdp") sub-mesh: HSDP). The batch is split over `data` only,
  as JAX's `P("data")`: the ranks of one data index hold the same slice.
  As in JAX, these two axes exist in training only.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .distributed import _collective_device

AXES = ("data", "fsdp", "model")


def visible_devices():
    """The CUDA cards this process sees, in order."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def parse_mesh_arg(mesh_arg):
    """'8' | '4,2' | '2,2,2' -> (n_data, n_fsdp, n_model); 'auto' -> every
    visible card on the data axis. None for empty / unset."""
    if not mesh_arg:
        return None
    if mesh_arg == "auto":
        return (torch.cuda.device_count(), 1, 1)
    dims = [int(x) for x in str(mesh_arg).split(",")]
    dims += [1] * (3 - len(dims))
    return tuple(dims[:3])


def make_mesh(n_data=None, n_fsdp=1, n_model=1, devices=None):
    """The mesh's devices in rank order: the first n_data x n_fsdp x n_model
    of `devices` (every visible card by default; n_data None takes all that
    the other two widths divide), as JAX's `make_mesh` takes them. Raises,
    with JAX's message, when too few devices are given."""
    if devices is None:
        devices = visible_devices()
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // (n_fsdp * n_model)
    n_used = n_data * n_fsdp * n_model
    if n_data < 1 or n_used > len(devices):
        raise ValueError(f"mesh data={n_data} x fsdp={n_fsdp} x model={n_model} needs "
                         f"{n_used} devices but only {len(devices)} are visible")
    return devices[:n_used]


def cli_pair_mesh(n_devices):
    """The CLIs' --mesh: (devices, batch_size). 0 -> (None, 1), one device;
    else the first n_devices visible cards and a batch of one pair a card.
    Raises when fewer are visible (silently under-provisioning would
    misreport throughput)."""
    if not n_devices:
        return None, 1
    devs = visible_devices()
    if n_devices > len(devs):
        raise ValueError(f"--mesh {n_devices} requested but only {len(devs)} devices visible")
    return devs[:n_devices], n_devices


def as_device_list(mesh):
    """A `mesh=` argument -> a list of torch.device (None stays None);
    anything but a non-empty list or tuple of devices raises TypeError."""
    if mesh is None:
        return None
    if not isinstance(mesh, (list, tuple)) or not mesh:
        raise TypeError(f"mesh= takes a non-empty list of devices, got {mesh!r}")
    try:
        return [torch.device(d) for d in mesh]
    except (TypeError, RuntimeError) as e:
        raise TypeError(f"mesh= takes a non-empty list of devices, got {mesh!r}") from e


# ---------------------------------------------------------------------- #
# the fsdp and model axes (training)
# ---------------------------------------------------------------------- #

def _flax_axes(module, leaf, ndim):
    """The torch dim of each axis of the flax leaf that holds this
    parameter (`checkpoint.state_dict_from_jax` reads them so): a Dense
    kernel (in, out) is `Linear.weight` (out, in), a Conv kernel (kh, kw,
    in, out) is `Conv2d.weight` (out, in, kh, kw); the rest (biases, norms,
    `ConvTranspose2d` kernels) keep their axes."""
    if leaf == "weight" and isinstance(module, nn.Linear):
        return (1, 0)
    if leaf == "weight" and isinstance(module, nn.Conv2d) and ndim == 4:
        return (2, 3, 1, 0)
    return tuple(range(ndim))


def _fsdp_spec(shape, n_fsdp, taken_axis=None, axes=None):
    """JAX's `_fsdp_spec` on a torch-layout shape: the largest flax axis
    divisible by n_fsdp that TP has not taken (`taken_axis`, a torch dim),
    ties broken as JAX breaks them (`np.argsort(sizes)[::-1]` over the flax
    axes); None: replicated. `axes`: `_flax_axes` of the parameter
    (identity by default). Returns a torch dim or None."""
    ndim = len(shape)
    if n_fsdp <= 1 or ndim == 0:
        return None
    axes = tuple(range(ndim)) if axes is None else axes
    sizes = [shape[d] for d in axes]  # the flax leaf's shape
    for ax in np.argsort(sizes)[::-1]:
        if axes[ax] == taken_axis:
            continue
        if sizes[ax] % n_fsdp == 0 and sizes[ax] >= n_fsdp:
            return axes[ax]
    return None


def _tp_axis(name, axes):
    """JAX's `_tp_axis` on a parameter name: the torch dim the Megatron MLP
    split shards, or None. fc1's kernel on its hidden axis (flax -1:
    column-parallel) and fc1's bias; fc2's kernel on its hidden axis (flax
    0: row-parallel); fc2's bias replicated."""
    keys = name.split(".")
    if "mlp" not in keys:
        return None
    if "fc1" in keys:
        return axes[-1] if keys[-1] == "weight" else axes[0]
    if "fc2" in keys and keys[-1] == "weight":
        return axes[0]
    return None


def param_placements(model, n_fsdp, n_model):
    """{parameter name: (fsdp dim, model dim)} in the torch layout: JAX's
    `param_shardings` on the same model (None: replicated on that axis). A
    leaf whose TP axis the model width does not divide stays unsplit."""
    out = {}
    for name, p in model.named_parameters():
        mod_name, _, leaf = name.rpartition(".")
        axes = _flax_axes(model.get_submodule(mod_name), leaf, p.dim())
        tp = _tp_axis(name, axes) if n_model > 1 and p.dim() else None
        if tp is not None and p.shape[tp] % n_model:
            tp = None
        out[name] = (_fsdp_spec(tuple(p.shape), n_fsdp, tp, axes), tp)
    return out


def train_mesh(n_data, n_fsdp, n_model, device_type):
    """The training `DeviceMesh` over the process group's ranks, axes
    ("data", "fsdp", "model"): JAX's `make_mesh` layout."""
    from torch.distributed.device_mesh import init_device_mesh

    if dist.get_world_size() != n_data * n_fsdp * n_model:
        raise ValueError(f"mesh data={n_data} x fsdp={n_fsdp} x model={n_model} needs "
                         f"{n_data * n_fsdp * n_model} ranks but the group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, (n_data, n_fsdp, n_model), mesh_dim_names=AXES)


def shard_params(mesh, model):
    """Shard `model` in place over a `train_mesh` as JAX's `shard_params`
    does (`param_placements`), and return it.

    1. Over `model`: `parallelize_module` on each block's `mlp` (`fc1`
       `ColwiseParallel`, `fc2` `RowwiseParallel`), where the model width
       divides the hidden width: its weights become DTensors split on
       `model`, its GEMMs' partial sums are all-reduced in the forward.
    2. Over ("data", "fsdp"): `fully_shard` on each encoder block, each
       block of both decoders and each head (their parameters are gathered
       one unit at a time), then on the root (the patch embed, the norms,
       decoder_embed): every parameter sharded on `fsdp` along the dim JAX picks
       (`shard_placement_fn`) and replicated on `data` (HSDP); gathered
       before a unit's forward and backward, its gradient reduce-scattered
       after the backward. A parameter JAX keeps whole on an `fsdp` wider
       than 1 (no divisible axis, or TP took its only one: fc1's bias) is
       left out of FSDP (`ignored_params`): replicated as in JAX, its
       gradient averaged over `data` by the train step (`unsharded_params`);
       so is one TP took its only dim of, at an fsdp width of 1.
    The conv and tail packings of the heads are no longer kept between
    calls (`keep_packing`): FSDP2 writes its gathered weights in place
    without a version bump."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.parallel import (ColwiseParallel, RowwiseParallel,
                                                   parallelize_module)

    n_fsdp, n_model = mesh["fsdp"].size(), mesh["model"].size()
    placements = param_placements(model, n_fsdp, n_model)
    for name, mod in model.named_modules():
        if name.endswith(".mlp") and placements[f"{name}.fc1.weight"][1] is not None:
            parallelize_module(mod, mesh["model"],
                               {"fc1": ColwiseParallel(), "fc2": RowwiseParallel()})
    params = dict(model.named_parameters())  # the TP DTensors, where split

    def fsdp_dim(name):
        d, tp = placements[name]
        if d is not None or n_fsdp > 1:
            return d  # None: JAX keeps it whole on fsdp
        # an fsdp width of 1: any dim but TP's holds the whole tensor
        return next((k for k in range(params[name].dim()) if k != tp), None)

    dims = {id(params[n]): fsdp_dim(n) for n in placements}
    ignored = {params[n] for n in placements if dims[id(params[n])] is None}

    def placement(p):
        return Shard(dims[id(p)])

    dp = mesh["data", "fsdp"]
    units = [*model.enc_blocks, *model.dec_blocks, *model.dec_blocks2, model.downstream_head1,
             model.downstream_head2, model]
    for unit in units:
        fully_shard(unit, mesh=dp, shard_placement_fn=placement, ignored_params=ignored)
    for m in model.modules():
        if hasattr(m, "keep_packing"):
            m.keep_packing = False
    model.train_mesh = mesh
    model.unsharded_params = [n for n, p in params.items() if p in ignored]
    return model


def _block(t, coord):
    """(the block of t (an index into the whole tensor) that the rank at
    `coord` ({axis: coordinate} on the training mesh) holds, whether that
    rank is its first holder: at coordinate 0 on every axis that does not
    shard t). t: a DTensor split into contiguous blocks (`Shard`, one dim an
    axis), or a plain tensor every rank holds whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(t, DTensor):
        return (slice(None),) * t.dim(), all(c == 0 for c in coord.values())
    index, sharding = [slice(None)] * t.dim(), set()
    sub = t.device_mesh
    for k, (axis, pl) in enumerate(zip(sub.mesh_dim_names, t.placements)):
        if type(pl) is Shard:
            size = t.shape[pl.dim]
            chunk = -(-size // sub.size(k))  # torch.chunk's split, as FSDP2 and DTensor cut
            start = min(coord[axis] * chunk, size)
            index[pl.dim] = slice(start, min(start + chunk, size))
            sharding.add(axis)
        elif type(pl) is not Replicate:
            raise ValueError(f"a {pl} placement is not a block of the tensor")
    return tuple(index), all(c == 0 for a, c in coord.items() if a not in sharding)


def _coords(mesh):
    """{rank: {axis: coordinate}} of every rank of the training mesh."""
    ranks = mesh.mesh.numpy()
    return {int(ranks[i]): dict(zip(mesh.mesh_dim_names, map(int, i)))
            for i in np.ndindex(ranks.shape)}


def local_block(t, mesh):
    """(index, local tensor, first) of this rank's block of t (`_block`)."""
    index, first = _block(t, _coords(mesh)[dist.get_rank()])
    local = t.to_local() if hasattr(t, "to_local") else t
    if tuple(local.shape) != tuple(len(range(*i.indices(n))) for i, n in zip(index, t.shape)):
        raise ValueError(f"a local block of {tuple(local.shape)} is not a chunk of "
                         f"{tuple(t.shape)} at {index}")
    return index, local, first


def full_tensor(t, mesh):
    """The whole of a sharded tensor (`shard_params`' DTensors, their
    gradients and AdamW moments; a plain tensor is every rank's) on rank
    0, on the host; None on the other ranks. A collective: every rank
    calls it. Each rank's block goes to rank 0 (a torch.distributed `gather`
    of the flattened blocks), which places each first-held one; no DTensor
    redistribution: gloo's functional all-gather of CUDA tensors does not
    return (torch 2.11)."""
    coords = _coords(mesh)
    blocks = [_block(t, coords[r]) for r in range(dist.get_world_size())]
    shapes = [tuple(len(range(*i.indices(n))) for i, n in zip(index, t.shape))
              for index, _ in blocks]
    _, local, _ = local_block(t, mesh)
    dev = _collective_device()
    buf = torch.zeros(max(math.prod(sh) for sh in shapes), dtype=t.dtype, device=dev)
    buf[:local.numel()] = local.detach().reshape(-1).to(dev)
    mine = dist.get_rank() == 0
    parts = [torch.empty_like(buf) for _ in blocks] if mine else None
    dist.gather(buf, parts, 0)
    if not mine:
        return None
    whole = torch.empty(t.shape, dtype=t.dtype)
    for (index, first), shape, part in zip(blocks, shapes, parts):
        if first:
            whole[index] = part[:math.prod(shape)].view(shape).cpu()
    return whole


def load_full(t, whole, mesh):
    """Write into the sharded tensor t (in place: its local block) the
    whole tensor `whole` that rank 0 holds (host; ignored elsewhere),
    broadcast to every rank. A collective: every rank calls it."""
    index, local, _ = local_block(t, mesh)
    dev = _collective_device()
    buf = (whole.to(dev, t.dtype) if dist.get_rank() == 0
           else torch.empty(t.shape, dtype=t.dtype, device=dev))
    dist.broadcast(buf, 0)
    with torch.no_grad():
        local.copy_(buf[index])


def sum_squares(tensors, mesh):
    """The sum of squares of every whole tensor of a sharded list (fp32, on
    their device), the same on every rank: each rank adds its first-held
    blocks' sums (`local_block`), all-reduced over the group, so a replicated
    block counts once."""
    parts, dev = [], None
    for t in tensors:
        _, local, first = local_block(t, mesh)
        dev = local.device
        if first:
            parts.append(local.float().square().sum())
    total = torch.stack(parts).sum() if parts else torch.zeros((), device=dev)
    dist.all_reduce(total)
    return total
