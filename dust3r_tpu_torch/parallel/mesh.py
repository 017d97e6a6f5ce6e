"""Device lists for the data axis: training ranks, the inference engine's
shards and the aligner's edge shards.

Counterpart of `dust3r_tpu/parallel/mesh.py` on the data axis, with JAX's
names. A JAX mesh is a grid of devices whose shardings XLA turns into
collectives; here the data axis is a list of `torch.device`s: one rank a
device in training (`DistributedDataParallel` over a process group), one
model replica a device in `InferenceEngine(mesh=)`, one shard of the
aligner's edges a device in `global_aligner(mesh=)`. A device may repeat
in a list given by a caller (one more replica or shard on that card); the
CLIs build lists of distinct cards. The `fsdp` and `model` axes (ZeRO-3
parameter sharding, the Megatron MLP split) are ROADMAP.md A10b and raise.
"""
from __future__ import annotations

import torch


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
    """The data axis's devices: the first n_data of `devices` (every visible
    card by default; n_data None takes them all). Raises for an fsdp or
    model width above 1 (not ported) and when too few devices are given."""
    if n_fsdp > 1 or n_model > 1:
        raise NotImplementedError(
            f"mesh fsdp={n_fsdp} x model={n_model}: only the data axis is ported; "
            f"parameter sharding and the tensor-parallel MLP are ROADMAP.md A10b")
    if devices is None:
        devices = visible_devices()
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices)
    if n_data < 1 or n_data > len(devices):
        raise ValueError(f"mesh data={n_data} x fsdp={n_fsdp} x model={n_model} needs "
                         f"{n_data * n_fsdp * n_model} devices but only {len(devices)} "
                         f"are visible")
    return devices[:n_data]


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
