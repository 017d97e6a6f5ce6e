"""The processes of a data-parallel run and their host-side reductions.

Counterpart of `dust3r_tpu/parallel/distributed.py`: one process a device,
joined in a `torch.distributed` process group. A launcher (`torchrun`, or
`launch` here) starts the ranks and names each one in the environment
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT);
`init_distributed_mode` joins them by env:// rendezvous and stays
single-process where they are unset, as JAX stays without
JAX_COORDINATOR_ADDRESS. The backend is always the caller's: "nccl" on the
cards, "gloo" on the CPU or for several ranks on one card (NCCL refuses two
ranks on one device).
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import socket
import traceback

import torch
import torch.distributed as dist


def init_distributed_mode(backend, init_method=None, world_size=None, rank=None):
    """Join the process group; returns whether this process is in one.

    Without `init_method`, the launcher's environment (env://): False, and
    nothing done, when RANK or WORLD_SIZE is unset. With it (e.g.
    "tcp://localhost:<port>"), `world_size` and `rank` are the caller's. A
    group already joined is kept."""
    if dist.is_initialized():
        return True
    if init_method is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return False
        init_method = "env://"
        world_size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return True


def rank_device(device=None):
    """This rank's device: `device` where it names an index (several ranks
    may share one card), else the card of LOCAL_RANK (0 when unset)."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def get_rank():
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process():
    return get_rank() == 0


def _collective_device():
    """Where a host value is reduced: the current card under NCCL (it
    reduces CUDA tensors only), the host otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_mean(x):
    """The mean of a host scalar across the ranks (float)."""
    if get_world_size() == 1:
        return float(x)
    t = torch.tensor(float(x), dtype=torch.float64, device=_collective_device())
    dist.all_reduce(t)
    return float(t) / get_world_size()


def save_on_master(save_fn, *args, **kwargs):
    if is_main_process():
        save_fn(*args, **kwargs)


def free_port():
    """A TCP port of localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, devices, port, args, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(len(devices)), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    if "OMP_NUM_THREADS" not in os.environ:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(devices)))
    try:
        out = fn(rank, len(devices), torch.device(devices[rank]), *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    # pickled here, not by the queue: the queue would hand tensors over as
    # shared memory whose descriptors die with this process
    results.put((rank, True, pickle.dumps(out)))


def launch(fn, devices, args=(), timeout=None):
    """Start one spawned process a rank, rank r for `devices[r]` (a device
    may repeat: several ranks on one card), and return the ranks' results
    in rank order.

    Each rank finds the launcher's variables in its environment (MASTER_ADDR
    localhost, a free MASTER_PORT, LOCAL_RANK = RANK), takes its share of
    the host's cores for its threads (unless OMP_NUM_THREADS is set) and calls
    `fn(rank, world_size, device, *args)`; `fn` joins the group itself
    (`init_distributed_mode(backend)`), and must be importable by name (a
    module's function), as `args` must be picklable. When a rank fails or
    `timeout` seconds pass, the other ranks are stopped and RuntimeError
    names the failure. Spawned ranks import the caller's main module: a
    script that launches needs an `if __name__ == "__main__":` guard."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    devices = [str(d) for d in devices]
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, devices, port, args, results))
             for r in range(len(devices))]
    for p in procs:
        p.start()
    out, failure = {}, None
    waited = 0.0
    try:
        while len(out) < len(procs) and failure is None:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                waited += 0.5
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and r not in out]
                if dead:
                    failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                elif timeout is not None and waited > timeout:
                    failure = f"the ranks did not finish within {timeout} s"
                continue
            if ok:
                out[rank] = pickle.loads(value)
            else:
                failure = f"rank {rank} failed:\n{value}"
        for p in procs:
            p.join(timeout=None if failure is None else 5)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(len(procs))]
