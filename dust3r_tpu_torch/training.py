"""Training: the LR schedule, the train step, the epoch loops, checkpoints.

Counterpart of `dust3r_tpu/training.py` (the reference's training.py:
AdamW (0.9, 0.95), lr = blr * eff_bs / 256, a per-iteration cosine
schedule with linear warmup, gradient accumulation, bf16 compute in the
model body, the non-finite loss abort). One process a device: with
`--mesh N` the ranks of a process group (`parallel/`), the model wrapped
in `DistributedDataParallel`; with `--mesh N,F,M` (F or M above 1) the
ranks of a (data, fsdp, model) mesh, the model's parameters sharded over
fsdp and its MLPs split over model (`parallel.mesh.shard_params`).

The step (`train_step`) follows the JAX step, `build_train_step`:
* each micro-batch's loss is back-propagated in turn, so the gradients
  are summed, then divided by `accum_iter`; the loss is the mean of the
  micro-batches', the details the last one's;
* over several ranks, each holds its slice of the batch, DDP all-reduces
  the gradients once a step (`no_sync` on all but the last micro-batch),
  every masked mean of the criterion is the global batch's
  (`losses.global_batch`), and the loss and details are averaged over the
  ranks: the JAX step on the global batch;
* on a sharded model the slices are the data axis's (the fsdp and model
  ranks of one data index hold the same one, as JAX's `P("data")`), FSDP2
  reduce-scatters the gradients once a step (`set_requires_gradient_sync`
  off on all but the last micro-batch), the parameters it leaves whole
  have theirs averaged over the data axis here, and every gradient below
  is a rank's local shard;
* the freeze mask multiplies the gradients, and AdamW still runs on every
  parameter (a frozen matrix keeps decaying, as in JAX);
* the global grad norm (on a sharded model each shard's sum of squares,
  summed over the ranks that shard it, a replicated block once), then the
  optional clip;
* AdamW with weight decay on the parameters of more than one dimension
  (the JAX `wd_mask`), the LR set per iteration at the fractional epoch;
* a step whose loss or grad norm is not finite changes nothing: neither
  the params, nor the optimizer's moments, nor its step count (JAX keeps
  the old state with `jnp.where`; here the optimizer is not stepped; the
  ranks decide alike, on the reduced loss and gradients);
* a quantized model (the int8 serving mode) is refused: it is
  inference-only.
The gt pointmaps are rebuilt on the device from depth, K and pose, as the
JAX step does (`_host_view` / `_ensure_gt_pts3d`); with `amp` the images
are cast to bf16 before they are sent.

Checkpoints are the reference's `.pth` files (`checkpoint.py`), where JAX
writes orbax directories, written by rank 0 and read back by every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from .losses import global_batch
from .ops.quant import is_quantized
from .optim_factory import adjust_learning_rate_by_lr
from .utils.misc import freeze_mask, interleave


def cosine_warmup_lr(epoch_f, lr, min_lr, warmup_epochs, total_epochs):
    """LR at fractional epoch epoch_f: linear warmup, then a half cosine."""
    if epoch_f < warmup_epochs:
        return lr * epoch_f / max(warmup_epochs, 1e-8)
    t = (epoch_f - warmup_epochs) / max(total_epochs - warmup_epochs, 1e-8)
    return min_lr + (lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * t))


@dataclasses.dataclass
class TrainSpec:
    """Static configuration of a training run."""
    lr: float = 1e-4          # already scaled: blr * eff_bs / 256
    min_lr: float = 1e-6
    warmup_epochs: float = 10
    epochs: float = 100
    weight_decay: float = 0.05
    betas: tuple = (0.9, 0.95)
    accum_iter: int = 1
    amp: bool = True          # bf16 compute in the model body
    freeze: str = "none"      # 'none' | 'mask' | 'encoder'
    clip_grad: float = 0.0    # > 0: clip gradients to this global norm


def decays(param):
    """Whether AdamW decays a parameter: matrices and conv kernels, not
    biases or norm scales (the JAX `wd_mask`, ndim > 1)."""
    return param.dim() > 1


def make_optimizer(model, spec):
    """AdamW over every parameter, in two groups: with and without weight
    decay. Its LR is set per iteration. A sharded model's is made after
    `parallel.mesh.shard_params`, over its shards."""
    params = list(model.parameters())
    groups = [dict(params=[p for p in params if decays(p)], weight_decay=spec.weight_decay),
              dict(params=[p for p in params if not decays(p)], weight_decay=0.0)]
    return torch.optim.AdamW(groups, lr=0.0, betas=tuple(spec.betas), eps=1e-8)


# ---------------------------------------------------------------------- #
# batches
# ---------------------------------------------------------------------- #

DEVICE_KEYS = ("img", "pts3d", "depthmap", "valid_mask", "camera_pose", "camera_intrinsics",
               "is_portrait")


def make_batch_symmetric(view1, view2):
    """((v1, v2), (v2, v1)) interleaved: twice the batch."""
    new1, new2 = {}, {}
    for k in view1:
        a, b = view1[k], view2[k]
        if isinstance(a, (torch.Tensor, np.ndarray)):
            new1[k], new2[k] = interleave(a, b)
        else:
            new1[k] = [x for pair in zip(a, b) for x in pair]
            new2[k] = [x for pair in zip(b, a) for x in pair]
    return new1, new2


def add_manyar_flags(view1, view2, force=False):
    """Per-sample `is_portrait` flags on both views when either holds a
    sample stored transposed (true_shape H > W), or with `force`; the
    flags select the model's ManyAR path."""
    flags = []
    for v in (view1, view2):
        ts = v.get("true_shape")
        if ts is None or np.ndim(ts) != 2:
            return view1, view2
        ts = torch.as_tensor(np.asarray(ts))
        flags.append(ts[:, 0] > ts[:, 1])
    if force or any(bool(f.any()) for f in flags):
        view1 = dict(view1, is_portrait=flags[0])
        view2 = dict(view2, is_portrait=flags[1])
    return view1, view2


def to_device_view(view, device, img_dtype=None):
    """The arrays a step reads, on `device`: gt pts3d is left behind when
    depth, K and pose are there (the step rebuilds it), depth when they are
    not; img cast to img_dtype first."""
    gt_from_depth = all(k in view for k in ("depthmap", "camera_intrinsics", "camera_pose"))
    out = {}
    for k in DEVICE_KEYS:
        if k not in view or (k == "pts3d" and gt_from_depth) or (
                k == "depthmap" and not gt_from_depth):
            continue
        t = torch.as_tensor(np.asarray(view[k]) if not isinstance(view[k], torch.Tensor)
                            else view[k])
        if k == "img" and img_dtype is not None:
            t = t.to(img_dtype)
        out[k] = t.to(device, non_blocking=True)
    return out


def _ensure_gt_pts3d(view):
    """The gt pointmap rebuilt on the device from depth, K and pose."""
    if "pts3d" in view or "depthmap" not in view:
        return view
    from .utils.geometry import depth_to_world_pts3d

    return dict(view, pts3d=depth_to_world_pts3d(view["depthmap"], view["camera_intrinsics"],
                                                 view["camera_pose"]))


def loss_of_one_batch(model, criterion, batch, symmetrized=False):
    """Forward (and criterion) of one (view1, view2) batch of device
    tensors. Returns ((loss, details) or None, (pred1, pred2))."""
    view1, view2 = batch
    if criterion is not None:
        view1, view2 = _ensure_gt_pts3d(view1), _ensure_gt_pts3d(view2)
    pred1, pred2 = model(view1["img"], view2["img"], view1.get("is_portrait"),
                         view2.get("is_portrait"), symmetrized=symmetrized)
    if criterion is None:
        return None, (pred1, pred2)
    return criterion(view1, view2, pred1, pred2), (pred1, pred2)


# ---------------------------------------------------------------------- #
# the step
# ---------------------------------------------------------------------- #

def global_norm(grads):
    """sqrt of the sum of every gradient's sum of squares (optax's
    `global_norm`)."""
    return torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()


def _local(t):
    """A DTensor's local shard; a plain tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def train_step(model, optimizer, criterion, micro_batches, epoch_f, spec, symmetrized=True,
               fmask=None):
    """One optimizer step over `accum_iter` micro-batches of device tensors
    (see the module docstring); `model` may be a DistributedDataParallel
    or a model `parallel.mesh.shard_params` sharded (each rank passes its
    slice of every micro-batch: its data index's). fmask:
    `freeze_mask(module, spec.freeze)`, made once by the caller. Returns the
    step's metrics as floats, the same on every rank: loss, lr, grad_norm,
    skipped and the criterion's details."""
    if len(micro_batches) != spec.accum_iter:
        raise ValueError(f"{len(micro_batches)} micro-batches for accum_iter {spec.accum_iter}")
    if is_quantized(model):
        raise ValueError("the model is quantized (the int8 serving mode), which is "
                         "inference-only: rounding has no gradient")
    ddp = isinstance(model, DistributedDataParallel)
    module = model.module if ddp else model
    mesh = getattr(module, "train_mesh", None)
    if mesh is not None:  # the losses' global batch is the data axis's
        group = data_group = mesh.get_group("data")
        world, n_data = dist.get_world_size(), mesh["data"].size()
    else:
        group = model.process_group if ddp else None
        world = n_data = dist.get_world_size(group) if ddp else 1
        data_group = group
    params = dict(module.named_parameters())
    for p in params.values():
        p.grad = None
    loss_sum = 0.0
    for k, batch in enumerate(micro_batches):
        last = k == len(micro_batches) - 1
        if mesh is not None:
            module.set_requires_gradient_sync(last)
        with (model.no_sync() if ddp and not last else contextlib.nullcontext()), \
                (global_batch(data_group) if n_data > 1 else contextlib.nullcontext()):
            (loss, details), _ = loss_of_one_batch(model, criterion, batch, symmetrized)
            loss.backward()
        loss_sum = loss_sum + loss.detach()
    loss = loss_sum / spec.accum_iter
    details = {k: v.detach() for k, v in details.items() if v.ndim == 0}
    if world > 1:  # the global batch's loss and details: the ranks' mean
        packed = torch.stack([loss.float()] + [v.float() for v in details.values()])
        dist.all_reduce(packed, group=group if mesh is None else None)
        packed /= world
        loss, details = packed[0], dict(zip(details, packed[1:]))
    grads = []
    for name, p in params.items():
        if p.grad is None:  # a parameter the loss does not reach: a zero gradient
            p.grad = torch.zeros_like(p)
        g = _local(p.grad)
        if mesh is not None and n_data > 1 and name in module.unsharded_params:
            dist.all_reduce(g, group=data_group)  # FSDP2 leaves these: the data mean
            g.div_(n_data)
        if spec.accum_iter > 1:
            g.div_(spec.accum_iter)
        if spec.freeze != "none":
            g.mul_(fmask[name])
        grads.append(g)
    if mesh is None:
        grad_norm = global_norm(grads)
    else:
        from .parallel.mesh import sum_squares

        grad_norm = sum_squares([p.grad for p in params.values()], mesh).sqrt()
    lr = cosine_warmup_lr(float(epoch_f), spec.lr, spec.min_lr, spec.warmup_epochs,
                          spec.epochs)
    finite = bool(torch.isfinite(grad_norm) & torch.isfinite(loss))
    if finite:
        if spec.clip_grad > 0:
            factor = torch.clamp(spec.clip_grad / grad_norm.clamp(min=1e-12), max=1.0)
            torch._foreach_mul_(grads, factor)
        adjust_learning_rate_by_lr(optimizer, lr)
        optimizer.step()
    metrics = dict(loss=float(loss), lr=lr, grad_norm=float(grad_norm),
                   skipped=float(not finite))
    metrics.update({k: float(v) for k, v in details.items()})
    return metrics


def check_finite_or_die(loss_value):
    """The reference's abort on a non-finite loss."""
    if not math.isfinite(loss_value):
        print(f"Loss is {loss_value}, stopping training", file=sys.stderr)
        sys.exit(1)


# ---------------------------------------------------------------------- #
# metric logging
# ---------------------------------------------------------------------- #

class SmoothedValue:
    """A series with its window median / mean and its global mean."""

    def __init__(self, window_size=20, fmt="{median:.4f} ({global_avg:.4f})"):
        self.window = []
        self.window_size = window_size
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n=1):
        self.window.append(value)
        if len(self.window) > self.window_size:
            self.window.pop(0)
        self.total += value * n
        self.count += n

    @property
    def median(self):
        return float(np.median(self.window)) if self.window else 0.0

    @property
    def avg(self):
        return float(np.mean(self.window)) if self.window else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.window[-1] if self.window else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               value=self.value)


class MetricLogger:
    def __init__(self, delimiter="  ", window_size=20):
        self.meters = {}
        self.delimiter = delimiter
        self.window_size = window_size

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if v is not None:
                self.meters.setdefault(k, SmoothedValue(self.window_size)).update(float(v))

    def __getattr__(self, attr):
        meters = object.__getattribute__(self, "meters")
        if attr in meters:
            return meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable, print_freq, header=""):
        start = time.time()
        for i, obj in enumerate(iterable):
            yield i, obj
            if print_freq and i % print_freq == 0:
                print(f"{header} [{i}]  {self}  ({time.time() - start:.1f}s)")


# ---------------------------------------------------------------------- #
# epochs
# ---------------------------------------------------------------------- #

def _grouped(iterable, n):
    """Lists of n consecutive items; a short tail is dropped (a partial
    accumulation group is skipped, as in the reference)."""
    group = []
    for item in iterable:
        group.append(item)
        if len(group) == n:
            yield group
            group = []


def symmetric_micro_batches(group, device, img_dtype):
    """A group of loader batches -> the step's symmetrized, flagged device
    micro-batches; if any got ManyAR flags, all get them."""
    sym = [add_manyar_flags(*make_batch_symmetric(v1, v2)) for v1, v2 in group]
    if any("is_portrait" in v1 for v1, _ in sym):
        sym = [add_manyar_flags(v1, v2, force=True) if "is_portrait" not in v1 else (v1, v2)
               for v1, v2 in sym]
    return [(to_device_view(v1, device, img_dtype), to_device_view(v2, device, img_dtype))
            for v1, v2 in sym]


def train_one_epoch(model, optimizer, criterion, data_loader, epoch, spec, device,
                    print_freq=20, log_writer=None, on_step=None, share=None):
    """One epoch of optimizer steps; returns the meters' global means.
    `model` may be a DistributedDataParallel, `data_loader` then this
    rank's share. on_step(module, epoch, i, metrics, micro_batches), when
    given, is called after each step with the unwrapped module. share(x),
    when given, returns the loader batches this rank trains on (a sharded
    run's: its data index's first rank's)."""
    from .parallel.distributed import all_reduce_mean

    module = model.module if isinstance(model, DistributedDataParallel) else model
    model.train()
    metric_logger = MetricLogger()
    header = f"Epoch: [{epoch}]"
    data_loader.set_epoch(epoch)
    n_iters = len(data_loader)
    img_dtype = torch.bfloat16 if spec.amp else None
    fmask = freeze_mask(module, spec.freeze) if spec.freeze != "none" else None
    groups = _grouped(iter(data_loader), spec.accum_iter)
    for i, group in metric_logger.log_every(groups, print_freq, header):
        epoch_f = epoch + (i * spec.accum_iter) / max(n_iters, 1)
        batches = symmetric_micro_batches(group if share is None else share(group), device,
                                          img_dtype)
        metrics = train_step(model, optimizer, criterion, batches, epoch_f, spec, fmask=fmask)
        check_finite_or_die(metrics["loss"])
        loss_value_reduce = all_reduce_mean(metrics["loss"])  # every rank, every step
        metric_logger.update(epoch=epoch_f, **metrics)
        if log_writer is not None and print_freq and i % print_freq == 0:
            epoch_1000x = int(epoch_f * 1000)
            log_writer.add_scalar("train_loss", loss_value_reduce, epoch_1000x)
            log_writer.add_scalar("train_lr", metrics["lr"], epoch_1000x)
            for name, val in metrics.items():
                if name not in ("loss", "lr"):
                    log_writer.add_scalar("train_" + name, val, epoch_1000x)
        if on_step is not None:
            on_step(module, epoch, i, metrics, batches)
    print("Averaged stats:", metric_logger)
    return {k: m.global_avg for k, m in metric_logger.meters.items()}


@torch.no_grad()
def test_one_epoch(model, criterion, data_loader, epoch, device, print_freq=20, prefix="test",
                   img_dtype=None, share=None):
    """The criterion over a test loader (the whole epoch in each meter's
    window); returns {name_avg, name_med} of every scalar. Over several
    ranks each runs the whole loader (it is not split, as in JAX) on its
    unwrapped module, so every rank takes the same checkpoint decisions."""
    if isinstance(model, DistributedDataParallel):
        model = model.module
    model.eval()
    metric_logger = MetricLogger(window_size=10 ** 9)
    header = f"Test Epoch: [{epoch}]"
    data_loader.set_epoch(epoch)
    for _, (view1, view2) in metric_logger.log_every(iter(data_loader), print_freq, header):
        if share is not None:
            view1, view2 = share((view1, view2))
        view1, view2 = add_manyar_flags(*make_batch_symmetric(view1, view2))
        batch = (to_device_view(view1, device, img_dtype), to_device_view(view2, device, img_dtype))
        (loss, details), _ = loss_of_one_batch(model, criterion, batch, symmetrized=True)
        scalars = {k: float(v) for k, v in details.items() if getattr(v, "ndim", 0) == 0}
        metric_logger.update(loss=float(loss), **scalars)
    print("Averaged stats:", metric_logger)
    return {f"{k}_{tag}": getattr(m, attr) for k, m in metric_logger.meters.items()
            for tag, attr in (("avg", "global_avg"), ("med", "median"))}


def build_model(model_str, device, dtype=None, remat=False, seed=0, remat_policy="full"):
    """The model of an arch string (landscape_only as JAX passes it)."""
    from .checkpoint import model_from_arch_string

    overrides = dict(device=device, remat=remat, remat_policy=remat_policy, seed=seed)
    if dtype is not None:
        overrides["dtype"] = dtype
    return model_from_arch_string(model_str, landscape_only=True, **overrides)


def train_rank(rank, world_size, device, args, on_step=None):
    """One rank of `train(args)` started by `parallel.distributed.launch`:
    the launcher's environment names the rank, `device` its card."""
    args.device = str(device)
    return train(args, on_step=on_step)


def _rank_devices(args, dims):
    """The devices of `--mesh N,F,M` without a launcher, in rank order:
    N x F x M CPU ranks with `--device cpu`, else the first N x F x M
    visible cards (JAX's error when fewer are visible)."""
    from .parallel.mesh import make_mesh

    if getattr(args, "device", None) and torch.device(args.device).type == "cpu":
        return [torch.device("cpu")] * math.prod(dims)
    return make_mesh(*dims)


def train(args, on_step=None):
    """The training job of `python -m dust3r_tpu_torch.train`'s flags:
    datasets, model, epochs, evaluation, checkpoints. on_step(module,
    epoch, i, metrics, micro_batches) is called after each optimizer step
    (a caller's probe). Returns the trained (unwrapped) model and its
    optimizer.

    `--mesh N[,F[,M]]` (JAX's `--mesh data,fsdp,model`) runs one process a
    device over the backend `--dist_backend`: under a launcher (torchrun:
    RANK, WORLD_SIZE set), this process is one rank and N x F x M must
    equal WORLD_SIZE; without one, N x F x M > 1 starts that many ranks on
    the first cards (CPU processes with `--device cpu`) and returns None
    once they end, and 1 makes this process a group of one. F = M = 1 is
    the data axis alone: the model wrapped in DistributedDataParallel. F or
    M above 1 shards the model over a (data, fsdp, model) mesh
    (`parallel.mesh.shard_params`: parameters, gradients and AdamW state
    split F ways, the MLPs M ways) before the optimizer is made. Each data
    index loads its share of the train set (`BatchedRandomSampler`'s split
    over N) at `--batch_size` and seeds numpy with seed + data index, so
    the F x M ranks of one index load the same batches; the LR rule counts
    the global batch (batch_size x accum_iter x N); rank 0 writes the
    checkpoints (a sharded model's gathered to the `--mesh 1` layout) and
    the logs, every rank resumes from checkpoint-last.pth."""
    from .checkpoint import (full_train_state, load_train_checkpoint, save_train_checkpoint,
                             warm_start)
    from .datasets import get_data_loader
    from .losses import build_criterion
    from .parallel.distributed import (free_port, get_rank, get_world_size,
                                       init_distributed_mode, is_main_process, launch,
                                       rank_device, replica_batches, save_on_master)
    from .parallel.mesh import make_mesh, parse_mesh_arg, shard_params, train_mesh
    from .utils.device import default_device

    backend = getattr(args, "dist_backend", "nccl")
    mesh_dims = parse_mesh_arg(getattr(args, "mesh", ""))
    n_data, n_fsdp, n_model = mesh_dims or (1, 1, 1)
    sharded = n_fsdp > 1 or n_model > 1
    n_ranks = n_data * n_fsdp * n_model
    if mesh_dims is not None:
        print(f"mesh: data={n_data} fsdp={n_fsdp} model={n_model}")
    launched = dist.is_initialized() or ("RANK" in os.environ and "WORLD_SIZE" in os.environ)
    if launched and getattr(args, "local_rank", -1) >= 0:  # torch.distributed.launch's flag
        os.environ.setdefault("LOCAL_RANK", str(args.local_rank))
    if not launched and n_ranks > 1:  # --mesh N[,F[,M]] in one command, as in JAX
        launch(train_rank, _rank_devices(args, (n_data, n_fsdp, n_model)),
               args=(args, on_step))
        return None
    own_group = False
    if launched:
        device = rank_device(getattr(args, "device", None))
    elif getattr(args, "device", None):
        device = torch.device(args.device)
    elif mesh_dims is not None:
        device = make_mesh(1)[0]
    else:
        device = default_device("train")
    if launched or mesh_dims is not None:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        if launched:
            init_distributed_mode(backend)
        else:  # --mesh 1 without a launcher: a group of one
            own_group = init_distributed_mode(backend, f"tcp://localhost:{free_port()}", 1, 0)
        if get_world_size() != n_ranks:
            raise ValueError(f"--mesh {getattr(args, 'mesh', '') or 1} asks for {n_ranks} "
                             f"ranks but the launcher started {get_world_size()}")
        if getattr(args, "world_size", 1) not in (1, get_world_size()):
            raise ValueError(f"--world_size {args.world_size} but the launcher started "
                             f"{get_world_size()} ranks")
    rank, world = get_rank(), get_world_size()
    mesh = train_mesh(n_data, n_fsdp, n_model, device.type) if sharded else None
    data_rank = mesh.get_coordinate()[0] if sharded else rank  # this rank's data index
    # the fsdp and model ranks of a data index train on one slice, its first
    # rank's: a loader's draws (ColorJitter's) differ from process to process
    share = replica_batches(n_data, n_fsdp * n_model) if sharded else None
    os.makedirs(args.output_dir, exist_ok=True)
    print("output_dir: " + args.output_dir)
    np.random.seed(args.seed + data_rank)
    torch.manual_seed(args.seed)

    print(f"Building train dataset {args.train_dataset}")
    loader_train = get_data_loader(args.train_dataset, batch_size=args.batch_size,
                                   num_workers=args.num_workers, world_size=n_data,
                                   rank=data_rank)
    loaders_test = {}
    if args.test_dataset and args.test_dataset != "[None]":
        for dataset in args.test_dataset.split("+"):
            name = dataset.split("(")[0].strip()
            loaders_test[name] = get_data_loader(dataset, batch_size=args.batch_size,
                                                 num_workers=args.num_workers, shuffle=False,
                                                 drop_last=False)

    print(f"Loading model: {args.model}")
    model = build_model(args.model, device, dtype=torch.bfloat16 if args.amp else None,
                        remat=bool(getattr(args, "remat", 0)), seed=args.seed,
                        remat_policy=getattr(args, "remat_policy", "full"))
    train_criterion = build_criterion(args.train_criterion)
    test_criterion = build_criterion(args.test_criterion or args.train_criterion)

    eff_batch_size = args.batch_size * args.accum_iter * n_data
    if args.lr is None:
        args.lr = args.blr * eff_batch_size / 256
    print(f"actual lr: {args.lr:.2e}  effective batch size: {eff_batch_size}")
    spec = TrainSpec(lr=args.lr, min_lr=args.min_lr, warmup_epochs=args.warmup_epochs,
                     epochs=args.epochs, weight_decay=args.weight_decay,
                     accum_iter=args.accum_iter, amp=bool(args.amp))
    if args.pretrained:
        print("Loading pretrained:", args.pretrained)
        warm_start(args.pretrained, model)
    if sharded:  # every rank built the same weights; each keeps its shards
        shard_params(mesh, model)
    optimizer = make_optimizer(model, spec)
    start_epoch, best_so_far = 0, math.inf
    last_ckpt = os.path.join(args.output_dir, "checkpoint-last.pth")
    if os.path.isfile(last_ckpt):
        print("auto-resuming from", last_ckpt)
        epoch, best_so_far = load_train_checkpoint(last_ckpt, model, optimizer)
        start_epoch = epoch + 1
    module = model
    if dist.is_initialized() and not sharded:  # the ranks start from rank 0's weights
        model = DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda" else None)

    log_writer = None
    if is_main_process():
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass
        else:
            log_writer = SummaryWriter(log_dir=args.output_dir)

    def save_model(epoch, fname, best):
        # a sharded model's state is gathered to rank 0 by every rank first
        state = full_train_state(module, optimizer) if sharded else None
        save_on_master(save_train_checkpoint,
                       os.path.join(args.output_dir, f"checkpoint-{fname}.pth"), module,
                       optimizer, epoch, best, args, state=state)

    def write_log_stats(epoch, train_stats, test_stats):
        if not is_main_process():
            return
        log_stats = dict(epoch=epoch, **{f"train_{k}": v for k, v in train_stats.items()})
        for name, stats in test_stats.items():
            log_stats.update({f"{name}_{k}": v for k, v in stats.items()})
        with open(os.path.join(args.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps(log_stats) + "\n")

    print(f"Start training for {args.epochs} epochs")
    train_stats, test_stats = {}, {}
    t_start = time.time()
    try:
        for epoch in range(start_epoch, args.epochs + 1):
            if epoch > start_epoch and args.save_freq and (
                    epoch % args.save_freq == 0 or epoch == args.epochs):
                save_model(epoch - 1, "last", best_so_far)
            new_best = False
            if epoch > 0 and args.eval_freq > 0 and epoch % args.eval_freq == 0:
                test_stats = {}
                for name, loader in loaders_test.items():
                    stats = test_one_epoch(model, test_criterion, loader, epoch, device,
                                           print_freq=args.print_freq, prefix=name,
                                           img_dtype=torch.bfloat16 if spec.amp else None,
                                           share=share)
                    test_stats[name] = stats
                    if stats["loss_med"] < best_so_far:
                        best_so_far = stats["loss_med"]
                        new_best = True
            write_log_stats(epoch, train_stats, test_stats)
            if epoch > start_epoch:
                if args.keep_freq and epoch % args.keep_freq == 0:
                    save_model(epoch - 1, str(epoch), best_so_far)
                if new_best:
                    save_model(epoch - 1, "best", best_so_far)
            if epoch >= args.epochs:
                break
            train_stats = train_one_epoch(model, optimizer, train_criterion, loader_train,
                                          epoch, spec, device, print_freq=args.print_freq,
                                          log_writer=log_writer, on_step=on_step, share=share)
        print(f"Training time {time.time() - t_start:.0f}s")
        save_model(args.epochs, "final", best_so_far)
        if world > 1:  # every rank returns once rank 0's checkpoints are on disk
            dist.barrier()
    finally:
        if log_writer is not None:
            log_writer.close()
        if own_group:
            dist.destroy_process_group()
    return module, optimizer
