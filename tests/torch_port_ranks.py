"""Functions that spawned ranks of `dust3r_tpu_torch.parallel.distributed.
launch` run in tests/test_torch_port_parallel.py: torch and the port only
(a rank imports this module by name, not the test module, so not JAX)."""
import torch
from torch.nn.parallel import DistributedDataParallel

from dust3r_tpu_torch import training
from dust3r_tpu_torch.losses import build_criterion
from dust3r_tpu_torch.models.model import AsymmetricCroCo3DStereo
from dust3r_tpu_torch.parallel.distributed import get_rank, get_world_size, init_distributed_mode


def ddp_steps(rank, world_size, device, cfg, state_dict, groups_of_ranks, epochs_f, spec_kw,
              criterion):
    """`training.train_step` on a DistributedDataParallel over gloo, one
    step a group of this rank's loader batches (view1, view2) of
    `groups_of_ranks[rank]`; returns each step's metrics and the final
    parameters."""
    init_distributed_mode("gloo")
    assert (get_rank(), get_world_size()) == (rank, world_size)
    model = AsymmetricCroCo3DStereo(**cfg, device=device)
    model.load_state_dict(state_dict, strict=True)
    spec = training.TrainSpec(**spec_kw)
    optimizer = training.make_optimizer(model, spec)
    ddp = DistributedDataParallel(model)
    crit = build_criterion(criterion)
    fmask = training.freeze_mask(model, spec.freeze) if spec.freeze != "none" else None
    metrics = []
    for group, epoch_f in zip(groups_of_ranks[rank], epochs_f):
        batches = training.symmetric_micro_batches(group, device, None)
        metrics.append(training.train_step(ddp, optimizer, crit, batches, epoch_f, spec,
                                           fmask=fmask))
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return dict(metrics=metrics, params=params)


def train_runs(rank, world_size, device, args, epochs):
    """`training.train_rank` once for each count of `epochs` in turn (a
    later run resumes from the earlier one's checkpoint-last.pth), without a
    log writer (its TensorFlow import is slow); returns each run's trained
    (epoch, loss) pairs and the checkpoint files this rank wrote, and the
    final parameters."""
    import os.path as osp
    import sys

    from dust3r_tpu_torch import checkpoint

    sys.modules["torch.utils.tensorboard"] = None  # the import fails: no writer
    saves, runs = [], []
    save = checkpoint.save_train_checkpoint

    def counted_save(path, *a, **kw):
        saves.append(osp.basename(path))
        return save(path, *a, **kw)

    checkpoint.save_train_checkpoint = counted_save
    for n in epochs:
        args.epochs = n
        trained = []
        module, _ = training.train_rank(
            rank, world_size, device, args,
            on_step=lambda m, epoch, i, metrics, mb: trained.append((epoch, metrics["loss"])))
        runs.append(dict(trained=trained, saves=list(saves)))
        saves.clear()
    return dict(runs=runs, params={k: v.detach().clone() for k, v in module.state_dict().items()})
