"""Optimizer helpers (the reference's dust3r/optim_factory.py): the LR is
set on the optimizer's parameter groups each iteration."""


def adjust_learning_rate_by_lr(optimizer, lr):
    """Set every parameter group's learning rate."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer
