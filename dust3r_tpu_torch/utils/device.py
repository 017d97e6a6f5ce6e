"""Where the port's entry points put their tensors when the caller names no
device: the CUDA card, or an error that says how to ask for the CPU."""
from __future__ import annotations

import torch


def default_device(what):
    """torch.device("cuda"); raises when there is no CUDA device, naming
    the `device="cpu"` argument of `what`, so nothing lands on the CPU
    unless the caller asks for it."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device (torch.cuda.is_available() is False); "
                           f"pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")
