"""dust3r_tpu_torch: the PyTorch / CUDA port of dust3r_tpu for NVIDIA Hopper.

Scene reconstruction (images -> pairs -> engine -> pointmaps and
confidences -> global aligner -> one scene's pointmaps, poses and focals),
with the fused 2D-RoPE attention and the DPT heads' 3x3 convs, 2x
upsamples and tails as hand-written CUDA kernels (`csrc/`, built at first
use into `build/dust3r_tpu_torch/`). Entry points run on the CUDA card
unless the caller passes `device="cpu"`. The JAX package `dust3r_tpu` is
the reference this port is tested against; the port imports no JAX.

Precision: params fp32; the transformer body computes in the model's
`dtype` (bf16 on the card) with fp32 LayerNorm and softmax; heads fp32.
TF32 is off for both matmuls and cuDNN convolutions, so an fp32 path
(the heads, the fp32 parity forward) is fp32; the two lines below, run at
import, are the one place that sets it.
"""
import importlib

import torch

__version__ = "0.1.0"

# PyTorch's defaults differ: TF32 off for matmuls, on for cuDNN convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .models.model import AsymmetricCroCo3DStereo, NAMED_MODELS  # noqa: E402,F401


def __getattr__(name):
    """Lazy top-level API. The `inference` function is not on it: the
    submodule of that name takes the attribute once it is imported, so
    import it from `dust3r_tpu_torch.inference`."""
    homes = {"InferenceEngine": ".inference",
             "make_pairs": ".image_pairs", "load_images": ".utils.image",
             "views_from_arrays": ".utils.image", "global_aligner": ".cloud_opt",
             "GlobalAlignerMode": ".cloud_opt"}
    if name not in homes:
        raise AttributeError(name)
    return getattr(importlib.import_module(homes[name], __name__), name)
