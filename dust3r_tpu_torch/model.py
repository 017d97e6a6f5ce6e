"""Import-parity shim: `from dust3r_tpu_torch.model import ...` mirrors the
reference's `from dust3r.model import ...` surface, with its loader."""
from .checkpoint import (from_pretrained, load_torch_checkpoint,  # noqa: F401
                         model_from_arch_string)
from .models.model import (AsymmetricCroCo3DStereo, NAMED_MODELS,  # noqa: F401
                           dust3r_224_linear, dust3r_512_dpt, dust3r_512_linear)


def load_model(model_path, device=None, verbose=True, **overrides):
    """The reference's loader (dust3r/model.py:27-43): a `.pth` checkpoint
    -> the loaded module on `device` (the CUDA card when None; it raises
    without one). `overrides` (dtype, attn_impl, conv_impl) go to the
    constructor."""
    return load_torch_checkpoint(model_path, verbose=verbose, device=device, **overrides)
