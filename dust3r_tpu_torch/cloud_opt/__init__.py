"""Global alignment: fuse pairwise pointmaps into one consistent scene.

Counterpart of `dust3r_tpu/cloud_opt/__init__.py`.
"""
from enum import Enum

from .optimizer import ModularPointCloudOptimizer, PointCloudOptimizer
from .pair_viewer import PairViewer


class GlobalAlignerMode(Enum):
    PointCloudOptimizer = "PointCloudOptimizer"
    ModularPointCloudOptimizer = "ModularPointCloudOptimizer"
    PairViewer = "PairViewer"


_MODES = {
    GlobalAlignerMode.PointCloudOptimizer: PointCloudOptimizer,
    GlobalAlignerMode.ModularPointCloudOptimizer: ModularPointCloudOptimizer,
    GlobalAlignerMode.PairViewer: PairViewer,
}


def global_aligner(dust3r_output, device=None, mode=GlobalAlignerMode.PointCloudOptimizer,
                   mesh=None, **optim_kw):
    """Build a scene optimizer from an inference output dict: numpy
    predictions (`inference()`) or device tensors
    (`InferenceEngine.infer_pairs(..., to_cpu=False)`). `device`: where the
    scene's observations and parameters live; None keeps tensor predictions
    on their device and puts numpy ones on the CUDA card, and raises when
    there is none (pass device="cpu" for the CPU). `mesh`: a list of
    devices over which the edges' observations are split, the parameters
    on the first (`base_opt.py`; JAX's `mesh=`); it replaces `device`."""
    view1, view2 = dust3r_output["view1"], dust3r_output["view2"]
    pred1, pred2 = dust3r_output["pred1"], dust3r_output["pred2"]
    try:
        cls = _MODES[mode]
    except KeyError:
        raise NotImplementedError(f"Unknown mode {mode}")
    return cls(view1, view2, pred1, pred2, device=device, mesh=mesh, **optim_kw)
