"""Visloc benchmark datasets (counterpart of `dust3r_tpu/visloc/datasets/`).

The four benchmark classes and the two bases, with a name registry so that
the CLI resolves `--dataset` strings.
"""
from . import aachen_day_night as _aachen
from . import base_colmap as _base_colmap
from . import base_dataset as _base
from . import cambridge_landmarks as _cambridge
from . import inloc as _inloc
from . import sevenscenes as _sevenscenes

BaseVislocDataset = _base.BaseVislocDataset
BaseVislocColmapDataset = _base_colmap.BaseVislocColmapDataset

#: name -> class, the namespace of the CLI's --dataset expressions
DATASET_REGISTRY = {
    cls.__name__: cls
    for cls in (
        _sevenscenes.VislocSevenScenes,
        _cambridge.VislocCambridgeLandmarks,
        _aachen.VislocAachenDayNight,
        _inloc.VislocInLoc,
    )
}
globals().update(DATASET_REGISTRY)

__all__ = ["BaseVislocDataset", "BaseVislocColmapDataset", "DATASET_REGISTRY",
           *DATASET_REGISTRY]
