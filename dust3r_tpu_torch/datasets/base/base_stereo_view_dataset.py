"""Base class of the stereo-view training datasets.

Counterpart of `dust3r_tpu/datasets/base/base_stereo_view_dataset.py`.
Subclasses implement `_get_views(idx, resolution, rng)`, returning two
view dicts {img (PIL), depthmap, camera_pose (cam2world),
camera_intrinsics, dataset, label, instance}; the base draws each item's
generator from the dataset seed and the index, transforms the image (NHWC
float32), derives pts3d and valid_mask, stores portrait views transposed
to landscape (`transpose_to_landscape`: batches keep one shape; the
training loop flags them `is_portrait`) and records the generator's state.
"""
from __future__ import annotations

import numpy as np

from ...utils.geometry import depthmap_to_absolute_camera_coordinates
from ..utils import cropping
from ..utils.transforms import ImgNorm
from .easy_dataset import EasyDataset

_VIEW_VALUE_DTYPES = (np.float32, bool, np.bool_, np.int32, np.int64, np.uint8)


class BaseStereoViewDataset(EasyDataset):
    def __init__(self, *, split=None, resolution=None, transform=ImgNorm, aug_crop=False,
                 seed=None):
        self.num_views = 2
        self.split = split
        self._set_resolutions(resolution)
        if isinstance(transform, str):
            from ..utils.transforms import TRANSFORM_DSL_NAMES

            transform = TRANSFORM_DSL_NAMES[transform]
        self.transform = transform
        self.aug_crop = aug_crop
        self.seed = seed

    def __len__(self):
        return len(self.scenes)

    def get_stats(self):
        return f"{len(self)} pairs"

    def __repr__(self):
        res = "[" + ";".join(f"{w}x{h}" for w, h in self._resolutions) + "]"
        return (f"{type(self).__name__}({self.get_stats()}, split={self.split}, "
                f"seed={self.seed}, resolutions={res})")

    def _get_views(self, idx, resolution, rng):
        raise NotImplementedError

    def _item_rng(self, idx):
        """A seeded dataset's generator is seeded by seed + idx, so each item
        is reproducible; an unseeded one keeps one stream a process."""
        if self.seed:
            self._rng = np.random.default_rng(seed=self.seed + idx)
        elif not hasattr(self, "_rng"):
            entropy = np.random.SeedSequence().entropy % (2 ** 63)
            self._rng = np.random.default_rng(seed=int(entropy))
        return self._rng

    def _finalize_view(self, view):
        """Transform the image, derive pts3d / valid_mask, check dtypes."""
        if {"pts3d", "valid_mask"} & view.keys():
            raise ValueError("pts3d / valid_mask are computed here from depth, K and pose")
        pil = view["img"]
        view["true_shape"] = np.int32((pil.size[1], pil.size[0]))  # (H, W)
        view["img"] = self.transform(pil)
        if "camera_intrinsics" not in view:
            raise ValueError(f"no camera_intrinsics for view {view_name(view)}")
        if "camera_pose" in view:
            if not np.isfinite(view["camera_pose"]).all():
                raise ValueError(f"NaN in camera pose for view {view_name(view)}")
        else:
            view["camera_pose"] = np.full((4, 4), np.nan, np.float32)
        if not np.isfinite(view["depthmap"]).all():
            raise ValueError(f"NaN in depthmap for view {view_name(view)}")
        pts3d, valid = depthmap_to_absolute_camera_coordinates(
            view["depthmap"], view["camera_intrinsics"], view["camera_pose"])
        pts3d = np.asarray(pts3d)
        view["pts3d"] = pts3d
        view["valid_mask"] = np.asarray(valid) & np.isfinite(pts3d).all(-1)
        for key, val in view.items():
            good, err = is_good_type(val)
            if not good:
                raise TypeError(f"{err} with {key}={val} for {view_name(view)}")

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            idx, ar_idx = idx
        else:
            if len(self._resolutions) != 1:
                raise IndexError("index a dataset of several resolutions with (idx, ar_idx)")
            ar_idx = 0
        rng = self._item_rng(idx)
        views = self._get_views(idx, self._resolutions[ar_idx], rng)
        if len(views) != self.num_views:
            raise ValueError(f"{len(views)} views, not {self.num_views}")
        for v, view in enumerate(views):
            view["idx"] = (idx, ar_idx, v)
            self._finalize_view(view)
        for view in views:
            transpose_to_landscape(view)
            view["rng"] = int.from_bytes(rng.bytes(4), "big")
        return views

    def _set_resolutions(self, resolutions):
        if resolutions is None:
            raise ValueError("undefined resolution")
        if not isinstance(resolutions, list):
            resolutions = [resolutions]
        parsed = [(r, r) if isinstance(r, int) else tuple(r) for r in resolutions]
        for width, height in parsed:
            if not (isinstance(width, int) and isinstance(height, int)):
                raise TypeError(f"resolution {width, height} must be ints")
            if width < height:
                raise ValueError("landscape-ordered (W, H) expected")
        self._resolutions = parsed

    def _crop_resize_if_necessary(self, image, depthmap, intrinsics, resolution, rng=None,
                                  info=None):
        """Crop centred on the principal point -> Lanczos rescale (with the
        aug_crop headroom) -> a final crop that keeps the intrinsics
        consistent."""
        image = cropping._to_pil(image)
        pp = intrinsics[:2, 2].round().astype(int)
        margin = np.minimum(pp, np.array(image.size) - pp)
        center_box = (*(pp - margin), *(pp + margin))
        image, depthmap, intrinsics = cropping.crop_image_depthmap(image, depthmap, intrinsics,
                                                                   center_box)
        # portrait flips the target; near-square inputs coin-flip
        aspect = image.size[1] / image.size[0]  # H / W
        if aspect > 1.1:
            resolution = resolution[::-1]
        elif 0.9 < aspect < 1.1 and resolution[0] != resolution[1]:
            if rng.integers(2):
                resolution = resolution[::-1]
        target_resolution = np.array(resolution)
        if self.aug_crop > 1:
            target_resolution += rng.integers(0, self.aug_crop)
        image, depthmap, intrinsics = cropping.rescale_image_depthmap(
            image, depthmap, intrinsics, target_resolution)
        intrinsics2 = cropping.camera_matrix_of_crop(intrinsics, image.size, resolution,
                                                     offset_factor=0.5)
        crop_bbox = cropping.bbox_from_intrinsics_in_out(intrinsics, intrinsics2, resolution)
        return cropping.crop_image_depthmap(image, depthmap, intrinsics, crop_bbox)


def is_good_type(v):
    if isinstance(v, (str, int, tuple)):
        return True, None
    if v.dtype not in _VIEW_VALUE_DTYPES:
        return False, f"bad dtype={v.dtype}"
    return True, None


def view_name(view, batch_index=None):
    def sel(x):
        return x[batch_index] if batch_index not in (None, slice(None)) else x
    return f"{sel(view['dataset'])}/{sel(view['label'])}/{sel(view['instance'])}"


def transpose_to_landscape(view):
    """Store a portrait view transposed (img, valid_mask, depthmap, pts3d
    swap H and W; K's rows 0 and 1 swap); `true_shape` keeps the real
    orientation."""
    height, width = view["true_shape"]
    if width < height:
        for key in ("img", "valid_mask", "depthmap", "pts3d"):
            view[key] = view[key].swapaxes(0, 1)
        view["camera_intrinsics"] = view["camera_intrinsics"][[1, 0, 2]]
