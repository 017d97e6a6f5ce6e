"""Visloc dataset utilities: the aspect-ratio bucket table and the resize
plumbing.

Counterpart of `dust3r_tpu/visloc/utils.py` (reference
dust3r_visloc/datasets/utils.py). Resizing is PIL's, imported inside the
functions that use it; coordinates go back to the original resolution
through 3x3 `to_orig` / `to_resize` transforms in COLMAP's convention.
`plot_matches` draws with PIL's `ImageDraw` and `utils.image.jet` where the
JAX one uses matplotlib, which neither of this repo's machines has
(ROADMAP.md §C).
"""
from __future__ import annotations

import numpy as np

from ..utils.geometry import geotrf
from ..utils.image import jet

ratios_resolutions = {
    224: {1.0: [224, 224]},
    512: {4 / 3: [512, 384], 32 / 21: [512, 336], 16 / 9: [512, 288],
          2 / 1: [512, 256], 16 / 5: [512, 160]},
}


def get_HW_resolution(H, W, maxdim, patchsize=16):
    """The (H, W) bucket of an H x W image: the table's nearest aspect
    ratio, transposed for a portrait image."""
    if maxdim not in ratios_resolutions:
        raise ValueError(f"maxdim must be one of {list(ratios_resolutions)}")
    table = ratios_resolutions[maxdim]
    ratio = W / H
    ref_ratios = np.array(list(table.keys()))
    islandscape = W >= H
    diff = np.abs(ratio - ref_ratios) if islandscape else np.abs(ratio - 1 / ref_ratios)
    res = table[ref_ratios[np.argmin(diff)]]
    if isinstance(patchsize, tuple) and patchsize[0] != patchsize[1]:
        raise ValueError(f"square patches only, got {patchsize}")
    return res[::-1] if islandscape else res


def get_resize_function(maxdim, patch_size, H, W, is_mask=False):
    """(resize_op on HWC arrays or PIL images, to_resize 3x3, to_orig 3x3):
    a centre crop to the bucket's aspect ratio, then a PIL resize
    (bilinear, nearest for masks); the identity at a bucket's own size."""
    if [max(H, W), min(H, W)] in ratios_resolutions[maxdim].values():
        return (lambda x: x), np.eye(3), np.eye(3)

    target_HW = get_HW_resolution(H, W, maxdim=maxdim, patchsize=patch_size)
    ratio = W / H
    target_ratio = target_HW[1] / target_HW[0]
    to_orig_crop = np.eye(3)
    to_rescaled_crop = np.eye(3)
    if abs(ratio - target_ratio) < np.finfo(np.float32).eps:
        crop_W, crop_H = W, H
    elif ratio - target_ratio < 0:
        crop_W = W
        crop_H = int(W / target_ratio)
        to_orig_crop[1, 2] = (H - crop_H) / 2.0
        to_rescaled_crop[1, 2] = -(H - crop_H) / 2.0
    else:
        crop_W = int(H * target_ratio)
        crop_H = H
        to_orig_crop[0, 2] = (W - crop_W) / 2.0
        to_rescaled_crop[0, 2] = -(W - crop_W) / 2.0

    def resize_op(x):
        """Centre crop + resize, a channel at a time; HWC numpy (float or
        uint8) or a PIL image."""
        import PIL.Image

        arr = np.asarray(x)
        Himg, Wimg = arr.shape[:2]
        t = (Himg - crop_H) // 2
        l = (Wimg - crop_W) // 2
        arr = arr[t:t + crop_H, l:l + crop_W]
        resample = PIL.Image.NEAREST if is_mask else PIL.Image.BILINEAR
        size = (target_HW[1], target_HW[0])
        if arr.ndim == 3:
            return np.stack([np.asarray(PIL.Image.fromarray(arr[..., c]).resize(size, resample))
                             for c in range(arr.shape[-1])], axis=-1)
        return np.asarray(PIL.Image.fromarray(arr).resize(size, resample))

    to_orig_resize = np.array([[crop_W / target_HW[1], 0, 0],
                               [0, crop_H / target_HW[0], 0],
                               [0, 0, 1]])
    to_rescaled_resize = np.array([[target_HW[1] / crop_W, 0, 0],
                                   [0, target_HW[0] / crop_H, 0],
                                   [0, 0, 1]])
    return (resize_op, to_rescaled_resize @ to_rescaled_crop,
            to_orig_crop @ to_orig_resize)


def rescale_points3d(pts2d, pts3d, to_resize, HR, WR):
    """Sparse 2D (OpenCV convention) -> 3D correspondences mapped into the
    HR x WR rescaled image: (rescaled 2D, their integer pixels in the
    image, the (HR, WR, 3) map with NaN where no point falls, its validity)."""
    pts2d = pts2d.copy()
    pts2d[:, 0] += 0.5  # cv2 -> colmap convention
    pts2d[:, 1] += 0.5

    pts2d_rescaled = np.asarray(geotrf(to_resize, pts2d, norm=True))

    pts2d_rescaled_int = pts2d_rescaled.copy()
    pts2d_rescaled_int[:, 0] -= 0.5
    pts2d_rescaled_int[:, 1] -= 0.5
    pts2d_rescaled_int = pts2d_rescaled_int.round().astype(np.int64)

    valid = ((pts2d_rescaled_int[:, 0] >= 0) & (pts2d_rescaled_int[:, 0] < WR)
             & (pts2d_rescaled_int[:, 1] >= 0) & (pts2d_rescaled_int[:, 1] < HR))
    pts2d_rescaled_int = pts2d_rescaled_int[valid]

    pts3d_rescaled = np.full((HR, WR, 3), np.nan, dtype=np.float32)
    pts3d_rescaled[pts2d_rescaled_int[:, 1], pts2d_rescaled_int[:, 0]] = pts3d[valid]
    return (pts2d_rescaled, pts2d_rescaled_int, pts3d_rescaled,
            np.isfinite(pts3d_rescaled.sum(axis=-1)))


def cam_to_world_from_kapture(kdata, timestamp, camera_id):
    """A kapture trajectory record -> 4x4 cam2world (kapture and
    numpy-quaternion are optional, imported here)."""
    import quaternion

    camera_to_world = kdata.trajectories[timestamp, camera_id].inverse()
    camera_pose = np.eye(4, dtype=np.float32)
    camera_pose[:3, :3] = quaternion.as_rotation_matrix(camera_to_world.r)
    camera_pose[:3, 3] = camera_to_world.t_raw
    return camera_pose


def plot_matches(query_rgb, map_rgb, matches_im0, matches_im1, n_viz=20, save_path=None):
    """Side-by-side match overlay (reference visloc.py:127-146).

    query_rgb / map_rgb: uint8 HWC arrays or PIL images at their original
    resolution; matches_im0 / matches_im1: (N, 2) OpenCV-convention pixels in
    each. n_viz matches, evenly subsampled, are drawn as lines coloured
    along `jet`, with a '+' at each end, over the two images side by side
    (the shorter padded with black below). With save_path the PNG is
    written and its path returned; otherwise the image is returned (the JAX
    version shows a matplotlib window there). None when there is no match.
    """
    import PIL.Image
    import PIL.ImageDraw

    img0 = np.asarray(query_rgb)
    img1 = np.asarray(map_rgb)
    num = len(matches_im0)
    if num == 0:
        return None
    n_viz = min(n_viz, num)
    idx = np.round(np.linspace(0, num - 1, n_viz)).astype(int)
    m0, m1 = matches_im0[idx], matches_im1[idx]

    H0, W0 = img0.shape[:2]
    H1, W1 = img1.shape[:2]
    img0 = np.pad(img0, ((0, max(H1 - H0, 0)), (0, 0), (0, 0)), "constant", constant_values=0)
    img1 = np.pad(img1, ((0, max(H0 - H1, 0)), (0, 0), (0, 0)), "constant", constant_values=0)
    canvas = PIL.Image.fromarray(np.concatenate((img0, img1), axis=1).astype(np.uint8))
    draw = PIL.ImageDraw.Draw(canvas)
    colors = np.round(jet(np.arange(n_viz) / max(n_viz - 1, 1))[:, :3] * 255).astype(int)
    width = max(1, round(max(canvas.size) / 500))
    arm = 3 * width
    for (x0, y0), (x1, y1), color in zip(m0, m1, colors):
        color = tuple(int(c) for c in color)
        ends = ((float(x0), float(y0)), (float(x1) + W0, float(y1)))
        draw.line(ends, fill=color, width=width)
        for x, y in ends:
            draw.line(((x - arm, y), (x + arm, y)), fill=color, width=width)
            draw.line(((x, y - arm), (x, y + arm)), fill=color, width=width)
    if save_path is not None:
        canvas.save(save_path)
        return save_path
    return canvas
