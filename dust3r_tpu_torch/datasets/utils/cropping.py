"""Joint image / depth / intrinsics rescale and crop (host: PIL and numpy).

Counterpart of `dust3r_tpu/datasets/utils/cropping.py`: Lanczos down /
bicubic up for the image (PIL), nearest for the depth, the principal
point kept through the COLMAP <-> OpenCV half-pixel convention. The depth
resize is `cv2.resize(..., INTER_NEAREST)` reproduced in numpy
(`resize_nearest`, bit for bit). PIL is imported where an image is
touched, as in the rest of the port.
"""
from __future__ import annotations

import numpy as np

from ...utils.geometry import colmap_to_opencv_intrinsics, opencv_to_colmap_intrinsics


def _to_pil(image):
    import PIL.Image

    return image if isinstance(image, PIL.Image.Image) else PIL.Image.fromarray(image)


def resize_nearest(arr, size):
    """`cv2.resize(arr, size, interpolation=cv2.INTER_NEAREST)`: size is
    (W, H); output pixel (y, x) reads source (min(floor(y · sh / dh),
    sh - 1), the same for x), the scales in fp64 as OpenCV computes them
    (1 / (dst / src))."""
    dw, dh = (int(s) for s in size)
    sh, sw = arr.shape[:2]
    xs = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / sw))).astype(np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / sh))).astype(np.int64), sh - 1)
    return arr[ys][:, xs]


def rescale_image_depthmap(image, depthmap, camera_intrinsics, output_resolution,
                           force=True):
    """Rescale so the image covers output_resolution, keeping its aspect.
    `image` may be one PIL image / array or a tuple / list of same-size
    images, resized together."""
    multi = isinstance(image, (tuple, list))
    images = [_to_pil(im) for im in (image if multi else [image])]
    if any(im.size != images[0].size for im in images):
        raise ValueError("images of one call must share a size")
    input_resolution = np.array(images[0].size)  # (W, H)
    output_resolution = np.array(output_resolution)
    if depthmap is not None and tuple(depthmap.shape[:2]) != images[0].size[::-1]:
        raise ValueError(f"depth {depthmap.shape[:2]} does not match image {images[0].size}")
    scale_final = max(output_resolution / images[0].size) + 1e-8
    if scale_final >= 1 and not force:
        return (tuple(images) if multi else images[0]), depthmap, camera_intrinsics
    output_resolution = np.floor(input_resolution * scale_final).astype(int)
    from PIL.Image import Resampling

    resample = Resampling.LANCZOS if scale_final < 1 else Resampling.BICUBIC
    images = [im.resize(tuple(output_resolution), resample=resample) for im in images]
    if depthmap is not None:
        depthmap = resize_nearest(depthmap, output_resolution)
    camera_intrinsics = camera_matrix_of_crop(camera_intrinsics, input_resolution,
                                              output_resolution, scaling=scale_final)
    return (tuple(images) if multi else images[0]), depthmap, camera_intrinsics


def camera_matrix_of_crop(input_camera_matrix, input_resolution, output_resolution,
                          scaling=1, offset_factor=0.5, offset=None):
    margins = np.asarray(input_resolution) * scaling - output_resolution
    if not np.all(margins >= 0.0):
        raise ValueError(f"crop {output_resolution} larger than the scaled input")
    if offset is None:
        offset = offset_factor * margins
    K = opencv_to_colmap_intrinsics(np.asarray(input_camera_matrix))
    K[:2, :] *= scaling
    K[:2, 2] -= offset
    return colmap_to_opencv_intrinsics(K)


def crop_image_depthmap(image, depthmap, camera_intrinsics, crop_bbox):
    image = _to_pil(image)
    l, t, r, b = crop_bbox
    image = image.crop((l, t, r, b))
    depthmap = depthmap[t:b, l:r]
    camera_intrinsics = np.array(camera_intrinsics)
    camera_intrinsics[0, 2] -= l
    camera_intrinsics[1, 2] -= t
    return image, depthmap, camera_intrinsics


def bbox_from_intrinsics_in_out(input_camera_matrix, output_camera_matrix, output_resolution):
    out_width, out_height = output_resolution
    l, t = np.int32(np.round(input_camera_matrix[:2, 2] - output_camera_matrix[:2, 2]))
    return (l, t, l + out_width, t + out_height)
