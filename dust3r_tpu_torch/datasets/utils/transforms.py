"""Image transforms (numpy and PIL; output HWC float32).

Counterpart of `dust3r_tpu/datasets/utils/transforms.py`, on JAX's default
path, the host image core (`utils/fastimg.py`, `csrc/fastimg.cpp`, built by
g++ at first use):
* `ImgNorm`, the normalization (mean = std = 0.5): uint8 input through the
  core (`x * (2 / 255) - 1` in fp32), other input through `img_norm_ref`,
  the numpy formula (the two differ by at most one fp32 ulp);
* `ColorJitter` (brightness, contrast, saturation 0.5, hue 0.1, in a random
  order: torchvision's semantics): its parameters, and their application
  on PIL's `ImageEnhance` with the hue turn as OpenCV's uint8 RGB -> HSV ->
  RGB round trip, reproduced bit for bit without cv2 (`viz.bgr_to_hsv` /
  `viz.hsv_to_bgr`);
* `ColorJitterAndNorm`, the two fused in the core (float math, the hue
  turned by an exact fraction of a turn) on uint8 RGB input, else
  `color_jitter_norm_ref`: the PIL path, then `img_norm_ref` (JAX's path
  where its core is absent). As in JAX, its parameters come from a fresh
  unseeded generator unless one is passed, and the first call on the core
  prints the path on stderr once.
"""
from __future__ import annotations

import numpy as np

from ...utils import fastimg
from ...viz import bgr_to_hsv, hsv_to_bgr


def img_norm_ref(img):
    """PIL image or uint8 / float HWC array -> (H, W, 3) float32 in [-1, 1]:
    the numpy formula."""
    return (np.asarray(img).astype(np.float32) / 255.0 - 0.5) / 0.5


def ImgNorm(img):
    """PIL image or uint8 / float HWC array -> (H, W, 3) float32 in [-1, 1];
    uint8 through the host image core."""
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        return fastimg.imgnorm(arr)
    return img_norm_ref(arr)


def hue_turn(rgb, shift):
    """Turn the hue of a uint8 RGB array by `shift` of OpenCV's 180 steps."""
    hsv = bgr_to_hsv(np.asarray(rgb)[..., ::-1])
    # widened: a uint8 sum would wrap mod 256 before the mod 180
    hsv[..., 0] = ((hsv[..., 0].astype(np.int16) + shift) % 180).astype(np.uint8)
    return np.ascontiguousarray(hsv_to_bgr(hsv)[..., ::-1])


class ColorJitter:
    """Random brightness / contrast / saturation / hue jitter on PIL images:
    factors drawn uniformly from [max(0, 1 - v), 1 + v] (hue from [-h, h]),
    applied in a random order."""

    def __init__(self, brightness=0.5, contrast=0.5, saturation=0.5, hue=0.1, rng=None):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.rng = rng or np.random.default_rng()

    def sample_params(self):
        """[(op, factor), ...] in application order; the draws are
        brightness, contrast, saturation, hue, then the permutation."""
        rng = self.rng
        ops = []
        for name in ("brightness", "contrast", "saturation"):
            v = getattr(self, name)
            if v:
                ops.append((name, rng.uniform(max(0, 1 - v), 1 + v)))
        if self.hue:
            ops.append(("hue", rng.uniform(-self.hue, self.hue)))
        order = rng.permutation(len(ops))
        return [ops[i] for i in order]

    @staticmethod
    def apply_pil(img, params):
        import PIL.Image
        from PIL import ImageEnhance

        enhance = dict(brightness=ImageEnhance.Brightness, contrast=ImageEnhance.Contrast,
                       saturation=ImageEnhance.Color)
        for name, f in params:
            if name == "hue":
                # OpenCV's hue is [0, 180) a turn: f * 180 steps is the same
                # fraction of a turn torchvision applies
                shift = int(round(f * 180)) % 180
                img = PIL.Image.fromarray(hue_turn(np.asarray(img), shift))
            else:
                img = enhance[name](img).enhance(f)
        return img

    def __call__(self, img):
        return self.apply_pil(img, self.sample_params())


def color_jitter_norm_ref(img, params):
    """ColorJitter's `params` on the PIL path, then the numpy formula."""
    return img_norm_ref(ColorJitter.apply_pil(img, params))


def ColorJitterAndNorm(img, rng=None):
    """ColorJitter, then ImgNorm: fused in the host image core on a uint8
    RGB image, else `color_jitter_norm_ref`."""
    params = ColorJitter(rng=rng).sample_params()
    arr = np.asarray(img)
    if arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[-1] == 3:
        out = fastimg.color_jitter_norm(arr, [n for n, _ in params], [f for _, f in params])
        _log_jitter_path()
        return out
    return color_jitter_norm_ref(img, params)


_JITTER_PATH_LOGGED = False


def _log_jitter_path():
    """JAX's provenance line, once a process: the core's hue turn differs
    from the PIL path's, so a training stream is reproducible bit for bit
    only on one path."""
    global _JITTER_PATH_LOGGED
    if not _JITTER_PATH_LOGGED:
        _JITTER_PATH_LOGGED = True
        import sys

        print("[dust3r_tpu_torch] ColorJitter path: native fastimg (float HSV)",
              file=sys.stderr)


# the names of the dataset DSL: in the reference's namespace `ColorJitter`
# is the composed jitter + ImgNorm
TRANSFORM_DSL_NAMES = {
    "ImgNorm": ImgNorm,
    "ColorJitter": ColorJitterAndNorm,
    "ColorJitter+ImgNorm": ColorJitterAndNorm,
}
