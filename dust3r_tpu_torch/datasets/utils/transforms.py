"""Image transforms (numpy and PIL; output HWC float32).

Counterpart of `dust3r_tpu/datasets/utils/transforms.py`:
* `ImgNorm`, the normalization (mean = std = 0.5). The JAX one goes
  through the native image core (`native/fastimg.cpp`, `x * (2 / 255) - 1`
  in fp32) when that library is built and through this formula otherwise;
  the two differ by at most one fp32 ulp (tests/test_torch_port_visloc.py).
* `ColorJitter` (brightness, contrast, saturation 0.5, hue 0.1, in a random
  order: torchvision's semantics) on PIL's `ImageEnhance`, and the hue turn
  as OpenCV's uint8 RGB -> HSV -> RGB round trip, reproduced bit for bit
  without cv2 (`viz.bgr_to_hsv` / `viz.hsv_to_bgr`).
* `ColorJitterAndNorm`, the two composed: the JAX package's PIL path (its
  native `fastimg` path is not carried). As in JAX, its parameters come
  from a fresh unseeded generator unless one is passed.
"""
from __future__ import annotations

import numpy as np

from ...viz import bgr_to_hsv, hsv_to_bgr


def ImgNorm(img):
    """PIL image or uint8 / float HWC array -> (H, W, 3) float32 in [-1, 1]."""
    return (np.asarray(img).astype(np.float32) / 255.0 - 0.5) / 0.5


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


def ColorJitterAndNorm(img, rng=None):
    """ColorJitter, then ImgNorm."""
    jitter = ColorJitter(rng=rng)
    return ImgNorm(ColorJitter.apply_pil(img, jitter.sample_params()))


# the names of the dataset DSL: in the reference's namespace `ColorJitter`
# is the composed jitter + ImgNorm
TRANSFORM_DSL_NAMES = {
    "ImgNorm": ImgNorm,
    "ColorJitter": ColorJitterAndNorm,
    "ColorJitter+ImgNorm": ColorJitterAndNorm,
}
