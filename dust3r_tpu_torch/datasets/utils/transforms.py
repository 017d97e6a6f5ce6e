"""Image transforms (numpy; output HWC float32).

Counterpart of `dust3r_tpu/datasets/utils/transforms.py`: `ImgNorm` only,
the normalization visloc's datasets apply (mean = std = 0.5). The JAX one
goes through the native image core (`native/fastimg.cpp`, `x * (2 / 255)
- 1` in fp32) when that library is built and through this formula
otherwise; the two differ by at most one fp32 ulp
(tests/test_torch_port_visloc.py). `ColorJitter` waits for the training
loaders (ROADMAP.md queue A item 7).
"""
from __future__ import annotations

import numpy as np


def ImgNorm(img):
    """PIL image or uint8 / float HWC array -> (H, W, 3) float32 in [-1, 1]."""
    return (np.asarray(img).astype(np.float32) / 255.0 - 0.5) / 0.5
