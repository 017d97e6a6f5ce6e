"""ctypes bindings of the host image core (`csrc/fastimg.cpp`).

Counterpart of `dust3r_tpu/utils/fastimg.py`, with its API. The core is
the JAX package's `native/fastimg.cpp` (a copy in the port's `csrc/`),
built at first use by `g++` with JAX's flags (`ops/_build.py::
load_host_library`). Unlike JAX, nothing falls back to numpy: a missing
`g++` or a failed build raises, and `available()` says whether the core
loads. Each function counts its calls in `<fn>.launches`
(`_build.count_launch`), so a run can show that its loaders took the core.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..ops import _build

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "color_jitter_norm_u8": [_u8p, _f32p, ctypes.c_int64, _i32p, ctypes.c_int32, _f32p],
    "imgnorm_u8_f32": [_u8p, _f32p, ctypes.c_int64],
    "depth_valid_mask": [_f32p, _u8p, ctypes.c_int64],
    "resize_nearest_f32": [_f32p, ctypes.c_int64, ctypes.c_int64, _f32p, ctypes.c_int64,
                           ctypes.c_int64],
}
# op codes of color_jitter_norm_u8
JITTER_OPS = {"brightness": 0, "contrast": 1, "saturation": 2, "hue": 3}


def _lib():
    lib = _build.load_host_library("fastimg")
    if not getattr(lib, "_typed", False):
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, None
        lib._typed = True
    return lib


def ensure_built():
    """Compile the core unless built; returns the library's path (raises
    if g++ is missing or fails)."""
    return str(_build.build_host("fastimg"))


def available():
    """Whether the core builds and loads here."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(arr, ptype):
    return arr.ctypes.data_as(ptype)


def imgnorm(arr_u8):
    """uint8 (..., 3) -> float32 in [-1, 1], as `x * (2 / 255) - 1` in fp32."""
    arr_u8 = np.ascontiguousarray(arr_u8, dtype=np.uint8)
    out = np.empty(arr_u8.shape, np.float32)
    _lib().imgnorm_u8_f32(_ptr(arr_u8, _u8p), _ptr(out, _f32p), arr_u8.size)
    _build.count_launch(imgnorm)
    return out


def depth_valid(depth_f32):
    """float32 depth -> bool validity mask (depth > 0 and finite)."""
    depth_f32 = np.ascontiguousarray(depth_f32, dtype=np.float32)
    out = np.empty(depth_f32.shape, np.uint8)
    _lib().depth_valid_mask(_ptr(depth_f32, _f32p), _ptr(out, _u8p), depth_f32.size)
    _build.count_launch(depth_valid)
    return out.astype(bool)


def resize_nearest(depth_f32, out_h, out_w):
    """Nearest-neighbour resize of an (H, W) depth map (cv2.INTER_NEAREST:
    source index floor(dst * scale))."""
    depth_f32 = np.ascontiguousarray(depth_f32, dtype=np.float32)
    if depth_f32.ndim != 2:
        raise ValueError(f"resize_nearest takes an (H, W) map, not {depth_f32.shape}")
    sh, sw = depth_f32.shape
    out = np.empty((out_h, out_w), np.float32)
    _lib().resize_nearest_f32(_ptr(depth_f32, _f32p), sh, sw, _ptr(out, _f32p), out_h, out_w)
    _build.count_launch(resize_nearest)
    return out


def color_jitter_norm(arr_u8, ops, factors):
    """Fused ColorJitter + ImgNorm on a uint8 (H, W, 3) image.

    ops: op names (JITTER_OPS keys) in application order; factors: their
    enhance factors (hue: a fraction of a turn). Returns float32 (H, W, 3)
    in [-1, 1]."""
    arr_u8 = np.ascontiguousarray(arr_u8, dtype=np.uint8)
    if arr_u8.ndim != 3 or arr_u8.shape[-1] != 3:
        raise ValueError(f"color_jitter_norm takes an (H, W, 3) image, not {arr_u8.shape}")
    if len(ops) != len(factors):
        raise ValueError(f"{len(ops)} ops but {len(factors)} factors")
    out = np.empty(arr_u8.shape, np.float32)
    ops_arr = np.asarray([JITTER_OPS[o] for o in ops], np.int32)
    fac_arr = np.asarray(factors, np.float32)
    _lib().color_jitter_norm_u8(_ptr(arr_u8, _u8p), _ptr(out, _f32p),
                                arr_u8.shape[0] * arr_u8.shape[1], _ptr(ops_arr, _i32p),
                                len(ops), _ptr(fac_arr, _f32p))
    _build.count_launch(color_jitter_norm)
    return out


for _fn in (imgnorm, depth_valid, resize_nearest, color_jitter_norm):
    _fn.launches = 0
del _fn
