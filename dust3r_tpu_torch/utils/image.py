"""Host-side image loading and preprocessing (numpy; PIL only to read files).

A copy of the slice's part of `dust3r_tpu/utils/image.py` (importing that
package would pull in JAX): EXIF transpose, RGB, resize (224: short side
then centre square crop; 512: long side then patch-multiple centre crop;
square inputs cropped 3:4 unless square_ok), normalize with mean = std =
0.5. PIL is imported inside the functions that read files, so the module
imports where PIL is missing; `views_from_arrays` needs no PIL at all.

Each view dict: {img: (1, H, W, 3) float32 NHWC in [-1, 1], true_shape:
int32 [[H, W]], idx, instance}.

For display: `rgb` (the inverse of the normalization), `img_to_arr`, and
`jet`, a numpy copy of matplotlib's "jet" colormap (its 256-entry table,
indexed as a `Colormap` call indexes it) for the demo's confidence gallery.

`imread_cv2` reads what the training loaders read, as `cv2.imread` and
`COLOR_BGR2RGB` return it, with PIL: colour (`IMREAD_COLOR`: EXIF
orientation applied, RGB uint8), and `IMREAD_UNCHANGED` 8-bit and 16-bit
PNGs (uint8 / uint16, one channel or RGB); EXR depth maps with the port's
codec (`utils/exr.read_exr`, float32).
"""
from __future__ import annotations

import os

import numpy as np

_PLAIN_EXTS = (".jpg", ".jpeg", ".png")
_HEIF_EXTS = (".heic", ".heif")


def normalize_img(arr):
    """uint8 HWC -> float32 HWC in [-1, 1] (ImgNorm: mean=std=0.5)."""
    return (np.asarray(arr, dtype=np.float32) / 255.0 - 0.5) / 0.5


# cv2's imread flags, by value
IMREAD_UNCHANGED, IMREAD_GRAYSCALE, IMREAD_COLOR = -1, 0, 1


def imread_cv2(path, options=None):
    """An image file as `cv2.imread(path, options)` then BGR -> RGB returns
    it, read with PIL. options: None or IMREAD_COLOR (3-channel uint8, EXIF
    orientation applied, as cv2 applies it), IMREAD_GRAYSCALE, or
    IMREAD_UNCHANGED (the stored depth and channels: uint8 or uint16).

    An .exr file is `read_exr(path)` whatever the options: float32 (H, W)
    for a one-channel depth map, as JAX's `cv2.imread(path,
    IMREAD_ANYDEPTH)` or its `read_exr` fallback gives it; a three-channel
    file gives (H, W, 3) RGB, where a cv2 with OpenEXR would give one
    channel under IMREAD_ANYDEPTH."""
    import PIL.Image
    from PIL.ImageOps import exif_transpose

    flags = IMREAD_COLOR if options is None else options
    if path.lower().endswith(".exr"):
        from .exr import read_exr

        return read_exr(path)
    try:
        img = PIL.Image.open(path)
        img.load()
    except (OSError, ValueError) as e:
        raise IOError(f"Could not load image={path} with options={flags}") from e
    if flags == IMREAD_UNCHANGED:
        if img.mode in ("I;16", "I;16B", "I"):
            return np.asarray(img).astype(np.uint16)
        if img.mode == "L":
            return np.asarray(img)
        if img.mode in ("RGB", "RGBA", "P"):  # BGR2RGB drops an alpha
            return np.asarray(img.convert("RGB"))
        raise ValueError(f"{path}: PIL mode {img.mode} not read")
    img = exif_transpose(img)
    if flags == IMREAD_GRAYSCALE:
        return np.asarray(img.convert("L"))
    if flags != IMREAD_COLOR:
        raise ValueError(f"imread flags {flags} not in (-1, 0, 1)")
    if img.mode in ("I;16", "I;16B", "I"):  # cv2 keeps the high byte
        return np.repeat((np.asarray(img).astype(np.uint16) >> 8).astype(np.uint8)[..., None],
                         3, axis=-1)
    return np.asarray(img.convert("RGB"))


def img_to_arr(img):
    """An image array passes through; a path is read by `imread_cv2`."""
    return imread_cv2(img) if isinstance(img, str) else img


def rgb(ftensor, true_shape=None):
    """Undo the normalization for display: float NHWC / HWC in [-1, 1] ->
    [0, 1] (uint8 input: / 255); channel-first layouts are moved last."""
    if isinstance(ftensor, list):
        return [rgb(x, true_shape=true_shape) for x in ftensor]
    arr = ftensor.detach().cpu().numpy() if hasattr(ftensor, "detach") else np.asarray(ftensor)
    if arr.ndim == 3 and arr.shape[0] == 3:
        arr = np.moveaxis(arr, 0, -1)
    elif arr.ndim == 4 and arr.shape[1] == 3:
        arr = np.moveaxis(arr, 1, -1)
    if true_shape is not None:
        arr = arr[: true_shape[0], : true_shape[1]]
    if arr.dtype == np.uint8:
        return (arr / np.float32(255)).clip(0, 1)
    return (arr * 0.5 + 0.5).clip(0, 1)


# matplotlib's "jet" segment data (matplotlib/_cm.py): (x, y0, y1) per channel
_JET_DATA = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
              (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
}


def _lookup_table(n, data):
    """matplotlib's `_create_lookup_table` at gamma 1: piecewise-linear
    samples of one channel at n evenly spaced points, clipped to [0, 1]."""
    adata = np.array(data)
    x, y0, y1 = adata[:, 0] * (n - 1), adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n) ** 1.0
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def _jet_lut(n=256):
    """matplotlib's (n + 3, 4) table: n colours, then under, over, bad."""
    lut = np.ones((n + 3, 4))
    for c, name in enumerate(("red", "green", "blue")):
        lut[:-3, c] = _lookup_table(n, _JET_DATA[name])
    lut[n], lut[n + 1], lut[n + 2] = lut[0], lut[n - 1], 0.0
    return lut


_JET_LUT = _jet_lut()


def jet(x):
    """RGBA float64 of values in [0, 1], as `matplotlib.pyplot.get_cmap("jet")(x)`
    gives them for float input: x * 256 truncated to a row of the table (x
    == 1 the last row; below 0 the first, above 1 the last; NaN
    transparent black)."""
    n = len(_JET_LUT) - 3
    xa = np.array(x, copy=True)
    if xa.dtype.kind != "f":
        raise TypeError("jet takes floating values in [0, 1]")
    xa *= n
    xa[xa == n] = n - 1
    under, over, bad = xa < 0, xa >= n, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        xa = xa.astype(int)
    xa[under], xa[over], xa[bad] = n, n + 1, n + 2
    return _JET_LUT.take(xa, axis=0, mode="clip")


def _resize_long_edge(img, long_edge_size):
    import PIL.Image

    longest = max(img.size)
    scale = long_edge_size / longest
    target = tuple(int(round(side * scale)) for side in img.size)
    resample = (PIL.Image.LANCZOS if longest > long_edge_size
                else PIL.Image.BICUBIC)
    return img.resize(target, resample)


def _center_crop_box(width, height, size, square_ok, patch_size):
    """Crop box (l, t, r, b) around the image centre per the recipe."""
    cx, cy = width // 2, height // 2
    if size == 224:
        hw = hh = min(cx, cy)  # largest centred square
    else:
        # largest centred patch-multiple rectangle; 3:4 if square
        hw = ((2 * cx) // patch_size) * patch_size / 2
        hh = ((2 * cy) // patch_size) * patch_size / 2
        if width == height and not square_ok:
            hh = 3 * hw / 4
    return (cx - hw, cy - hh, cx + hw, cy + hh)


def preprocess_pil(img, size, square_ok=False, patch_size=16):
    """Resize and crop one PIL image per the recipe; returns PIL."""
    if size == 224:
        # short side lands on `size` (long edge = size * aspect)
        aspect = max(img.size) / min(img.size)
        resized = _resize_long_edge(img, round(size * aspect))
    else:
        resized = _resize_long_edge(img, size)
    box = _center_crop_box(*resized.size, size, square_ok, patch_size)
    return resized.crop(box)


def _view(arr_uint8, idx):
    height, width = arr_uint8.shape[:2]
    return dict(img=normalize_img(arr_uint8)[None],
                true_shape=np.int32([[height, width]]),
                idx=idx, instance=str(idx))


def _iter_source_images(folder_or_list):
    """Yield (display_name, PIL image) pairs from a folder or mixed list."""
    import PIL.Image

    try:
        import pillow_heif
    except ImportError:  # optional, as in the reference
        heif = False
    else:
        pillow_heif.register_heif_opener()
        heif = True
    if isinstance(folder_or_list, str):
        root, entries = folder_or_list, sorted(os.listdir(folder_or_list))
    elif isinstance(folder_or_list, list):
        root, entries = "", folder_or_list
    else:
        raise ValueError(f"bad folder_or_list={folder_or_list!r}")
    accepted = _PLAIN_EXTS + (_HEIF_EXTS if heif else ())
    for entry in entries:
        if isinstance(entry, PIL.Image.Image):
            yield "<PIL image>", entry
        elif str(entry).lower().endswith(accepted):
            yield entry, PIL.Image.open(os.path.join(root, entry))
    # other files are skipped, as in the reference


def load_images(folder_or_list, size, square_ok=False, verbose=True,
                patch_size=16):
    """Load a folder or list of image paths into model-ready view dicts."""
    from PIL.ImageOps import exif_transpose

    views = []
    for name, source in _iter_source_images(folder_or_list):
        upright = exif_transpose(source).convert("RGB")
        cropped = preprocess_pil(upright, size, square_ok, patch_size)
        if verbose:
            print(f" - adding {name} with resolution "
                  f"{upright.size[0]}x{upright.size[1]} --> "
                  f"{cropped.size[0]}x{cropped.size[1]}")
        views.append(_view(np.asarray(cropped), len(views)))
    if not views:
        raise FileNotFoundError(f"no images found at {folder_or_list}")
    if verbose:
        print(f" (Found {len(views)} images)")
    return views


def views_from_arrays(arrays, patch_size=16):
    """uint8 (H, W, 3) arrays already at a bucket size -> view dicts, as
    `load_images` makes them (no PIL)."""
    views = []
    for arr in arrays:
        arr = np.asarray(arr)
        if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
            raise ValueError(f"expected uint8 (H, W, 3), got {arr.dtype} {arr.shape}")
        if arr.shape[0] % patch_size or arr.shape[1] % patch_size:
            raise ValueError(f"{arr.shape[:2]} is not a multiple of {patch_size}")
        views.append(_view(arr, len(views)))
    return views
