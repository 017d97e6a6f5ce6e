"""The port's EXR codec (`dust3r_tpu_torch/utils/exr.py`) against the JAX
package's (`dust3r_tpu/utils/exr.py`), on the CPU:

* `write_exr` writes JAX's bytes for NONE / ZIPS / ZIP, HALF and FLOAT, one
  and three channels, and `read_exr` reads JAX's values from them;
* both read `tests/data/openexr_sample.exr` (written by the OpenEXR
  library) alike;
* the port's `imwrite_exr` writes the bytes JAX's writes where cv2 has no
  OpenEXR writer, and the port's `imread_cv2` reads an .exr as JAX's does;
* the refusals (tiled or multipart files, other compressions, not an EXR,
  other shapes) raise JAX's errors.
"""
import os.path as osp
import re
import struct

import numpy as np
import pytest

from dust3r_tpu.utils import exr as jexr
from dust3r_tpu.utils.image import imread_cv2 as jax_imread
from dust3r_tpu_torch.utils import exr
from dust3r_tpu_torch.utils.image import IMREAD_UNCHANGED, imread_cv2

SAMPLE = osp.join(osp.dirname(__file__), "data", "openexr_sample.exr")


def _image(shape, seed):
    """Values with long constant runs (ZIP compresses them) and noise (it
    does not), so both of the writer's branches are taken."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 80, shape).astype(np.float32)
    a[: shape[0] // 2] = np.round(a[: shape[0] // 2] / 8)
    return a


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
def test_write_exr_writes_jax_bytes_and_reads_them(tmp_path, compression, half, channels):
    shape = (37, 53) if channels == 1 else (33, 29, 3)
    a = _image(shape, seed=channels + 2 * half)
    ours, theirs = str(tmp_path / "port.exr"), str(tmp_path / "jax.exr")
    exr.write_exr(ours, a, half=half, compression=compression)
    jexr.write_exr(theirs, a, half=half, compression=compression)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    got, want = exr.read_exr(ours), jexr.read_exr(theirs)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(got, a.astype(np.float16).astype(np.float32) if half else a)
    with open(ours, "rb") as f:
        assert np.array_equal(exr.read_exr(f.read()), want)  # from bytes


def test_reads_the_openexr_library_file_as_jax():
    got, want = exr.read_exr(SAMPLE), jexr.read_exr(SAMPLE)
    assert got.shape == want.shape and got.shape[:2] == (16, 16)
    assert np.array_equal(got, want)


def test_imwrite_exr_is_jaxs_without_an_openexr_cv2(tmp_path):
    a = _image((40, 24), seed=5)
    exr.imwrite_exr(str(tmp_path / "port.exr"), a)
    jexr.imwrite_exr(str(tmp_path / "jax.exr"), a)  # this cv2 has no EXR writer
    assert (tmp_path / "port.exr").read_bytes() == (tmp_path / "jax.exr").read_bytes()


@pytest.mark.parametrize("shape", [(20, 30), (12, 18, 3)])
def test_imread_cv2_reads_exr_as_jax(tmp_path, shape):
    path = str(tmp_path / "depth.exr")
    jexr.write_exr(path, _image(shape, seed=7))
    for options in (None, IMREAD_UNCHANGED):
        got, want = imread_cv2(path, options), jax_imread(path, options)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _refusals(tmp_path):
    path = str(tmp_path / "ok.exr")
    jexr.write_exr(path, _image((8, 8), seed=0), compression="zips")
    with open(path, "rb") as f:
        buf = f.read()
    tiled = buf[:4] + struct.pack("<i", 2 | 0x200) + buf[8:]
    multipart = buf[:4] + struct.pack("<i", 2 | 0x1000) + buf[8:]
    at = buf.index(b"compression\0compression\0") + len(b"compression\0compression\0") + 4
    piz = buf[:at] + bytes([4]) + buf[at + 1:]
    return dict(tiled=tiled, multipart=multipart, piz=piz, not_exr=b"\0" * 8 + buf[8:])


@pytest.mark.parametrize("case", ["tiled", "multipart", "piz", "not_exr", "shape"])
def test_refusals_raise_jaxs_errors(tmp_path, case):
    if case == "shape":
        def call(codec):
            codec.write_exr(str(tmp_path / "x.exr"), np.zeros((4, 4, 2)))
    else:
        buf = _refusals(tmp_path)[case]

        def call(codec):
            codec.read_exr(buf)
    with pytest.raises(Exception) as want:
        call(jexr)
    with pytest.raises(want.type, match=f"^{re.escape(str(want.value))}$"):
        call(exr)
