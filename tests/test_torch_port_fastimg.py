"""The port's host image core (`dust3r_tpu_torch/utils/fastimg.py`, built
from `csrc/fastimg.cpp` by g++) against the JAX package's
(`dust3r_tpu/utils/fastimg.py`, built from `native/fastimg.cpp`), on the CPU.

* `imgnorm`, `depth_valid`, `resize_nearest` and `color_jitter_norm` equal
  JAX's core bit for bit, in one process: the two libraries are the same
  source under the same flags, and they run at the same OpenMP thread
  count. Across thread counts the bits may differ: the static schedule
  cuts each op's loop into other chunks, so other pixels fall on the
  scalar remainder of a vectorized loop, and g++ contracts the saturation
  blend into FMAs otherwise there than in the vector body (with
  `-ffp-contract=off` the bits agree). The contrast op's OpenMP sum is
  not the cause: it adds fp32 terms in double and rounds the mean to fp32
  once. Measured: 1 thread against 5, at most 3.6e-7 apart (3 fp32 ulps
  at 1); the test allows 1e-6.
* `color_jitter_norm_ref` (the PIL path, then the numpy formula) equals
  JAX's fallback (its core patched away) bit for bit; the core lies
  within JAX's own bounds of it (tests/test_fastimg.py: 0.01, hue 0.08,
  the four ops mixed 0.09).
* `ImgNorm` and `ColorJitterAndNorm` take the core, as JAX's do where its
  core builds, and equal JAX's default path bit for bit; each counts its
  calls; the provenance line is printed once.
* A missing g++ raises and names it: JAX falls back to numpy there, the
  port raises (ROADMAP §C).
"""
import os
import subprocess
import sys

import numpy as np
import PIL.Image
import pytest

import dust3r_tpu.datasets.utils.transforms as jtransforms
import dust3r_tpu.utils.fastimg as jfastimg
from dust3r_tpu_torch.datasets.utils import transforms
from dust3r_tpu_torch.ops import _build
from dust3r_tpu_torch.utils import fastimg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (ops, JAX's bound of the core against the PIL path)
JITTERS = [
    ([("brightness", 1.3)], 0.01),
    ([("brightness", 0.6)], 0.01),
    ([("contrast", 0.7)], 0.01),
    ([("contrast", 1.5)], 0.01),
    ([("saturation", 1.4)], 0.01),
    ([("hue", 0.08)], 0.08),
    ([("hue", -0.1)], 0.08),
    ([("saturation", 0.6), ("hue", 0.05), ("brightness", 1.2), ("contrast", 1.3)], 0.09),
]
THREADS_ATOL = 1e-6


def _image(seed, shape=(96, 128, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_core():
    assert jfastimg.available(), "JAX's core did not build (tests/test_fastimg.py needs it)"
    assert fastimg.available()


def test_elementwise_functions_equal_jax(jax_core):
    arr = _image(0, (97, 131, 3))
    got = fastimg.imgnorm(arr)
    assert got.dtype == np.float32 and np.array_equal(got, jfastimg.imgnorm(arr))
    assert np.abs(got - (arr.astype(np.float32) / 255.0 - 0.5) / 0.5).max() <= 3e-7
    rng = np.random.default_rng(1)
    depth = rng.uniform(-1, 5, (61, 83)).astype(np.float32)
    depth[::7, ::5] = np.nan
    depth[3, :9] = [np.inf, -np.inf, 0, -0.0, 1e-30, 1, 2, 3, 4]
    assert np.array_equal(fastimg.depth_valid(depth), jfastimg.depth_valid(depth))
    for out_h, out_w in ((30, 41), (61, 83), (122, 166), (17, 200), (1, 1)):
        got = fastimg.resize_nearest(depth, out_h, out_w)
        assert np.array_equal(got, jfastimg.resize_nearest(depth, out_h, out_w), equal_nan=True)


@pytest.mark.parametrize("params,bound", JITTERS)
def test_color_jitter_norm_equals_jax(jax_core, params, bound):
    arr = _image(2, (384, 512, 3))
    ops, factors = [n for n, _ in params], [f for _, f in params]
    got = fastimg.color_jitter_norm(arr, ops, factors)
    assert np.array_equal(got, jfastimg.color_jitter_norm(arr, ops, factors))
    ref = transforms.color_jitter_norm_ref(PIL.Image.fromarray(arr), params)
    assert float(np.abs(got - ref).max()) < bound


def test_sampled_jitters_equal_jax(jax_core):
    """Parameters as ColorJitter draws them, several images and sizes."""
    jit = transforms.ColorJitter(rng=np.random.default_rng(3))
    for k in range(12):
        arr = _image(10 + k, (48 + 8 * k, 64 + 5 * k, 3))
        params = jit.sample_params()
        ops, factors = [n for n, _ in params], [f for _, f in params]
        assert np.array_equal(fastimg.color_jitter_norm(arr, ops, factors),
                              jfastimg.color_jitter_norm(arr, ops, factors)), params
    assert np.array_equal(fastimg.color_jitter_norm(arr, [], []), fastimg.imgnorm(arr))


@pytest.mark.parametrize("params,bound", JITTERS)
def test_ref_path_equals_jax_fallback(monkeypatch, params, bound):
    monkeypatch.setattr(jfastimg, "_load", lambda: None)
    img = PIL.Image.fromarray(_image(4))
    want = jtransforms.ImgNorm(jtransforms.ColorJitter.apply_pil(img, params))
    got = transforms.color_jitter_norm_ref(img, params)
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_transforms_take_the_core(jax_core):
    arr = _image(5)
    img = PIL.Image.fromarray(arr)
    before = fastimg.imgnorm.launches, fastimg.color_jitter_norm.launches
    assert np.array_equal(transforms.ImgNorm(img), jtransforms.ImgNorm(img))
    for seed in (7, 8, 9):
        got = transforms.ColorJitterAndNorm(img, rng=np.random.default_rng(seed))
        want = jtransforms.ColorJitterAndNorm(img, rng=np.random.default_rng(seed))
        assert np.array_equal(got, want), seed
    assert (fastimg.imgnorm.launches - before[0],
            fastimg.color_jitter_norm.launches - before[1]) == (1, 3)
    f = arr.astype(np.float32)
    assert np.array_equal(transforms.ImgNorm(f), jtransforms.ImgNorm(f))


def test_jitter_path_is_printed_once(monkeypatch, capsys):
    monkeypatch.setattr(transforms, "_JITTER_PATH_LOGGED", False)
    img = PIL.Image.fromarray(_image(6, (16, 16, 3)))
    transforms.ColorJitterAndNorm(img, rng=np.random.default_rng(1))
    transforms.ColorJitterAndNorm(img, rng=np.random.default_rng(2))
    err = capsys.readouterr().err
    assert err.count("ColorJitter path: native fastimg (float HSV)") == 1


_THREADS_SCRIPT = """
import sys
import numpy as np
from dust3r_tpu_torch.utils import fastimg
outs = []
for seed in range(4):
    arr = np.random.default_rng(seed).integers(0, 256, (384, 512, 3), dtype=np.uint8)
    for ops, f in ((["contrast"], [0.7]), (["brightness", "contrast"], [1.37, 1.4]),
                   (["saturation", "hue", "contrast"], [0.6, 0.05, 0.55])):
        outs.append(fastimg.color_jitter_norm(arr, ops, f))
np.save(sys.argv[1], np.stack(outs))
"""


def test_thread_counts_agree_within_fma_rounding(jax_core, tmp_path):
    """1 and 5 OpenMP threads (196608 pixels: 5 chunks that split the
    vector loops' blocks): within THREADS_ATOL, the saturation blend's FMA
    contraction apart (see the module docstring); contrast alone on integer
    pixels is bit for bit."""
    outs = {}
    for n in (1, 5):
        path = tmp_path / f"t{n}.npy"
        env = dict(os.environ, OMP_NUM_THREADS=str(n), PYTHONPATH=ROOT)
        subprocess.run([sys.executable, "-c", _THREADS_SCRIPT, str(path)], env=env, check=True,
                       timeout=120)
        outs[n] = np.load(path)
    assert np.abs(outs[1] - outs[5]).max() <= THREADS_ATOL
    assert np.array_equal(outs[1][::3], outs[5][::3])


def test_a_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        fastimg.imgnorm(_image(0, (4, 4, 3)))
    assert not fastimg.available()
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        fastimg.ensure_built()


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "csrc"
    bad.mkdir()
    (bad / "fastimg.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", bad)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build fastimg.cpp") as err:
        fastimg.imgnorm(_image(0, (4, 4, 3)))
    assert "error" in str(err.value)
    assert not list((tmp_path / "build").rglob("*.so"))  # nothing half-written is left
