"""The port's training data path against the JAX package, on the CPU, on
the Co3d-layout fixture of tests/test_co3d_loader.py (written with cv2,
plus one portrait sequence) and its WildRGB-D twin.

* `imread_cv2` (PIL) equals the JAX one (cv2) on the fixture's JPEG, 8-bit
  and 16-bit PNG files, bit for bit;
* the depth resize equals `cv2.resize(INTER_NEAREST)` over many sizes, and
  the hue turn's HSV -> RGB equals cv2's on every HSV triple;
* `Co3d` / `WildRGBD` views equal JAX's bit for bit at several
  resolutions, portrait ones among them, through ColorJitter and ImgNorm
  (both packages' unseeded jitter generator seeded alike), on both
  packages' host image core (JAX's default path) and, as a second case,
  on JAX's fallback (its core patched away) against the port's plain
  versions;
* the sampler yields JAX's (idx, ar_idx), the loader JAX's batches (with
  worker processes too), the dataset DSL JAX's lengths and items;
* the misc and device helpers equal JAX's.
"""
import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import dust3r_tpu.datasets as jds  # noqa: E402
import dust3r_tpu.utils.fastimg as jfastimg  # noqa: E402
import dust3r_tpu.utils.device as jdevice  # noqa: E402
import dust3r_tpu.utils.misc as jmisc  # noqa: E402
from dust3r_tpu.utils.image import imread_cv2 as jax_imread  # noqa: E402
import dust3r_tpu_torch.datasets as tds  # noqa: E402
from dust3r_tpu_torch.datasets.utils.cropping import resize_nearest  # noqa: E402
from dust3r_tpu_torch.utils import device as tdevice  # noqa: E402
from dust3r_tpu_torch.utils import misc as tmisc  # noqa: E402
from dust3r_tpu_torch.utils.image import IMREAD_UNCHANGED, imread_cv2  # noqa: E402
from dust3r_tpu_torch.viz import hsv_to_bgr  # noqa: E402

# (category, sequence, H, W): two landscape sequences and a portrait one
SEQS = (("apple", "seq0", 96, 128), ("apple", "seq1", 96, 128), ("pear", "seq2", 128, 96))


def _write_co3d(root, seed):
    rng = np.random.default_rng(seed)
    selected = {}
    for cat, seq, H, W in SEQS:
        selected.setdefault(cat, {})[seq] = list(range(100))
        base = osp.join(root, cat, seq)
        for sub in ("images", "depths", "masks"):
            os.makedirs(osp.join(base, sub), exist_ok=True)
        for fn in range(100):
            cv2.imwrite(osp.join(base, "images", f"frame{fn:06d}.jpg"),
                        rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
            depth = rng.uniform(1, 4, (H, W)).astype(np.float32)
            d16 = (depth / depth.max() * 65535).astype(np.uint16)
            cv2.imwrite(osp.join(base, "depths", f"frame{fn:06d}.jpg.geometric.png"), d16)
            mask = (rng.uniform(size=(H, W)) > 0.2).astype(np.uint8) * 255
            cv2.imwrite(osp.join(base, "masks", f"frame{fn:06d}.png"), mask)
            K = np.float32([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]])
            pose = np.eye(4, dtype=np.float32)
            pose[:3, 3] = rng.standard_normal(3)
            np.savez(osp.join(base, "images", f"frame{fn:06d}.npz"), camera_intrinsics=K,
                     camera_pose=pose, maximum_depth=float(depth.max()))
    with open(osp.join(root, "selected_seqs_train.json"), "w") as f:
        json.dump(selected, f)
    return root


def _write_wildrgbd(root, seed):
    rng = np.random.default_rng(seed)
    H, W = 96, 128
    base = osp.join(root, "cat", "scene0")
    for sub in ("rgb", "depth", "masks", "metadata"):
        os.makedirs(osp.join(base, sub), exist_ok=True)
    K = np.float32([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]])
    for fn in range(100):
        cv2.imwrite(osp.join(base, "rgb", f"{fn:0>5d}.jpg"),
                    rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
        cv2.imwrite(osp.join(base, "depth", f"{fn:0>5d}.png"),
                    rng.uniform(1000, 4000, (H, W)).astype(np.uint16))
        cv2.imwrite(osp.join(base, "masks", f"{fn:0>5d}.png"),
                    (rng.uniform(size=(H, W)) > 0.2).astype(np.uint8) * 255)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = rng.standard_normal(3)
        np.savez(osp.join(base, "metadata", f"{fn:0>5d}.npz"), camera_intrinsics=K,
                 camera_pose=pose, maximum_depth=4.0)
    with open(osp.join(root, "selected_seqs_train.json"), "w") as f:
        json.dump({"cat": {"scene0": list(range(100))}}, f)
    return root


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return dict(Co3d=_write_co3d(str(tmp_path_factory.mktemp("co3d")), 0),
                WildRGBD=_write_wildrgbd(str(tmp_path_factory.mktemp("wildrgbd")), 1))


@pytest.fixture(params=["native", "fallback"])
def same_jitter(request, monkeypatch):
    """Both packages' ColorJitter draw from np.random.default_rng() with no
    seed; seed those calls alike. "native": both take their host image core
    (JAX's default path, its core built as tests/test_fastimg.py builds
    it). "fallback": JAX's core patched away (its library absent), so JAX
    takes its PIL / cv2 path, and the port its plain versions
    (`img_norm_ref`, `color_jitter_norm_ref`)."""
    orig = np.random.default_rng

    def seeded(seed=None):
        return orig(1234 if seed is None else seed)

    monkeypatch.setattr(np.random, "default_rng", seeded)
    if request.param == "native":
        assert jfastimg.available()
    else:
        monkeypatch.setattr(jfastimg, "_load", lambda: None)
        patch_port_to_plain(monkeypatch)


def patch_port_to_plain(monkeypatch):
    """The port's transforms on their plain versions instead of the core."""
    import PIL.Image

    from dust3r_tpu_torch.datasets.utils import transforms
    from dust3r_tpu_torch.utils import fastimg

    monkeypatch.setattr(fastimg, "imgnorm", transforms.img_norm_ref)
    monkeypatch.setattr(fastimg, "color_jitter_norm", lambda arr, ops, factors: (
        transforms.color_jitter_norm_ref(PIL.Image.fromarray(arr), list(zip(ops, factors)))))


def test_imread_equals_cv2(roots):
    base = osp.join(roots["Co3d"], "pear", "seq2")
    for name, flags in (("images/frame000003.jpg", None), ("masks/frame000003.png", None),
                        ("masks/frame000003.png", IMREAD_UNCHANGED),
                        ("depths/frame000003.jpg.geometric.png", IMREAD_UNCHANGED)):
        got = imread_cv2(osp.join(base, name), flags)
        want = jax_imread(osp.join(base, name), flags)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert imread_cv2(osp.join(base, "depths/frame000003.jpg.geometric.png"),
                      IMREAD_UNCHANGED).dtype == np.uint16
    with pytest.raises(IOError):
        imread_cv2(osp.join(base, "images/frame000003.npz"))


def test_depth_resize_is_cv2_nearest():
    rng = np.random.default_rng(0)
    for _ in range(400):
        sh, sw, dh, dw = (int(n) for n in rng.integers(1, 400, 4))
        src = rng.random((sh, sw)).astype(np.float32)
        want = cv2.resize(src, (dw, dh), fx=0.3, fy=0.7, interpolation=cv2.INTER_NEAREST)
        assert np.array_equal(resize_nearest(src, (dw, dh)), want), (sh, sw, dh, dw)


@pytest.mark.parametrize("width", [1, 256, 100])
def test_hsv_to_rgb_is_cv2_on_every_triple(width):
    """Every HSV triple through cv2's scalar loop (rows of 1), its vector
    blocks (rows of 256) and both (rows of 100: the last 4 of each row)."""
    a = np.arange(256, dtype=np.uint8)
    hsv = np.stack(np.meshgrid(a, a, a, indexing="ij"), -1).reshape(-1, 3)
    hsv = np.concatenate([hsv, hsv[:(-len(hsv)) % width]]).reshape(-1, width, 3)
    assert np.array_equal(hsv_to_bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


RESOLUTIONS = "[(64, 48), (64, 32), (48, 48)]"


@pytest.mark.parametrize("name,extra", [
    ("Co3d", "mask_bg='rand', aug_crop=8, transform=ColorJitter"),
    ("Co3d", "mask_bg=True"),
    ("WildRGBD", "mask_bg=False, transform=ColorJitter"),
])
def test_views_equal_jax(roots, same_jitter, name, extra):
    dsl = f"{name}(split='train', ROOT='{roots[name]}', resolution={RESOLUTIONS}, seed=5, {extra})"
    ours, theirs = tds.build_dataset(dsl), jds.build_dataset(dsl)
    assert len(ours) == len(theirs) and repr(ours) == repr(theirs)
    portrait = 0
    for idx in (0, 7, len(ours) // 3, len(ours) - 1, len(ours) - 40):
        for ar in range(3):
            for got, want in zip(ours[idx, ar], theirs[idx, ar]):
                assert got.keys() == want.keys()
                for k, w in want.items():
                    g = got[k]
                    if isinstance(w, np.ndarray):
                        assert g.dtype == w.dtype and np.array_equal(g, w), (idx, ar, k)
                    else:
                        assert g == w, (idx, ar, k)
                portrait += int(got["true_shape"][0] > got["true_shape"][1])
    assert portrait > 0 or name == "WildRGBD"


def test_sampler_and_loader_equal_jax(roots, same_jitter):
    dsl = (f"20 @ Co3d(split='train', ROOT='{roots['Co3d']}', resolution={RESOLUTIONS}, "
           f"seed=3, transform=ColorJitter) + 2 * WildRGBD(split='train', "
           f"ROOT='{roots['WildRGBD']}', resolution={RESOLUTIONS}, seed=4)")
    ours = tds.get_data_loader(dsl, batch_size=4, num_workers=0)
    theirs = jds.get_data_loader(dsl, batch_size=4, num_workers=0)
    assert len(ours) == len(theirs) == len(jds.build_dataset(dsl)) // 4
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert list(ours.batch_sampler.sampler) == list(theirs.sampler)
        for n, (got, want) in enumerate(zip(ours, theirs)):
            _same_batch(got, want)
            if n == 3:
                break


def _same_batch(got, want):
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert np.array_equal(g[k].numpy(), w[k]), k
            else:
                assert list(g[k]) == list(w[k]), k


def test_loader_workers_give_the_same_batches(roots):
    """Spawned workers and pinned memory (where there is a card) change
    nothing in the batches, the main process having run the host image
    core (ImgNorm) before the workers start and load it again."""
    from dust3r_tpu_torch.utils import fastimg

    dsl = f"Co3d(split='train', ROOT='{roots['Co3d']}', resolution={RESOLUTIONS}, seed=3)"
    serial = tds.get_data_loader(dsl, batch_size=2, num_workers=0)
    workers = tds.get_data_loader(dsl, batch_size=2, num_workers=2)
    serial.set_epoch(2)
    workers.set_epoch(2)
    before = fastimg.imgnorm.launches
    iter_serial = iter(serial)
    wants = [next(iter_serial) for _ in range(3)]
    assert fastimg.imgnorm.launches - before == 3 * 2 * 2  # a call a view
    it = iter(workers)
    try:
        for n, got in enumerate(it):
            want = wants[n]
            for g, w in zip(got, want):
                for k in w:
                    if isinstance(w[k], torch.Tensor):
                        assert torch.equal(g[k], w[k]), k
                    else:
                        assert g[k] == w[k], k
            if n == 2:
                break
    finally:
        del it


def test_unshuffled_loader_and_dsl_equal_jax(roots, same_jitter):
    dsl = f"Co3d(split='train', ROOT='{roots['Co3d']}', resolution=(64, 48), seed=9)"
    ours = tds.get_data_loader(dsl, batch_size=3, num_workers=0, shuffle=False, drop_last=False)
    theirs = jds.get_data_loader(dsl, batch_size=3, num_workers=0, shuffle=False,
                                 drop_last=False)
    ours.set_epoch(0)
    theirs.set_epoch(0)
    assert len(ours) == len(theirs)
    _same_batch(next(iter(ours)), next(iter(theirs)))
    for expr in ("3 * {d}", "10 @ {d}", "{d} + 2 * {d}", "10_000 @ {d}"):
        o, t = tds.build_dataset(expr.format(d=dsl)), jds.build_dataset(expr.format(d=dsl))
        o.set_epoch(1)
        t.set_epoch(1)
        assert len(o) == len(t) and repr(o) == repr(t)
        _same_batch(tds.collate_views([o[len(o) - 1]]), jds.collate_views([t[len(t) - 1]]))


def test_build_dataset_names_all_nine(tmp_path):
    """Every dataset name of JAX's DSL builds (on the layouts of
    tools/train_scenes.py); the DSL still has no builtins."""
    from dust3r_tpu_torch.tools.train_scenes import TRAIN_ARGS, mix_dsl, write_mix

    roots = write_mix(str(tmp_path), frames=2, long_edge=64)
    assert set(roots) == set(tds.DATASET_CLASSES) == set(jds.DATASET_CLASSES)
    for name in TRAIN_ARGS:
        built = tds.build_dataset(mix_dsl(roots, {name: 1}, (32, 24)))
        assert type(built.dataset) is tds.DATASET_CLASSES[name] and len(built.dataset) > 0
    with pytest.raises(NameError):  # no builtins in the DSL
        tds.build_dataset("open('x')")


def test_misc_and_device_helpers_equal_jax():
    rng = np.random.default_rng(2)
    a, b = (rng.standard_normal((4, 3, 2)).astype(np.float32) for _ in range(2))
    for got, want in zip(tmisc.interleave(a, b), jmisc.interleave(a, b)):
        assert np.array_equal(got, want)
    for got, want in zip(tmisc.interleave(torch.from_numpy(a), torch.from_numpy(b)),
                         jmisc.interleave(a, b)):
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tmisc.flip(a), jmisc.flip(a))
    d = dict(x=rng.standard_normal((2, 3, 4, 1)))
    assert np.array_equal(tmisc.transposed(d)["x"], jmisc.transposed(d)["x"])
    for inst in ([("a", "b"), ("b", "a")], [("a", "b"), ("a", "b")], [("a",), ("a",)]):
        gt1, gt2 = dict(instance=list(inst[0])), dict(instance=list(inst[1]))
        assert tmisc.is_symmetrized(gt1, gt2) == jmisc.is_symmetrized(gt1, gt2)

    def f(x, y=2, *, z="q"):
        return x

    assert tmisc.fill_default_args({"y": 5}, f) == jmisc.fill_default_args({"y": 5}, f)
    results = [dict(pts=rng.standard_normal((2, 3)), name=["u", "v"]) for _ in range(3)]
    got, want = tdevice.collate_with_cat(results), jdevice.collate_with_cat(results)
    assert np.array_equal(got["pts"], want["pts"]) and got["name"] == want["name"]
    got = tdevice.collate_with_cat([dict(pts=torch.from_numpy(r["pts"])) for r in results])
    assert np.array_equal(got["pts"].numpy(), want["pts"])
    mixed = [rng.standard_normal((1, 2)), rng.standard_normal((3, 2))]
    for g, w in zip(tdevice.collate_with_cat(mixed, lists=True),
                    jdevice.collate_with_cat(mixed, lists=True)):
        assert np.array_equal(g, w)
    nested = dict(a=[torch.ones(2)], b=(np.zeros(3), "s"))
    got = tdevice.to_numpy(nested)
    assert isinstance(got["a"][0], np.ndarray) and got["b"][1] == "s"
    assert tdevice.to_cpu(nested)["b"][0].dtype == torch.float64
