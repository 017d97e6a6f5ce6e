"""The port's seven other training datasets against the JAX package's, on
the CPU, on the layouts of `dust3r_tpu_torch/tools/train_scenes.py` (PIL
JPEGs, the port's EXR writer; 128 pixels on the long edge, read at
64x48 / 64x32) and on one written the JAX way
(`tests/test_exr_loaders.py::_write_frame`: cv2 JPEGs, JAX's EXR writer):

* ARKitScenes, ScanNetpp, BlendedMVS, MegaDepth, StaticThings3D, Waymo
  and Habitat views equal JAX's bit for bit (img, depthmap, pts3d,
  valid_mask, camera_pose, camera_intrinsics, true_shape, dataset, label,
  instance, idx, rng) through aug_crop, ColorJitter (both packages'
  unseeded generator seeded alike; on both packages' host image core,
  JAX's default path, and again on JAX's fallback, its core patched away,
  against the port's plain versions) and mask_bg, over the splits; Habitat's walk past a view with a
  non-finite pose, MegaDepth's `select_scene`, Habitat's `filter_scene`;
* each layout's pts3d lies on the tool's plane (world z = PLANE_Z) to
  1e-3 of its depth, which a wrong convention (mm, cam2world against
  world2cam, Habitat's JSON) breaks;
* a batch of the nine-dataset mix through `get_data_loader` equals JAX's.
"""
import os
import os.path as osp
import sys

import numpy as np
import pytest

pytest.importorskip("cv2")
sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

import dust3r_tpu.datasets as jds  # noqa: E402
import dust3r_tpu.utils.fastimg as jfastimg  # noqa: E402
import dust3r_tpu_torch.datasets as tds  # noqa: E402
from dust3r_tpu_torch.tools.train_scenes import (PLANE_Z, TRAIN_ARGS, camera,  # noqa: E402
                                                 mix_dsl, write_mix)
from test_exr_loaders import _write_frame  # noqa: E402
from test_torch_port_train_data import patch_port_to_plain  # noqa: E402

RESOLUTIONS = "[(64, 48), (64, 32)]"


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return write_mix(str(tmp_path_factory.mktemp("mix")), frames=3, seed=0, long_edge=128)


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    """MegaDepth as JAX's own loader test writes it: 96x128, cv2, JAX's EXR."""
    root = str(tmp_path_factory.mktemp("megadepth_jax"))
    rng = np.random.default_rng(1)
    scenes, images = np.array(["0001 0", "0015 0"]), np.array(["im0", "im1", "im2", "im3"])
    pairs = np.array([(0, 0, 1, 0.9), (0, 1, 2, 0.8), (0, 2, 3, 0.7), (1, 3, 0, 0.7)],
                     dtype=[("scene_id", "i4"), ("im1_id", "i4"), ("im2_id", "i4"),
                            ("score", "f4")])
    np.savez(osp.join(root, "all_metadata.npz"), scenes=scenes, images=images, pairs=pairs)
    for scene in scenes:
        d = osp.join(root, *scene.split())
        os.makedirs(d)
        for im in images:
            _write_frame(d, im, rng)
    return root


@pytest.fixture(params=["native", "fallback"])
def same_jitter(request, monkeypatch):
    """Both packages' ColorJitter draw from np.random.default_rng() with no
    seed: seed those calls alike. "native": both on their host image core
    (JAX's default path); "fallback": JAX's core patched away, so JAX takes
    its PIL / cv2 path, and the port its plain versions."""
    orig = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: orig(1234 if seed is None else seed))
    if request.param == "native":
        assert jfastimg.available()
    else:
        monkeypatch.setattr(jfastimg, "_load", lambda: None)
        patch_port_to_plain(monkeypatch)


def _same_views(got, want, where):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys(), where
        for k, wv in w.items():
            if isinstance(wv, np.ndarray):
                assert g[k].dtype == wv.dtype and np.array_equal(g[k], wv), (where, k)
            else:
                assert g[k] == wv, (where, k, g[k], wv)


def _both(dsl):
    ours, theirs = tds.build_dataset(dsl), jds.build_dataset(dsl)
    assert len(ours) == len(theirs) and repr(ours) == repr(theirs)
    return ours, theirs


@pytest.mark.parametrize("name,args", [
    ("ARKitScenes", "split='train', aug_crop=256, transform=ColorJitter"),
    ("ARKitScenes", "split='test'"),
    ("ScanNetpp", "split='train', aug_crop=256, transform=ColorJitter"),
    ("BlendedMVS", "split='train', aug_crop=16, transform=ColorJitter"),
    ("BlendedMVS", "split='val'"),
    ("BlendedMVS", ""),
    ("MegaDepth", "split='train', aug_crop=16, transform=ColorJitter"),
    ("MegaDepth", "split='val'"),
    ("StaticThings3D", "mask_bg='rand', aug_crop=256, transform=ColorJitter"),
    ("StaticThings3D", "mask_bg=True"),
    ("StaticThings3D", "mask_bg=False"),
    ("Waymo", "aug_crop=16, transform=ColorJitter"),
    ("Habitat", "1_000_000, split='train', aug_crop=16, transform=ColorJitter"),
    ("Habitat", "1_000, split='val'"),
])
def test_views_equal_jax(roots, same_jitter, name, args):
    sep = ", " if args else ""
    ours, theirs = _both(f"{name}({args}{sep}ROOT='{roots[name]}', resolution={RESOLUTIONS}, "
                         f"seed=5)")
    portrait = 0
    for idx in range(len(ours)):
        for ar in range(2):
            got = ours[idx, ar]
            _same_views(got, theirs[idx, ar], (idx, ar))
            portrait += sum(int(v["true_shape"][0] > v["true_shape"][1]) for v in got)
    if name in ("ARKitScenes", "MegaDepth") and "train" in args:
        assert portrait  # their portrait scenes come through transposed


def test_habitat_walks_past_a_non_finite_pose(roots, same_jitter):
    """The tool's first train key has a failed render at file 3 (slot 2):
    pinned to it, the partner is read from slot 3 and recorded as slot 2."""
    dsl = (f"Habitat(1_000_000, split='train', ROOT='{roots['Habitat']}', "
           f"resolution=(64, 48), seed=4)")
    ours, theirs = _both(dsl)
    for ds in (ours, theirs):
        ds.filter_scene("scene_train", "00000_3")
    assert len(ours) == 1 and ours.instances == theirs.instances == [2]
    got = ours[0]
    _same_views(got, theirs[0], "walk")
    assert got[1]["instance"] == "00000_2"
    _, walked_to = camera(128, 128, 3, 5)  # file 4's camera
    assert np.array_equal(got[1]["camera_pose"], walked_to)
    with pytest.raises(ValueError, match="no scene was selected"):
        ours.filter_scene("nowhere")


def test_select_scene_equals_jax(roots, same_jitter):
    dsl = f"MegaDepth(split=None, ROOT='{roots['MegaDepth']}', resolution=(64, 48), seed=2)"
    for args, kwargs in ((("0001",), {}), (("0002",), dict(opposite=True)),
                         (("0001", "0001_0000"), {}), (("0001", "0001_0000", "0001_0001"), {}),
                         ((("0015", "0022"),), {})):
        ours, theirs = _both(dsl)
        ours.select_scene(*args, **kwargs)
        theirs.select_scene(*args, **kwargs)
        assert np.array_equal(ours.pairs, theirs.pairs) and len(ours) > 0, args
        _same_views(ours[len(ours) - 1], theirs[len(theirs) - 1], args)
    with pytest.raises(ValueError, match="no scene found"):
        ours.select_scene("9999")


def test_layout_written_the_jax_way_reads_alike(jax_written, same_jitter):
    for split, n in (("train", 3), ("val", 1), (None, 4)):
        ours, theirs = _both(f"MegaDepth(split={split!r}, ROOT='{jax_written}', "
                             f"resolution={RESOLUTIONS}, aug_crop=16, "
                             f"transform=ColorJitter, seed=3)")
        assert len(ours) == n
        for idx in range(n):
            _same_views(ours[idx, 1], theirs[idx, 1], (split, idx))


# each layout read at its written size (the crop around the principal point
# keeps all of it; Waymo's 85 rows lose one), so the depth is not resampled
GEOMETRY = dict(Habitat=("1_000_000, split='train'", (128, 128)),
                BlendedMVS=("split='train'", (128, 96)), MegaDepth=("split='train'", (128, 96)),
                ARKitScenes=("split='train'", (128, 96)), Co3d=("split='train'", (128, 96)),
                StaticThings3D=("mask_bg=True", (128, 96)),
                ScanNetpp=("split='train'", (128, 96)), Waymo=("split=None", (128, 84)),
                WildRGBD=("split='train'", (128, 96)))


@pytest.mark.parametrize("name", list(GEOMETRY))
def test_pts3d_lie_on_the_plane(roots, name):
    args, resolution = GEOMETRY[name]
    ds = tds.build_dataset(f"{name}({args}, ROOT='{roots[name]}', resolution={resolution}, "
                           f"seed=1)")
    for idx in range(0, len(ds), max(1, len(ds) // 6)):
        for view in ds[idx]:
            valid = view["valid_mask"]
            assert valid.any(), (idx, view["instance"])
            z, depth = view["pts3d"][valid][:, 2], view["depthmap"][valid]
            assert np.all(np.abs(z - PLANE_Z) <= 1e-3 * depth), (idx, view["instance"])


def test_mix_batch_equals_jax(roots, same_jitter):
    dsl = mix_dsl(roots, {name: 2 for name in TRAIN_ARGS}, RESOLUTIONS, seed=11)
    ours = tds.get_data_loader(dsl, batch_size=6, num_workers=0)
    theirs = jds.get_data_loader(dsl, batch_size=6, num_workers=0)
    assert len(ours) == len(theirs) == 3
    ours.set_epoch(0)
    theirs.set_epoch(0)
    labels = set()
    for got, want in zip(ours, theirs):
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                if isinstance(w[k], np.ndarray):
                    assert np.array_equal(g[k].numpy(), w[k]), k
                else:
                    assert list(g[k]) == list(w[k]), k
            labels |= set(g["dataset"])
    assert labels == {"Habitat", "BlendedMVS", "MegaDepth", "arkitscenes", "Co3d_v2",
                      "StaticThings3D", "ScanNet++", "Waymo", "WildRGBD"}
