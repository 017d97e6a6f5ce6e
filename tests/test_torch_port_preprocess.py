"""The port's preprocess scripts (`dust3r_tpu_torch/datasets_preprocess/`)
against the JAX package's (`datasets_preprocess/`), on the same raw layouts
(`dust3r_tpu_torch/tools/raw_scenes.py` at test sizes).

Each script's output tree must match file for file: the same names; npz /
npy arrays bit for bit (no tolerance was needed: the float64 products run
in the same order on both sides); EXR bytes; PNG and JPEG pixels (the PNG
bytes differ, PIL compresses otherwise; the JPEGs are bytes-equal: PIL at
quality 95 encodes as cv2.imwrite does here, `test_torch_port_cvops.py`).
Scope: all of Co3d, WildRGBD, BlendedMVS, StaticThings3D, ARKitScenes and
MegaDepth (h5py present here); Waymo's stage 2 (JAX's bare cv2.imwrite of
the .exr, which this cv2 cannot write, routed onto its own write_exr, and
its process map, which cannot pickle its call, run on threads: the two
faults of ROADMAP.md §C); ScanNet++'s undistort_images; Habitat's
extract_cropped_camera on a fabricated envmap with the same jitter draws.
Then the closed forms of tests/test_preprocess_units.py over the port's
copies, the port modules' imports without cv2 and JAX, the port's loaders
on the port's outputs (pts3d on the plane), and the reference faults.
"""
import json
import os
import os.path as osp
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)

cv2 = pytest.importorskip("cv2")

from dust3r_tpu_torch.tools import raw_scenes  # noqa: E402
from dust3r_tpu_torch.tools.train_scenes import PLANE_Z  # noqa: E402

# raw sizes (W, H) at test scale; StaticThings3D's script asserts 960x540
SMALL = dict(Co3d=(160, 90), WildRGBD=(160, 120), BlendedMVS=(160, 120), MegaDepth=(160, 120),
             StaticThings3D=(960, 540), ARKitScenes=(160, 120), Waymo=(160, 106),
             ScanNetpp=(160, 106), Habitat=(256, 128))
FRAMES = 3
# the image sizes Co3d and WildRGBD rescale to (so that Co3d's INTER_AREA runs)
IMG_SIZE = ["--img_size", "64"]
WHOLE_SCRIPTS = ("Co3d", "WildRGBD", "BlendedMVS", "MegaDepth", "StaticThings3D",
                 "ARKitScenes", "Waymo")
PLANE_RTOL = 1e-2


def _raw(name, root):
    info = raw_scenes.write_raw(name, str(root), FRAMES, 7, SMALL[name])
    if name in ("Co3d", "WildRGBD"):
        info["argv"] = info["argv"] + IMG_SIZE
    return info


@pytest.fixture(scope="module")
def port_outputs(tmp_path_factory):
    """Every raw layout and the port's outputs, {name: (info, out)}."""
    root = tmp_path_factory.mktemp("preprocess")
    done = {}
    for name in SMALL:
        info = _raw(name, root / name)
        out = str(root / name / "port")
        raw_scenes.preprocess(info, out)
        done[name] = (info, out)
    return done


def _run_jax(name, info, out, monkeypatch):
    import importlib

    module = importlib.import_module("datasets_preprocess." + dict(
        Co3d="preprocess_co3d", WildRGBD="preprocess_wildrgbd",
        BlendedMVS="preprocess_blendedmvs", MegaDepth="preprocess_megadepth",
        StaticThings3D="preprocess_staticthings3d", ARKitScenes="preprocess_arkitscenes",
        Waymo="preprocess_waymo")[name])
    argv = info.get("argv", [])
    if name in ("Co3d", "WildRGBD"):
        monkeypatch.setattr(sys, "argv", ["preprocess", *argv, "--output_dir", out])
        module.main()
    elif name == "Waymo":
        from dust3r_tpu.utils.exr import write_exr
        from dust3r_tpu.utils.parallel import parallel_threads

        imwrite = cv2.imwrite
        monkeypatch.setattr(cv2, "imwrite", lambda path, img, *a: (
            write_exr(path, img) or True) if path.endswith(".exr") else imwrite(path, img, *a))
        monkeypatch.setattr(module, "parallel_map", parallel_threads)
        shutil.copytree(info["tmp"], osp.join(out, "tmp"))
        module.make_crops(out, workers=1)
        module._stamp_pair_table(info["pairs"], out)
        shutil.rmtree(osp.join(out, "tmp"))
    else:
        module.main(argv[1], argv[3], out)


def _files(root):
    return sorted(osp.relpath(osp.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def _compare_trees(ref_root, got_root):
    import PIL.Image

    from dust3r_tpu_torch.utils.exr import read_exr

    assert _files(ref_root) == _files(got_root)
    checked = dict(npz=0, image=0, exr=0, other=0)
    for rel in _files(ref_root):
        a, b = osp.join(ref_root, rel), osp.join(got_root, rel)
        if rel.endswith((".npz", ".npy")):
            da, db = np.load(a), np.load(b)
            da, db = (da, db) if rel.endswith(".npz") else ({"": da}, {"": db})
            assert sorted(da) == sorted(db), rel
            for k in da:
                assert da[k].dtype == db[k].dtype and da[k].shape == db[k].shape, (rel, k)
                np.testing.assert_array_equal(db[k], da[k], err_msg=f"{rel}:{k}")
            checked["npz"] += 1
        elif rel.endswith((".png", ".jpg", ".jpeg")):
            x, y = np.asarray(PIL.Image.open(a)), np.asarray(PIL.Image.open(b))
            assert x.dtype == y.dtype, rel
            np.testing.assert_array_equal(y, x, err_msg=rel)
            checked["image"] += 1
        elif rel.endswith(".exr"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel
            np.testing.assert_array_equal(read_exr(b), read_exr(a))
            checked["exr"] += 1
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read() or rel.endswith(".json"), rel
            if rel.endswith(".json"):
                with open(a) as fa, open(b) as fb:
                    assert json.load(fa) == json.load(fb), rel
            checked["other"] += 1
    return checked


@pytest.mark.parametrize("name", WHOLE_SCRIPTS)
def test_script_matches_jax(name, port_outputs, tmp_path, monkeypatch):
    info, port_out = port_outputs[name]
    jax_out = str(tmp_path / "jax")
    _run_jax(name, info, jax_out, monkeypatch)
    checked = _compare_trees(jax_out, port_out)
    assert checked["npz"] > 0 and checked["image"] > 0


def test_scannetpp_undistort_images(port_outputs):
    """Both camera models of the raw layout (OPENCV_FISHEYE DSLR, OPENCV
    iPhone) through JAX's and the port's undistort_images."""
    import PIL.Image

    from datasets_preprocess import preprocess_scannetpp as jax_snp
    from dust3r_tpu_torch.datasets_preprocess import preprocess_scannetpp as port_snp

    info, _ = port_outputs["ScanNetpp"]
    base = osp.join(info["root"], "data", "0a5c013435")
    for cam, rgb_dir, mask_dir in (("dslr", "resized_images", "resized_anon_masks"),
                                   ("iphone", "rgb", "rgb_masks")):
        _, infos = port_snp.load_sfm(osp.join(base, cam, "colmap"), cam_type=cam)
        _, jinfos = jax_snp.load_sfm(osp.join(base, cam, "colmap"), cam_type=cam)
        for idx, im in infos.items():
            np.testing.assert_array_equal(im["cam_to_world"], jinfos[idx]["cam_to_world"])
            rgb = np.array(PIL.Image.open(osp.join(base, cam, rgb_dir, im["path"])))
            mask = np.array(PIL.Image.open(osp.join(base, cam, mask_dir, im["path"][:-3] + "png")))
            ref = jax_snp.undistort_images(im["intrinsics"], rgb, mask)
            got = port_snp.undistort_images(im["intrinsics"], rgb, mask)
            assert got[:2] == ref[:2]
            np.testing.assert_allclose(got[2], ref[2], rtol=1e-6, atol=1e-6 * np.abs(ref[2]).max())
            np.testing.assert_array_equal(got[3], ref[3])
            np.testing.assert_array_equal(got[4], ref[4])


def test_habitat_extract_cropped_camera(port_outputs):
    """A 5-view fan cut from the raw envmaps: JAX's crop generator (built
    without habitat-sim) and the port's, the jitter drawn by JAX from the
    global RNG and by the port from a RandomState of the same seed."""
    from datasets_preprocess.habitat import multiview_crop_generator as jax_mcg
    from datasets_preprocess.habitat import projections as jax_proj
    from dust3r_tpu_torch.datasets_preprocess.habitat import multiview_crop_generator as mcg

    info, _ = port_outputs["Habitat"]
    h, w = info["resolution"]
    envmaps = raw_scenes.EnvmapFiles(info["envmaps"], info["resolution"])
    port = mcg.HabitatMultiviewCrops(None, None, "", equirectangular_resolution=(h, w),
                                     renderer=envmaps, rng=np.random.RandomState(11))
    ref = jax_mcg.HabitatMultiviewCrops.__new__(jax_mcg.HabitatMultiviewCrops)
    ref.jitter_iters, ref.jitter_noise = port.jitter_iters, port.jitter_noise
    ref.envmap_projection = jax_proj.RotatedProjection(
        jax_proj.EquirectangularProjection(h, w), np.asarray(envmaps.R_cam_to_world()).T)
    with open(info["metadata"]) as f:
        views = json.load(f)["view_batches"]["00000"]
    np.random.seed(11)
    for params in views.values():
        projection, position = mcg.dict_to_perspective_projection(params)
        jprojection, _ = jax_mcg.dict_to_perspective_projection(params)
        data = port.render_viewpoint_data(position)
        got = port.extract_cropped_camera(projection, data.colormap, data.distancemap,
                                          data.pointmap)
        want = ref.extract_cropped_camera(jprojection, data.colormap, data.distancemap,
                                          data.pointmap)
        for g, r in zip(got[:3], want[:3]):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


CLOSED_FORMS = {
    "TestCo3dConversions": ["test_ndc_to_pinhole", "test_opencv_from_cameras_projection",
                            "test_category_list_matches_paper_recipe",
                            "test_load_16bit_png_depth"],
    "TestBlendedMVS": ["test_load_pfm_little_endian", "test_load_cam_txt"],
    "TestArkitScenes": ["test_slerp_endpoints_and_midpoint", "test_slerp_hemisphere",
                        "test_rotvec_to_rotmat", "test_interpolate_poses"],
    "TestStaticThings3D": ["test_read_float3_roundtrip"],
    "TestMegaDepth": ["test_colmap_pose_identity", "test_colmap_pose_rotation"],
    "TestHabitatProjections": ["test_perspective_project_unproject_roundtrip",
                               "test_equirectangular_roundtrip"],
}


def _on_port(cls_name, method, tmp_path, monkeypatch):
    """Run tests/test_preprocess_units.py's `cls_name.method` with its
    `datasets_preprocess.*` imports answered by the port's modules (and
    ARKitScenes' rotvec_to_rotmat by cvops.rodrigues)."""
    import importlib

    import test_preprocess_units as units

    from dust3r_tpu_torch.utils import cvops

    names = ["preprocess_co3d", "preprocess_blendedmvs", "preprocess_arkitscenes",
             "preprocess_staticthings3d", "preprocess_megadepth", "habitat.projections"]
    pkg = importlib.import_module("dust3r_tpu_torch.datasets_preprocess")
    monkeypatch.setitem(sys.modules, "datasets_preprocess", pkg)
    for n in names:
        module = importlib.import_module(f"dust3r_tpu_torch.datasets_preprocess.{n}")
        monkeypatch.setitem(sys.modules, f"datasets_preprocess.{n}", module)
    monkeypatch.setitem(sys.modules, "datasets_preprocess.habitat",
                        importlib.import_module("dust3r_tpu_torch.datasets_preprocess.habitat"))
    ark = sys.modules["datasets_preprocess.preprocess_arkitscenes"]
    monkeypatch.setattr(ark, "rotvec_to_rotmat", cvops.rodrigues, raising=False)
    test = getattr(getattr(units, cls_name)(), method)
    kwargs = {"tmp_path": tmp_path} if "tmp_path" in test.__code__.co_varnames else {}
    test(**kwargs)


@pytest.mark.parametrize("method", CLOSED_FORMS["TestCo3dConversions"])
def test_co3d_closed_forms(method, tmp_path, monkeypatch):
    _on_port("TestCo3dConversions", method, tmp_path, monkeypatch)


@pytest.mark.parametrize("method", CLOSED_FORMS["TestBlendedMVS"])
def test_blendedmvs_closed_forms(method, tmp_path, monkeypatch):
    _on_port("TestBlendedMVS", method, tmp_path, monkeypatch)


@pytest.mark.parametrize("method", CLOSED_FORMS["TestArkitScenes"])
def test_arkitscenes_closed_forms(method, tmp_path, monkeypatch):
    _on_port("TestArkitScenes", method, tmp_path, monkeypatch)


@pytest.mark.parametrize("method", CLOSED_FORMS["TestStaticThings3D"])
def test_staticthings3d_closed_forms(method, tmp_path, monkeypatch):
    _on_port("TestStaticThings3D", method, tmp_path, monkeypatch)


@pytest.mark.parametrize("method", CLOSED_FORMS["TestMegaDepth"])
def test_megadepth_closed_forms(method, tmp_path, monkeypatch):
    _on_port("TestMegaDepth", method, tmp_path, monkeypatch)


@pytest.mark.parametrize("method", CLOSED_FORMS["TestHabitatProjections"])
def test_habitat_projection_closed_forms(method, tmp_path, monkeypatch):
    _on_port("TestHabitatProjections", method, tmp_path, monkeypatch)


PORT_MODULES = ["dust3r_tpu_torch.utils.parallel", "dust3r_tpu_torch.utils.cvops",
                "dust3r_tpu_torch.tools.raw_scenes"] + [
    f"dust3r_tpu_torch.datasets_preprocess.{m}" for m in (
        "preprocess_co3d", "preprocess_wildrgbd", "preprocess_blendedmvs",
        "preprocess_megadepth", "preprocess_staticthings3d", "preprocess_arkitscenes",
        "preprocess_waymo", "preprocess_scannetpp", "habitat.projections",
        "habitat.multiview_crop_generator", "habitat.habitat_sim_envmaps_renderer",
        "habitat.find_scenes", "habitat.preprocess_habitat")]


def test_port_modules_import_without_cv2_or_jax():
    code = ("import sys; sys.modules['cv2'] = sys.modules['jax'] = None\n"
            "import importlib\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'dust3r_tpu' or m.startswith('dust3r_tpu.')"
            " or m.split('.')[0] == 'datasets_preprocess']\n"
            "assert not bad, bad\nprint('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]


@pytest.mark.parametrize("name", list(SMALL))
def test_port_loader_reads_port_outputs(name, port_outputs):
    """One view of each of the nine loaders over the port's outputs, at the
    published arguments (Habitat's list size what find_scenes wrote): its
    pts3d lie on the plane."""
    from dust3r_tpu_torch.datasets import build_dataset
    from dust3r_tpu_torch.tools.train_scenes import mix_dsl

    roots = {n: out for n, (_, out) in port_outputs.items()}
    args = raw_scenes.mix_args(roots["Habitat"])
    ds = build_dataset(mix_dsl(roots, {name: 1}, [(64, 48)], seed=3, args=args))
    ds.set_epoch(0)
    for view in ds[0, 0]:
        assert view["valid_mask"].any()
        err = raw_scenes.plane_error(view)
        assert err <= PLANE_RTOL, (name, err)
        assert abs(np.median(view["pts3d"][..., 2][view["valid_mask"]]) - PLANE_Z) < 0.05


def test_reference_faults(tmp_path, monkeypatch):
    """ROADMAP.md §C: JAX's Habitat write passes imwrite_exr a third
    argument it does not take; its Waymo stage 2 writes the .exr with a
    bare cv2.imwrite, which raises where cv2 has no OpenEXR writer (this
    one); its parallel_processes pickles a lambda, so its process pools
    raise (shown on a spawned pool: a forked one would copy this process's
    threads). The port's counterparts write and map."""
    import multiprocessing

    import dust3r_tpu.utils.parallel as jax_parallel
    from dust3r_tpu.utils.exr import imwrite_exr
    from dust3r_tpu.utils.parallel import parallel_processes as jax_processes
    from dust3r_tpu_torch.utils.exr import read_exr, write_exr
    from dust3r_tpu_torch.utils.parallel import parallel_processes

    depth = np.linspace(0.5, 4, 12, dtype=np.float32).reshape(3, 4)
    with pytest.raises(TypeError):
        imwrite_exr(str(tmp_path / "h.exr"), depth, [cv2.IMWRITE_EXR_TYPE,
                                                      cv2.IMWRITE_EXR_TYPE_HALF])
    with pytest.raises(cv2.error):
        cv2.imwrite(str(tmp_path / "w.exr"), depth)
    write_exr(str(tmp_path / "h.exr"), depth, half=True)
    np.testing.assert_array_equal(read_exr(str(tmp_path / "h.exr")),
                                  depth.astype(np.float16).astype(np.float32))
    monkeypatch.setattr(jax_parallel, "ProcessPool", multiprocessing.get_context("spawn").Pool)
    with pytest.raises(AttributeError):
        jax_processes(divmod, [(7, 2), (9, 4)], star_args=True, workers=1, front_num=0)
    assert parallel_processes(divmod, [(7, 2), (9, 4)], star_args=True, workers=1,
                              front_num=0) == [(3, 1), (2, 1)]
