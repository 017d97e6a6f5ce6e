"""The port's demo against the JAX package's, on the same PNG files and the
same tiny weights (tests/test_demo_flow.py's model, its parameters from
`model.init`, carried into the port by `state_dict_from_jax`).

Both engines run on the files and their outputs are held to 1e-5. The
tiny random weights give a degenerate scene (every focal estimate near 0,
clamped to 1e-4 px, poses near 1e17), where the two aligners cannot agree
to 1e-4; so the aligners then take, in both packages, the same pairwise
predictions of a known rig (tests/test_cloud_opt.py::make_synthetic_scene
at the views' size, 2 % seeded noise on the points so that the MST init is
not the optimum) for the same pairs and images. The MST init calls
`fast_pnp`: cv2 in the JAX package, the port's numpy solver here
(ROADMAP.md §C); the JAX side's `fast_pnp` (in `init_im_poses` and
`pair_viewer`) is monkeypatched to the port's, so both inits agree; then
focals, poses and depthmaps after 20 iterations are held at 1e-4 relative
(the poses and depthmaps at 1e-4 of their largest |value| as well).
The export alone is held with the JAX scene's final parameters loaded into
the port's scene: the same PLY header and colours, vertices to 1e-5 of the
largest |coordinate|, the gallery to 1e-6. The UI runs through a gradio
stub (a copy of tests/test_demo_gradio_ui.py's).
"""
import os
import os.path as osp
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

import dust3r_tpu.demo as jdemo
from dust3r_tpu.inference import InferenceEngine as JaxEngine
from dust3r_tpu.models.model import AsymmetricCroCo3DStereo as JaxModel
from dust3r_tpu_torch import demo
from dust3r_tpu_torch.checkpoint import save_torch_checkpoint, state_dict_from_jax
from dust3r_tpu_torch.cloud_opt import PairViewer, PointCloudOptimizer
from dust3r_tpu_torch.cloud_opt.init_im_poses import fast_pnp
from dust3r_tpu_torch.image_pairs import make_pairs
from dust3r_tpu_torch.inference import InferenceEngine, inference
from dust3r_tpu_torch.models.model import AsymmetricCroCo3DStereo
from dust3r_tpu_torch.utils.image import load_images

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))
from test_cloud_opt import make_synthetic_scene  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_size=(32, 32), patch_size=16, enc_embed_dim=64, enc_depth=2, enc_num_heads=2,
            dec_embed_dim=48, dec_depth=2, dec_num_heads=2)
SIZE = 32  # load_images' size: 32x16 views
ARGS = dict(schedule="linear", niter=20, min_conf_thr=3.0, as_pointcloud=True, mask_sky=False,
            clean_depth=False, transparent_cams=False, cam_size=0.05, scenegraph_type="complete",
            winsize=1, refid=0)


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, the port's engine on the CPU) on the same weights."""
    model = JaxModel(**TINY, attn_impl="ref")
    probe = jnp.zeros((1, 32, 32, 3))
    params = model.init(jax.random.PRNGKey(0), probe, probe)
    port = AsymmetricCroCo3DStereo(**TINY, device="cpu")
    port.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), 2, 2, "linear"))
    return JaxEngine(model, params, batch_size=4), InferenceEngine(port, batch_size=4)


@pytest.fixture
def imagefiles(tmp_path):
    """Three 48x64 PNG files of seeded noise, a bright low-saturation band
    on top (the sky that mask_sky removes)."""
    rng = np.random.default_rng(0)
    files = []
    for i in range(3):
        img = rng.integers(0, 150, (48, 64, 3), dtype=np.uint8)
        img[:18] = np.clip(rng.normal((205, 215, 235), 5, (18, 64, 3)), 0, 255)
        p = tmp_path / f"img{i}.png"
        PIL.Image.fromarray(img).save(p)
        files.append(str(p))
    return files


@pytest.fixture
def same_pnp(monkeypatch):
    """The JAX package's MST init and PairViewer on the port's numpy PnP."""
    import dust3r_tpu.cloud_opt.init_im_poses as jinit
    import dust3r_tpu.cloud_opt.pair_viewer as jpv

    monkeypatch.setattr(jinit, "fast_pnp", fast_pnp)
    monkeypatch.setattr(jpv, "fast_pnp", fast_pnp)


def rig_output(pairs):
    """The inference output a known rig gives for `pairs`: exact pairwise
    pointmaps at the views' size with 2 % seeded noise, the views' own
    images."""
    edges = [(int(a["idx"]), int(b["idx"])) for a, b in pairs]
    H, W = pairs[0][0]["img"].shape[1:3]
    n_imgs = max(max(e) for e in edges) + 1
    out = make_synthetic_scene(n_imgs=n_imgs, H=H, W=W, focal=1.2 * W, seed=5, edges=edges)[0]
    rng = np.random.default_rng(6)
    for side, key in (("pred1", "pts3d"), ("pred2", "pts3d_in_other_view")):
        pts = out[side][key]
        out[side][key] = (pts * (1 + 0.02 * rng.standard_normal(pts.shape))).astype(np.float32)
    for side, k in (("view1", 0), ("view2", 1)):
        out[side]["img"] = np.concatenate([p[k]["img"] for p in pairs])
    return out


@pytest.fixture
def on_the_rig(monkeypatch):
    """Both demos' `inference`: the engine runs (its outputs are recorded),
    the aligner takes the rig's predictions."""
    engine_outputs = {}
    for name, mod in (("jax", jdemo), ("port", demo)):
        def run(pairs, engine, verbose=True, _real=mod.inference, _name=name):
            engine_outputs[_name] = _real(pairs, engine, verbose=verbose)
            return rig_output(pairs)

        monkeypatch.setattr(mod, "inference", run)
    return engine_outputs


def assert_engines_agree(jout, out):
    assert [list(v["idx"]) for v in (out["view1"], out["view2"])] == \
        [list(v["idx"]) for v in (jout["view1"], jout["view2"])]
    np.testing.assert_array_equal(out["view1"]["img"], jout["view1"]["img"])
    for side, key in (("pred1", "pts3d"), ("pred1", "conf"), ("pred2", "pts3d_in_other_view"),
                      ("pred2", "conf")):
        want = np.asarray(jout[side][key])
        np.testing.assert_allclose(out[side][key], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _run(engines, files, tmp_path, **kw):
    """Both packages' get_reconstructed_scene on the same files."""
    args = dict(ARGS, **kw)
    outs = []
    for name, mod, engine in (("jax", jdemo, engines[0]), ("port", demo, engines[1])):
        outdir = tmp_path / name
        outdir.mkdir(exist_ok=True)
        outs.append(mod.get_reconstructed_scene(str(outdir), engine, "cpu", True, SIZE, files,
                                                **args))
    return outs


def test_engine_outputs_match_jax(engines, imagefiles):
    from dust3r_tpu.image_pairs import make_pairs as jmake_pairs
    from dust3r_tpu.inference import inference as jinference
    from dust3r_tpu.utils.image import load_images as jload

    jout = jinference(jmake_pairs(jload(imagefiles, size=SIZE, verbose=False), "complete",
                                  symmetrize=True), engines[0], verbose=False)
    out = inference(make_pairs(load_images(imagefiles, size=SIZE, verbose=False), "complete",
                               symmetrize=True), engines[1], verbose=False)
    assert_engines_agree(jout, out)


@pytest.mark.parametrize("graph,niter", [("complete", 20), ("swin", 0), ("oneref", 0)])
def test_reconstructed_scene_matches_jax(engines, imagefiles, tmp_path, same_pnp, on_the_rig,
                                        graph, niter):
    """Three images: the engines' outputs to 1e-5, the scene graph's edges,
    then focals, poses and depthmaps at 1e-4 relative after 20
    linear-schedule iterations (`complete`) or after the MST init (the
    other graphs, whose scenes the JAX package would compile its loop for
    again)."""
    (js, jfile, jgal), (ts, tfile, tgal) = _run(engines, imagefiles, tmp_path,
                                                scenegraph_type=graph, refid=1, niter=niter)
    assert_engines_agree(on_the_rig["jax"], on_the_rig["port"])
    assert isinstance(ts, PointCloudOptimizer)
    assert [tuple(map(int, e)) for e in ts.edges] == [tuple(map(int, e)) for e in js.edges]
    assert tfile.endswith("scene.ply") and jfile.endswith("scene.ply")
    np.testing.assert_allclose(_np(ts.get_focals()), np.asarray(js.get_focals()), rtol=1e-4)
    np.testing.assert_allclose(_np(ts.get_im_poses()), np.asarray(js.get_im_poses()),
                               rtol=1e-4, atol=1e-4)
    for a, b in zip(ts.get_depthmaps(), js.get_depthmaps()):  # 1e-4 of the map's largest
        b = np.asarray(b)
        np.testing.assert_allclose(_np(a), b, rtol=1e-4, atol=1e-4 * np.abs(b).max())
    assert len(tgal) == len(jgal) == 9
    assert ts.min_conf_thr == pytest.approx(js.min_conf_thr, rel=1e-7)  # log(3), the quirk


def test_two_images_take_the_pair_viewer_and_one_is_duplicated(engines, imagefiles, tmp_path,
                                                               same_pnp, on_the_rig):
    for files in (imagefiles[:2], imagefiles[:1]):
        (js, _, jgal), (ts, tfile, tgal) = _run(engines, files, tmp_path)
        assert_engines_agree(on_the_rig["jax"], on_the_rig["port"])
        assert isinstance(ts, PairViewer) and type(js).__name__ == "PairViewer"
        assert ts.n_imgs == js.n_imgs == 2 and len(tgal) == len(jgal) == 6
        np.testing.assert_allclose(_np(ts.get_focals()).ravel(),
                                   np.asarray(js.get_focals()).ravel(), rtol=1e-4)
        np.testing.assert_allclose(_np(ts.get_im_poses()), np.asarray(js.get_im_poses()),
                                   rtol=1e-4, atol=1e-4)
        assert os.path.isfile(tfile)


def _ply(path):
    with open(path, "rb") as f:
        raw = f.read()
    header, body = raw.split(b"end_header\n", 1)
    return header, np.frombuffer(body, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])


def test_export_matches_jax(engines, imagefiles, tmp_path, same_pnp, on_the_rig, monkeypatch):
    """The export and the gallery alone: the port's scene takes the JAX
    scene's final parameters in place of its own alignment; with mask_sky
    and clean_depth on, its PLY and gallery must be the JAX package's."""
    seen = {}
    args = dict(ARGS, mask_sky=True, clean_depth=True)
    js, jfile, jgal = jdemo.get_reconstructed_scene(str(tmp_path), engines[0], "cpu", True,
                                                    SIZE, imagefiles, **args)
    state = js.state_dict()
    build = demo.global_aligner

    def aligner_with_jax_state(*a, **kw):
        scene = build(*a, **kw)
        scene.compute_global_alignment = lambda **_: scene.load_state_dict(state)
        return scene

    def capture(*a, **kw):
        seen["output"] = a[0]
        return aligner_with_jax_state(*a, **kw)

    monkeypatch.setattr(demo, "global_aligner", capture)
    port_dir = tmp_path / "port"
    port_dir.mkdir()
    ts, tfile, tgal = demo.get_reconstructed_scene(str(port_dir), engines[1], "cpu", True, SIZE,
                                                   imagefiles, **args)
    (jh, jv), (th, tv) = _ply(jfile), _ply(tfile)
    assert th == jh and len(tv) == len(jv) > 8 * 16 * 3
    np.testing.assert_array_equal(tv["rgb"], jv["rgb"])
    np.testing.assert_allclose(tv["xyz"], jv["xyz"], rtol=0,
                               atol=1e-5 * np.abs(jv["xyz"]).max())
    sky = [(c == 0).sum() for c in demo.global_aligner(seen["output"], device="cpu",
                                                       verbose=False).mask_sky().im_conf]
    assert min(sky) > 0  # the band is sky in every image
    assert len(tgal) == len(jgal) == 9
    for a, b in zip(tgal, jgal):
        assert a.shape == np.asarray(b).shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)


def test_ply_export_is_the_jax_packages(tmp_path):
    """tests/test_demo_flow.py::test_ply_fallback_export's scene through
    both exports: the same bytes but for float noise in the frusta."""
    rng = np.random.default_rng(0)
    n, h, w = 2, 8, 10
    imgs = [rng.uniform(0, 1, (h, w, 3)).astype(np.float32) for _ in range(n)]
    pts3d = [rng.standard_normal((h, w, 3)).astype(np.float32) for _ in range(n)]
    mask = [np.ones((h, w), bool), np.zeros((h, w), bool)]
    mask[1][:4] = True
    cams2world = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    cams2world[1, :3, 3] = (1, 0, 0)
    paths = []
    for name, mod in (("jax", jdemo), ("port", demo)):
        (tmp_path / name).mkdir()
        paths.append(mod._export_scene_ply(str(tmp_path / name), imgs, pts3d, mask,
                                           np.float32([100.0, 90.0]), cams2world, silent=True))
    (jh, jv), (th, tv) = _ply(paths[0]), _ply(paths[1])
    n_pts = int(mask[0].sum() + mask[1].sum()) + n * 8 * 16
    assert th == jh and f"element vertex {n_pts}".encode() in th
    np.testing.assert_array_equal(tv["rgb"], jv["rgb"])
    np.testing.assert_allclose(tv["xyz"], jv["xyz"], rtol=0, atol=1e-6)


# ------------------------------------------------------------ gradio stub
class _Component:
    """Records constructor kwargs and event registrations."""

    def __init__(self, *args, **kwargs):
        self.args, self.kwargs, self.events = args, kwargs, []
        _STUB.components.append(self)

    def _register(self, name, fn=None, inputs=None, outputs=None):
        self.events.append(dict(event=name, fn=fn, inputs=inputs, outputs=outputs))

    def change(self, fn=None, inputs=None, outputs=None):
        self._register("change", fn, inputs, outputs)

    def release(self, fn=None, inputs=None, outputs=None):
        self._register("release", fn, inputs, outputs)

    def click(self, fn=None, inputs=None, outputs=None):
        self._register("click", fn, inputs, outputs)


class _Container(_Component):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Blocks(_Container):
    def launch(self, **kwargs):
        _STUB.launched.append(kwargs)


class _Stub(types.ModuleType):
    def __init__(self):
        super().__init__("gradio")
        self.components, self.launched = [], []
        self.Blocks, self.Column, self.Row = _Blocks, _Container, _Container
        for name in ("State", "HTML", "File", "Dropdown", "Number", "Slider", "Button",
                     "Checkbox", "Model3D", "Gallery"):
            setattr(self, name, type(name, (_Component,), {}))

    def reset(self):
        self.components.clear()
        self.launched.clear()


_STUB = _Stub()


@pytest.fixture
def gradio_stub(monkeypatch):
    _STUB.reset()
    monkeypatch.setitem(sys.modules, "gradio", _STUB)
    return _STUB


def _find(stub, cls_name, **kwargs):
    return [c for c in stub.components if type(c).__name__ == cls_name
            and all(c.kwargs.get(k) == v for k, v in kwargs.items())]


def test_main_demo_builds_and_run_click_drives_the_port(gradio_stub, engines, imagefiles,
                                                       tmp_path):
    demo.main_demo(str(tmp_path), engines[1], "cpu", SIZE, server_name="127.0.0.1",
                   server_port=7860, silent=True)
    assert gradio_stub.launched == [dict(share=False, server_name="127.0.0.1",
                                         server_port=7860)]
    (run_btn,) = _find(gradio_stub, "Button")
    (click,) = run_btn.events
    assert click["event"] == "click" and len(click["inputs"]) == 12
    assert len(click["outputs"]) == 3
    dropdowns = _find(gradio_stub, "Dropdown", label="Scenegraph")
    assert len(dropdowns) == 1 and len(dropdowns[0].events) == 1
    (files,) = _find(gradio_stub, "File")
    assert files.events and files.events[0]["event"] == "change"
    post_ctls = (_find(gradio_stub, "Slider", label="min_conf_thr")
                 + _find(gradio_stub, "Slider", label="cam_size") + _find(gradio_stub, "Checkbox"))
    assert len(post_ctls) == 6
    for ctl in post_ctls:  # re-export only: scene + 6 control values
        assert len(ctl.events) == 1
        assert ctl.events[0]["fn"] is not click["fn"] and len(ctl.events[0]["inputs"]) == 7
    scene, outfile, gallery = click["fn"](imagefiles[:2], "cosine", 3, 3.0, True, True, True,
                                          False, 0.05, "complete", 1, 0)
    assert outfile.endswith("scene.ply") and os.path.isfile(outfile)
    assert len(gallery) == 6
    post = post_ctls[0].events[0]["fn"](scene, 2.0, True, False, False, False, 0.05)
    assert post == outfile


def test_set_scenegraph_options_logic(gradio_stub):
    files = [f"im{i}.png" for i in range(7)]
    win, ref = demo.set_scenegraph_options(files, 1, 0, "swin")
    assert win.kwargs["visible"] is True and ref.kwargs["visible"] is False
    assert win.kwargs["maximum"] == 3
    win, ref = demo.set_scenegraph_options(files, 1, 0, "oneref")
    assert win.kwargs["visible"] is False and ref.kwargs["visible"] is True
    assert ref.kwargs["maximum"] == 6
    win, ref = demo.set_scenegraph_options(None, 1, 0, "complete")
    assert win.kwargs["visible"] is False and ref.kwargs["visible"] is False


def test_cli_parses_and_refuses_what_is_not_ported():
    run = subprocess.run([sys.executable, "-m", "dust3r_tpu_torch.demo", "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0 and "--weights" in run.stdout and "--images" in run.stdout
    args = demo.get_args_parser().parse_args(["--weights", "w.pth"])
    assert args.device == "cuda" and args.image_size == 512 and args.mesh == 0
    assert not args.serving and args.quantize is None
    # the int8 serving flags are ported (tests/test_torch_port_serving.py drives them)
    args = demo.get_args_parser().parse_args(["--weights", "w.pth", "--serving", "--quantize",
                                              "int8"])
    assert args.serving and args.quantize == "int8"
    with pytest.raises(NotImplementedError, match="item 10"):
        demo.main(["--weights", "w.pth", "--mesh", "2"])


def test_headless_main_writes_the_scene(engines, imagefiles, tmp_path, monkeypatch):
    """main() end to end on the CPU: a .pth written by the port, two
    images, one reconstruction without the UI (a two-view scene of the
    tiny random weights, whose focals clip to 0: the file is checked, not
    its geometry)."""
    import builtins

    monkeypatch.setattr(builtins, "print", builtins.print)  # main() stamps print
    weights = str(tmp_path / "tiny.pth")
    save_torch_checkpoint(weights, engines[1].model)
    out = tmp_path / "out"
    assert demo.main(["--weights", weights, "--device", "cpu", "--image_size", "224",
                      "--images", *imagefiles[:2], "--outdir", str(out), "--silent"]) == 0
    header, verts = _ply(str(out / "scene.ply"))
    assert b"element vertex" in header and len(verts) >= 2 * 8 * 16
