"""The port's inference engine, pair builders and image loading against the
JAX package on the CPU, and the port's import hygiene.

The engines of both packages serve the same view dicts (made from seeded
uint8 arrays) with the same weights (a seeded numpy parameter tree carried
over by `state_dict_from_jax`); the port runs its plain versions. Outputs
are compared at rtol = atol = 1e-4 on values scaled by their mean |x|.
"""
import os
import os.path as osp
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

from dust3r_tpu import image_pairs as jpairs  # noqa: E402
from dust3r_tpu.inference import InferenceEngine as JaxEngine  # noqa: E402
from dust3r_tpu.utils import image as jimage  # noqa: E402
from dust3r_tpu_torch import image_pairs  # noqa: E402
from dust3r_tpu_torch.checkpoint import state_dict_from_jax  # noqa: E402
from dust3r_tpu_torch.inference import InferenceEngine, inference  # noqa: E402
from dust3r_tpu_torch.models.model import AsymmetricCroCo3DStereo  # noqa: E402
from dust3r_tpu_torch.utils import image  # noqa: E402
from test_torch_port_model import (CONFIGS, assert_model_close, jax_model,  # noqa: E402
                                   seeded_variables)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SCENES = {  # name: (H, W) of each view
    "uniform": [(32, 48)] * 3,
    "mixed": [(32, 48), (32, 48), (32, 32), (32, 32)],
}


@pytest.fixture(scope="module")
def engines():
    cfg = CONFIGS["tiny_linear"]
    model = jax_model("tiny_linear")
    variables = seeded_variables(model, 21)
    port = AsymmetricCroCo3DStereo(**cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, cfg["enc_depth"],
                                             cfg["dec_depth"], "linear"))
    return JaxEngine(model, variables, batch_size=4), InferenceEngine(port, batch_size=4)


def scene(name, seed=0):
    rng = np.random.default_rng(seed)
    return image.views_from_arrays([rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
                                    for hw in SCENES[name]])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_engine_matches_jax_engine(engines, name):
    jax_engine, engine = engines
    views = scene(name)
    pairs = image_pairs.make_pairs(views, "complete", symmetrize=True)
    enc0, pair0 = engine.encoder_batches, engine.pair_batches
    ours = inference(pairs, engine, verbose=False)
    theirs = jax_engine.infer_pairs(pairs)
    # at most 4 views of a shape: one encoder batch per shape; pairs grouped
    # by (shape1, shape2) bucket in batches of 4
    buckets = {}
    for v1, v2 in pairs:
        key = (v1["img"].shape, v2["img"].shape)
        buckets[key] = buckets.get(key, 0) + 1
    assert engine.encoder_batches - enc0 == len(set(SCENES[name]))
    assert engine.pair_batches - pair0 == sum(-(-n // 4) for n in buckets.values())
    assert sorted(ours) == sorted(theirs) == ["pred1", "pred2", "view1", "view2"]
    for side in ("view1", "view2"):
        assert ours[side]["idx"] == theirs[side]["idx"]
        np.testing.assert_array_equal(ours[side]["true_shape"], theirs[side]["true_shape"])
        for a, b in zip(ours[side]["img"], theirs[side]["img"]):
            np.testing.assert_array_equal(a, b)
    for side, keys in (("pred1", ("pts3d", "conf")),
                       ("pred2", ("pts3d_in_other_view", "conf"))):
        assert sorted(ours[side]) == sorted(keys)
        for key in keys:
            a, b = ours[side][key], theirs[side][key]
            assert type(a) is type(b) and len(a) == len(b) == len(pairs)
            for x, y in zip(a, b):
                assert x.shape == y.shape
                assert_model_close(x, y)


def test_engine_keeps_predictions_on_the_device(engines):
    engine = engines[1]
    pairs = image_pairs.make_pairs(scene("mixed"), "complete", symmetrize=True)
    on_cpu = engine.infer_pairs(pairs)
    kept = engine.infer_pairs(pairs, to_cpu=False)
    for n in range(len(pairs)):
        assert isinstance(kept["pred1"]["pts3d"][n], torch.Tensor)
        np.testing.assert_array_equal(kept["pred1"]["pts3d"][n].numpy(),
                                      on_cpu["pred1"]["pts3d"][n])


def test_engine_takes_images_already_on_the_device(engines):
    """Views whose images are tensors on the model's device are stacked and
    padded there, with the same result as numpy views."""
    engine = engines[1]
    views = scene("mixed")
    want = engine.infer_pairs(image_pairs.make_pairs(views, "complete"))
    tensor_views = [dict(v, img=torch.from_numpy(v["img"])) for v in views]
    got = engine.infer_pairs(image_pairs.make_pairs(tensor_views, "complete"))
    for side, key in (("pred1", "pts3d"), ("pred2", "pts3d_in_other_view")):
        for a, b in zip(got[side][key], want[side][key]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(got["view1"]["img"], want["view1"]["img"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("graph", ["complete", "swin-2", "swin-5", "swin-2-noncyclic",
                                   "logwin-2", "logwin-3-noncyclic", "oneref-1"])
def test_pair_graphs_match_jax(graph):
    views = [dict(idx=i, instance=str(i)) for i in range(5)]
    assert image_pairs.build_edges(5, graph) == jpairs.build_edges(5, graph)
    for prefilter in (None, "seq1", "cyc1"):
        ours = image_pairs.make_pairs(views, graph, prefilter=prefilter)
        theirs = jpairs.make_pairs(views, graph, prefilter=prefilter)
        assert [(a["idx"], b["idx"]) for a, b in ours] == \
               [(a["idx"], b["idx"]) for a, b in theirs]


def test_filter_edges_matches_jax():
    view = dict(idx=np.array([0, 1, 4, 3]), img=np.arange(4))
    other = dict(idx=np.array([1, 3, 0, 2]), img=np.arange(4))
    pred = dict(conf=np.arange(4.0))
    ours = image_pairs.filter_edges_seq(view, other, pred, pred, 1, cyclic=True,
                                        verbose=False)
    theirs = jpairs.filter_edges_seq(view, other, pred, pred, 1, cyclic=True,
                                     verbose=False)
    for a, b in zip(ours, theirs):
        for key in a:
            np.testing.assert_array_equal(a[key], np.asarray(b[key]))


@pytest.mark.parametrize("size,hw", [(512, (300, 400)), (512, (400, 400)), (224, (250, 330))])
def test_load_images_matches_jax(tmp_path, size, hw):
    import PIL.Image

    rng = np.random.default_rng(size + hw[0])
    for n in range(2):
        arr = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        PIL.Image.fromarray(arr).save(tmp_path / f"{n}.png")
    (tmp_path / "notes.txt").write_text("skipped")
    ours = image.load_images(str(tmp_path), size, verbose=False)
    theirs = jimage.load_images(str(tmp_path), size, verbose=False)
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        np.testing.assert_array_equal(a["img"], b["img"])
        np.testing.assert_array_equal(a["true_shape"], b["true_shape"])
        assert (a["idx"], a["instance"]) == (b["idx"], b["instance"])


def test_views_from_arrays_makes_load_images_views():
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    (view,) = image.views_from_arrays([arr])
    assert view["img"].shape == (1, 48, 64, 3) and view["img"].dtype == np.float32
    np.testing.assert_array_equal(view["img"][0], jimage.normalize_img(arr))
    np.testing.assert_array_equal(view["true_shape"], [[48, 64]])
    assert (view["idx"], view["instance"]) == (0, "0")
    with pytest.raises(ValueError):
        image.views_from_arrays([arr[:40]])  # not a multiple of the patch size


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    """With no CUDA device the model constructors, and global_aligner on
    numpy predictions, raise and name device="cpu": nothing lands on the
    CPU unless the caller asks for it. With one, the card is the default."""
    from dust3r_tpu_torch.cloud_opt import global_aligner
    from dust3r_tpu_torch.model import dust3r_512_dpt
    from dust3r_tpu_torch.tools.scenes import synthetic_scene
    from dust3r_tpu_torch.utils.device import default_device

    out, _, _ = synthetic_scene(3, 8, 8, 10.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        dust3r_512_dpt()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        AsymmetricCroCo3DStereo(**CONFIGS["tiny_linear"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        global_aligner(out, verbose=False)
    assert global_aligner(out, device="cpu", verbose=False).device == torch.device("cpu")
    assert AsymmetricCroCo3DStereo(**CONFIGS["tiny_linear"], device="cpu").patch_embed \
        .proj.weight.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device("AsymmetricCroCo3DStereo") == torch.device("cuda")


def test_port_imports_no_jax_pil_or_triton():
    """Every module of the port imports with torch, numpy and scipy alone:
    no JAX, flax, optax, cv2, PIL or triton, and nothing of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dust3r_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(dust3r_tpu_torch.__path__,"
        " 'dust3r_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 23, mods\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'dust3r_tpu', 'triton', 'PIL', 'cv2')"
        " if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, where):
    """No CUDA device here: the script exits non-zero and prints no result;
    copied alone into an empty directory it fails as well."""
    script = osp.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(script)], cwd=osp.dirname(str(script)),
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
