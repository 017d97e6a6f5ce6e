"""The port's checkpoint loaders against the JAX package's, on files written
here in every layout `tests/test_checkpoint.py` covers.

Weights: the JAX models of tests/test_torch_port_model.py (`tiny_linear`
and `small_dpt`, its real DPT hooks at dec_depth 12) with parameters from a
seeded numpy generator, exported through `dust3r_tpu.checkpoint`'s
`to_torch_state_dict` / `save_torch_checkpoint`. Each file is loaded by both
packages; the port's state dict must equal `state_dict_from_jax` of the
JAX package's loaded variables bit for bit, and the two forwards agree to
1e-5 of the largest |output| with the linear head. With the DPT head the
bound is 3e-5: its conf = 1 + exp(x) turns the two packages' float noise in
x (2.6e-5 relative, element by element) into 1.0e-5 to 1.5e-5 of the
largest |conf| over three seeds (tests/test_torch_port_model.py holds the
same forward at 1e-4 of mean |x|). The manifests of the published state
dicts (docs/ckpt_manifest_*.json) are read, never written.
"""
import argparse
import json
import os.path as osp
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

import dust3r_tpu.checkpoint as jckpt  # noqa: E402
import dust3r_tpu_torch  # noqa: E402
from dust3r_tpu_torch import checkpoint as ckpt  # noqa: E402
from dust3r_tpu_torch.model import load_model  # noqa: E402
from dust3r_tpu_torch.models.model import dust3r_224_linear, dust3r_512_dpt  # noqa: E402
from test_torch_port_model import CONFIGS, IMG_HW, images, jax_model, seeded_variables  # noqa: E402

DOCS = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "docs")
FWD_RTOL = {"linear": 1e-5, "dpt": 3e-5}


def arch_of(cfg, extra="patch_embed_cls='ManyAR_PatchEmbed', "):
    """The published arch-string layout for a config."""
    return (f"AsymmetricCroCo3DStereo(pos_embed='RoPE100', {extra}"
            f"img_size={tuple(cfg['img_size'])}, head_type={cfg['head_type']!r}, "
            f"output_mode='pts3d', depth_mode=('exp', -inf, inf), conf_mode=('exp', 1, inf), "
            f"enc_embed_dim={cfg['enc_embed_dim']}, enc_depth={cfg['enc_depth']}, "
            f"enc_num_heads={cfg['enc_num_heads']}, dec_embed_dim={cfg['dec_embed_dim']}, "
            f"dec_depth={cfg['dec_depth']}, dec_num_heads={cfg['dec_num_heads']}, "
            f"landscape_only=False)")


def hub_config(cfg):
    """A hub mixin's config.json: JSON infinities, torch-only keys, and the
    croco kwargs beside the model's."""
    return dict(output_mode="pts3d", head_type=cfg["head_type"],
                depth_mode=["exp", -float("inf"), float("inf")],
                conf_mode=["exp", 1, float("inf")], freeze="none", landscape_only=True,
                patch_embed_cls="ManyAR_PatchEmbed", img_size=list(cfg["img_size"]),
                pos_embed="RoPE100", mlp_ratio=4.0,
                **{k: cfg[k] for k in ("patch_size", "enc_embed_dim", "enc_depth",
                                       "enc_num_heads", "dec_embed_dim", "dec_depth",
                                       "dec_num_heads")})


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def weights(request):
    """(config, JAX model, JAX variables, the reference-named torch state
    dict of those variables)."""
    name = request.param
    model = jax_model(name)
    variables = seeded_variables(model, 21)
    cfg = CONFIGS[name]
    sd = jckpt.to_torch_state_dict(variables, cfg["enc_depth"], cfg["dec_depth"],
                                   cfg["head_type"])
    return cfg, model, variables, {k: torch.from_numpy(np.ascontiguousarray(v))
                                   for k, v in sd.items()}


def release_sd(cfg, sd):
    """As a released file lays its tensors out: one decoder, the DPT heads'
    dead refinenet4.resConfUnit1, a mask_token."""
    out = {k: v for k, v in sd.items() if not k.startswith("dec_blocks2.")}
    gen = torch.Generator().manual_seed(5)
    out["mask_token"] = torch.randn(1, 1, cfg["enc_embed_dim"], generator=gen)
    if cfg["head_type"] == "dpt":
        unit = "dpt.scratch.refinenet4.resConfUnit1"
        for n in (1, 2):
            for conv in ("conv1", "conv2"):
                w = sd[f"downstream_head{n}.dpt.scratch.refinenet4.resConfUnit2.{conv}.weight"]
                out[f"downstream_head{n}.{unit}.{conv}.weight"] = torch.randn(
                    w.shape, generator=gen)
                out[f"downstream_head{n}.{unit}.{conv}.bias"] = torch.randn(
                    w.shape[0], generator=gen)
    return out


def check_against_jax(port, jax_loaded, cfg, forward=False):
    """The port's loaded state dict against the JAX package's loaded
    variables, bit for bit; with `forward`, the two forwards."""
    jmodel, jvars = jax_loaded
    want = ckpt.state_dict_from_jax(jax.tree.map(np.asarray, jvars), cfg["enc_depth"],
                                    cfg["dec_depth"], cfg["head_type"])
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert next(port.parameters()).device == torch.device("cpu")
    if forward:
        img1, img2 = images(4)
        jr1, jr2 = jmodel.clone(attn_impl="ref").apply(jvars, jnp.asarray(img1),
                                                        jnp.asarray(img2))
        with torch.no_grad():
            r1, r2 = port(torch.from_numpy(img1), torch.from_numpy(img2))
        for ours, theirs in ((r1["pts3d"], jr1["pts3d"]), (r1["conf"], jr1["conf"]),
                             (r2["pts3d_in_other_view"], jr2["pts3d_in_other_view"]),
                             (r2["conf"], jr2["conf"])):
            theirs = np.asarray(theirs)
            assert ours.shape == theirs.shape
            err = np.abs(ours.numpy() - theirs).max() / np.abs(theirs).max()
            assert err <= FWD_RTOL[cfg["head_type"]], err


# ---------------------------------------------------------------------- #
# arch strings and hub configs
# ---------------------------------------------------------------------- #

PUBLISHED = {
    "512_dpt": ("AsymmetricCroCo3DStereo(pos_embed='RoPE100', "
                "patch_embed_cls='ManyAR_PatchEmbed', img_size=(512, 512), head_type='dpt', "
                "output_mode='pts3d', depth_mode=('exp', -inf, inf), "
                "conf_mode=('exp', 1, inf), enc_embed_dim=1024, enc_depth=24, "
                "enc_num_heads=16, dec_embed_dim=768, dec_depth=12, dec_num_heads=12, "
                "landscape_only=False)"),
    "512_linear": ("AsymmetricCroCo3DStereo(pos_embed='RoPE100', "
                   "patch_embed_cls='ManyAR_PatchEmbed', img_size=(512, 512), "
                   "head_type='linear', output_mode='pts3d', depth_mode=('exp', -inf, inf), "
                   "conf_mode=('exp', 1, inf), enc_embed_dim=1024, enc_depth=24, "
                   "enc_num_heads=16, dec_embed_dim=768, dec_depth=12, dec_num_heads=12)"),
    "224_linear": ("AsymmetricCroCo3DStereo(pos_embed='RoPE100', img_size=(224, 224), "
                   "head_type='linear', output_mode='pts3d', depth_mode=('exp', -inf, inf), "
                   "conf_mode=('exp', 1, inf), enc_embed_dim=1024, enc_depth=24, "
                   "enc_num_heads=16, dec_embed_dim=768, dec_depth=12, dec_num_heads=12)"),
    "float_call": ("AsymmetricCroCo3DStereo(img_size=224, depth_mode=('exp', -inf, 1e2), "
                   "mlp_ratio=float(2))"),
}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_parse_arch_string_matches_jax(name):
    assert ckpt.parse_arch_string(PUBLISHED[name]) == jckpt.parse_arch_string(PUBLISHED[name])


def test_arch_string_refuses_code():
    for bad in ("AsymmetricCroCo3DStereo(img_size=__import__('os').getcwd())",
                "Other(img_size=(1, 2))", "not an arch string"):
        with pytest.raises(ValueError):
            ckpt.parse_arch_string(bad)


def test_model_from_arch_string_builds_the_published_config():
    model = ckpt.model_from_arch_string(PUBLISHED["512_dpt"], device="meta")
    assert (model.head_type, model.img_size, model.enc_depth, model.dec_depth) == \
        ("dpt", (512, 512), 24, 12)
    assert model.depth_mode == ("exp", -np.inf, np.inf)
    small = ckpt.model_from_arch_string(PUBLISHED["float_call"], device="meta")
    assert small.img_size == (224, 224) and small.depth_mode == ("exp", -np.inf, 100.0)
    assert small.mlp_ratio == 2.0


def test_hub_config_string_inf_and_nested_kwargs():
    """JSON-mangled infinities come back, nested croco_kwargs are
    flattened, keys the port's constructor does not take are dropped, as
    in `model_from_hub_config` of the JAX package."""
    tiny = {k: v for k, v in CONFIGS["tiny_linear"].items() if k not in ("img_size",
                                                                        "head_type")}
    cfg = dict(output_mode="pts3d", head_type="linear", depth_mode=["exp", "-inf", "Infinity"],
               conf_mode=None, patch_embed_cls="PatchEmbedDust3R", freeze="encoder",
               croco_kwargs=dict(img_size=224, **tiny))
    jm = jckpt.model_from_hub_config(cfg)
    pm = ckpt.model_from_hub_config(cfg, device="meta")
    for field in ("head_type", "img_size", "depth_mode", "conf_mode", "enc_depth",
                  "enc_embed_dim", "dec_num_heads", "patch_size", "mlp_ratio", "pos_embed"):
        assert getattr(pm, field) == getattr(jm, field), field
    assert pm.img_size == (224, 224) and pm.conf_mode is None


# ---------------------------------------------------------------------- #
# .pth files
# ---------------------------------------------------------------------- #

PTH_LAYOUTS = ("release", "single_decoder", "jax_export", "bf16", "arch_key")


def write_pth(layout, path, cfg, jmodel, variables, sd):
    if layout == "jax_export":  # dust3r_tpu.checkpoint.save_torch_checkpoint
        jckpt.save_torch_checkpoint(path, jmodel, variables)
        return
    model_sd = {"release": release_sd(cfg, sd),
                "single_decoder": {k: v for k, v in sd.items()
                                   if not k.startswith("dec_blocks2.")},
                "bf16": {k: v.to(torch.bfloat16) for k, v in sd.items()},
                "arch_key": sd}[layout]
    if layout == "arch_key":
        torch.save({"arch": arch_of(cfg), "model": model_sd, "epoch": 3}, path)
    else:
        torch.save({"args": argparse.Namespace(model=arch_of(cfg)), "model": model_sd}, path)


@pytest.mark.parametrize("layout", PTH_LAYOUTS)
def test_pth_loads_as_the_jax_package_loads_it(weights, layout, tmp_path):
    cfg, jmodel, variables, sd = weights
    path = str(tmp_path / "ckpt.pth")
    write_pth(layout, path, cfg, jmodel, variables, sd)
    theirs = jckpt.load_torch_checkpoint(path, verbose=False)
    ours = ckpt.load_torch_checkpoint(path, verbose=False, device="cpu")
    check_against_jax(ours, theirs, cfg, forward=layout == "release")
    if layout in ("release", "single_decoder"):  # dec_blocks copied into dec_blocks2
        for k, v in sd.items():
            if k.startswith("dec_blocks."):
                assert torch.equal(ours.state_dict()["dec_blocks2." + k[11:]], v)


def test_leftover_report_is_the_jax_converters(weights, tmp_path, capsys):
    """With verbose, both packages report the same unconsumed tensors (the
    mask_token; the dead refinenet4 unit is read by the JAX converter and
    dropped quietly by the port)."""
    cfg, jmodel, variables, sd = weights
    path = str(tmp_path / "release.pth")
    write_pth("release", path, cfg, jmodel, variables, sd)
    capsys.readouterr()
    jckpt.load_torch_checkpoint(path, verbose=True)
    theirs = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("converter:")]
    ckpt.load_torch_checkpoint(path, verbose=True, device="cpu")
    ours = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("converter:")]
    assert ours == theirs and "mask_token" in ours[0]


@pytest.mark.parametrize("weights", ["small_dpt"], indirect=True)
def test_layer_rn_spelling_is_renamed(weights, tmp_path):
    """`scratch.layer_rn.{k-1}` (a ModuleList registration in the wild) is
    read as `scratch.layer{k}_rn`, as the JAX converter's `rn_name` does."""
    cfg, jmodel, variables, sd = weights
    renamed = {re.sub(r"\.scratch\.layer(\d)_rn\.", lambda m: f".scratch.layer_rn.{int(m[1]) - 1}.",
                      k): v for k, v in sd.items()}
    assert any(".layer_rn.3." in k for k in renamed)
    path = str(tmp_path / "rn.pth")
    torch.save({"args": argparse.Namespace(model=arch_of(cfg)), "model": renamed}, path)
    check_against_jax(ckpt.load_torch_checkpoint(path, verbose=False, device="cpu"),
                      jckpt.load_torch_checkpoint(path, verbose=False), cfg)


def test_port_writes_what_both_packages_load(weights, tmp_path):
    """The port's save_torch_checkpoint, and a snapshot of the port's state
    dict: the JAX loaders read back the same weights."""
    from safetensors.torch import save_file

    cfg, jmodel, variables, sd = weights
    port = ckpt.load_torch_checkpoint(_pth(tmp_path, cfg, jmodel, variables, sd),
                                      verbose=False, device="cpu")
    path = str(tmp_path / "port.pth")
    ckpt.save_torch_checkpoint(path, port)
    check_against_jax(ckpt.load_torch_checkpoint(path, verbose=False, device="cpu"),
                      jckpt.load_torch_checkpoint(path, verbose=False), cfg)
    snap = tmp_path / "snap"
    snap.mkdir()
    save_file(port.state_dict(), str(snap / "model.safetensors"))
    (snap / "config.json").write_text(json.dumps(hub_config(cfg)))
    check_against_jax(ckpt.from_pretrained(str(snap), verbose=False, device="cpu"),
                      jckpt.from_pretrained(str(snap), verbose=False), cfg)


def _pth(tmp_path, cfg, jmodel, variables, sd):
    path = str(tmp_path / "source.pth")
    write_pth("jax_export", path, cfg, jmodel, variables, sd)
    return path


# ---------------------------------------------------------------------- #
# hub snapshots
# ---------------------------------------------------------------------- #

HUB_LAYOUTS = ("safetensors", "legacy_bin", "full_bin", "training_wrapper", "bf16_bin")


@pytest.mark.parametrize("layout", HUB_LAYOUTS)
def test_hub_snapshot_loads_as_the_jax_package_loads_it(weights, layout, tmp_path):
    from safetensors.torch import save_file

    cfg, jmodel, variables, sd = weights
    names = {"safetensors": "model.safetensors"}
    wpath = str(tmp_path / names.get(layout, "pytorch_model.bin"))
    if layout == "safetensors":
        save_file({k: v.contiguous() for k, v in sd.items()}, wpath)
    elif layout == "legacy_bin":
        torch.save(sd, wpath)
    elif layout == "full_bin":  # a full reference checkpoint under a hub name
        jckpt.save_torch_checkpoint(wpath, jmodel, variables)
    elif layout == "training_wrapper":
        torch.save({"model": sd, "optimizer": {}, "epoch": 7}, wpath)
    else:
        torch.save({k: v.to(torch.bfloat16) for k, v in sd.items()}, wpath)
    cpath = None
    if layout != "full_bin":
        cpath = str(tmp_path / "config.json")
        with open(cpath, "w") as f:
            json.dump(hub_config(cfg), f)  # writes -Infinity / Infinity
    theirs = jckpt.load_hub_checkpoint(wpath, cpath, verbose=False)
    ours = ckpt.load_hub_checkpoint(wpath, cpath, verbose=False, device="cpu")
    check_against_jax(ours, theirs, cfg, forward=layout == "safetensors")
    # the same file through from_pretrained: a directory, and the file itself
    for target in (str(tmp_path), wpath):
        check_against_jax(ckpt.from_pretrained(target, verbose=False, device="cpu"),
                          theirs, cfg)


def test_from_pretrained_reads_config_only_beside_hub_names(weights, tmp_path):
    """A plain .pth next to an unrelated config.json goes through its arch
    string; a bare state dict under a non-hub name does not pick up the
    neighbour (both packages refuse it)."""
    cfg, jmodel, variables, sd = weights
    path = str(tmp_path / "release.pth")
    write_pth("release", path, cfg, jmodel, variables, sd)
    (tmp_path / "config.json").write_text(json.dumps({"head_type": "other", "x": 1}))
    model = ckpt.from_pretrained(path, verbose=False, device="cpu")
    assert model.head_type == cfg["head_type"]
    check_against_jax(model, jckpt.from_pretrained(path, verbose=False), cfg)
    bare = str(tmp_path / "weights.bin")
    torch.save(sd, bare)
    with pytest.raises(Exception):
        jckpt.from_pretrained(bare, verbose=False)
    with pytest.raises(Exception):
        ckpt.from_pretrained(bare, verbose=False, device="cpu")


# ---------------------------------------------------------------------- #
# the published state dicts, deliberate divergences, entry points
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("name,make", [("512_dpt", dust3r_512_dpt),
                                       ("224_linear", dust3r_224_linear)])
def test_state_dict_is_the_committed_manifest(name, make):
    """What the loader feeds `load_state_dict(strict=True)` at full width:
    the names and shapes of docs/ckpt_manifest_{name}.json."""
    with open(osp.join(DOCS, f"ckpt_manifest_{name}.json")) as f:
        manifest = json.load(f)
    sd = make(device="meta").state_dict()
    assert {k: list(v.shape) for k, v in sd.items()} == manifest


def test_orbax_directory_and_portrait_flags_raise(tmp_path):
    """A deliberate divergence: an orbax directory holds JAX trees, and
    raises. landscape_only=True, which raised before the ManyAR portrait
    flags were ported, is now taken as JAX takes it: the model it builds is
    the landscape_only=False one (the flags of a batch choose the path)."""
    orbax_dir = str(tmp_path / "ckpt-1")
    jckpt.save_checkpoint(orbax_dir, {"params": {"w": jnp.ones(3)}},
                          metadata={"arch": PUBLISHED["224_linear"]})
    with pytest.raises(NotImplementedError, match="save_torch_checkpoint"):
        ckpt.from_pretrained(orbax_dir, verbose=False, device="cpu")
    for build, arg in ((ckpt.model_from_arch_string, PUBLISHED["224_linear"]),
                       (ckpt.model_from_hub_config, {"head_type": "linear"})):
        portrait, landscape = (build(arg, landscape_only=flag, device="meta")
                               for flag in (True, False))
        assert ckpt.arch_string(portrait) == ckpt.arch_string(landscape)
        assert {k: v.shape for k, v in portrait.state_dict().items()} == \
            {k: v.shape for k, v in landscape.state_dict().items()}


def test_load_model_and_the_lazy_api(weights, tmp_path):
    cfg, jmodel, variables, sd = weights
    path = _pth(tmp_path, cfg, jmodel, variables, sd)
    theirs = jckpt.load_torch_checkpoint(path, verbose=False)
    check_against_jax(load_model(path, device="cpu", verbose=False), theirs, cfg)
    assert dust3r_tpu_torch.load_model is load_model
    assert dust3r_tpu_torch.from_pretrained is ckpt.from_pretrained
    bf16 = load_model(path, device="cpu", verbose=False, dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    assert next(bf16.parameters()).dtype == torch.float32  # params stay fp32
    if not torch.cuda.is_available():  # no device named: the card, or an error
        with pytest.raises(RuntimeError, match='device="cpu"'):
            load_model(path, verbose=False)
