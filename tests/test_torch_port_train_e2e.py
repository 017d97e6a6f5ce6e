"""`python -m dust3r_tpu_torch.train` end to end on the CPU: the tiny arch
on the Co3d-layout fixture of tests/test_torch_port_train_data.py (its
portrait sequence gives ManyAR batches), two epochs with a test set.

The checkpoints come on the JAX loop's cadence (`dust3r_tpu/training.py`:
last at each epoch's start, kept every keep_freq, best on a better test
median, final at the end; each file's epoch is the one JAX records); a
second run in the same directory resumes from checkpoint-last at the next
epoch; checkpoint-final.pth loads through `load_model`.
"""
import json
import os.path as osp
import runpy
import sys

import numpy as np
import torch

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

from dust3r_tpu_torch.model import load_model  # noqa: E402
from test_torch_port_train_data import _write_co3d  # noqa: E402

ARCH = ("AsymmetricCroCo3DStereo(pos_embed='RoPE100', patch_embed_cls='ManyAR_PatchEmbed', "
        "img_size=(64, 64), head_type='linear', output_mode='pts3d', "
        "depth_mode=('exp', -inf, inf), conf_mode=('exp', 1, inf), enc_embed_dim=32, "
        "enc_depth=1, enc_num_heads=2, dec_embed_dim=32, dec_depth=1, dec_num_heads=2, "
        "landscape_only=True)")


def _run(monkeypatch, root, out, epochs, extra=()):
    argv = ["dust3r_tpu_torch.train", "--model", ARCH,
            "--train_dataset", f"8 @ Co3d(split='train', ROOT='{root}', resolution=[(64, 48), "
                               f"(64, 32)], seed=3, transform=ColorJitter, mask_bg='rand')",
            "--test_dataset", f"4 @ Co3d(split='train', ROOT='{root}', resolution=(64, 48), "
                              f"seed=4)",
            "--batch_size", "2", "--accum_iter", "2", "--epochs", str(epochs),
            "--warmup_epochs", "1", "--lr", "1e-4", "--keep_freq", "1", "--print_freq", "1",
            "--num_workers", "0", "--device", "cpu", "--output_dir", out, *extra]
    monkeypatch.setattr(sys, "argv", argv)
    runpy.run_module("dust3r_tpu_torch.train", run_name="__main__")


def _ckpt(out, name):
    return torch.load(osp.join(out, f"checkpoint-{name}.pth"), map_location="cpu",
                      weights_only=False)


def test_train_cli_cadence_resume_and_final(tmp_path, monkeypatch, capsys):
    root = _write_co3d(str(tmp_path / "co3d"), 0)
    out = str(tmp_path / "run")
    _run(monkeypatch, root, out, 2)
    # JAX's cadence at epochs=2, save/eval/keep every epoch: last(1), kept 1
    # (0) and 2 (1), best (0 or 1), final (2)
    epochs = {name: _ckpt(out, name)["epoch"] for name in ("last", "1", "2", "best", "final")}
    assert epochs["last"] == 1 and epochs["1"] == 0 and epochs["2"] == 1
    assert epochs["final"] == 2 and epochs["best"] in (0, 1)
    final = _ckpt(out, "final")
    assert set(final) == {"model", "optimizer", "epoch", "best_so_far", "args"}
    assert np.isfinite(final["best_so_far"])
    steps = {int(s["step"]) for s in final["optimizer"]["state"].values()}
    assert steps == {2 * 2}  # 2 epochs x (8 pairs / (2 x 2) a step)
    with open(osp.join(out, "log.txt")) as f:
        log = [json.loads(line) for line in f]
    assert [e["epoch"] for e in log] == [0, 1, 2] and "train_loss" in log[2]

    model = load_model(osp.join(out, "checkpoint-final.pth"), device="cpu", verbose=False)
    for k, v in model.state_dict().items():
        assert torch.equal(v, final["model"][k]), k
    img = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (2, 48, 64, 3))
                           .astype(np.float32))
    with torch.no_grad():
        r1, r2 = model(img, img.flip(0))
    assert torch.isfinite(r1["pts3d"]).all() and torch.isfinite(r2["conf"]).all()

    # resume: a longer run in the same directory starts at epoch 2
    capsys.readouterr()
    _run(monkeypatch, root, out, 3)
    printed = capsys.readouterr().out
    assert "auto-resuming from" in printed and "Epoch: [2]" in printed
    assert "Epoch: [0]" not in printed and "Epoch: [1]" not in printed
    final = _ckpt(out, "final")
    assert final["epoch"] == 3
    assert {int(s["step"]) for s in final["optimizer"]["state"].values()} == {3 * 2}


def test_train_cli_remat_policies_train_alike(tmp_path, monkeypatch):
    """`--remat 1 --remat_policy dots` trains through the CLI: one epoch
    (ColorJitter's unseeded draws seeded alike) ends on `--remat 0`'s
    weights bit for bit, the CPU's recompute being exact."""
    import dust3r_tpu_torch.training as training

    root = _write_co3d(str(tmp_path / "co3d"), 0)
    built = []
    real = training.build_model
    monkeypatch.setattr(training, "build_model",
                        lambda *a, **kw: built.append(kw) or real(*a, **kw))
    orig = np.random.default_rng  # ColorJitter's unseeded draws, seeded alike in each run
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: orig(1234 if seed is None else seed))
    finals = {}
    for tag, extra in (("none", ()), ("dots", ("--remat", "1", "--remat_policy", "dots"))):
        out = str(tmp_path / tag)
        _run(monkeypatch, root, out, 1, extra)
        finals[tag] = _ckpt(out, "final")["model"]
    assert [(kw["remat"], kw["remat_policy"]) for kw in built] == [(False, "full"),
                                                                  (True, "dots")]
    for k, v in finals["none"].items():
        assert torch.equal(finals["dots"][k], v), k


def test_train_on_the_nine_dataset_mix_with_a_test_set(tmp_path):
    """train(args) at the tiny arch on the published mix of the nine
    datasets (the layouts of tools/train_scenes.py), evaluated on the
    published test mix with its criterion: 2 steps, every loss finite."""
    from dust3r_tpu_torch.tools.train_scenes import (TRAIN_ARGS, mix_dsl, test_mix_dsl,
                                                     write_mix)
    from dust3r_tpu_torch.train import get_args_parser
    from dust3r_tpu_torch.training import train

    roots = write_mix(str(tmp_path / "mix"), frames=3, seed=1, long_edge=96)
    small = dict(Habitat=(64, 48), BlendedMVS=(64, 48), MegaDepth=(64, 32), Co3d=(64, 48))
    out = str(tmp_path / "run")
    args = get_args_parser().parse_args([
        "--model", ARCH,
        "--train_dataset", mix_dsl(roots, {name: 1 for name in TRAIN_ARGS},
                                   [(64, 48), (64, 32)], seed=3),
        "--test_dataset", test_mix_dsl(roots, 2, small),
        "--train_criterion", "ConfLoss(Regr3D(L21, norm_mode='avg_dis'), alpha=0.2)",
        "--test_criterion", "Regr3D_ScaleShiftInv(L21, gt_scale=True)",
        "--batch_size", "2", "--accum_iter", "2", "--epochs", "1", "--warmup_epochs", "0",
        "--lr", "1e-4", "--num_workers", "0", "--device", "cpu", "--output_dir", out])
    steps = []
    train(args, on_step=lambda model, epoch, i, metrics, mbs: steps.append(metrics))
    assert len(steps) == 2  # 9 pairs at batch 2 x accum 2
    assert all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in steps)
    with open(osp.join(out, "log.txt")) as f:
        last = [json.loads(line) for line in f][-1]
    tested = {k for k in last if k.endswith("_loss_med")}
    assert len(tested) == 4 and all(np.isfinite(last[k]) for k in tested), last
