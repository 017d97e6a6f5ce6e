"""Fixtures of the benchmark's CPU tests: a tiny copy of the benchmark's
layout (the real BENCHMARK.json's cells and metrics, tiny-width configs and
small mixes) under a temporary root."""
from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_ARCH = dict(img_size=[512, 512], patch_size=16, pos_embed="RoPE100", enc_embed_dim=32,
                 enc_depth=2, enc_num_heads=2, dec_embed_dim=32, dec_depth=10, dec_num_heads=2,
                 mlp_ratio=4.0, output_mode="pts3d", depth_mode=["exp", "-inf", "inf"],
                 conf_mode=["exp", 1, "inf"])
TINY_LIMIT = 1e-5
TINY_MIXES = {
    "pose10": dict(scenes=[dict(images=3, height=48, width=64)], pool=2, batch_size=4,
                   check=dict(scenes=1, from_first=1), trace=dict(scenes=1)),
}


def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A root holding `portbench/` with tiny configs, mixes and limits of the
    benchmark's own names; returns (root, bench dict pointing at them)."""
    root = tmp_path_factory.mktemp("tiny")
    pb = root / "portbench"
    shutil.copytree(ROOT / "portbench" / "metrics", pb / "metrics")
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True)
    b = copy.deepcopy(bench())
    for c in b["configs"]:
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        head = cfg["arch"]["head_type"]
        cfg["arch"] = dict(TINY_ARCH, head_type=head)
        # float32 throughout, as the program runs on the CPU (plain convs)
        cfg["precision"].update(body="float32", conv3x3_operands="float32")
        path = pb / "configs" / Path(c["file"]).name
        path.write_text(json.dumps(cfg))
        c["file"] = str(path)
    for w in b["workloads"]:
        with open(ROOT / "portbench" / "traffic" / f"{w['traffic']}.json") as f:
            mix = json.load(f)
        mix.update(TINY_MIXES[w["traffic"]])
        (pb / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(mix))
        # the cell's own numbers, each held to TINY_LIMIT: at tiny widths in
        # float32 the program reads rounding alone
        with open(ROOT / "portbench" / "limits" / f"{w['name']}.json") as f:
            limits = dict.fromkeys(json.load(f), TINY_LIMIT)
        (pb / "limits" / f"{w['name']}.json").write_text(json.dumps(limits))
    return root, b


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (runs the cell at its size)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell at its own size")
    return "cuda"
