"""The one generator of the benchmark's traffic: a mix file
(`traffic/<mix>.json`) and `--seed` give the scenes a run sends and their
images.

A mix lists scene specs (images, height, width), how many distinct seeded
scenes each spec has (`pool`), and the order the window sends them in: the
cycle of every (spec, pool) pair repeated, in the file's order (`cycle`) or
shuffled once from the seed (`shuffled_cycle`), so every seed sends the same
sizes in another order. Images are uint8 RGB: a horizontal ramp in red and a
vertical ramp in green, each shifted a little per image, a seeded flat blue
and seeded noise.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ORDERS = ("cycle", "shuffled_cycle")


def load_mix(name, root=HERE):
    """The mix file `traffic/<name>.json` under `root`."""
    with open(Path(root) / "traffic" / f"{name}.json") as f:
        mix = json.load(f)
    if mix.get("order") not in ORDERS:
        raise ValueError(f"mix {name}: order {mix.get('order')!r} not in {ORDERS}")
    return mix


def _rng(seed, *key):
    return np.random.default_rng([int(seed) % 2 ** 63, *key])


def cycle(mix, seed):
    """The (spec index, pool index) of each scene of one cycle, in the order
    the window sends them."""
    keys = [(s, p) for p in range(mix["pool"]) for s in range(len(mix["scenes"]))]
    if mix["order"] == "shuffled_cycle":
        keys = [keys[i] for i in _rng(seed, 1).permutation(len(keys))]
    return keys


def images(seed, spec_index, pool_index, spec):
    """The uint8 (H, W, 3) images of one scene."""
    rng = _rng(seed, 2, spec_index, pool_index)
    H, W = spec["height"], spec["width"]
    v, u = np.mgrid[:H, :W].astype(np.float32)
    u, v = u / W, v / H
    out = []
    for _ in range(spec["images"]):
        du, dv = rng.uniform(-0.05, 0.05, 2)
        img = np.stack([230 * np.clip(u + du, 0, 1), 230 * np.clip(v + dv, 0, 1),
                        np.full_like(u, rng.uniform(40, 90))], -1)
        img += 4 * rng.standard_normal(img.shape, dtype=np.float32)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def pair_count(n, mix):
    """Pairs of an n-image scene under the mix's graph."""
    if mix["scene_graph"] != "complete":
        raise ValueError(f"scene graph {mix['scene_graph']!r}: only 'complete' is counted here")
    return n * (n - 1) // (1 if mix["symmetrize"] else 2)


def check_sample(mix, seed):
    """Which scenes of the window the check compares: `check.scenes` of the
    first `check.from_first` sent, drawn from the seed."""
    chk = mix["check"]
    return sorted(int(k) for k in _rng(seed, 3).choice(chk["from_first"], chk["scenes"],
                                                        replace=False))
