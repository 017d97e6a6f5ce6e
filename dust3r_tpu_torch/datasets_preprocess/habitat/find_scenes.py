#!/usr/bin/env python3
"""Export habitat scene lists after rendering.

Counterpart of `datasets_preprocess/habitat/find_scenes.py` (walk the
rendered output for *_1_depth.exr markers, 90/10 train/val split of whole
scenes with seed 777, size-capped shuffled lists):

    python -m dust3r_tpu_torch.datasets_preprocess.habitat.find_scenes \
        --root OUT [--n_scenes 1000 10000] [--yes]
"""
import argparse
import os
from collections import defaultdict

import numpy as np

_MARKER = "_1_depth.exr"  # one per rendered sub-scene
_INDEX_NAME = "Habitat_all_scenes.txt"


def _walk_for_subscenes(habitat_root):
    """Find every rendered sub-scene under the root (slow full walk)."""
    found = []
    for dirpath, _dirs, filenames in os.walk(habitat_root):
        rel = os.path.relpath(dirpath, habitat_root)
        found += [os.path.join(rel, name[: -len(_MARKER)])
                  for name in filenames if name.endswith(_MARKER)]
    return found


def _load_or_build_index(habitat_root, assume_yes):
    index_path = os.path.join(habitat_root, _INDEX_NAME)
    try:
        return open(index_path).read().splitlines()
    except IOError:
        pass
    if not assume_yes and \
            input("parsing sub-folders to find scenes? (y/n) ") != "y":
        return None
    subscenes = _walk_for_subscenes(habitat_root)
    with open(index_path, "w") as out:
        out.write("\n".join(subscenes))
    print(f">> wrote {index_path}")
    return subscenes


def _dump_capped(scene_groups, cap, path):
    """Write up to `cap` shuffled sub-scenes; skip if fewer exist."""
    flat = [os.path.join(scene, sid)
            for scene, ids in scene_groups for sid in ids]
    np.random.shuffle(flat)
    if len(flat) >= cap:
        with open(path, "w") as out:
            out.write("\n".join(flat[:cap]))
        print(f">> wrote {path}")


def find_all_scenes(habitat_root, n_scenes=(100000,), assume_yes=False):
    np.random.seed(777)

    subscenes = _load_or_build_index(habitat_root, assume_yes)
    if subscenes is None:
        return
    print(f"Loaded {len(subscenes)} sub-scenes")

    by_scene = defaultdict(list)
    for entry in subscenes:
        parent, sid = os.path.split(entry)
        by_scene[parent].append(sid)
    grouped = list(by_scene.items())
    print(f"from {len(grouped)} scenes in total")

    # whole scenes (not sub-scenes) are assigned to a split: 10% val
    np.random.shuffle(grouped)
    n_val = len(grouped) // 10
    val_split, train_split = grouped[:n_val], grouped[n_val:]

    for cap in n_scenes:
        _dump_capped(train_split, cap, os.path.join(
            habitat_root, f"Habitat_{cap}_scenes_train.txt"))
        _dump_capped(val_split, cap // 10, os.path.join(
            habitat_root, f"Habitat_{cap // 10}_scenes_val.txt"))


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", required=True)
    parser.add_argument("--n_scenes", nargs="+",
                        default=[1_000, 10_000, 100_000, 1_000_000], type=int)
    parser.add_argument("--yes", action="store_true",
                        help="don't ask before walking the tree")
    args = parser.parse_args()
    find_all_scenes(args.root, args.n_scenes, assume_yes=args.yes)
