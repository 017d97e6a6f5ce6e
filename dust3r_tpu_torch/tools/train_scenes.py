"""Co3d-layout training scenes with a known geometry, written with PIL and
numpy (no cv2).

    python -m dust3r_tpu_torch.tools.train_scenes OUT_DIR [--frames 100]

Each sequence is a camera moving over a textured plane (z = PLANE_Z in the
world, a checkerboard with a seeded colour noise on it); each frame's
depth is the plane's, ray by ray, so the images, depths and cameras agree.
It writes, as `datasets_preprocess/preprocess_co3d.py` lays them out:
  OUT/selected_seqs_{split}.json
  OUT/{category}/{sequence}/images/frame%06d.jpg   (the JPEG image)
  OUT/{category}/{sequence}/images/frame%06d.npz   (K, cam2world, max depth)
  OUT/{category}/{sequence}/depths/frame%06d.jpg.geometric.png (16 bit)
  OUT/{category}/{sequence}/masks/frame%06d.png    (foreground: a disc)
`SEQUENCES` gives two 640x480 landscape sequences and one 480x640
portrait one: Co3d at 512 buckets gives batches of both orientations.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import numpy as np

PLANE_Z = 3.0
# (category, sequence, width, height)
SEQUENCES = (("teddybear", "seq0", 640, 480), ("teddybear", "seq1", 640, 480),
             ("hydrant", "seq2", 480, 640))


def _rotation(rx, ry):
    cx, sx, cy, sy = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return Ry @ Rx


def _texture(x, y, noise):
    """Colour of the plane at world (x, y): a 0.25-unit checkerboard, a
    colour ramp and a seeded per-cell noise."""
    cx, cy = np.floor(x / 0.25).astype(np.int64), np.floor(y / 0.25).astype(np.int64)
    check = ((cx + cy) % 2).astype(np.float64)
    cell = noise[cx % noise.shape[0], cy % noise.shape[1]]
    rgb = np.stack([0.3 + 0.4 * check, 0.5 + 0.2 * np.sin(x), 0.5 + 0.2 * np.cos(y)], -1)
    return np.clip(255 * (0.8 * rgb + 0.2 * cell), 0, 255).astype(np.uint8)


def frame(W, H, k, n, noise):
    """Frame k of n: (rgb uint8, depth float32, K, cam2world, fg mask)."""
    focal = 0.9 * max(W, H)
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    t = k / max(n - 1, 1)
    R = _rotation(0.15 * np.sin(2 * np.pi * t), 0.2 * np.cos(2 * np.pi * t))
    c = np.array([0.6 * np.sin(2 * np.pi * t), 0.4 * np.cos(2 * np.pi * t), 0.2 * t])
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3], pose[:3, 3] = R, c
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    rays = np.stack([gx, gy, np.ones_like(gx)], -1) @ np.linalg.inv(K.astype(np.float64)).T
    world_rays = rays @ R.T
    depth = (PLANE_Z - c[2]) / world_rays[..., 2]  # camera z of the hit (rays have z = 1)
    hit = c + world_rays * depth[..., None]
    rgb = _texture(hit[..., 0], hit[..., 1], noise)
    r = np.hypot(gx - W / 2, gy - H / 2)
    mask = (r < 0.4 * min(W, H)).astype(np.uint8) * 255
    return rgb, depth.astype(np.float32), K, pose, mask


def write_scenes(root, frames=100, seed=0, split="train", sequences=SEQUENCES, quality=90):
    """Write the sequences under root; returns root."""
    import PIL.Image

    rng = np.random.default_rng(seed)
    selected = {}
    for cat, seq, W, H in sequences:
        noise = rng.uniform(0, 1, (16, 16, 3))
        base = osp.join(root, cat, seq)
        for sub in ("images", "depths", "masks"):
            os.makedirs(osp.join(base, sub), exist_ok=True)
        for k in range(frames):
            rgb, depth, K, pose, mask = frame(W, H, k, frames, noise)
            max_depth = float(depth.max())
            name = f"frame{k:06d}"
            PIL.Image.fromarray(rgb).save(osp.join(base, "images", name + ".jpg"),
                                          quality=quality)
            d16 = np.round(depth / max_depth * 65535).astype(np.uint16)
            PIL.Image.fromarray(d16).save(osp.join(base, "depths", name + ".jpg.geometric.png"))
            PIL.Image.fromarray(mask).save(osp.join(base, "masks", name + ".png"))
            np.savez(osp.join(base, "images", name + ".npz"), camera_intrinsics=K,
                     camera_pose=pose, maximum_depth=np.float32(max_depth))
        selected.setdefault(cat, {})[seq] = list(range(frames))
    with open(osp.join(root, f"selected_seqs_{split}.json"), "w") as f:
        json.dump(selected, f)
    return root


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out_dir")
    parser.add_argument("--frames", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    a = parser.parse_args()
    write_scenes(a.out_dir, a.frames, a.seed)
