"""Training scenes with a known geometry, in the on-disk layouts of the nine
training datasets, written with PIL and numpy (no cv2).

    python -m dust3r_tpu_torch.tools.train_scenes OUT_DIR [--frames 100]   # Co3d
    python -m dust3r_tpu_torch.tools.train_scenes OUT_DIR --mix [--frames 8]  # OUT_DIR/<name>

Every frame is a camera over a textured plane (z = PLANE_Z in the world, a
checkerboard with a seeded colour noise on it); its depth is the plane's,
ray by ray, so the images, depths and cameras agree. Each layout is what
its preprocess script (`datasets_preprocess/`) leaves on disk, at its
size (`write_dataset`'s `long_edge` scales it):
  Co3d             640x480 and 480x640 JPEGs, 16-bit depth over max depth
                   (`write_scenes`: OUT/{category}/{sequence}/images|depths|masks)
  WildRGBD         512x384, depth in mm, a mask, metadata npz
  BlendedMVS       512x384, EXR depth, R_cam2world / t_cam2world, the pair
                   table; seq_low 10 is a val scene
  MegaDepth        800x600 and portrait 600x800, EXR depth; scenes 0015 and
                   0022 (val) beside 0001 and 0002
  StaticThings3D   512x384 clean and final passes, EXR depth with a far
                   background corner (depth 1000, masked by mask_bg), a
                   left and a right camera
  Waymo            512x341, a sparse (lidar-like) EXR depth
  ARKitScenes      640x480 vga_wide JPEGs (one portrait scene), uint16 mm
                   lowres_depth at the image's size, Training and Test
  ScanNetpp        920x690, uint16 mm depth
  Habitat          512x512 fans of 5 views, half-float EXR depth, camera
                   JSON; the first key of each split has a view whose pose
                   is not finite (the loader walks past it)
EXR files come from `utils/exr.write_exr`. `mix_dsl` and `test_mix_dsl`
give the published mix's dataset strings over these roots.
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
FAR_DEPTH = 1000.0  # StaticThings3D's background corner, past the loader's 200


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


def camera(W, H, k, n):
    """Frame k of n's intrinsics and cam2world: a camera circling above the
    plane, looking down at it."""
    focal = 0.9 * max(W, H)
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    t = k / max(n - 1, 1)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = _rotation(0.15 * np.sin(2 * np.pi * t), 0.2 * np.cos(2 * np.pi * t))
    pose[:3, 3] = (0.6 * np.sin(2 * np.pi * t), 0.4 * np.cos(2 * np.pi * t), 0.2 * t)
    return K, pose


def render(W, H, K, pose, noise):
    """The plane seen by a camera: (rgb uint8, depth float32)."""
    R, c = pose[:3, :3].astype(np.float64), pose[:3, 3].astype(np.float64)
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    rays = np.stack([gx, gy, np.ones_like(gx)], -1) @ np.linalg.inv(K.astype(np.float64)).T
    world_rays = rays @ R.T
    depth = (PLANE_Z - c[2]) / world_rays[..., 2]  # camera z of the hit (rays have z = 1)
    hit = c + world_rays * depth[..., None]
    return _texture(hit[..., 0], hit[..., 1], noise), depth.astype(np.float32)


def frame(W, H, k, n, noise):
    """Frame k of n: (rgb uint8, depth float32, K, cam2world, fg mask)."""
    K, pose = camera(W, H, k, n)
    rgb, depth = render(W, H, K, pose, noise)
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    mask = (np.hypot(gx - W / 2, gy - H / 2) < 0.4 * min(W, H)).astype(np.uint8) * 255
    return rgb, depth, K, pose, mask


def _frames(W, H, n, rng):
    """The n frames of one sequence, on a texture of its own."""
    noise = rng.uniform(0, 1, (16, 16, 3))
    return [frame(W, H, k, n, noise) for k in range(n)]


def _pairs(n):
    """A sequence's pairs: each frame with the next two."""
    return [(i, j) for i in range(n) for j in (i + 1, i + 2) if j < n]


def _sized(default, long_edge):
    """(W, H) of a default size scaled to `long_edge` (None: the default)."""
    W, H = default
    if long_edge is None:
        return W, H
    s = long_edge / max(W, H)
    return int(round(W * s)), int(round(H * s))


def _jpg(path, rgb, quality=75):
    import PIL.Image

    os.makedirs(osp.dirname(path), exist_ok=True)
    PIL.Image.fromarray(rgb).save(path, quality=quality)


def _png(path, arr):
    import PIL.Image

    os.makedirs(osp.dirname(path), exist_ok=True)
    PIL.Image.fromarray(arr).save(path)


def _npz(path, **arrays):
    os.makedirs(osp.dirname(path), exist_ok=True)
    np.savez(path, **arrays)


def _mm(depth):
    return np.round(depth * 1000).astype(np.uint16)


def write_scenes(root, frames=100, seed=0, split="train", sequences=SEQUENCES, quality=90):
    """The Co3d layout (`datasets_preprocess/preprocess_co3d.py`): sequences
    under root and selected_seqs_{split}.json; returns root."""
    rng = np.random.default_rng(seed)
    selected = {}
    for cat, seq, W, H in sequences:
        base = osp.join(root, cat, seq)
        for k, (rgb, depth, K, pose, mask) in enumerate(_frames(W, H, frames, rng)):
            max_depth = float(depth.max())
            name = f"frame{k:06d}"
            _jpg(osp.join(base, "images", name + ".jpg"), rgb, quality)
            _png(osp.join(base, "depths", name + ".jpg.geometric.png"),
                 np.round(depth / max_depth * 65535).astype(np.uint16))
            _png(osp.join(base, "masks", name + ".png"), mask)
            _npz(osp.join(base, "images", name + ".npz"), camera_intrinsics=K,
                     camera_pose=pose, maximum_depth=np.float32(max_depth))
        selected.setdefault(cat, {})[seq] = list(range(frames))
    with open(osp.join(root, f"selected_seqs_{split}.json"), "w") as f:
        json.dump(selected, f)
    return root


def _write_co3d(root, frames, rng, long_edge):
    s = 1.0 if long_edge is None else long_edge / 640
    scaled = [(c, q, int(round(W * s)), int(round(H * s))) for c, q, W, H in SEQUENCES]
    write_scenes(root, frames, int(rng.integers(2 ** 31)), "train", scaled)
    write_scenes(root, frames, int(rng.integers(2 ** 31)), "test",
                 [("teddybear", "seq9", *scaled[0][2:])])


def _write_wildrgbd(root, frames, rng, long_edge):
    W, H = _sized((512, 384), long_edge)
    for split, seq in (("train", "scene_000"), ("test", "scene_001")):
        base = osp.join(root, "chair", seq)
        for k, (rgb, depth, K, pose, mask) in enumerate(_frames(W, H, frames, rng)):
            _jpg(osp.join(base, "rgb", f"{k:05d}.jpg"), rgb)
            _png(osp.join(base, "depth", f"{k:05d}.png"), _mm(depth))
            _png(osp.join(base, "masks", f"{k:05d}.png"), mask)
            _npz(osp.join(base, "metadata", f"{k:05d}.npz"), camera_intrinsics=K,
                     camera_pose=pose)
        with open(osp.join(root, f"selected_seqs_{split}.json"), "w") as f:
            json.dump({"chair": {seq: list(range(frames))}}, f)


BLENDEDMVS_PAIRS = np.dtype([("seq_high", "u4"), ("seq_low", "u8"), ("img1", "u2"),
                             ("img2", "u2"), ("score", "f4")])


def _write_blendedmvs(root, frames, rng, long_edge):
    W, H = _sized((512, 384), long_edge)
    rows = []
    for seqh, seql in ((0x5a3cb4e4, 1), (0x5a3cb4e4, 10)):  # seq_low 10: a val scene
        base = osp.join(root, f"{seqh:08x}{seql:016x}")
        for k, (rgb, depth, K, pose, _) in enumerate(_frames(W, H, frames, rng)):
            stem = osp.join(base, f"{k:08n}")
            _jpg(stem + ".jpg", rgb, 80)
            _exr(stem + ".exr", depth)
            _npz(stem + ".npz", intrinsics=K, R_cam2world=pose[:3, :3],
                     t_cam2world=pose[:3, 3])
        rows += [(seqh, seql, i, j, 1.0 / (j - i)) for i, j in _pairs(frames)]
    np.save(osp.join(root, "blendedmvs_pairs.npy"), np.array(rows, BLENDEDMVS_PAIRS))


MEGADEPTH_PAIRS = np.dtype([("scene_id", "i4"), ("im1_id", "i4"), ("im2_id", "i4"),
                            ("score", "f4")])


def _write_megadepth(root, frames, rng, long_edge):
    landscape = _sized((800, 600), long_edge)
    scenes = ("0001 0", "0002 0", "0015 0", "0022 0")  # 0015, 0022: the val split
    images, rows = [], []
    for s, scene in enumerate(scenes):
        W, H = landscape if s % 2 == 0 else landscape[::-1]  # 0002 and 0022 portrait
        base = osp.join(root, *scene.split())
        first = len(images)
        for k, (rgb, depth, K, pose, _) in enumerate(_frames(W, H, frames, rng)):
            name = f"{scene.split()[0]}_{k:04d}.jpg"  # the image's own name, then the suffix
            images.append(name)
            stem = osp.join(base, name)
            _jpg(stem + ".jpg", rgb, 90)
            _exr(stem + ".exr", depth)
            _npz(stem + ".npz", intrinsics=K, cam2world=pose)
        rows += [(s, first + i, first + j, 1.0 / (j - i)) for i, j in _pairs(frames)]
    np.savez(osp.join(root, "all_metadata.npz"), scenes=np.array(scenes),
             images=np.array(images), pairs=np.array(rows, MEGADEPTH_PAIRS))


STATICTHINGS_PAIRS = np.dtype([("scene", "S7"), ("seq", "i4"), ("cam1", "S1"), ("im1", "i4"),
                               ("cam2", "S1"), ("im2", "i4")])


def _write_staticthings3d(root, frames, rng, long_edge):
    W, H = _sized((512, 384), long_edge)
    rows = []
    for scene, seq in ((b"A/0000", 4), (b"B/0001", 7)):
        base = osp.join(root, "TRAIN", scene.decode(), f"{seq:04d}")
        noise = rng.uniform(0, 1, (16, 16, 3))
        for k in range(frames):
            num = 6 + k  # the preprocess keeps frames 6..15
            K, left = camera(W, H, k, frames)
            right = left.copy()
            right[:3, 3] += left[:3, :3] @ np.float32([0.1, 0, 0])  # a 0.1-unit baseline
            for cam_dir, pose in (("left", left), ("right", right)):
                rgb, depth = render(W, H, K, pose, noise)
                rgb[:H // 8, :W // 8], depth[:H // 8, :W // 8] = (128, 128, 160), FAR_DEPTH
                stem = osp.join(base, cam_dir, f"{num:04n}")
                _jpg(stem + "_clean.jpg", rgb, 80)
                _jpg(stem + "_final.jpg", np.clip(0.8 * rgb + 30, 0, 255).astype(np.uint8), 80)
                _exr(stem + ".exr", depth)
                _npz(stem + ".npz", intrinsics=K, cam2world=pose)
        rows += [(scene, seq, b"l", 6 + i, b"r", 6 + i) for i in range(frames)]
        rows += [(scene, seq, b"r", 6 + i, b"l", 6 + j) for i, j in _pairs(frames)]
    np.save(osp.join(root, "staticthings_pairs.npy"), np.array(rows, STATICTHINGS_PAIRS))


def _write_waymo(root, frames, rng, long_edge):
    W, H = _sized((512, 341), long_edge)
    scenes = [f"segment-{s:019d}_with_camera_labels.tfrecord" for s in (1005081002, 1005081003)]
    names = [f"{k:05d}_1" for k in range(frames)]  # frame, camera 1 (front)
    rows = []
    for s, scene in enumerate(scenes):
        for k, (rgb, depth, K, pose, _) in enumerate(_frames(W, H, frames, rng)):
            stem = osp.join(root, scene, names[k])
            _jpg(stem + ".jpg", rgb, 80)
            lidar = rng.uniform(size=depth.shape) < 0.15  # the splatted points
            _exr(stem + ".exr", np.where(lidar, depth, 0).astype(np.float32))
            _npz(stem + ".npz", intrinsics=K, cam2world=pose, distortion=np.zeros(5))
        rows += [(s, i, j) for i, j in _pairs(frames)]
    np.savez(osp.join(root, "waymo_pairs.npz"), scenes=np.array(scenes),
             frames=np.array(names), pairs=np.array(rows))


def _metadata(out, scenes, per_scene):
    """all_metadata.npz as the ARKitScenes / ScanNet++ scripts concatenate
    it: per_scene[s] = (images, intrinsics, trajectories, pairs)."""
    offset, counts, sceneids, parts = 0, [], [], ([], [], [], [])
    for s, (images, Ks, poses, pairs) in enumerate(per_scene):
        counts.append(offset)
        sceneids += [s] * len(images)
        for part, value in zip(parts, (images, Ks, poses,
                                       np.array(pairs, np.float64) + [offset, offset, 0])):
            part.append(np.asarray(value))
        offset += len(images)
    np.savez(osp.join(out, "all_metadata.npz"), counts=counts, scenes=scenes,
             sceneids=sceneids, **{k: np.concatenate(p) for k, p in
                                   zip(("images", "intrinsics", "trajectories", "pairs"), parts)})


def _mm_scene(base, names, rgb_path, depth_path, W, H, frames, rng):
    """One scene of JPEGs and uint16 mm depths; returns its metadata part."""
    Ks, poses = [], []
    for name, (rgb, depth, K, pose, _) in zip(names, _frames(W, H, frames, rng)):
        _jpg(osp.join(base, rgb_path(name)), rgb)
        _png(osp.join(base, depth_path(name)), _mm(depth))
        Ks.append(K)
        poses.append(pose)
    return names, Ks, poses, [(i, j, 1.0 / (j - i)) for i, j in _pairs(frames)]


def _write_arkitscenes(root, frames, rng, long_edge):
    landscape = _sized((640, 480), long_edge)
    for split, scenes in (("Training", ("41069021", "41069042")), ("Test", ("41142278",))):
        parts = []
        for s, scene in enumerate(scenes):
            W, H = landscape if s == 0 else landscape[::-1]  # a scene shot rotated: portrait
            names = [f"{scene}_{1000 + 0.1 * k:.3f}.png" for k in range(frames)]
            parts.append(_mm_scene(osp.join(root, split, scene), names,
                                   lambda n: osp.join("vga_wide", n.replace(".png", ".jpg")),
                                   lambda n: osp.join("lowres_depth", n), W, H, frames, rng))
        _metadata(osp.join(root, split), list(scenes), parts)


def _write_scannetpp(root, frames, rng, long_edge):
    W, H = _sized((920, 690), long_edge)
    scenes = ("0a5c013435", "1b75758486")
    parts = []
    for scene, fmt in zip(scenes, ("DSC{:05d}", "frame_{:06d}")):  # DSLR, iPhone
        names = [fmt.format(10 * k) for k in range(frames)]
        parts.append(_mm_scene(osp.join(root, scene), names,
                               lambda n: osp.join("images", n + ".jpg"),
                               lambda n: osp.join("depth", n + ".png"), W, H, frames, rng))
    _metadata(root, list(scenes), parts)


HABITAT_SIZES = dict(train=1_000_000, val=1_000)  # the published strings' index files


def _write_habitat(root, frames, rng, long_edge):
    W = H = _sized((512, 512), long_edge)[0]
    for split, size in HABITAT_SIZES.items():
        keys = [f"scene_{split}/{i:05d}" for i in range(frames if split == "train" else 2)]
        for i, key in enumerate(keys):
            noise = rng.uniform(0, 1, (16, 16, 3))
            for v in range(1, 6):
                K, pose = camera(W, H, v - 1, 5)
                rgb, depth = render(W, H, K, pose, noise)
                stem = osp.join(root, f"{key}_{v}")
                _jpg(stem + ".jpeg", rgb)
                _exr(stem + "_depth.exr", depth, half=True)
                if i == 0 and v == 3:  # a failed render: the loader walks past it
                    pose = np.full((4, 4), np.nan)
                with open(stem + "_camera_params.json", "w") as f:
                    json.dump(dict(camera_intrinsics=K.tolist(), size=(W, H),
                                   R_cam2world=pose[:3, :3].tolist(),
                                   t_cam2world=pose[:3, 3].tolist()), f)
        with open(osp.join(root, f"Habitat_{size}_scenes_{split}.txt"), "w") as f:
            f.write("\n".join(keys) + "\n")


WRITERS = dict(Co3d=_write_co3d, WildRGBD=_write_wildrgbd, BlendedMVS=_write_blendedmvs,
               MegaDepth=_write_megadepth, StaticThings3D=_write_staticthings3d,
               Waymo=_write_waymo, ARKitScenes=_write_arkitscenes, ScanNetpp=_write_scannetpp,
               Habitat=_write_habitat)


def _exr(path, img, half=False):
    from ..utils.exr import write_exr

    os.makedirs(osp.dirname(path), exist_ok=True)
    write_exr(path, img, half=half)


def write_dataset(name, root, frames=8, seed=0, long_edge=None):
    """Write dataset `name`'s layout under root (`frames` a sequence, or a
    split's Habitat keys); returns root."""
    os.makedirs(root, exist_ok=True)
    WRITERS[name](root, frames, np.random.default_rng(seed), long_edge)
    return root


def write_mix(root, frames=8, seed=0, long_edge=None):
    """All nine layouts, root/<name> each (dataset i seeded seed + i; one
    thread a dataset); returns {name: its root}."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(WRITERS)) as pool:
        futures = {name: pool.submit(write_dataset, name, osp.join(root, name), frames, seed + i,
                                     long_edge) for i, name in enumerate(WRITERS)}
        return {name: f.result() for name, f in futures.items()}


# the published 512 stage's datasets and their arguments (docs/TRAINING.md:41,
# :60; ARKitScenes with the split its loader needs), then Waymo and WildRGBD,
# which it does not train on, so that every loader is on the path
TRAIN_ARGS = dict(
    Habitat="1_000_000, split='train', aug_crop=16",
    BlendedMVS="split='train', aug_crop=16",
    MegaDepth="split='train', aug_crop=16",
    ARKitScenes="split='train', aug_crop=256",
    Co3d="split='train', aug_crop=16, mask_bg='rand'",
    StaticThings3D="aug_crop=256, mask_bg='rand'",
    ScanNetpp="split='train', aug_crop=256",
    Waymo="aug_crop=16",
    WildRGBD="split='train', aug_crop=16, mask_bg='rand'",
)
# the published test mix (docs/TRAINING.md:61): arguments and resolution
TEST_ARGS = dict(Habitat=("1_000, split='val'", (512, 384)),
                 BlendedMVS=("split='val'", (512, 384)),
                 MegaDepth=("split='val'", (512, 336)),
                 Co3d=("split='test'", (512, 384)))


def mix_dsl(roots, counts, resolution, seed=None, args=None):
    """The train mix's dataset string: `counts[name] @ name(...)` for each
    name of counts, with ColorJitter; seeded (seed + i) if seed is given;
    `args` in place of TRAIN_ARGS."""
    args = TRAIN_ARGS if args is None else args
    parts = []
    for i, (name, n) in enumerate(counts.items()):
        seeded = "" if seed is None else f", seed={seed + i}"
        parts.append(f"{n} @ {name}({args[name]}, ROOT='{roots[name]}', "
                     f"resolution={resolution}, transform=ColorJitter{seeded})")
    return " + ".join(parts)


def test_mix_dsl(roots, n, resolutions=None, seed=777):
    """The test mix's string: Habitat's val keys as they are, `n @` the
    others; each at its published resolution unless `resolutions` names
    another."""
    parts = []
    for name, (args, published) in TEST_ARGS.items():
        resized = "" if name == "Habitat" else f"{n} @ "
        resolution = (resolutions or {}).get(name, published)
        parts.append(f"{resized}{name}({args}, ROOT='{roots[name]}', resolution={resolution}, "
                     f"seed={seed})")
    return " + ".join(parts)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out_dir")
    parser.add_argument("--frames", type=int, default=None,
                        help="frames a sequence (default: 100 for Co3d alone, 8 with --mix)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--mix", action="store_true", help="all nine, OUT_DIR/<name> each")
    a = parser.parse_args()
    if a.mix:
        write_mix(a.out_dir, a.frames or 8, a.seed)
    else:
        write_scenes(a.out_dir, a.frames or 100, a.seed)
