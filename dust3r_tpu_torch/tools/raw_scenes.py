"""Raw dataset layouts with a known geometry, as each dataset's download
lays them out, for the preprocess scripts (`datasets_preprocess/`).

    python -m dust3r_tpu_torch.tools.raw_scenes OUT_DIR [--frames 3]    # all nine, raw + processed

Every frame is `tools/train_scenes.py`'s textured plane (world z =
PLANE_Z) seen by a camera of known pose and intrinsics, so every depth,
pose and camera the scripts write is known: after preprocessing, the
loaders' pts3d lie on the plane. The layouts, at their sources' sizes
(`size=` scales them down for tests):

  Co3d            1920x1080 JPEGs, float16-pattern 16-bit depth PNGs, masks,
                  frame / sequence annotations (.jgz, pytorch3d NDC cameras),
                  fewview set lists (train and test sequences)
  WildRGBD        640x480 PNGs, uint16 mm depth, masks, metadata (K column
                  major), cam_poses.txt, camera_eval / nvs lists
  BlendedMVS      768x576 blended_images, PFM depth (rows bottom-up),
                  cams/*_cam.txt (world2cam, K), the pair table (.npy)
  MegaDepth       1600x1200, a portrait 1200x1600 and a val scene: imgs, depths/*.h5
                  ("depth"; .npy where h5py is missing), the manhattan sparse
                  model (SIMPLE_RADIAL, k = -0.02), the pair table (.npz)
  StaticThings3D  960x540 clean and final passes, .float3 depth / K / world2cam
                  for frames 6..15 of a left and a right camera, the pair table
  ARKitScenes     640x480 vga_wide PNGs, 256x192 uint16 mm lowres_depth,
                  lowres_wide.traj (world2cam angle-axis), .pincam; one scene
                  upright, one rolled 90 degrees (find_scene_orientation turns
                  it: sky RIGHT); scene_list.json + selected_pairs.npz
  Waymo           stage 1's output (tmp/<segment>.tfrecord/: 1920x1280 JPEGs,
                  lidar pixels + vehicle-frame points npz, calib.json)
  ScanNetpp       1752x1168 OPENCV_FISHEYE DSLR frames and a 1920x1440 OPENCV
                  (radial-tangential) iPhone frame, anonymisation masks, both
                  COLMAP models; the depth comes from `PlaneRenderer`, which
                  stands in for the mesh render
  Habitat         a 1024x2048 equirectangular colour (PNG) and distance (.npy)
                  pair per viewpoint, read by `EnvmapFiles` in place of
                  habitat-sim, and the metadata.json of a 5-view fan

`write_raw(name, root, ...)` writes one; `preprocess(info, out)` runs
the port's script on it (what habitat-sim, pyrender and TensorFlow would
render or extract comes from the stand-ins above); `run_all` does all nine
and returns each dataset's processed root, `mix_args` the arguments of
`train_scenes.mix_dsl` over them, `plane_error` how far a loader's view
lies from the plane.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import os.path as osp
import shutil
import time

import numpy as np

from .train_scenes import PLANE_Z, _rotation, _texture

# each dataset's raw image size (W, H)
RAW_SIZES = dict(Co3d=(1920, 1080), WildRGBD=(640, 480), BlendedMVS=(768, 576),
                 MegaDepth=(1600, 1200), StaticThings3D=(960, 540), ARKitScenes=(640, 480),
                 Waymo=(1920, 1280), ScanNetpp=(1752, 1168), Habitat=(2048, 1024))
SCANNETPP_IPHONE = (1920, 1440)
ARKIT_LOWRES = (256, 192)
HABITAT_CROP = 512
STATICTHINGS_FRAMES = range(6, 16)  # the frames the script reads, each camera
# habitat-sim's axes (habitat_sim.geo): RIGHT, -UP, FRONT as rows
HABITAT_R_CAM_TO_WORLD = np.array([[1.0, 0, 0], [0, -1, 0], [0, 0, -1]])


def _noise(rng):
    return rng.uniform(0, 1, (16, 16, 3))


def _pose(k, n, tilt=(0.15, 0.2)):
    """Frame k of n's cam2world (float64), as `train_scenes.camera` moves
    it: a camera circling above the plane, looking down at it (+z)."""
    t = k / max(n - 1, 1)
    pose = np.eye(4)
    pose[:3, :3] = _rotation(tilt[0] * np.sin(2 * np.pi * t), tilt[1] * np.cos(2 * np.pi * t))
    pose[:3, 3] = (0.6 * np.sin(2 * np.pi * t), 0.4 * np.cos(2 * np.pi * t), 0.2 * t)
    return pose


def _K(W, H, focal=None, centre=0.0):
    """Pinhole K (OpenCV pixels): the principal point at the image centre
    minus `centre` (0.5: the centre of the middle pixel)."""
    f = 0.9 * max(W, H) if focal is None else focal
    return np.array([[f, 0, W / 2 - centre], [0, f, H / 2 - centre], [0, 0, 1.0]])


def plane_hits(rays_cam, pose):
    """Camera-frame rays (..., 3) through a cam2world pose: (world hit
    points, the rays' camera z at the hit); no hit: NaN."""
    R, c = pose[:3, :3], pose[:3, 3]
    world = rays_cam @ R.T
    with np.errstate(divide="ignore", invalid="ignore"):
        s = (PLANE_Z - c[2]) / world[..., 2]
    s = np.where(s > 0, s, np.nan)
    return c + world * s[..., None], s * rays_cam[..., 2]


def _pixel_rays(W, H, K):
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    return np.stack([gx, gy, np.ones_like(gx)], -1) @ np.linalg.inv(K).T


def plane_depth(W, H, K, pose):
    """Depth (float32 z, 0 off the plane) of the plane for OpenCV K."""
    _, z = plane_hits(_pixel_rays(W, H, K), pose)
    return np.nan_to_num(z, nan=0.0).astype(np.float32)


def render_rays(rays_cam, pose, noise):
    """Colour (uint8) and camera z (float32) along given camera rays."""
    hit, z = plane_hits(rays_cam, pose)
    rgb = _texture(np.nan_to_num(hit[..., 0]), np.nan_to_num(hit[..., 1]), noise)
    rgb[~np.isfinite(z)] = 96
    return rgb, np.nan_to_num(z, nan=0.0).astype(np.float32)


def render(W, H, K, pose, noise):
    return render_rays(_pixel_rays(W, H, K), pose, noise)


def _scaled(name, size):
    return RAW_SIZES[name] if size is None else tuple(size)


def _mkdir(path):
    os.makedirs(path, exist_ok=True)
    return path


def _save(path, arr, **kw):
    import PIL.Image

    _mkdir(osp.dirname(path))
    if path.endswith(".png"):
        kw.setdefault("compress_level", 1)  # lossless all the same, and ~3x faster
    PIL.Image.fromarray(arr).save(path, **kw)


def _w2c(pose):
    return np.linalg.inv(pose)


def _qvec_t(pose):
    """cam2world -> COLMAP's world2cam (qw, qx, qy, qz, tx, ty, tz)."""
    from scipy.spatial.transform import Rotation

    w2c = _w2c(pose)
    x, y, z, w = Rotation.from_matrix(w2c[:3, :3]).as_quat()
    return (w, x, y, z, *w2c[:3, 3])


def _fmt(values):
    return " ".join(repr(float(v)) for v in values)


# --------------------------------------------------------------------- #
# the nine raw layouts
# --------------------------------------------------------------------- #

def _raw_co3d(root, frames, rng, size):
    W, H = _scaled("Co3d", size)
    cat = "teddybear"
    frame_ann, seq_ann, set_list = [], [], {"train": [], "val": [], "test": []}
    for split, seq in (("train", "seq_0"), ("test", "seq_9")):
        noise = _noise(rng)
        for k in range(frames):
            fn = k + 1
            K, pose = _K(W, H), _pose(k, frames)
            rgb, depth = render(W, H, K, pose, noise)
            rel = {kind: f"{cat}/{seq}/{kind}/frame{fn:06d}{ext}" for kind, ext in
                   (("images", ".jpg"), ("depths", ".jpg.geometric.png"), ("masks", ".png"))}
            _save(osp.join(root, rel["images"]), rgb, quality=95)
            _save(osp.join(root, rel["depths"]), depth.astype(np.float16).view(np.uint16))
            gx, gy = np.meshgrid(np.arange(W), np.arange(H))
            mask = (np.hypot(gx - W / 2, gy - H / 2) < 0.45 * min(W, H)).astype(np.uint8) * 255
            _save(osp.join(root, rel["masks"]), mask)
            # pytorch3d's camera: R row-major with x, y flipped, NDC intrinsics
            scale = min(W, H) / 2
            R_pt3d = pose[:3, :3].copy()
            R_pt3d[:, :2] *= -1
            T = -pose[:3, :3].T @ pose[:3, 3]
            T[:2] *= -1
            frame_ann.append(dict(
                sequence_name=seq, frame_number=fn,
                image=dict(path=rel["images"], size=[H, W]), depth=dict(path=rel["depths"]),
                mask=dict(path=rel["masks"]),
                viewpoint=dict(R=R_pt3d.tolist(), T=T.tolist(),
                               focal_length=[K[0, 0] / scale, K[1, 1] / scale],
                               principal_point=[(W / 2 - K[0, 2]) / scale,
                                                (H / 2 - K[1, 2]) / scale],
                               intrinsics_format="ndc_isotropic")))
            set_list[split].append([seq, fn, rel["images"]])
        seq_ann.append(dict(sequence_name=seq, category=cat, viewpoint_quality_score=1.0))
    for name, data in (("frame_annotations.jgz", frame_ann),
                       ("sequence_annotations.jgz", seq_ann)):
        with gzip.open(osp.join(root, cat, name), "wt") as f:
            json.dump(data, f)
    with open(osp.join(_mkdir(osp.join(root, cat, "set_lists")),
                       "set_lists_fewview_train.json"), "w") as f:
        json.dump(set_list, f)
    return dict(argv=["--co3d_dir", root, "--category", cat])


def _raw_wildrgbd(root, frames, rng, size):
    W, H = _scaled("WildRGBD", size)
    cat = "chair"
    lists = {"train": ["scenes/scene_000"], "val": ["scenes/scene_001"]}
    for seq in lists["train"] + lists["val"]:
        base = _mkdir(osp.join(root, cat, seq))
        noise = _noise(rng)
        K = _K(W, H)
        poses = []
        for k in range(frames):
            pose = _pose(k, frames)
            rgb, depth = render(W, H, K, pose, noise)
            _save(osp.join(base, "rgb", f"{k:05d}.png"), rgb)
            _save(osp.join(base, "depth", f"{k:05d}.png"),
                  np.round(depth * 1000).astype(np.uint16))
            mask = np.full((H, W), 255, np.uint8)
            mask[: H // 10] = 0
            _save(osp.join(base, "masks", f"{k:05d}.png"), mask)
            poses.append(np.r_[k, pose.ravel()])
        np.savetxt(osp.join(base, "cam_poses.txt"), np.array(poses))
        with open(osp.join(base, "metadata"), "w") as f:
            json.dump(dict(K=K.T.ravel().tolist(), w=W, h=H), f)
    for name in ("camera_eval_list.json", "nvs_list.json"):
        with open(osp.join(root, cat, name), "w") as f:
            json.dump(lists, f)
    return dict(argv=["--wildrgbd_dir", root, "--num_frames", str(frames)])


BLENDEDMVS_PAIRS = np.dtype([("seq_high", "u4"), ("seq_low", "u8"), ("img1", "u2"),
                             ("img2", "u2"), ("score", "f4")])


def _write_pfm(path, depth):
    _mkdir(osp.dirname(path))
    H, W = depth.shape
    with open(path, "wb") as f:
        f.write(f"Pf\n{W} {H}\n-1\n".encode())
        f.write(np.ascontiguousarray(depth[::-1], "<f4").tobytes())  # rows bottom-up


def _raw_blendedmvs(root, frames, rng, size):
    W, H = _scaled("BlendedMVS", size)
    rows = []
    seqh, seql = 0x5a3cb4e4, 1
    base = osp.join(root, f"{seqh:08x}{seql:016x}")
    noise = _noise(rng)
    for k in range(frames):
        K, pose = _K(W, H), _pose(k, frames)
        rgb, depth = render(W, H, K, pose, noise)
        name = f"{k:08d}"
        _save(osp.join(base, "blended_images", name + ".jpg"), rgb, quality=95)
        _write_pfm(osp.join(base, "rendered_depth_maps", name + ".pfm"), depth)
        w2c = _w2c(pose)
        with open(osp.join(_mkdir(osp.join(base, "cams")), name + "_cam.txt"), "w") as f:
            f.write("extrinsic\n" + "\n".join(_fmt(r) for r in w2c) + "\n\nintrinsic\n"
                    + "\n".join(_fmt(r) for r in K) + "\n\n2.0 0.01 192 4.0\n")
    with open(osp.join(base, "cams", "pair.txt"), "w") as f:
        f.write(f"{frames}\n")
    rows += [(seqh, seql, i, j, 1.0 / (j - i)) for i in range(frames) for j in range(i + 1, frames)]
    pairs = osp.join(root, "blendedmvs_pairs.npy")
    np.save(pairs, np.array(rows, BLENDEDMVS_PAIRS))
    return dict(argv=["--blendedmvs_dir", root, "--precomputed_pairs", pairs])


MEGADEPTH_PAIRS = np.dtype([("scene_id", "i4"), ("im1_id", "i4"), ("im2_id", "i4"),
                            ("score", "f4")])
MEGADEPTH_K0 = -0.02  # the sparse model's SIMPLE_RADIAL k


def _raw_megadepth(root, frames, rng, size):
    from ..utils.cvops import get_optimal_new_camera_matrix

    try:
        import h5py
    except ImportError:
        h5py = None
    landscape = _scaled("MegaDepth", size)
    scenes = ("0001 0", "0002 0", "0015 0")  # 0002 portrait; 0015 a val scene (the loader needs one)
    images, rows = [], []
    for s, scene in enumerate(scenes):
        W, H = landscape if s != 1 else landscape[::-1]
        n = frames if s < 2 else 2
        sid, sub = scene.split()
        dense = osp.join(root, sid, "dense" + sub)
        sparse = _mkdir(osp.join(root, sid, "sparse", "manhattan", sub))
        noise = _noise(rng)
        K_raw = _K(W, H)
        # the dense images are the undistorted ones: render through the
        # camera the script derives from the sparse model
        K = get_optimal_new_camera_matrix(K_raw, (MEGADEPTH_K0, 0, 0, 0), (W, H), 0, (W, H))
        cams, imgs = [], []
        first = len(images)
        for k in range(n):
            pose = _pose(k, n)
            rgb, depth = render(W, H, K, pose, noise)
            tag = f"{int(sid) * 1000 + k}_{k:04x}.jpg"
            images.append(tag)
            _save(osp.join(dense, "imgs", tag), rgb, quality=95)
            stem = osp.join(_mkdir(osp.join(dense, "depths")), tag[:-4])
            if h5py is not None:
                with h5py.File(stem + ".h5", "w") as f:
                    f.create_dataset("depth", data=depth)
            else:
                np.save(stem + ".npy", depth)
            cams.append(f"{k + 1} SIMPLE_RADIAL {W} {H} " + _fmt(
                (K_raw[0, 0], K_raw[0, 2], K_raw[1, 2], MEGADEPTH_K0)))
            imgs += [f"{k + 1} " + _fmt(_qvec_t(pose)) + f" {k + 1} {tag}", ""]
        with open(osp.join(sparse, "cameras.txt"), "w") as f:
            f.write("# Camera list\n# CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n# n\n"
                    + "\n".join(cams) + "\n")
        with open(osp.join(sparse, "images.txt"), "w") as f:
            f.write("# Image list\n# IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n"
                    "# POINTS2D[] as (X, Y, POINT3D_ID)\n# n\n" + "\n".join(imgs) + "\n")
        rows += [(s, first + i, first + j, 1.0 / (j - i))
                 for i in range(n) for j in range(i + 1, n)]
    pairs = osp.join(root, "megadepth_pairs.npz")
    np.savez(pairs, scenes=np.array(scenes), images=np.array(images),
             pairs=np.array(rows, MEGADEPTH_PAIRS))
    return dict(argv=["--megadepth_dir", root, "--precomputed_pairs", pairs],
                h5=h5py is not None)


def megadepth_npy_reader(in_dir, tag):
    """The depth `_raw_megadepth` saved as .npy where h5py was missing."""
    return np.load(osp.join(in_dir, "depths", osp.splitext(tag)[0] + ".npy"))


STATICTHINGS_PAIRS = np.dtype([("scene", "S7"), ("seq", "i4"), ("cam1", "S1"), ("im1", "i4"),
                               ("cam2", "S1"), ("im2", "i4")])


def _write_float3(path, data):
    _mkdir(osp.dirname(path))
    data = np.asarray(data, np.float32)
    with open(path, "wb") as f:
        f.write(f"float\n{data.ndim}\n".encode())
        f.write("".join(f"{d}\n" for d in reversed(data.shape)).encode())
        f.write(data.tobytes())


def _raw_staticthings3d(root, frames, rng, size):
    W, H = _scaled("StaticThings3D", size)
    scene, seq = "A", 4
    rel = osp.join("TRAIN", scene, f"{seq:04d}")
    for sub in "BC":
        _mkdir(osp.join(root, "intrinsics", "TRAIN", sub))
    noise = _noise(rng)
    nums = list(STATICTHINGS_FRAMES)
    for k, num in enumerate(nums):
        K, left = _K(W, H), _pose(k, len(nums))
        right = left.copy()
        right[:3, 3] += left[:3, :3] @ np.array([0.1, 0, 0])  # a 0.1-unit baseline
        _write_float3(osp.join(root, "intrinsics", rel, f"{num:04d}.float3"), K)
        for cam, pose in (("left", left), ("right", right)):
            rgb, depth = render(W, H, K, pose, noise)
            stem = osp.join(rel, cam, f"{num:04d}")
            _write_float3(osp.join(root, "poses", stem + ".float3"), _w2c(pose))
            _write_float3(osp.join(root, "depths", stem + ".float3"), depth)
            _save(osp.join(root, "frames_cleanpass", stem + ".png"), rgb)
            _save(osp.join(root, "frames_finalpass", stem + ".png"),
                  np.clip(0.8 * rgb + 30, 0, 255).astype(np.uint8))
    rows = [(scene.encode(), seq, b"l", n, b"r", n) for n in nums[:frames]]
    rows += [(scene.encode(), seq, b"r", a, b"l", b) for a, b in zip(nums, nums[1:frames])]
    pairs = osp.join(root, "staticthings_pairs.npy")
    np.save(pairs, np.array(rows, STATICTHINGS_PAIRS))
    return dict(argv=["--StaticThings3D_dir", root, "--precomputed_pairs", pairs])


def _arkit_pose(k, n, rolled):
    """A camera at the origin area looking up at the plane (the ceiling,
    z = PLANE_Z) 35 degrees above the horizon, z up; `rolled`: turned 90
    degrees about its optical axis (its sky on the image's right)."""
    e = np.radians(35.0)
    yaw = 0.2 * np.sin(2 * np.pi * k / max(n, 1))
    z = np.array([np.sin(yaw) * np.cos(e), np.cos(yaw) * np.cos(e), np.sin(e)])
    x = np.array([np.cos(yaw), -np.sin(yaw), 0.0])
    y = np.cross(z, x)
    if rolled:
        x, y = -y, x
    pose = np.eye(4)
    pose[:3, :3] = np.stack([x, y, z], axis=1)
    pose[:3, 3] = (0.3 * k / max(n, 1), 0.0, 0.2)
    return pose


def _raw_arkitscenes(root, frames, rng, size, pairs_root):
    from scipy.spatial.transform import Rotation

    W, H = _scaled("ARKitScenes", size)
    w, h = ARKIT_LOWRES if size is None else (int(round(W * 0.4)), int(round(H * 0.4)))
    scenes = ("41069021", "41069042")  # upright, rolled
    split = "Training"
    for scene, rolled in zip(scenes, (False, True)):
        base = osp.join(root, split, scene)
        noise = _noise(rng)
        # the principal point at the middle pixel's centre: the script's
        # swap of a LEFT / RIGHT scene's intrinsics is then exact
        K = _K(W, H, centre=0.5)
        K_low = K.copy()
        K_low[0] *= w / W
        K_low[1] *= h / H
        K_low[:2, 2] = ((K[0, 2] + 0.5) * w / W - 0.5, (K[1, 2] + 0.5) * h / H - 0.5)
        names, traj = [], []
        for k in range(frames):
            ts = f"{1000 + 0.1 * k:.3f}"
            name = f"{scene}_{ts}.png"
            names.append(name)
            pose = _arkit_pose(k, frames, rolled)
            rgb, _ = render(W, H, K, pose, noise)
            _, depth = render(w, h, K_low, pose, noise)
            _save(osp.join(base, "vga_wide", name), rgb)
            _save(osp.join(base, "lowres_depth", name), np.round(depth * 1000).astype(np.uint16))
            with open(osp.join(_mkdir(osp.join(base, "vga_wide_intrinsics")),
                               name[:-4] + ".pincam"), "w") as f:
                f.write(_fmt((W, H, K[0, 0], K[1, 1], K[0, 2], K[1, 2])) + "\n")
            w2c = _w2c(pose)
            traj.append(f"{ts} " + _fmt(Rotation.from_matrix(w2c[:3, :3]).as_rotvec())
                        + " " + _fmt(w2c[:3, 3]))
        with open(osp.join(base, "lowres_wide.traj"), "w") as f:
            f.write("\n".join(traj) + "\n")
        pairs = np.array([(i, j, 1.0 / (j - i)) for i in range(frames)
                          for j in range(i + 1, frames)], np.float64)
        np.savez(osp.join(_mkdir(osp.join(pairs_root, split, scene)), "selected_pairs.npz"),
                 selection=np.array(names), pairs=pairs)
    with open(osp.join(pairs_root, split, "scene_list.json"), "w") as f:
        json.dump(list(scenes), f)
    return dict(argv=["--arkitscenes_dir", root, "--precomputed_pairs", pairs_root])


VEHICLE_TO_OPENCV = np.float64([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]])
WAYMO_LIDAR = 0.05  # share of the pixels with a lidar return


def _raw_waymo(root, frames, rng, size):
    """Stage 1's output under root/tmp: one camera (FRONT), its
    cam_to_car the sequence's, the vehicle moving so that the camera takes
    `_pose`'s path; lidar points at WAYMO_LIDAR of the pixels."""
    W, H = _scaled("Waymo", size)
    scenes = ["segment-1005081002024129653_5313_150_5333_150_with_camera_labels.tfrecord"]
    names = [f"{k:05d}_1" for k in range(frames)]
    for scene in scenes:
        base = _mkdir(osp.join(root, "tmp", scene))
        noise = _noise(rng)
        K = _K(W, H)
        car = _pose(0, frames) @ VEHICLE_TO_OPENCV
        calib = [[1, dict(width=W, height=H,
                          intrinsics=[K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0, 0, 0, 0, 0],
                          extrinsics=car.ravel().tolist())]]
        for k, name in enumerate(names):
            pose = _pose(k, frames)
            vehicle = pose @ VEHICLE_TO_OPENCV @ np.linalg.inv(car)  # vehicle -> world
            rgb, _ = render(W, H, K, pose, noise)
            _save(osp.join(base, name + ".jpg"), rgb, quality=95)
            ys, xs = np.nonzero(rng.uniform(size=(H, W)) < WAYMO_LIDAR)
            pix = np.stack([xs, ys], -1)
            rays = np.c_[pix.astype(np.float64), np.ones(len(pix))] @ np.linalg.inv(K).T
            hits, _ = plane_hits(rays, pose)
            pts = (hits - vehicle[:3, 3]) @ vehicle[:3, :3]  # world -> vehicle frame
            np.savez(osp.join(base, name + ".npz"), pose=vehicle,
                     pixels=pix.astype(np.int16), pts3d=pts.astype(np.float32),
                     timestamp=1.0 + 0.1 * k)
        with open(osp.join(base, "calib.json"), "w") as f:
            json.dump(calib, f)
    rows = [(0, i, j) for i in range(frames) for j in range(i + 1, frames)]
    pairs = osp.join(root, "waymo_pairs_table.npz")
    np.savez(pairs, scenes=np.array(scenes), frames=np.array(names), pairs=np.array(rows))
    return dict(pairs=pairs, tmp=osp.join(root, "tmp"))


def _fisheye_rays(W, H, K, k):
    """Camera rays (z = 1) of an OPENCV_FISHEYE image's pixels: the
    equidistant model inverted by Newton's method."""
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    x, y = (gx - K[0, 2]) / K[0, 0], (gy - K[1, 2]) / K[1, 1]
    theta_d = np.hypot(x, y)
    theta = theta_d.copy()
    for _ in range(6):
        t2 = theta * theta
        f = theta * (1 + k[0] * t2 + k[1] * t2 ** 2 + k[2] * t2 ** 3 + k[3] * t2 ** 4) - theta_d
        df = 1 + 3 * k[0] * t2 + 5 * k[1] * t2 ** 2 + 7 * k[2] * t2 ** 3 + 9 * k[3] * t2 ** 4
        theta = theta - f / df
    with np.errstate(invalid="ignore", divide="ignore"):
        s = np.where(theta_d > 0, np.tan(theta) / theta_d, 1.0)
    return np.stack([x * s, y * s, np.ones_like(x)], -1)


def _radial_rays(W, H, K, d):
    """Camera rays (z = 1) of an OPENCV (radial-tangential) image's pixels:
    the model inverted by fixed-point iterations."""
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    x0, y0 = (gx - K[0, 2]) / K[0, 0], (gy - K[1, 2]) / K[1, 1]
    k1, k2, p1, p2 = d
    x, y = x0.copy(), y0.copy()
    for _ in range(8):
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 * r2
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = (x0 - dx) / radial, (y0 - dy) / radial
    return np.stack([x, y, np.ones_like(x)], -1)


class PlaneRenderer:
    """Stands in for the ScanNet++ mesh render (`preprocess_scannetpp.
    MeshRenderer`): the plane's metric depth for COLMAP-convention K."""

    def load_scene(self, dir_scans):
        pass

    def render(self, K, W, H, cam_to_world):
        from ..utils.geometry import colmap_to_opencv_intrinsics

        return plane_depth(W, H, colmap_to_opencv_intrinsics(K), np.asarray(cam_to_world))


SCANNETPP_FISHEYE = (0.02, -0.01, 0.003, -0.001)
SCANNETPP_RADIAL = (-0.05, 0.01, 0.0005, -0.0004)


def _raw_scannetpp(root, frames, rng, size, pairs_root):
    W, H = _scaled("ScanNetpp", size)
    Wi, Hi = SCANNETPP_IPHONE if size is None else (int(W * 1920 / 1752), int(W * 1440 / 1752))
    scene = "0a5c013435"
    base = osp.join(root, "data", scene)
    _mkdir(osp.join(base, "scans"))
    noise = _noise(rng)
    n_dslr = max(frames - 1, 1)
    selection = []
    for cam_type, n in (("dslr", n_dslr), ("iphone", 1)):
        if cam_type == "dslr":
            Ww, Hh, d, model = W, H, SCANNETPP_FISHEYE, "OPENCV_FISHEYE"
            K = _K(Ww, Hh, focal=0.46 * max(Ww, Hh))
        else:
            Ww, Hh, d, model = Wi, Hi, SCANNETPP_RADIAL, "OPENCV"
            K = _K(Ww, Hh, focal=0.75 * max(Ww, Hh))
        rays = _fisheye_rays(Ww, Hh, K, d) if cam_type == "dslr" else _radial_rays(Ww, Hh, K, d)
        images = []
        for k in range(n):
            pose = _pose(k + (n_dslr if cam_type == "iphone" else 0), frames, tilt=(0.1, 0.1))
            rgb, _ = render_rays(rays, pose, noise)
            mask = np.full((Hh, Ww), 255, np.uint8)
            mask[Hh // 3: Hh // 3 + Hh // 20, Ww // 3: Ww // 3 + Ww // 20] = 0  # an anonymised patch
            if cam_type == "dslr":
                name = f"DSC{10 * k:05d}"
                _save(osp.join(base, "dslr", "resized_images", name + ".JPG"), rgb, quality=95)
                _save(osp.join(base, "dslr", "resized_anon_masks", name + ".png"), mask)
                rel = name + ".JPG"
            else:
                name = f"frame_{10 * k:06d}"
                _save(osp.join(base, "iphone", "rgb", name + ".jpg"), rgb, quality=95)
                _save(osp.join(base, "iphone", "rgb_masks", name + ".png"), mask)
                rel = "iphone/" + name + ".jpg" if k == 0 else name + ".jpg"
            selection.append(name)
            images += [f"{k + 1} " + _fmt(_qvec_t(pose)) + f" 1 {rel}", ""]
        colmap = _mkdir(osp.join(base, cam_type, "colmap"))
        with open(osp.join(colmap, "cameras.txt"), "w") as f:
            f.write("# Camera list\n# CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n# n\n"
                    f"1 {model} {Ww} {Hh} "
                    + _fmt((K[0, 0], K[1, 1], K[0, 2] + 0.5, K[1, 2] + 0.5, *d)) + "\n")
        with open(osp.join(colmap, "images.txt"), "w") as f:
            f.write("# Image list\n# IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n"
                    + "\n".join(images) + "\n")
    pairs = np.array([(i, j, 1.0 / (j - i)) for i in range(len(selection))
                      for j in range(i + 1, len(selection))], np.float64)
    np.savez(osp.join(_mkdir(osp.join(pairs_root, scene)), "selected_pairs.npz"),
             selection=np.array(selection), pairs=pairs)
    with open(osp.join(pairs_root, "scene_list.json"), "w") as f:
        json.dump([scene], f)
    return dict(root=root, pairs=pairs_root)


class EnvmapFiles:
    """Stands in for habitat-sim's envmap renderer (`habitat_sim_envmaps_
    renderer.HabitatEnvironmentMapRenderer`): the equirectangular colour
    and distance maps `_raw_habitat` wrote for each viewpoint, habitat's
    axes."""

    def __init__(self, root, equirectangular_resolution):
        self.root = root
        self.equirectangular_resolution = tuple(equirectangular_resolution)
        with open(osp.join(root, "viewpoints.json")) as f:
            self.viewpoints = {tuple(np.round(p, 6)): name for name, p in json.load(f).items()}

    def R_cam_to_world(self):
        return HABITAT_R_CAM_TO_WORLD.tolist()

    def up_direction(self):
        return [0.0, 1.0, 0.0]

    def render_viewpoint(self, viewpoint_position):
        import PIL.Image

        name = self.viewpoints[tuple(np.round(np.asarray(viewpoint_position, float), 6))]
        color = np.asarray(PIL.Image.open(osp.join(self.root, name + "_color.png")))
        dist = np.load(osp.join(self.root, name + "_distance.npy"))
        return dict(observations=dict(color_equirectangular=color,
                                      depth_equirectangular=dist),
                    position=viewpoint_position)


def envmap_rays(h, w):
    """World rays of an h x w envmap's pixels, as the crop generator
    unprojects them with habitat's axes."""
    from ..datasets_preprocess.habitat import projections

    proj = projections.RotatedProjection(projections.EquirectangularProjection(h, w),
                                         HABITAT_R_CAM_TO_WORLD.T)
    return projections.get_projection_rays(proj)


def _raw_habitat(root, frames, rng, size):
    """One scene's metadata (a fan of 5 views, each at its own viewpoint)
    and an envmap pair per viewpoint."""
    w, h = _scaled("Habitat", size)
    crop = HABITAT_CROP if size is None else max(32, (w // 4) // 16 * 16)
    scene = "scene_00"
    envdir = _mkdir(osp.join(root, "envmaps", scene))
    rays = envmap_rays(h, w)
    noise = _noise(rng)
    K = _K(crop, crop, focal=0.6 * crop, centre=0.0)
    views, points = {}, {}
    for v in range(1, 6):
        pose = _pose(v - 1, 5)
        position = pose[:3, 3]
        with np.errstate(divide="ignore", invalid="ignore"):
            dist = (PLANE_Z - position[2]) / rays[..., 2]  # unit rays: the ray distance
        dist = np.where(dist > 0, dist, 0.0)
        hits = position + rays * dist[..., None]
        dist = dist.astype(np.float32)
        rgb = _texture(np.nan_to_num(hits[..., 0]), np.nan_to_num(hits[..., 1]), noise)
        rgb[dist == 0] = 96
        name = f"view{v}"
        _save(osp.join(envdir, name + "_color.png"), rgb)
        np.save(osp.join(envdir, name + "_distance.npy"), dist)
        points[name] = position.tolist()
        views[str(v)] = dict(camera_intrinsics=K.tolist(), size=[crop, crop],
                             R_cam2world=pose[:3, :3].tolist(), t_cam2world=position.tolist())
    with open(osp.join(envdir, "viewpoints.json"), "w") as f:
        json.dump(points, f)
    meta = osp.join(_mkdir(osp.join(root, "metadata", scene)), "metadata.json")
    with open(meta, "w") as f:
        json.dump(dict(scene=scene + ".glb", scene_dataset_config_file="",
                       view_batches={"00000": views}), f)
    return dict(metadata=meta, envmaps=envdir, scenes_dir=osp.join(root, "scenes"),
                rel=scene, crop=crop, resolution=(h, w))


def write_raw(name, root, frames=3, seed=0, size=None):
    """Write dataset `name`'s raw layout under root (`frames` a sequence;
    `size` (W, H) in place of the source's); returns what `preprocess`
    needs."""
    rng = np.random.default_rng(seed)
    raw = _mkdir(osp.join(root, "raw"))
    if name == "ARKitScenes":
        info = _raw_arkitscenes(raw, frames, rng, size, _mkdir(osp.join(root, "pairs")))
    elif name == "ScanNetpp":
        info = _raw_scannetpp(raw, frames, rng, size, _mkdir(osp.join(root, "pairs")))
    else:
        info = RAW_WRITERS[name](raw, frames, rng, size)
    return dict(info, name=name, raw=raw)


RAW_WRITERS = dict(Co3d=_raw_co3d, WildRGBD=_raw_wildrgbd, BlendedMVS=_raw_blendedmvs,
                   MegaDepth=_raw_megadepth, StaticThings3D=_raw_staticthings3d,
                   ARKitScenes=_raw_arkitscenes, Waymo=_raw_waymo, ScanNetpp=_raw_scannetpp,
                   Habitat=_raw_habitat)
NOT_DRIVEN = dict(Waymo="stage 1 (tensorflow + waymo_open_dataset): its output layout is written",
                  ScanNetpp="the mesh render (pyrender + trimesh): PlaneRenderer's depth",
                  Habitat="habitat-sim's envmap render: EnvmapFiles read the raw envmaps")


def preprocess(info, out):
    """Run the port's script for `info` (`write_raw`'s) into out; returns
    the processed root the loader reads."""
    from ..datasets_preprocess import (preprocess_arkitscenes, preprocess_blendedmvs,
                                       preprocess_co3d, preprocess_megadepth,
                                       preprocess_scannetpp, preprocess_staticthings3d,
                                       preprocess_waymo, preprocess_wildrgbd)
    from ..datasets_preprocess.habitat import find_scenes, preprocess_habitat

    name = info["name"]
    argv = list(info.get("argv", []))
    if name == "Co3d":
        preprocess_co3d.main(argv + ["--output_dir", out])
    elif name == "WildRGBD":
        preprocess_wildrgbd.main(argv + ["--output_dir", out])
    elif name in ("BlendedMVS", "StaticThings3D", "ARKitScenes"):
        module = dict(BlendedMVS=preprocess_blendedmvs, StaticThings3D=preprocess_staticthings3d,
                      ARKitScenes=preprocess_arkitscenes)[name]
        module.main(argv[1], argv[3], out)
    elif name == "MegaDepth":
        preprocess_megadepth.main(argv[1], argv[3], out,
                                  depth_reader=None if info["h5"] else megadepth_npy_reader)
    elif name == "Waymo":
        shutil.copytree(info["tmp"], osp.join(out, "tmp"), dirs_exist_ok=True)
        preprocess_waymo.crop_and_stamp(info["pairs"], out, workers=1)
    elif name == "ScanNetpp":
        preprocess_scannetpp.process_scenes(info["root"], info["pairs"], out, 920,
                                            renderer=PlaneRenderer())
    elif name == "Habitat":
        preprocess_habitat.preprocess_metadata(
            info["metadata"], info["scenes_dir"], osp.join(out, info["rel"]),
            crop_resolution=(info["crop"], info["crop"]),
            equirectangular_resolution=info["resolution"],
            envmap_renderer=EnvmapFiles(info["envmaps"], info["resolution"]))
        n = len(find_scenes._walk_for_subscenes(out))
        find_scenes.find_all_scenes(out, n_scenes=(n,), assume_yes=True)
    else:
        raise ValueError(f"no dataset {name}")
    return out


def mix_args(habitat_root):
    """`train_scenes.TRAIN_ARGS` with Habitat's list size the one
    find_scenes wrote under habitat_root (the published 1_000_000 needs that
    many sub-scenes)."""
    from .train_scenes import TRAIN_ARGS

    with open(osp.join(habitat_root, "Habitat_all_scenes.txt")) as f:
        n = len(f.read().splitlines())
    return dict(TRAIN_ARGS, Habitat=TRAIN_ARGS["Habitat"].replace("1_000_000", str(n), 1))


def plane_error(view):
    """Median |z - PLANE_Z| / PLANE_Z of a loader view's pts3d over its
    valid pixels (inf without one)."""
    valid = np.asarray(view["valid_mask"])
    if not valid.any():
        return float("inf")
    z = np.asarray(view["pts3d"])[..., 2][valid]
    return float(np.median(np.abs(z - PLANE_Z)) / PLANE_Z)


def run_all(root, frames=3, seed=0):
    """Write every raw layout under root/<name>/ and preprocess it into
    root/<name>/out, one thread a dataset; returns {name: (processed root,
    seconds of the raw layout, seconds of its script, files written,
    `write_raw`'s info)}."""
    from concurrent.futures import ThreadPoolExecutor

    def one(i, name):
        t0 = time.perf_counter()
        base = osp.join(root, name)
        shutil.rmtree(base, ignore_errors=True)
        info = write_raw(name, base, frames, seed + i)
        t1 = time.perf_counter()
        out = preprocess(info, osp.join(base, "out"))
        t2 = time.perf_counter()
        files = sum(len(f) for _, _, f in os.walk(out))
        return name, (out, t1 - t0, t2 - t1, files, info)

    with ThreadPoolExecutor(len(RAW_WRITERS)) as pool:
        return dict(pool.map(lambda a: one(*a), enumerate(RAW_WRITERS)))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out_dir")
    parser.add_argument("--frames", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    a = parser.parse_args()
    for name, (out, raw_s, prep_s, files, _) in run_all(a.out_dir, a.frames, a.seed).items():
        print(f"{name}: raw {raw_s:.2f} s, preprocess {prep_s:.2f} s, {files} files in {out}")
