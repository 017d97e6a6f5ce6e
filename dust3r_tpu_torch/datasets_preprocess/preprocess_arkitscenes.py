#!/usr/bin/env python3
"""Offline ARKitScenes preprocessing: raw download -> loader format.

Counterpart of `datasets_preprocess/preprocess_arkitscenes.py` (trajectory
parsing + pose interpolation at the selected frames' timestamps, the
sky-direction scene rotation, swapped intrinsics for LEFT / RIGHT scenes,
per-scene metadata concatenated into all_metadata.npz), with
`utils/cvops.py` for cv2's Rodrigues, rotate, INTER_NEAREST_EXACT resize
and PNG write.

Quaternion interpolation is a hemisphere-aligned slerp between the
bracketing trajectory samples, as in the JAX script.

    python -m dust3r_tpu_torch.datasets_preprocess.preprocess_arkitscenes \\
        --arkitscenes_dir RAW --precomputed_pairs PAIRS_DIR --output_dir OUT
"""
import argparse
import json
import math
import os
import os.path as osp
from bisect import bisect_left

import numpy as np
import torch

from ..utils import cvops
from ..utils.image import IMREAD_UNCHANGED, imread_cv2
from ..utils.pose import quat_to_rotmat, rotmat_to_quat


def get_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--arkitscenes_dir", required=True)
    parser.add_argument("--precomputed_pairs", required=True)
    parser.add_argument("--output_dir", default="data/arkitscenes_processed")
    return parser


def _rotmat(q):
    """xyzw quaternion (host float64) -> 3x3 rotation, rounded to float32 as
    the JAX package's quat_to_rotmat gives it for host floats."""
    return quat_to_rotmat(torch.as_tensor(q, dtype=torch.float64)).numpy().astype(np.float32)


def slerp(q0, q1, t):
    """Hemisphere-aligned quaternion slerp; q in xyzw."""
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    dot = float(np.dot(q0, q1))
    if dot < 0:
        q1, dot = -q1, -dot
    if dot > 0.9995:
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    theta0 = math.acos(min(dot, 1.0))
    theta = theta0 * t
    s0 = math.cos(theta) - dot * math.sin(theta) / math.sin(theta0)
    s1 = math.sin(theta) / math.sin(theta0)
    return s0 * q0 + s1 * q1


def read_traj(traj_path):
    """lowres_wide.traj: per line timestamp + angle-axis + t (world2cam)."""
    timestamps, positions, quats, poses_c2w = [], [], [], []
    with open(traj_path) as f:
        for line in f:
            tokens = line.split()
            assert len(tokens) == 7
            ts = round(float(tokens[0]), 3)
            R_w2c = cvops.rodrigues([float(t) for t in tokens[1:4]])
            t_w2c = np.asarray([float(t) for t in tokens[4:7]])
            pose_w2c = np.eye(4)
            pose_w2c[:3, :3], pose_w2c[:3, 3] = R_w2c, t_w2c
            pose_c2w = np.linalg.inv(pose_w2c)
            timestamps.append(ts)
            positions.append(pose_c2w[:3, 3])
            quats.append(np.asarray(rotmat_to_quat(pose_c2w[:3, :3])))
            poses_c2w.append(pose_c2w)
    # hemisphere-align consecutive quaternions (quaternion.unflip_rotors)
    for i in range(1, len(quats)):
        if np.dot(quats[i - 1], quats[i]) < 0:
            quats[i] = -quats[i]
    return (np.asarray(timestamps), np.asarray(positions), np.asarray(quats),
            poses_c2w)


def interpolate_poses(timestamps, positions, quats, t_query):
    """Linear position + slerp rotation at query timestamps."""
    poses = []
    for tq in t_query:
        i = bisect_left(timestamps, tq)
        i = min(max(i, 1), len(timestamps) - 1)
        t0, t1 = timestamps[i - 1], timestamps[i]
        a = 0.0 if t1 == t0 else np.clip((tq - t0) / (t1 - t0), 0, 1)
        pos = (1 - a) * positions[i - 1] + a * positions[i]
        q = slerp(quats[i - 1], quats[i], a)
        pose = np.eye(4)
        pose[:3, :3] = _rotmat(q)
        pose[:3, 3] = pos
        poses.append(pose)
    return poses


def find_scene_orientation(poses_c2w):
    """Detect the sky direction and the rotation fixing it to UP."""
    if len(poses_c2w):
        up = sum(p @ np.array([0.0, -1.0, 0.0, 0.0]) for p in poses_c2w) \
            / len(poses_c2w)
        right = sum(p @ np.array([1.0, 0.0, 0.0, 0.0]) for p in poses_c2w) \
            / len(poses_c2w)
    else:
        up = np.array([0.0, -1.0, 0.0, 0.0])
        right = np.array([1.0, 0.0, 0.0, 0.0])
    up_world = np.array([0.0, 0.0, 1.0, 0.0])

    ang_up = math.degrees(math.acos(np.clip(np.dot(up_world, up), -1, 1)))
    ang_right = math.degrees(math.acos(np.clip(np.dot(up_world, right), -1, 1)))

    def rotz(angle):
        M = np.eye(4)
        c, s = math.cos(angle), math.sin(angle)
        M[:2, :2] = [[c, -s], [s, c]]
        return M

    if abs(ang_up - 90) < abs(ang_right - 90):
        assert abs(ang_up - 90) < 45
        if ang_right > 90:
            sky, cam_to_rotated = "LEFT", rotz(math.pi / 2)
        else:
            sky, cam_to_rotated = "RIGHT", rotz(-math.pi / 2)
    else:
        assert abs(ang_right - 90) < 45
        if ang_up > 90:
            sky, cam_to_rotated = "DOWN", rotz(math.pi)
        else:
            sky, cam_to_rotated = "UP", np.eye(4)
    return sky, np.linalg.inv(cam_to_rotated)


def rotate_image_depth(img, depth, sky):
    from PIL import Image

    if sky == "RIGHT":
        img = img.transpose(Image.Transpose.ROTATE_90)
        depth = cvops.rotate(depth, cvops.ROTATE_90_COUNTERCLOCKWISE)
    elif sky == "LEFT":
        img = img.transpose(Image.Transpose.ROTATE_270)
        depth = cvops.rotate(depth, cvops.ROTATE_90_CLOCKWISE)
    elif sky == "DOWN":
        img = img.transpose(Image.Transpose.ROTATE_180)
        depth = cvops.rotate(depth, cvops.ROTATE_180)
    return img, depth


def convert_scene(scene_subdir, scene_dir, out_scene_subdir, selection, pairs):
    from PIL import Image

    timestamps, positions, quats, poses_c2w = read_traj(
        osp.join(scene_dir, "lowres_wide.traj"))
    sky, rotated_to_cam = find_scene_orientation(poses_c2w)

    selected_images = [(b, b.split(".png")[0].split("_")[1])
                       for b in selection]
    t_query = [float(fid) for _, fid in selected_images]
    interp = interpolate_poses(timestamps, positions, quats, t_query)

    intr_dir = osp.join(scene_dir, "vga_wide_intrinsics")
    trajectories, intrinsics, images = [], [], []
    for i, (basename, frame_id) in enumerate(selected_images):
        fn = osp.join(intr_dir, f"{scene_subdir}_{frame_id}.pincam")
        if not osp.exists(fn):
            fn = osp.join(intr_dir,
                          f"{scene_subdir}_{float(frame_id) - 0.001:.3f}.pincam")
        if not osp.exists(fn):
            fn = osp.join(intr_dir,
                          f"{scene_subdir}_{float(frame_id) + 0.001:.3f}.pincam")
        assert osp.exists(fn)
        w, h, fx, fy, hw, hh = np.loadtxt(fn)

        images.append(basename)
        if sky in ("RIGHT", "LEFT"):
            intrinsics.append([h, w, fy, fx, hh, hw])  # swapped
        else:
            intrinsics.append([w, h, fx, fy, hw, hh])
        trajectories.append(interp[i] @ rotated_to_cam)

    os.makedirs(osp.join(out_scene_subdir, "vga_wide"), exist_ok=True)
    os.makedirs(osp.join(out_scene_subdir, "lowres_depth"), exist_ok=True)
    for basename in images:
        img_out = osp.join(out_scene_subdir, "vga_wide",
                           basename.replace(".png", ".jpg"))
        depth_out = osp.join(out_scene_subdir, "lowres_depth", basename)
        if osp.isfile(img_out) and osp.isfile(depth_out):
            continue
        img = Image.open(osp.join(scene_dir, "vga_wide", basename))
        depth = imread_cv2(osp.join(scene_dir, "lowres_depth", basename),
                           IMREAD_UNCHANGED)
        img, depth = rotate_image_depth(img, depth, sky)
        W, H = img.size
        if not osp.isfile(img_out):
            img.save(img_out)
        depth = cvops.resize_nearest_exact(depth, (W, H))
        if not osp.isfile(depth_out):
            cvops.imwrite(depth_out, depth)

    return trajectories, intrinsics, images


def main(rootdir, pairsdir, outdir):
    os.makedirs(outdir, exist_ok=True)
    for subdir in ("Test", "Training"):
        if not osp.isdir(osp.join(rootdir, subdir)):
            continue
        outsubdir = osp.join(outdir, subdir)
        os.makedirs(outsubdir, exist_ok=True)
        with open(osp.join(pairsdir, subdir, "scene_list.json")) as f:
            scene_dirs = json.load(f)

        valid_scenes = []
        for scene_subdir in scene_dirs:
            out_scene_subdir = osp.join(outsubdir, scene_subdir)
            os.makedirs(out_scene_subdir, exist_ok=True)
            sel = np.load(osp.join(pairsdir, subdir, scene_subdir,
                                   "selected_pairs.npz"))
            selection, pairs = sel["selection"], sel["pairs"]
            if len(selection) == 0 or len(pairs) == 0:
                continue
            valid_scenes.append(scene_subdir)

            meta_path = osp.join(out_scene_subdir, "scene_metadata.npz")
            if osp.isfile(meta_path):
                continue
            print(f"parsing {scene_subdir}")
            trajectories, intrinsics, images = convert_scene(
                scene_subdir, osp.join(rootdir, subdir, scene_subdir),
                out_scene_subdir, selection, pairs)
            np.savez(meta_path, trajectories=trajectories,
                     intrinsics=intrinsics, images=images, pairs=pairs)

        with open(osp.join(outsubdir, "scene_list.json"), "w") as f:
            json.dump(valid_scenes, f)

        # concat per-scene metadata into one file (loader contract)
        offset = 0
        counts, scenes, sceneids = [], [], []
        images, intrinsics, trajectories, pairs = [], [], [], []
        for scene_idx, scene_subdir in enumerate(valid_scenes):
            with np.load(osp.join(outsubdir, scene_subdir,
                                  "scene_metadata.npz")) as data:
                num_imgs = data["images"].shape[0]
                img_pairs = data["pairs"].copy()
                scenes.append(scene_subdir)
                sceneids.extend([scene_idx] * num_imgs)
                images.append(data["images"])
                K = np.expand_dims(np.eye(3), 0).repeat(num_imgs, 0)
                K[:, 0, 0] = data["intrinsics"][:, 2]
                K[:, 1, 1] = data["intrinsics"][:, 3]
                K[:, 0, 2] = data["intrinsics"][:, 4]
                K[:, 1, 2] = data["intrinsics"][:, 5]
                intrinsics.append(K)
                trajectories.append(data["trajectories"])
                img_pairs[:, 0:2] += offset
                pairs.append(img_pairs)
                counts.append(offset)
                offset += num_imgs
        np.savez(osp.join(outsubdir, "all_metadata.npz"),
                 counts=counts, scenes=scenes, sceneids=sceneids,
                 images=np.concatenate(images, axis=0),
                 intrinsics=np.concatenate(intrinsics, axis=0),
                 trajectories=np.concatenate(trajectories, axis=0),
                 pairs=np.concatenate(pairs, axis=0))


if __name__ == "__main__":
    args = get_parser().parse_args()
    main(args.arkitscenes_dir, args.precomputed_pairs, args.output_dir)
