#!/usr/bin/env python3
"""Offline MegaDepth preprocessing: COLMAP sparse models -> loader format.

Counterpart of `datasets_preprocess/preprocess_megadepth.py` (manhattan
sparse model parsing, undistorted optimal intrinsics, h5 depth decode,
800x600 downscale, jpg + exr + npz), with
`utils/cvops.get_optimal_new_camera_matrix` for cv2's. The .h5 read
(`read_depth_h5`, h5py imported there) is apart from `resize_one_image`'s
core, which takes the depth array; `main(..., depth_reader=...)` takes
another reader.

    python -m dust3r_tpu_torch.datasets_preprocess.preprocess_megadepth \\
        --megadepth_dir RAW --precomputed_pairs megadepth_pairs.npz --output_dir OUT
"""
import argparse
import collections
import os
import os.path as osp

import numpy as np
import torch

from ..datasets.utils import cropping
from ..utils import cvops
from ..utils.exr import imwrite_exr
from ..utils.image import imread_cv2
from ..utils.parallel import parallel_threads
from ..utils.pose import quat_to_rotmat


def get_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--megadepth_dir", required=True)
    parser.add_argument("--precomputed_pairs", required=True)
    parser.add_argument("--output_dir", default="data/megadepth_processed")
    return parser


def colmap_pose_to_w2c(image_pose):
    """COLMAP images.txt pose (qw qx qy qz tx ty tz) -> world2cam 4x4 (R
    rounded to float32, as the JAX package's quat_to_rotmat gives it for
    host floats)."""
    qvec = np.asarray(image_pose[:4], np.float64)
    qvec = qvec / np.linalg.norm(qvec)
    w, x, y, z = qvec
    R = quat_to_rotmat(torch.tensor([x, y, z, w], dtype=torch.float64))
    pose = np.eye(4)
    pose[:3, :3] = R.numpy().astype(np.float32)
    pose[:3, 3] = image_pose[4:7]
    return pose


def load_sparse_model(root, scene_id, subscene):
    """Parse cameras.txt + images.txt of the manhattan sparse model."""
    sparse = osp.join(root, scene_id, "sparse", "manhattan", subscene)
    with open(osp.join(sparse, "cameras.txt")) as f:
        raw = f.readlines()[3:]
    camera_intrinsics = {}
    for camera in raw:
        camera = camera.split(" ")
        width, height, focal, cx, cy, k0 = [float(e) for e in camera[2:]]
        K = np.eye(3)
        K[0, 0] = K[1, 1] = focal
        K[0, 2], K[1, 2] = cx, cy
        camera_intrinsics[int(camera[0])] = (
            (int(width), int(height)), K, (k0, 0, 0, 0))

    with open(osp.join(sparse, "images.txt")) as f:
        raw = f.read().splitlines()[4:]
    poses = {}
    cam_ids = []
    for image, points in zip(raw[0::2], raw[1::2]):
        image = image.split(" ")
        image_id = image[-1]
        cam_ids.append(int(image[-2]))
        poses[image_id] = colmap_pose_to_w2c(
            [float(e) for e in image[1:-2]])
    intrinsics = {im_id: camera_intrinsics[cam]
                  for im_id, cam in zip(poses, cam_ids)}
    return poses, intrinsics


def read_depth_h5(root, tag):
    """depths/<stem>.h5's "depth" array (h5py, an optional package)."""
    import h5py

    with h5py.File(osp.join(root, "depths", osp.splitext(tag)[0] + ".h5"), "r") as hd5:
        return np.asarray(hd5["depth"])


def resize_one_image(root, tag, K_pre_rectif, pose_w2cam, out_dir, depthmap=None):
    """One image (and its depth: read from the .h5 where not given)
    undistorted to its optimal intrinsics and rescaled to 800x600."""
    if osp.isfile(osp.join(out_dir, tag + ".npz")):
        return
    img = imread_cv2(osp.join(root, "imgs", tag))
    if depthmap is None:
        depthmap = read_depth_h5(root, tag)

    # undistort the intrinsics (optimal new camera matrix, centered pp)
    imsize_pre, K_pre, distortion = K_pre_rectif
    imsize_post = img.shape[1::-1]
    K_post = cvops.get_optimal_new_camera_matrix(
        K_pre, np.asarray(distortion), imsize_pre, alpha=0,
        new_size=imsize_post)

    H, W = img.shape[:2]
    resolution_out = sorted((800, 600))[::+1 if W < H else -1]
    img_out, depth_out, K_out = cropping.rescale_image_depthmap(
        img, depthmap, K_post, resolution_out, force=False)

    img_out.save(osp.join(out_dir, tag + ".jpg"), quality=90)
    imwrite_exr(osp.join(out_dir, tag + ".exr"), depth_out)
    cam2world = np.linalg.inv(pose_w2cam)
    np.savez(osp.join(out_dir, tag + ".npz"), intrinsics=K_out,
             cam2world=cam2world)


def main(db_root, pairs_path, output_dir, depth_reader=None):
    """depth_reader(in_dir, tag) -> the image's depth array; None reads
    the .h5 files."""
    os.makedirs(output_dir, exist_ok=True)
    data = np.load(pairs_path, allow_pickle=True)
    scenes = data["scenes"]
    images = data["images"]
    pairs = data["pairs"]

    todo = collections.defaultdict(set)
    for scene, im1, im2, score in pairs:
        todo[scene].add(im1)
        todo[scene].add(im2)

    for scene, im_idxs in todo.items():
        scene, subscene = scenes[scene].split()
        out_dir = osp.join(output_dir, scene, subscene)
        os.makedirs(out_dir, exist_ok=True)
        poses_w2c, intrinsics = load_sparse_model(db_root, scene, subscene)
        in_dir = osp.join(db_root, scene, "dense" + subscene)
        func_args = [(in_dir, img, intrinsics[img], poses_w2c[img], out_dir,
                      None if depth_reader is None else depth_reader(in_dir, img))
                     for img in [images[i] for i in im_idxs]]
        parallel_threads(resize_one_image, func_args, star_args=True,
                         front_num=0, leave=False)

    np.savez(osp.join(output_dir, "all_metadata.npz"), scenes=scenes,
             images=images, pairs=pairs)
    print("Done! prepared all pairs in", output_dir)


if __name__ == "__main__":
    args = get_parser().parse_args()
    main(args.megadepth_dir, args.precomputed_pairs, args.output_dir)
