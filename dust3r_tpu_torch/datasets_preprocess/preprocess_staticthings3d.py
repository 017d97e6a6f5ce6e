#!/usr/bin/env python3
"""Offline StaticThings3D preprocessing: raw download -> loader format.

Counterpart of `datasets_preprocess/preprocess_staticthings3d.py`
(lmb-freiburg .float3 decode, the clean and final passes rescaled together
to 512x384, exr depth + npz cameras, checked against the precomputed
pairs), reading its PNGs with `utils/image.imread_cv2`.

    python -m dust3r_tpu_torch.datasets_preprocess.preprocess_staticthings3d \\
        --StaticThings3D_dir RAW --precomputed_pairs staticthings_pairs.npy --output_dir OUT
"""
import argparse
import os
import os.path as osp

import numpy as np

from ..datasets.utils import cropping
from ..utils.exr import imwrite_exr
from ..utils.image import imread_cv2
from ..utils.parallel import parallel_threads


def get_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--StaticThings3D_dir", required=True)
    parser.add_argument("--precomputed_pairs", required=True)
    parser.add_argument("--output_dir",
                        default="data/staticthings3d_processed")
    return parser


def read_float3(name):
    """lmb-freiburg .float3 format: 'float' header, ndim, dims, raw f32."""
    with open(name, "rb") as f:
        if f.readline().decode("utf-8") != "float\n":
            raise ValueError(f"{name} is not a .float3 file")
        dim = int(f.readline())
        dims = []
        count = 1
        for _ in range(dim):
            d = int(f.readline())
            dims.append(d)
            count *= d
        data = np.fromfile(f, np.float32, count).reshape(list(reversed(dims)))
    return data


def process_one(db_root, relpath_, camera, num, out_dir):
    relpath = osp.join(relpath_, camera, num)
    if osp.isfile(osp.join(out_dir, relpath + ".npz")):
        return
    os.makedirs(osp.join(out_dir, relpath_, camera), exist_ok=True)

    K = read_float3(osp.join(db_root, "intrinsics", relpath_, num + ".float3"))
    cam2world = np.linalg.inv(
        read_float3(osp.join(db_root, "poses", relpath + ".float3")))
    depth = read_float3(osp.join(db_root, "depths", relpath + ".float3"))
    img_clean = imread_cv2(osp.join(db_root, "frames_cleanpass", relpath + ".png"))
    img_final = imread_cv2(osp.join(db_root, "frames_finalpass", relpath + ".png"))

    assert img_clean.shape[:2] == (540, 960)
    (clean_out, final_out), depthmap, K_out = cropping.rescale_image_depthmap(
        (img_clean, img_final), depth, K, (512, 384))

    clean_out.save(osp.join(out_dir, relpath + "_clean.jpg"), quality=80)
    final_out.save(osp.join(out_dir, relpath + "_final.jpg"), quality=80)
    imwrite_exr(osp.join(out_dir, relpath + ".exr"), depthmap)
    np.savez(osp.join(out_dir, relpath + ".npz"), intrinsics=K_out,
             cam2world=cam2world)


def list_all_scenes(path):
    res = []
    for split in ["TRAIN"]:
        for subsplit in "ABC":
            for seq in os.listdir(osp.join(path, "intrinsics", split,
                                           subsplit)):
                res.append((split, subsplit, seq))
    assert res, f"nothing found at {path}"
    print(f">> found {len(res)} scenes")
    return res


def main(db_root, pairs_path, output_dir):
    all_scenes = list_all_scenes(db_root)
    func_args = [(db_root, osp.join(split, subsplit, seq), camera,
                  f"{n:04d}", output_dir)
                 for split, subsplit, seq in all_scenes
                 for camera in ("left", "right") for n in range(6, 16)]
    parallel_threads(process_one, func_args, star_args=True, front_num=1)

    CAM = {b"l": "left", b"r": "right"}
    pairs = np.load(pairs_path)
    for scene, seq, cam1, im1, cam2, im2 in pairs:
        seq_path = osp.join("TRAIN", scene.decode("ascii"), f"{seq:04d}")
        for cam, idx in [(CAM[cam1], im1), (CAM[cam2], im2)]:
            for ext in ("clean", "final"):
                impath = osp.join(output_dir, seq_path, cam,
                                  f"{idx:04n}_{ext}.jpg")
                assert osp.isfile(impath), f"missing image at {impath}"
    np.save(osp.join(output_dir, "staticthings_pairs.npy"), pairs)
    print(f">> Saved all data to {output_dir}!")


if __name__ == "__main__":
    args = get_parser().parse_args()
    main(args.StaticThings3D_dir, args.precomputed_pairs, args.output_dir)
