#!/usr/bin/env python3
"""Offline BlendedMVS preprocessing: raw download -> loader format.

Counterpart of `datasets_preprocess/preprocess_blendedmvs.py` (per-view
cam.txt parsing, PFM depth decode, 512x384 rescale, jpg + exr + npz
outputs checked against the precomputed pairs file); the PFM's vertical
flip is `utils/cvops.flip`, the EXR `utils/exr.imwrite_exr`.

    python -m dust3r_tpu_torch.datasets_preprocess.preprocess_blendedmvs \\
        --blendedmvs_dir RAW --precomputed_pairs blendedmvs_pairs.npy --output_dir OUT
"""
import argparse
import os
import os.path as osp
import re

import numpy as np

from ..datasets.utils import cropping
from ..utils import cvops
from ..utils.exr import imwrite_exr
from ..utils.image import imread_cv2
from ..utils.parallel import parallel_threads


def get_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--blendedmvs_dir", required=True)
    parser.add_argument("--precomputed_pairs", required=True)
    parser.add_argument("--output_dir", default="data/blendedmvs_processed")
    return parser


def load_pfm_file(file_path):
    """Decode a PFM depth map (little/big endian, vertically flipped)."""
    with open(file_path, "rb") as f:
        header = f.readline().decode("UTF-8").strip()
        if header == "PF":
            is_color = True
        elif header == "Pf":
            is_color = False
        else:
            raise ValueError("not a valid PFM file")
        dims = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("UTF-8"))
        if not dims:
            raise ValueError("invalid PFM header")
        w, h = map(int, dims.groups())
        endian_scale = float(f.readline().decode("UTF-8").strip())
        dtype = "<f" if endian_scale < 0 else ">f"
        data = np.frombuffer(f.read(), dtype=dtype)
        data = data.reshape((h, w, 3) if is_color else (h, w))
        return cvops.flip(data, 0)


def load_cam_txt(path):
    """cam.txt: extrinsic (world2cam 4x4) then intrinsic 3x3."""
    with open(path) as f:
        RT = np.loadtxt(f, skiprows=1, max_rows=4, dtype=np.float32)
        assert RT.shape == (4, 4)
        RT = np.linalg.inv(RT)  # -> cam2world
        K = np.loadtxt(f, skiprows=2, max_rows=3, dtype=np.float32)
        assert K.shape == (3, 3)
    return K, RT[:3, :3], RT[:3, 3]


def process_one(root, img, out_dir):
    if osp.isfile(osp.join(out_dir, img + ".npz")):
        return

    K, R_c2w, t_c2w = load_cam_txt(osp.join(root, "cams", img + "_cam.txt"))
    color = imread_cv2(osp.join(root, "blended_images", img + ".jpg"))
    depth = load_pfm_file(osp.join(root, "rendered_depth_maps", img + ".pfm"))

    H, W = color.shape[:2]
    assert H * 4 == W * 3, f"expected 4:3 input, got {W}x{H}"
    image, depthmap, K_out = cropping.rescale_image_depthmap(
        color, depth, K, (512, 384))

    image.save(osp.join(out_dir, img + ".jpg"), quality=80)
    imwrite_exr(osp.join(out_dir, img + ".exr"), depthmap)
    np.savez(osp.join(out_dir, img + ".npz"), intrinsics=K_out,
             R_cam2world=R_c2w, t_cam2world=t_c2w)


def main(db_root, pairs_path, output_dir):
    sequences = [f for f in os.listdir(db_root) if len(f) == 24]
    assert sequences, f"no sequences found at {db_root}"
    print(f">> found {len(sequences)} sequences")

    for seq in sequences:
        out_dir = osp.join(output_dir, seq)
        os.makedirs(out_dir, exist_ok=True)
        root = osp.join(db_root, seq)
        cam_dir = osp.join(root, "cams")
        func_args = [(root, f[:-8], out_dir) for f in os.listdir(cam_dir)
                     if not f.startswith("pair")]
        parallel_threads(process_one, func_args, star_args=True, leave=False)

    # verify against the precomputed pairs
    pairs = np.load(pairs_path)
    for seqh, seql, img1, img2, score in pairs:
        for view_index in (img1, img2):
            impath = osp.join(output_dir, f"{seqh:08x}{seql:016x}",
                              f"{view_index:08n}.jpg")
            assert osp.isfile(impath), f"missing image at {impath}"
    # copy the pairs file next to the data (loader contract)
    np.save(osp.join(output_dir, "blendedmvs_pairs.npy"), pairs)
    print(f">> Done, saved everything in {output_dir}/")


if __name__ == "__main__":
    args = get_parser().parse_args()
    main(args.blendedmvs_dir, args.precomputed_pairs, args.output_dir)
