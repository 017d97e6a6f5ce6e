#!/usr/bin/env python3
"""Offline WildRGB-D preprocessing: raw download -> loader format.

Counterpart of `datasets_preprocess/preprocess_wildrgbd.py` (train/val
list intersection splits, principal-point-centred crop + 3/4-aspect
rescale, uint16 mm depth re-encode, per-frame npz metadata); its PNG writes
are `utils/cvops.imwrite`.

    python -m dust3r_tpu_torch.datasets_preprocess.preprocess_wildrgbd \\
        --wildrgbd_dir RAW --output_dir OUT [--num_frames 100]
"""
import argparse
import json
import os
import os.path as osp
import random

import numpy as np

from ..datasets.utils import cropping
from ..utils import cvops
from ..utils.image import IMREAD_UNCHANGED, imread_cv2


def get_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_dir", type=str,
                        default="data/wildrgbd_processed")
    parser.add_argument("--wildrgbd_dir", type=str, required=True)
    parser.add_argument("--train_num_sequences_per_object", type=int,
                        default=50)
    parser.add_argument("--test_num_sequences_per_object", type=int,
                        default=10)
    parser.add_argument("--num_frames", type=int, default=100)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--img_size", type=int, default=512)
    return parser


def get_set_list(category_dir, split):
    """Train split = intersection of both camera/nvs train lists; test =
    everything else."""
    listfiles = ["camera_eval_list.json", "nvs_list.json"]
    sequences_all = {s: {k: set() for k in listfiles}
                     for s in ("train", "val")}
    for listfile in listfiles:
        with open(osp.join(category_dir, listfile)) as f:
            data = json.load(f)
            for s in ("train", "val"):
                sequences_all[s][listfile].update(data[s])
    train_intersection = set.intersection(
        *list(sequences_all["train"].values()))
    if split == "train":
        return train_intersection
    all_seqs = set.union(*list(sequences_all["train"].values()),
                         *list(sequences_all["val"].values()))
    return all_seqs.difference(train_intersection)


def prepare_sequences(category, wildrgbd_dir, output_dir, img_size, split,
                      max_num_sequences_per_object, output_num_frames, seed):
    import PIL.Image

    random.seed(seed)
    category_dir = osp.join(wildrgbd_dir, category)
    category_output_dir = osp.join(output_dir, category)
    sequences_all = sorted(get_set_list(category_dir, split))
    sequences_all = [s for s in sequences_all
                     if os.path.isdir(osp.join(category_dir, s))]
    if len(sequences_all) > max_num_sequences_per_object:
        sequences_all = random.sample(sequences_all,
                                      max_num_sequences_per_object)

    selected = {}
    for seq_name in sequences_all:
        scene_dir = osp.join(category_dir, seq_name)
        scene_output_dir = osp.join(category_output_dir, seq_name)
        with open(osp.join(scene_dir, "metadata")) as f:
            metadata = json.load(f)

        K = np.array(metadata["K"]).reshape(3, 3).T
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        camera_intrinsics = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])

        c2w_content = np.genfromtxt(osp.join(scene_dir, "cam_poses.txt"))
        camera_to_world = c2w_content[:, 1:].reshape(-1, 4, 4)
        frame_idx = c2w_content[:, 0]
        num_frames = frame_idx.shape[0]
        assert num_frames >= output_num_frames
        assert np.all(frame_idx == np.arange(num_frames))

        frames = np.round(np.linspace(0, num_frames - 1,
                                      output_num_frames)).astype(int).tolist()
        selected[seq_name] = frames

        for frame_id in frames:
            rgb = PIL.Image.open(
                osp.join(scene_dir, "rgb", f"{frame_id:0>5d}.png")).convert("RGB")
            mask = np.asarray(PIL.Image.open(
                osp.join(scene_dir, "masks", f"{frame_id:0>5d}.png")),
                np.float64) / 255.0
            depth = imread_cv2(
                osp.join(scene_dir, "depth", f"{frame_id:0>5d}.png"),
                IMREAD_UNCHANGED).astype(np.float64)
            depth_mask = np.stack((depth, mask), axis=-1)
            H, W = depth.shape

            # principal-point-centered crop
            min_margin_x = min(cx, W - cx)
            min_margin_y = min(cy, H - cy)
            crop_bbox = (int(cx - min_margin_x), int(cy - min_margin_y),
                         int(cx + min_margin_x), int(cy + min_margin_y))
            rgb, depth_mask, K_out = cropping.crop_image_depthmap(
                rgb, depth_mask, camera_intrinsics, crop_bbox)

            scale_final = ((img_size * 3 // 4) / min(H, W)) + 1e-8
            output_resolution = np.floor(np.array([W, H])
                                         * scale_final).astype(int)
            if max(output_resolution) < img_size:
                scale_final = (img_size / max(H, W)) + 1e-8
                output_resolution = np.floor(np.array([W, H])
                                             * scale_final).astype(int)
            rgb, depth_mask, K_out = cropping.rescale_image_depthmap(
                rgb, depth_mask, K_out, output_resolution)
            depth = depth_mask[:, :, 0]
            mask = depth_mask[:, :, 1]

            for sub in ("rgb", "depth", "masks", "metadata"):
                os.makedirs(osp.join(scene_output_dir, sub), exist_ok=True)
            rgb.save(osp.join(scene_output_dir, "rgb",
                              f"{frame_id:0>5d}.jpg"))
            cvops.imwrite(osp.join(scene_output_dir, "depth",
                                   f"{frame_id:0>5d}.png"),
                          depth.astype(np.uint16))
            cvops.imwrite(osp.join(scene_output_dir, "masks",
                                   f"{frame_id:0>5d}.png"),
                          (mask * 255).astype(np.uint8))
            np.savez(osp.join(scene_output_dir, "metadata",
                              f"{frame_id:0>5d}.npz"),
                     camera_intrinsics=K_out,
                     camera_pose=camera_to_world[frame_id])
    return selected


def main(argv=None):
    args = get_parser().parse_args(argv)
    assert args.wildrgbd_dir != args.output_dir
    categories = sorted([
        d for d in os.listdir(args.wildrgbd_dir)
        if os.path.isdir(osp.join(args.wildrgbd_dir, d, "scenes"))])
    os.makedirs(args.output_dir, exist_ok=True)

    split_sizes = [args.train_num_sequences_per_object,
                   args.test_num_sequences_per_object]
    for split, n_seqs in zip(["train", "test"], split_sizes):
        out_path = osp.join(args.output_dir, f"selected_seqs_{split}.json")
        if osp.isfile(out_path):
            continue
        all_selected = {}
        for category in categories:
            cat_out = osp.join(args.output_dir, category)
            os.makedirs(cat_out, exist_ok=True)
            cat_path = osp.join(cat_out, f"selected_seqs_{split}.json")
            if osp.isfile(cat_path):
                with open(cat_path) as f:
                    cat_selected = json.load(f)
            else:
                print(f"Processing {split} - category = {category}")
                # the literal "category" (not the name) seeds every category, as in the reference
                cat_selected = prepare_sequences(
                    category, args.wildrgbd_dir, args.output_dir,
                    args.img_size, split, n_seqs, args.num_frames,
                    args.seed + int("category".encode("ascii").hex(), 16))
                with open(cat_path, "w") as f:
                    json.dump(cat_selected, f)
            all_selected[category] = cat_selected
        with open(out_path, "w") as f:
            json.dump(all_selected, f)


if __name__ == "__main__":
    main()
