#!/usr/bin/env python3
"""Offline Co3D_v2 preprocessing: raw download -> loader format.

Counterpart of `datasets_preprocess/preprocess_co3d.py` (NDC -> pinhole
conversion, the pytorch3d -> OpenCV camera flip, quality filtering,
per-category sequence selection, the 16-bit depth PNG re-encoded over the
frame's max depth), with `utils/cvops.py` for its cv2 calls: INTER_AREA
for the image, INTER_NEAREST for depth and mask, PNG and JPEG (quality 95)
writes.

    python -m dust3r_tpu_torch.datasets_preprocess.preprocess_co3d \\
        --co3d_dir RAW --output_dir OUT [--category teddybear]

Output layout (read by `dust3r_tpu_torch.datasets.Co3d`):
  OUT/selected_seqs_{split}.json
  OUT/{category}/{sequence}/images/frame{:06d}.jpg
  OUT/{category}/{sequence}/depths/frame{:06d}.jpg.geometric.png
  OUT/{category}/{sequence}/masks/frame{:06d}.png
  OUT/{category}/{sequence}/images/frame{:06d}.npz
"""
import argparse
import gzip
import json
import os
import os.path as osp
import random

import numpy as np

from ..utils import cvops
from ..utils.image import IMREAD_UNCHANGED, imread_cv2

# the full 51-category training corpus of the paper recipe; order matters:
# the per-category RNG seed is `seed + index` below
CATEGORIES = [
    "apple", "backpack", "ball", "banana", "baseballbat", "baseballglove",
    "bench", "bicycle", "book", "bottle", "bowl", "broccoli", "cake", "car",
    "carrot", "cellphone", "chair", "couch", "cup", "donut", "frisbee",
    "hairdryer", "handbag", "hotdog", "hydrant", "keyboard", "kite",
    "laptop", "microwave", "motorcycle", "mouse", "orange", "parkingmeter",
    "pizza", "plant", "remote", "sandwich", "skateboard", "stopsign",
    "suitcase", "teddybear", "toaster", "toilet", "toybus", "toyplane",
    "toytrain", "toytruck", "tv", "umbrella", "vase", "wineglass",
]
SINGLE_SEQUENCE_CATEGORIES = sorted(
    set(CATEGORIES) - {"microwave", "stopsign", "tv"})


def get_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--category", type=str, default=None)
    parser.add_argument("--single_sequence_subset", action="store_true")
    parser.add_argument("--output_dir", type=str,
                        default="data/co3d_processed")
    parser.add_argument("--co3d_dir", type=str, required=True)
    parser.add_argument("--num_sequences_per_object", type=int, default=50)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--min_quality", type=float, default=0.5)
    parser.add_argument("--img_size", type=int, default=512)
    return parser


def convert_ndc_to_pinhole(focal_length, principal_point, image_size):
    """pytorch3d NDC camera -> pixel-space pinhole K."""
    focal_length = np.asarray(focal_length)
    principal_point = np.asarray(principal_point)
    image_size_wh = np.asarray([image_size[1], image_size[0]])
    half = image_size_wh / 2
    rescale = half.min()
    pp_px = half - principal_point * rescale
    f_px = focal_length * rescale
    return np.array([[f_px[0], 0, pp_px[0]], [0, f_px[1], pp_px[1]],
                     [0, 0, 1]], np.float32)


def opencv_from_cameras_projection(R, T, focal, p0, image_size):
    """pytorch3d camera (row-major R, NDC intrinsics) -> OpenCV R, t, K.

    Convention flip: pytorch3d's +X left / +Y up screen axes vs OpenCV's
    +X right / +Y down, and R stored row-major.
    """
    R = np.asarray(R, np.float64)
    T = np.asarray(T, np.float64)
    focal = np.asarray(focal, np.float64)
    p0 = np.asarray(p0, np.float64)
    image_size_wh = np.asarray(image_size, np.float64)[::-1]

    T_cv = T.copy()
    R_cv = R.copy()
    T_cv[:2] *= -1
    R_cv[:, :2] *= -1
    R_out = R_cv.T  # row-major -> column-major

    scale = image_size_wh.min() / 2.0
    c0 = image_size_wh / 2.0
    principal_point = -p0 * scale + c0
    focal_length = focal * scale

    K = np.zeros((3, 3), np.float64)
    K[0, 0], K[1, 1] = focal_length[0], focal_length[1]
    K[:2, 2] = principal_point
    K[2, 2] = 1.0
    return R_out, T_cv, K


def get_set_list(category_dir, split, is_single_sequence_subset=False):
    listfiles = os.listdir(osp.join(category_dir, "set_lists"))
    key = "manyview_dev" if is_single_sequence_subset else "fewview_train"
    sequences_all = []
    for f in [f for f in listfiles if key in f]:
        with open(osp.join(category_dir, "set_lists", f)) as fin:
            sequences_all.extend(json.load(fin)[split])
    return sequences_all


def load_16bit_png_depth(depth_png_path):
    """Co3D stores depth as float16 bit patterns inside a 16-bit png."""
    import PIL.Image

    with PIL.Image.open(depth_png_path) as img:
        arr = np.array(img, dtype=np.uint16)
    return arr.view(np.float16).astype(np.float32).reshape(arr.shape)


def prepare_sequences(category, co3d_dir, output_dir, img_size, split,
                      min_quality, max_num_sequences_per_object, seed,
                      is_single_sequence_subset=False):
    """Select, convert and re-encode the frames of one category."""
    random.seed(seed)
    category_dir = osp.join(co3d_dir, category)
    category_output_dir = osp.join(output_dir, category)
    sequences_all = get_set_list(category_dir, split,
                                 is_single_sequence_subset)
    sequences_numbers = sorted({s for s, _, _ in sequences_all})

    with gzip.open(osp.join(category_dir, "frame_annotations.jgz"), "r") as f:
        frame_data = json.loads(f.read())
    with gzip.open(osp.join(category_dir, "sequence_annotations.jgz"),
                   "r") as f:
        seq_data = json.loads(f.read())

    frame_index = {(f["sequence_name"], f["frame_number"]): f
                   for f in frame_data}
    good_quality = {s["sequence_name"] for s in seq_data
                    if s["viewpoint_quality_score"] is not None
                    and s["viewpoint_quality_score"] > min_quality}

    sequences_numbers = [s for s in sequences_numbers if s in good_quality]
    if len(sequences_numbers) > max_num_sequences_per_object:
        sequences_numbers = random.sample(sequences_numbers,
                                          max_num_sequences_per_object)

    selected = {}
    for seq_name in sequences_numbers:
        frames = sorted([fn for (sn, fn) in frame_index if sn == seq_name])
        kept = []
        for fn in frames:
            fr = frame_index[(seq_name, fn)]
            img_path = osp.join(co3d_dir, fr["image"]["path"])
            depth_path = osp.join(co3d_dir, fr["depth"]["path"])
            mask_path = osp.join(co3d_dir, fr["mask"]["path"])
            if not (osp.isfile(img_path) and osp.isfile(depth_path)):
                continue

            vp = fr["viewpoint"]
            H, W = fr["image"]["size"]
            R, T, K = opencv_from_cameras_projection(
                np.array(vp["R"]), np.array(vp["T"]),
                np.array(vp["focal_length"]),
                np.array(vp["principal_point"]), np.array([H, W]))
            pose_w2c = np.eye(4, dtype=np.float32)
            pose_w2c[:3, :3], pose_w2c[:3, 3] = R, T
            camera_pose = np.linalg.inv(pose_w2c)  # cam2world

            bgr = imread_cv2(img_path)[..., ::-1]  # as cv2.imread gives it
            depth = load_16bit_png_depth(depth_path)
            mask = imread_cv2(mask_path, IMREAD_UNCHANGED) \
                if osp.isfile(mask_path) else np.full(depth.shape, 255,
                                                      np.uint8)

            # resize so min dim >= 3/4 img_size and max dim >= img_size
            scale = max(img_size / max(H, W), img_size * 0.75 / min(H, W))
            if scale < 1:
                newW, newH = round(W * scale), round(H * scale)
                bgr = cvops.resize_area(bgr, (newW, newH))
                depth = cvops.resize_nearest(depth, (newW, newH))
                mask = cvops.resize_nearest(mask, (newW, newH))
                K = K.copy()
                K[:2] *= scale

            out_seq = osp.join(category_output_dir, seq_name)
            os.makedirs(osp.join(out_seq, "images"), exist_ok=True)
            os.makedirs(osp.join(out_seq, "depths"), exist_ok=True)
            os.makedirs(osp.join(out_seq, "masks"), exist_ok=True)
            cvops.imwrite(osp.join(out_seq, "images", f"frame{fn:06d}.jpg"),
                          bgr)
            cvops.imwrite(osp.join(out_seq, "masks", f"frame{fn:06d}.png"),
                          mask)
            # 16-bit depth scaled by max depth (loader contract)
            max_depth = float(np.nan_to_num(depth).max()) or 1.0
            d16 = np.clip(depth / max_depth * 65535, 0, 65535).astype(np.uint16)
            cvops.imwrite(osp.join(out_seq, "depths",
                                   f"frame{fn:06d}.jpg.geometric.png"), d16)
            np.savez(osp.join(out_seq, "images", f"frame{fn:06d}.npz"),
                     camera_intrinsics=K.astype(np.float32),
                     camera_pose=camera_pose.astype(np.float32),
                     maximum_depth=max_depth)
            kept.append(fn)
        if kept:
            selected[seq_name] = kept
    return selected


def main(argv=None):
    args = get_parser().parse_args(argv)
    assert args.co3d_dir != args.output_dir
    categories = SINGLE_SEQUENCE_CATEGORIES if args.single_sequence_subset \
        else CATEGORIES
    if args.category:
        categories = [args.category]
    os.makedirs(args.output_dir, exist_ok=True)

    for split in ("train", "test"):
        all_selected = {}
        for category in categories:
            print(f"[{split}] processing {category} ...")
            selected = prepare_sequences(
                category, args.co3d_dir, args.output_dir, args.img_size,
                split, args.min_quality, args.num_sequences_per_object,
                args.seed + CATEGORIES.index(category),
                args.single_sequence_subset)
            if selected:
                all_selected[category] = selected
        with open(osp.join(args.output_dir,
                           f"selected_seqs_{split}.json"), "w") as f:
            json.dump(all_selected, f)


if __name__ == "__main__":
    main()
