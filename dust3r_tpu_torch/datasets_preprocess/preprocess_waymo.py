#!/usr/bin/env python3
"""Offline Waymo Open Dataset preprocessing: tfrecords -> loader format.

Counterpart of `datasets_preprocess/preprocess_waymo.py`. Two stages, with
the reference's tmp-dir handoff:
  stage 1  extract   tfrecord -> tmp/<seq>/ (full-res jpg + raw npz +
                     calib.json); tensorflow and waymo_open_dataset,
                     imported there (optional packages)
  stage 2  crop      tmp/<seq>/ -> <seq>/ (512 long-edge jpg, the lidar
                     points splatted into a sparse depth written as a FLOAT
                     ZIP EXR by `utils/exr.write_exr`, per-frame
                     intrinsics / cam2world / distortion npz); numpy and PIL
then the precomputed pair table is checked against the files and stamped to
waymo_pairs.npz. `crop_and_stamp` runs stage 2 and the stamp on a tmp/
that stage 1 left (`main` runs both stages).

    python -m dust3r_tpu_torch.datasets_preprocess.preprocess_waymo \\
        --waymo_dir TFRECORDS --precomputed_pairs waymo_pairs.npz --output_dir OUT
"""
import argparse
import json
import os
import os.path as osp
import shutil
import sys
from dataclasses import dataclass

import numpy as np

from ..datasets.utils import cropping
from ..utils.exr import write_exr
from ..utils.geometry import geotrf, inv
from ..utils.image import imread_cv2
from ..utils.parallel import parallel_processes as parallel_map

# waymo stores poses in the vehicle frame (x forward, y left, z up);
# rows below re-express that in the opencv camera convention
VEHICLE_TO_OPENCV = np.float64([
    [0, -1, 0, 0],
    [0, 0, -1, 0],
    [1, 0, 0, 0],
    [0, 0, 0, 1],
])

CAMERA_IDS = "12345"  # FRONT, FRONT_LEFT, FRONT_RIGHT, SIDE_LEFT, SIDE_RIGHT


@dataclass
class CameraCalib:
    """One camera's calibration, decoded from the stored calib.json row."""
    size: tuple          # (W, H)
    K: np.ndarray        # 3x3 pinhole
    distortion: np.ndarray
    cam_to_car: np.ndarray  # 4x4

    @classmethod
    def from_json_row(cls, info):
        f1, f2, cx, cy, k1, k2, p1, p2, k3 = info["intrinsics"]
        return cls(size=(info["width"], info["height"]),
                   K=np.float64([(f1, 0, cx), (0, f2, cy), (0, 0, 1)]),
                   distortion=np.float64([k1, k2, p1, p2, k3]),
                   cam_to_car=np.float64(info["extrinsics"]).reshape(4, 4))


def _load_seq_calib(seq_dir):
    """calib.json -> {camera_id(str): CameraCalib}, or None if absent."""
    try:
        with open(osp.join(seq_dir, "calib.json")) as f:
            rows = json.load(f)
    except IOError:
        return None
    return {str(cam_id): CameraCalib.from_json_row(info)
            for cam_id, info in rows}


def _tfrecord_sequences(root):
    seqs = sorted(name for name in os.listdir(root)
                  if name.endswith(".tfrecord"))
    print(f">> found {len(seqs)} sequences in {root}")
    return seqs


# ---------------------------------------------------------------------------
# stage 1: tfrecord extraction (needs tensorflow + waymo_open_dataset)
# ---------------------------------------------------------------------------

def _iter_waymo_frames(filename):
    """Yield (context_name, calib_rows, {camera_id: raw view}) per frame."""
    import tensorflow.compat.v1 as tf
    from waymo_open_dataset import dataset_pb2 as open_dataset
    from waymo_open_dataset.utils import frame_utils

    for record in tf.data.TFRecordDataset(filename, compression_type=""):
        frame = open_dataset.Frame()
        frame.ParseFromString(bytearray(record.numpy()))
        (range_images, camera_projections,
         _seg, range_image_top_pose) = \
            frame_utils.parse_range_image_and_camera_projection(frame)

        calib_rows = [
            (cam.name, dict(width=cam.width, height=cam.height,
                            intrinsics=list(cam.intrinsic),
                            extrinsics=list(cam.extrinsic.transform)))
            for cam in frame.context.camera_calibrations]

        # lidar returns + the camera each point projects into
        points, cp_points = frame_utils.convert_range_image_to_point_cloud(
            frame, range_images, camera_projections, range_image_top_pose)
        points_all = np.concatenate(points, axis=0)
        cp_all = np.concatenate(cp_points, axis=0)

        views = {}
        for image in frame.images:
            hits = cp_all[..., 0] == image.name
            proj = cp_all[hits].astype(np.float32)
            views[image.name] = dict(
                img=np.asarray(tf.image.decode_jpeg(image.image)),
                pose=np.float64(image.pose.transform).reshape(4, 4),
                pixels=proj[..., 1:3].round().astype(np.int16),
                pts3d=points_all[hits],
                timestamp=image.pose_timestamp)
        yield frame.context.name, calib_rows, views


def extract_one_seq(db_root, output_dir, seq):
    """Dump one sequence's frames + calib under output_dir/<seq>."""
    import PIL.Image

    out_dir = osp.join(output_dir, seq)
    os.makedirs(out_dir, exist_ok=True)
    calib_path = osp.join(out_dir, "calib.json")
    if osp.isfile(calib_path):
        return  # resume: this sequence is complete

    calib_rows = None
    try:
        for f, (_name, rows, views) in enumerate(
                _iter_waymo_frames(osp.join(db_root, seq))):
            calib_rows = calib_rows or rows
            for cam_id, view in views.items():
                stem = osp.join(out_dir, f"{f:05d}_{cam_id}")
                PIL.Image.fromarray(view.pop("img")).save(stem + ".jpg")
                np.savez(stem + ".npz", **view)
    except RuntimeError:
        print(f"/!\\ Error with sequence {seq} /!\\", file=sys.stderr)
        return
    # written LAST: acts as the stage-1 completion marker
    with open(calib_path, "w") as f:
        json.dump(calib_rows, f)


def extract_frames(db_root, output_dir, workers=8):
    tmp = osp.join(output_dir, "tmp")
    parallel_map(extract_one_seq,
                 [(db_root, tmp, s) for s in _tfrecord_sequences(db_root)],
                 star_args=True, workers=workers)


# ---------------------------------------------------------------------------
# stage 2: rescale + sparse-depth rendering (numpy / PIL)
# ---------------------------------------------------------------------------

def _splat_sparse_depth(shape_hw, pix, z):
    """Scatter per-point depths into a zero-initialized (H, W) map."""
    H, W = shape_hw
    depth = np.zeros((H, W), np.float32)
    x, y = pix.T
    depth[y.clip(0, H - 1), x.clip(0, W - 1)] = z
    return depth


def _crop_one_frame(seq_dir, out_dir, stem, calib, resolution):
    cam = calib[stem[-1]]
    raw = np.load(osp.join(seq_dir, stem + ".npz"))

    # lidar points, vehicle frame -> this camera's opencv frame
    cam_pts = np.asarray(geotrf(
        VEHICLE_TO_OPENCV @ np.asarray(inv(cam.cam_to_car)), raw["pts3d"]))

    image = imread_cv2(osp.join(seq_dir, stem + ".jpg"))
    W0, H0 = cam.size
    long_edge = (resolution, 1) if W0 > H0 else (1, resolution)
    image, _, K2 = cropping.rescale_image_depthmap(
        image, None, cam.K, long_edge)
    image.save(osp.join(out_dir, stem + ".jpg"), quality=80)

    # re-project the stored pixel hits through the rescale homography
    W, H = image.size
    pix = np.asarray(geotrf(K2 @ np.linalg.inv(cam.K),
                            raw["pixels"].round().astype(np.float64)))
    depth = _splat_sparse_depth((H, W), pix.round().astype(np.int32),
                                cam_pts[:, 2])
    write_exr(osp.join(out_dir, stem + ".exr"), depth)

    cam2world = raw["pose"] @ cam.cam_to_car @ \
        np.linalg.inv(VEHICLE_TO_OPENCV)
    np.savez(osp.join(out_dir, stem + ".npz"), intrinsics=K2,
             cam2world=cam2world, distortion=cam.distortion)


def crop_one_seq(input_dir, output_dir, seq, resolution=512):
    seq_dir = osp.join(input_dir, seq)
    out_dir = osp.join(output_dir, seq)
    if osp.isfile(osp.join(out_dir, "00100_1.jpg")):
        return  # resume: this sequence is complete
    os.makedirs(out_dir, exist_ok=True)

    calib = _load_seq_calib(seq_dir)
    if calib is None:
        print(f"/!\\ Missing calib.json in sequence {seq} /!\\",
              file=sys.stderr)
        return
    for name in sorted(os.listdir(seq_dir)):
        if not name.endswith(".jpg"):
            continue
        stem = name[:-4]
        assert stem[-1] in CAMERA_IDS, f"bad camera id in {name}"
        _crop_one_frame(seq_dir, out_dir, stem, calib, resolution)


def make_crops(output_dir, workers=16):
    tmp = osp.join(output_dir, "tmp")
    parallel_map(crop_one_seq,
                 [(tmp, output_dir, s) for s in _tfrecord_sequences(tmp)],
                 star_args=True, workers=workers, front_num=0)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _stamp_pair_table(pairs_path, output_dir):
    """Check every paired image exists, then store the table alongside."""
    with np.load(pairs_path) as data:
        scenes, frames, pairs = (data["scenes"], data["frames"],
                                 data["pairs"])
    for scene_id, *img_ids in pairs:
        for im_id in img_ids:
            path = osp.join(output_dir, scenes[scene_id],
                            frames[im_id] + ".jpg")
            assert osp.isfile(path), f"Missing a file at {path}"
    np.savez(osp.join(output_dir, "waymo_pairs.npz"),
             scenes=scenes, frames=frames, pairs=pairs)


def crop_and_stamp(pairs_path, output_dir, workers=1):
    """Stages 2 and 3 on output_dir/tmp (stage 1's output), then tmp removed."""
    make_crops(output_dir, workers=workers)
    _stamp_pair_table(pairs_path, output_dir)
    shutil.rmtree(osp.join(output_dir, "tmp"))
    print("Done! all data generated at", output_dir)


def main(waymo_root, pairs_path, output_dir, workers=1):
    extract_frames(waymo_root, output_dir, workers=workers)
    crop_and_stamp(pairs_path, output_dir, workers=workers)


def get_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--waymo_dir", required=True)
    parser.add_argument("--precomputed_pairs", required=True)
    parser.add_argument("--output_dir", default="data/waymo_processed")
    parser.add_argument("--workers", type=int, default=1)
    return parser


if __name__ == "__main__":
    args = get_parser().parse_args()
    main(args.waymo_dir, args.precomputed_pairs, args.output_dir,
         workers=args.workers)
