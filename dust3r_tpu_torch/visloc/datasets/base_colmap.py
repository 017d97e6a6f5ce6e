"""COLMAP-backed visloc datasets (Aachen, Cambridge).

Counterpart of `dust3r_tpu/visloc/datasets/base_colmap.py` (reference
dust3r_visloc/datasets/base_colmap.py): COLMAP text parsing (cameras,
images, points3D: plain Python), the pairsfile's retrieval lists, kapture
query records (kapture imported inside the functions that read them, as in
the JAX package), and per-view dicts with `rgb_rescaled`, the sparse
`pts3d_rescaled` and the 3x3 `to_orig` transform. Views carry HWC float
arrays, as the JAX package's do.

`_get_view_query` looks a query up in kapture and hands its camera model,
parameters and pose to `_query_view`, which builds the view; a caller that
holds its queries without kapture builds them through `_query_view` too.
"""
from __future__ import annotations

import collections
import os
import pickle

import numpy as np
import torch

from .base_dataset import BaseVislocDataset
from ..utils import get_resize_function, rescale_points3d
from ...datasets.utils.transforms import ImgNorm
from ...utils.geometry import colmap_to_opencv_intrinsics
from ...utils.pose import quat_to_rotmat

KaptureSensor = collections.namedtuple("Sensor", "sensor_params camera_params")


def kapture_to_opencv_intrinsics(sensor):
    """COLMAP / kapture camera params -> (K in OpenCV's convention,
    distortion [k1, k2, p1, p2], (w, h))."""
    sensor_type = sensor.sensor_params[0]
    p = sensor.camera_params
    if sensor_type == "SIMPLE_PINHOLE":
        w, h, f, cx, cy = p
        fx = fy = f
        k1 = k2 = p1 = p2 = 0
    elif sensor_type == "PINHOLE":
        w, h, fx, fy, cx, cy = p
        k1 = k2 = p1 = p2 = 0
    elif sensor_type == "SIMPLE_RADIAL":
        w, h, f, cx, cy, k1 = p
        fx = fy = f
        k2 = p1 = p2 = 0
    elif sensor_type == "RADIAL":
        w, h, f, cx, cy, k1, k2 = p
        fx = fy = f
        p1 = p2 = 0
    elif sensor_type == "OPENCV":
        w, h, fx, fy, cx, cy, k1, k2, p1, p2 = p
    else:
        raise NotImplementedError(f"Sensor type {sensor_type} not supported")

    K = np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    K = colmap_to_opencv_intrinsics(K)
    dist = np.asarray([k1, k2, p1, p2], np.float32)
    return K, dist, (w, h)


def K_from_colmap(elems):
    sensor = KaptureSensor(elems, tuple(map(float, elems[1:])))
    K, dist, (w, h) = kapture_to_opencv_intrinsics(sensor)
    return dict(resolution=(w, h), intrinsics=K, distortion=dist)


def pose_from_qwxyz_txyz(elems):
    """COLMAP images.txt pose (world2cam, wxyz quaternion) -> cam2world."""
    qw, qx, qy, qz, tx, ty, tz = map(float, elems)
    pose = np.eye(4)
    # float64 products rounded to fp32, as the JAX package's quat_to_rotmat
    # gives them for host floats
    R = quat_to_rotmat(torch.tensor([qx, qy, qz, qw], dtype=torch.float64))
    pose[:3, :3] = R.numpy().astype(np.float32)
    pose[:3, 3] = (tx, ty, tz)
    return np.linalg.inv(pose)


def _text_lines(path):
    with open(path) as f:
        return [line for line in f.read().splitlines() if not line.startswith("#")]


def read_colmap_text_model(sfm_dir):
    """Parse cameras.txt, images.txt and points3D.txt (plain Python).
    Returns ({image name: {resolution, intrinsics, distortion, path,
    camera_pose (cam2world), sparse_pts2d {point3D id: (x, y)}}},
    {point3D id: (x, y, z)})."""
    intrinsics = {}
    for camera in _text_lines(os.path.join(sfm_dir, "cameras.txt")):
        camera = camera.split(" ")
        intrinsics[int(camera[0])] = K_from_colmap(camera[1:])

    raw = _text_lines(os.path.join(sfm_dir, "images.txt"))
    img_infos = {}
    for image, points in zip(raw[0::2], raw[1::2]):
        image = image.split(" ")
        points = points.split(" ")
        img_name = image[-1]
        pts2d = {int(i): (float(x), float(y))
                 for i, x, y in zip(points[2::3], points[0::3], points[1::3]) if i != "-1"}
        img_infos[img_name] = dict(intrinsics[int(image[-2])], path=img_name,
                                   camera_pose=pose_from_qwxyz_txyz(image[1:-2]),
                                   sparse_pts2d=pts2d)

    points3D = {}
    for point in _text_lines(os.path.join(sfm_dir, "points3D.txt")):
        point = point.split()
        points3D[int(point[0])] = tuple(map(float, point[1:4]))
    return img_infos, points3D


def get_ordered_pairs_from_file(pairsfile_path):
    """Parse a retrieval pairsfile: 'query map [score]' lines ->
    {query: [(map, score), ...]} sorted by score, descending."""
    pairs = collections.defaultdict(list)
    with open(pairsfile_path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 2:
                continue
            q, m = parts[0], parts[1]
            score = float(parts[2]) if len(parts) > 2 else 0.0
            pairs[q].append((m, score))
    return {q: sorted(v, key=lambda x: -x[1]) for q, v in pairs.items()}


class BaseVislocColmapDataset(BaseVislocDataset):
    def __init__(self, image_path, map_path, query_path, pairsfile_path, topk=1,
                 cache_sfm=False):
        super().__init__()
        self.topk = topk
        self.num_views = self.topk + 1
        self.image_path = image_path
        self.cache_sfm = cache_sfm
        self._load_sfm(map_path)

        from kapture.io.csv import kapture_from_dir  # optional

        kdata_query = kapture_from_dir(query_path)
        if kdata_query.records_camera is None:
            raise ValueError(f"{query_path}: kapture data without camera records")
        searchindex = {kdata_query.records_camera[(t, s)]: (t, s)
                       for t, s in kdata_query.records_camera.key_pairs()}
        self.query_data = {"kdata": kdata_query, "searchindex": searchindex}
        self.pairs = get_ordered_pairs_from_file(pairsfile_path)
        self.scenes = kdata_query.records_camera.data_list()

    def _load_sfm(self, sfm_dir):
        cache = os.path.join(sfm_dir, "dust3r_tpu_cache.pkl")
        if self.cache_sfm and os.path.isfile(cache):
            with open(cache, "rb") as f:  # a cache this class wrote
                data = pickle.load(f)
            self.img_infos = data["img_infos"]
            self.points3D = data["points3D"]
            return
        self.img_infos, self.points3D = read_colmap_text_model(sfm_dir)
        if self.cache_sfm:
            with open(cache, "wb") as f:
                pickle.dump(dict(img_infos=self.img_infos, points3D=self.points3D), f)

    def __len__(self):
        return len(self.scenes)

    def _get_view_query(self, imgname):
        """The query's kapture record -> `_query_view`."""
        from kapture.core import CameraType

        from ..utils import cam_to_world_from_kapture

        kdata = self.query_data["kdata"]
        timestamp, camera_id = self.query_data["searchindex"][imgname]
        ctype = kdata.sensors[camera_id].camera_type
        models = {CameraType.SIMPLE_PINHOLE: "SIMPLE_PINHOLE",
                  CameraType.SIMPLE_RADIAL: "SIMPLE_RADIAL"}
        if ctype not in models:
            raise NotImplementedError(f"camera type {ctype}")
        if kdata.trajectories is not None and (timestamp, camera_id) in kdata.trajectories:
            cam_to_world = cam_to_world_from_kapture(kdata, timestamp, camera_id)
        else:
            cam_to_world = np.eye(4, dtype=np.float32)
        return self._query_view(imgname, models[ctype], kdata.sensors[camera_id].camera_params,
                                cam_to_world)

    def _query_view(self, imgname, camera_model, params, cam_to_world):
        """The query view of image `imgname` (under image_path) taken by a
        COLMAP `camera_model` ("SIMPLE_PINHOLE": W, H, f, cx, cy;
        "SIMPLE_RADIAL": W, H, f, cx, cy, k1) at `cam_to_world`."""
        import PIL.Image

        if camera_model == "SIMPLE_PINHOLE":
            W, H, f, cx, cy = params
            k1 = 0
        elif camera_model == "SIMPLE_RADIAL":
            W, H, f, cx, cy, k1 = params
        else:
            raise NotImplementedError(f"camera type {camera_model}")
        W, H = int(W), int(H)
        K = colmap_to_opencv_intrinsics(np.float32([(f, 0, cx), (0, f, cy), (0, 0, 1)]))
        distortion = [k1, 0, 0, 0]

        rgb_image = PIL.Image.open(os.path.join(self.image_path, imgname)).convert("RGB")
        resize_func, _, to_orig = get_resize_function(self.maxdim, self.patch_size, H, W)
        rgb_rescaled = resize_func(ImgNorm(rgb_image))  # HWC float

        return {"intrinsics": K, "distortion": distortion, "cam_to_world": cam_to_world,
                "rgb": rgb_image, "rgb_rescaled": rgb_rescaled, "to_orig": to_orig,
                "idx": 0, "image_name": imgname}

    def _get_view_map(self, imgname, idx):
        import PIL.Image

        infos = self.img_infos[imgname]
        rgb_image = PIL.Image.open(os.path.join(self.image_path, infos["path"])).convert("RGB")
        W, H = rgb_image.size
        K = colmap_to_opencv_intrinsics(infos["intrinsics"])

        pts2d_map = infos["sparse_pts2d"]
        sparse_pos2d = np.float32(list(pts2d_map.values())).reshape(-1, 2)
        sparse_pts3d = np.float32([self.points3D[i] for i in pts2d_map]).reshape(-1, 3)

        sparse_pos2d_cv2 = sparse_pos2d.copy()
        sparse_pos2d_cv2[:, 0] -= 0.5
        sparse_pos2d_cv2[:, 1] -= 0.5
        pos_int = sparse_pos2d_cv2.round().astype(np.int64)
        valid = ((pos_int[:, 0] >= 0) & (pos_int[:, 0] < W)
                 & (pos_int[:, 1] >= 0) & (pos_int[:, 1] < H))
        pos_int = pos_int[valid]
        pts3d = np.full((H, W, 3), np.nan, np.float32)
        pts3d[pos_int[:, 1], pos_int[:, 0]] = sparse_pts3d[valid]

        resize_func, to_resize, to_orig = get_resize_function(self.maxdim, self.patch_size, H, W)
        rgb_rescaled = resize_func(ImgNorm(rgb_image))
        HR, WR = rgb_rescaled.shape[:2]
        _, _, pts3d_rescaled, valid_rescaled = rescale_points3d(
            sparse_pos2d_cv2, sparse_pts3d, to_resize, HR, WR)

        return {"intrinsics": K, "distortion": infos["distortion"],
                "cam_to_world": infos["camera_pose"], "rgb": rgb_image, "pts3d": pts3d,
                "valid": np.isfinite(pts3d.sum(axis=-1)), "rgb_rescaled": rgb_rescaled,
                "pts3d_rescaled": pts3d_rescaled, "valid_rescaled": valid_rescaled,
                "to_orig": to_orig, "idx": idx, "image_name": imgname}

    def __getitem__(self, idx):
        if self.maxdim is None or self.patch_size is None:
            raise RuntimeError("call set_resolution(model) first")
        query_image = self.scenes[idx]
        map_images = [p[0] for p in self.pairs[query_image][:self.topk]]
        views = [self._get_view_query(query_image)]
        for n, map_image in enumerate(map_images):
            views.append(self._get_view_map(map_image, n + 1))
        return views
