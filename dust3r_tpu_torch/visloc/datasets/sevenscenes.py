"""7-Scenes visloc dataset (counterpart of
`dust3r_tpu/visloc/datasets/sevenscenes.py`).

kapture query and mapping records; each map view's registered depth
(`.reg`) lifted to 3D by its depth, K and pose. kapture is imported inside
the methods, as in the JAX package.
"""
from __future__ import annotations

import os

import numpy as np

from .base_dataset import BaseVislocDataset
from ..utils import cam_to_world_from_kapture, get_resize_function, rescale_points3d
from ...cloud_opt.init_im_poses import pixel_grid
from ...datasets.utils.transforms import ImgNorm
from ...utils.geometry import depthmap_to_absolute_camera_coordinates


def load_kdata(root, split, remove_rigs=False):
    """{path, kdata, searchindex: image name -> (timestamp, sensor)} of one
    kapture split."""
    from kapture.io.csv import kapture_from_dir

    path = os.path.join(root, split)
    kdata = kapture_from_dir(path)
    if kdata.records_camera is None:
        raise ValueError(f"{path}: kapture data without camera records")
    if remove_rigs:
        import kapture

        if kdata.trajectories is None or kdata.rigs is None:
            raise ValueError(f"{path}: kapture data without trajectories or rigs")
        kapture.rigs_remove_inplace(kdata.trajectories, kdata.rigs)
    searchindex = {kdata.records_camera[(t, s)]: (t, s)
                   for t, s in kdata.records_camera.key_pairs()}
    return {"path": path, "kdata": kdata, "searchindex": searchindex}


class VislocSevenScenes(BaseVislocDataset):
    def __init__(self, root, subscene, pairsfile, topk=1):
        super().__init__()
        from .base_colmap import get_ordered_pairs_from_file

        self.root = root
        self.subscene = subscene
        self.topk = topk
        self.num_views = self.topk + 1
        self.query_data = load_kdata(os.path.join(root, subscene), "query", remove_rigs=True)
        self.map_data = load_kdata(os.path.join(root, subscene), "mapping", remove_rigs=True)
        self.pairs = get_ordered_pairs_from_file(
            os.path.join(self.root, subscene, "pairfiles/query", pairsfile + ".txt"))
        self.scenes = self.query_data["kdata"].records_camera.data_list()

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, idx):
        import PIL.Image
        from kapture.io.records import depth_map_from_file

        if self.maxdim is None or self.patch_size is None:
            raise RuntimeError("call set_resolution(model) first")
        query_image = self.scenes[idx]
        map_images = [p[0] for p in self.pairs[query_image][:self.topk]]
        views = []
        dataarray = [(query_image, self.query_data, False)] + \
            [(m, self.map_data, True) for m in map_images]
        for vidx, (imgname, data, load_depth) in enumerate(dataarray):
            imgpath = data["path"]
            kdata = data["kdata"]
            timestamp, camera_id = data["searchindex"][imgname]

            W, H, f, cx, cy = kdata.sensors[camera_id].camera_params
            intrinsics = np.float32([(f, 0, cx), (0, f, cy), (0, 0, 1)])
            cam_to_world = cam_to_world_from_kapture(kdata, timestamp, camera_id)

            rgb_image = PIL.Image.open(os.path.join(
                imgpath, "sensors/records_data", imgname)).convert("RGB")
            W, H = rgb_image.size
            resize_func, to_resize, to_orig = get_resize_function(self.maxdim, self.patch_size,
                                                                  H, W)
            rgb_rescaled = resize_func(ImgNorm(rgb_image))

            view = {"intrinsics": intrinsics, "distortion": [0, 0, 0, 0],
                    "cam_to_world": cam_to_world, "rgb": rgb_image,
                    "rgb_rescaled": rgb_rescaled, "to_orig": to_orig,
                    "idx": vidx, "image_name": imgname}

            if load_depth:
                depth_file = os.path.join(imgpath, "sensors/records_data",
                                          imgname.replace("color.png", "depth.reg"))
                depthmap = depth_map_from_file(depth_file, (int(W), int(H))).astype(np.float32)
                pts3d_full, valid = depthmap_to_absolute_camera_coordinates(
                    depthmap, intrinsics, cam_to_world)
                pts3d_full = np.asarray(pts3d_full)
                valid = np.asarray(valid)
                pts3d = pts3d_full[valid]
                pts2d = pixel_grid(H, W)[valid].astype(np.float64)
                pts3d_full[~valid] = np.nan
                view["pts3d"] = pts3d_full
                view["valid"] = np.isfinite(pts3d_full.sum(axis=-1))
                HR, WR = rgb_rescaled.shape[:2]
                _, _, pts3d_rescaled, valid_rescaled = rescale_points3d(
                    pts2d, pts3d, to_resize, HR, WR)
                view["pts3d_rescaled"] = pts3d_rescaled
                view["valid_rescaled"] = valid_rescaled
            views.append(view)
        return views
