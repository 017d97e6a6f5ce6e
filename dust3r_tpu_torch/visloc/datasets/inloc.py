"""InLoc visloc dataset (counterpart of `dust3r_tpu/visloc/datasets/inloc.py`).

kapture query and mapping records; each map view's depth cutout
(`XYZcut` of its `.mat` file, read by `scipy.io.loadmat`) aligned to its
scene by the DUC1 / DUC2 ICP transformations.
"""
from __future__ import annotations

import os

import numpy as np

from .base_dataset import BaseVislocDataset
from .sevenscenes import load_kdata
from ..utils import cam_to_world_from_kapture, get_resize_function, rescale_points3d
from ...cloud_opt.init_im_poses import pixel_grid
from ...datasets.utils.transforms import ImgNorm
from ...utils.geometry import geotrf


def read_alignments(path_to_alignment):
    """Parse InLoc's 'After general icp' 4x4 alignment of each scene."""
    aligns = {}
    with open(path_to_alignment, "r") as fid:
        while True:
            line = fid.readline()
            if not line:
                break
            if len(line) == 4:
                trans_nr = line[:-1]
                while line != "After general icp:\n":
                    line = fid.readline()
                line = fid.readline()
                p = []
                for _ in range(4):
                    elems = line.split(" ")
                    line = fid.readline()
                    p += [float(e) for e in elems if len(e)]
                aligns[trans_nr] = np.array(p).reshape(4, 4)
    return aligns


class VislocInLoc(BaseVislocDataset):
    def __init__(self, root, pairsfile, topk=1):
        super().__init__()
        from .base_colmap import get_ordered_pairs_from_file

        self.root = root
        self.topk = topk
        self.num_views = self.topk + 1
        self.query_data = load_kdata(self.root, "query")
        self.map_data = load_kdata(self.root, "mapping")

        pairs_path = os.path.join(self.root, "pairfiles/query", pairsfile + ".txt")
        try:
            self.pairs = get_ordered_pairs_from_file(pairs_path)
        except ValueError:  # hloc-format pairs
            self.pairs = {}
            with open(pairs_path) as fid:
                for line in fid:
                    splits = line.rstrip("\n\r").split(" ")
                    self.pairs.setdefault(splits[0].replace("query/", ""), []).append(
                        (splits[1].replace("database/cutouts/", ""), 1.0))

        self.scenes = self.query_data["kdata"].records_camera.data_list()
        self.aligns_DUC1 = read_alignments(os.path.join(
            self.root, "mapping/DUC1_alignment/all_transformations.txt"))
        self.aligns_DUC2 = read_alignments(os.path.join(
            self.root, "mapping/DUC2_alignment/all_transformations.txt"))

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, idx):
        import PIL.Image
        import scipy.io

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

            if kdata.trajectories is not None and (timestamp, camera_id) in kdata.trajectories:
                cam_to_world = cam_to_world_from_kapture(kdata, timestamp, camera_id)
            else:
                cam_to_world = np.eye(4, dtype=np.float32)

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
                matfile = os.path.join(imgpath, "sensors/records_data", imgname + ".mat")
                depthmap = scipy.io.loadmat(matfile)
                pt3d_cut = depthmap["XYZcut"]
                scene_id = imgname.replace("\\", "/").split("/")[1]
                aligns = self.aligns_DUC1 if imgname.startswith("DUC1") else self.aligns_DUC2
                pts3d_full = np.asarray(geotrf(aligns[scene_id], pt3d_cut))
                valid = np.isfinite(pts3d_full.sum(axis=-1))

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
