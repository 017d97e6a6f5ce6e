#!/usr/bin/env python3
"""Offline ScanNet++ preprocessing: raw download -> loader format.

Counterpart of `datasets_preprocess/preprocess_scannetpp.py` (COLMAP model
parsing for the DSLR and iPhone captures, fisheye / radial undistortion to
a centred pinhole, depth rendered from the aligned mesh, per-scene metadata
concatenated into all_metadata.npz). `undistort_images` and the metadata
are numpy (`utils/cvops.py` for cv2's undistortion maps and remap); the
depth comes from a renderer object, `MeshRenderer` (pyrender and trimesh,
optional packages, imported when it is built) unless `process_scenes`
is given another with the same two methods.

    python -m dust3r_tpu_torch.datasets_preprocess.preprocess_scannetpp \\
        --scannetpp_dir RAW --precomputed_pairs PAIRS_DIR --output_dir OUT
"""
import argparse
import json
import os
import os.path as osp
import re

import numpy as np

from ..datasets.utils.cropping import rescale_image_depthmap
from ..utils import cvops
from ..utils.geometry import colmap_to_opencv_intrinsics, opencv_to_colmap_intrinsics
from ..visloc.datasets.base_colmap import pose_from_qwxyz_txyz

REGEXPR_DSLR = re.compile(r"^.*DSC(?P<frameid>\d+).JPG$")
REGEXPR_IPHONE = re.compile(r".*frame_(?P<frameid>\d+).jpg$")

OPENGL_TO_OPENCV = np.float32([[1, 0, 0, 0], [0, -1, 0, 0],
                               [0, 0, -1, 0], [0, 0, 0, 1]])


def get_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--scannetpp_dir", required=True)
    parser.add_argument("--precomputed_pairs", required=True)
    parser.add_argument("--output_dir", default="data/scannetpp_processed")
    parser.add_argument("--target_resolution", default=920, type=int)
    parser.add_argument("--pyopengl-platform", type=str, default="")
    return parser


def get_frame_number(name, cam_type="dslr"):
    regex = REGEXPR_DSLR if cam_type == "dslr" else REGEXPR_IPHONE
    m = re.match(regex, name)
    if m is None:
        raise ValueError(f"Invalid name {name}")
    return m["frameid"]


def load_sfm(sfm_dir, cam_type="dslr"):
    """COLMAP text model; intrinsics kept raw (type + params)."""
    with open(osp.join(sfm_dir, "cameras.txt")) as f:
        raw = f.read().splitlines()[3:]
    intrinsics = {}
    for camera in raw:
        camera = camera.split(" ")
        intrinsics[int(camera[0])] = [camera[1]] + \
            [float(c) for c in camera[2:]]

    with open(osp.join(sfm_dir, "images.txt")) as f:
        raw = [line for line in f.read().splitlines() if not line.startswith("#")]
    img_idx, img_infos = {}, {}
    for image, points in zip(raw[0::2], raw[1::2]):
        image = image.split(" ")
        idx = image[0]
        img_name = image[-1]
        for prefix in ("iphone/", "video/"):
            if img_name.startswith(prefix):
                img_name = img_name[len(prefix):]
        assert img_name not in img_idx, "duplicate db image: " + img_name
        img_idx[img_name] = idx
        img_infos[idx] = dict(
            intrinsics=intrinsics[int(image[-2])], path=img_name,
            frame_id=get_frame_number(img_name, cam_type),
            cam_to_world=pose_from_qwxyz_txyz(image[1:-2]))
    return img_idx, img_infos


def undistort_images(intrinsics, rgb, mask):
    """Fisheye or radial undistortion to a centered pinhole camera."""
    camera_type = intrinsics[0]
    width, height = int(intrinsics[1]), int(intrinsics[2])
    fx, fy, cx, cy = intrinsics[3:7]
    distortion = np.array(intrinsics[7:])

    K = np.zeros((3, 3))
    K[0, 0], K[1, 1] = fx, fy
    K[0, 2], K[1, 2] = cx, cy
    K[2, 2] = 1
    K = colmap_to_opencv_intrinsics(K)

    if camera_type == "OPENCV_FISHEYE":
        assert len(distortion) == 4
        new_K = cvops.fisheye_estimate_new_camera_matrix(
            K, distortion, (width, height), balance=0.0)
        new_K[0, 2] = width / 2.0
        new_K[1, 2] = height / 2.0
        map1, map2 = cvops.fisheye_init_undistort_rectify_map(
            K, distortion, new_K, (width, height))
    else:
        new_K = cvops.get_optimal_new_camera_matrix(
            K, distortion, (width, height), 1, (width, height))
        map1, map2 = cvops.init_undistort_rectify_map(
            K, distortion, new_K, (width, height))

    rgb_u = cvops.remap(rgb, map1, map2, cvops.INTER_LINEAR, cvops.BORDER_REFLECT_101)
    mask_u = cvops.remap(mask, map1, map2, cvops.INTER_LINEAR, cvops.BORDER_CONSTANT, 255)
    return width, height, opencv_to_colmap_intrinsics(new_K), rgb_u, mask_u


class MeshRenderer:
    """Metric depth of a scene's aligned mesh (scans/mesh_aligned_0.05.ply)
    through a pinhole, by pyrender (optional, with trimesh)."""

    znear, zfar = 0.05, 20.0

    def __init__(self):
        import pyrender

        self.pyrender = pyrender
        self.renderer = pyrender.OffscreenRenderer(0, 0)
        self.scene = None

    def load_scene(self, dir_scans):
        import trimesh
        import trimesh.exchange.ply

        with open(osp.join(dir_scans, "mesh_aligned_0.05.ply"), "rb") as f:
            mesh_scene = trimesh.Trimesh(**trimesh.exchange.ply.load_ply(f))
        mesh = self.pyrender.Mesh.from_trimesh(mesh_scene, smooth=False)
        self.scene = self.pyrender.Scene()
        self.scene.add(mesh)

    def render(self, K, W, H, cam_to_world):
        """Depth (H, W) in metres for COLMAP-convention intrinsics K."""
        self.renderer.viewport_width = W
        self.renderer.viewport_height = H
        camera = self.pyrender.camera.IntrinsicsCamera(
            K[0, 0], K[1, 1], K[0, 2], K[1, 2], znear=self.znear, zfar=self.zfar)
        cam_node = self.scene.add(camera, pose=cam_to_world @ OPENGL_TO_OPENCV)
        _, depth = self.renderer.render(self.scene,
                                        flags=self.pyrender.RenderFlags.SKIP_CULL_FACES)
        self.scene.remove_node(cam_node)
        return depth


def process_scenes(root, pairsdir, output_dir, target_resolution, renderer=None):
    """renderer: an object with load_scene(dir_scans) and render(K, W, H,
    cam_to_world) -> depth (metres); None builds a `MeshRenderer`."""
    import PIL.Image as Image

    os.makedirs(output_dir, exist_ok=True)

    with open(osp.join(pairsdir, "scene_list.json")) as f:
        scenes = json.load(f)

    renderer = MeshRenderer() if renderer is None else renderer
    for scene in scenes:
        data_dir = osp.join(root, "data", scene)
        dir_dslr = osp.join(data_dir, "dslr")
        dir_iphone = osp.join(data_dir, "iphone")
        dir_scans = osp.join(data_dir, "scans")

        out_scene = osp.join(output_dir, scene)
        meta_path = osp.join(out_scene, "scene_metadata.npz")
        if osp.isfile(meta_path):
            continue

        sel = np.load(osp.join(pairsdir, scene, "selected_pairs.npz"))
        selection, pairs = sel["selection"], sel["pairs"]

        out_rgb = osp.join(out_scene, "images")
        out_depth = osp.join(out_scene, "depth")
        os.makedirs(out_rgb, exist_ok=True)
        os.makedirs(out_depth, exist_ok=True)

        renderer.load_scene(dir_scans)

        img_idx_dslr, img_infos_dslr = load_sfm(
            osp.join(dir_dslr, "colmap"), cam_type="dslr")
        img_idx_iphone, img_infos_iphone = load_sfm(
            osp.join(dir_iphone, "colmap"), cam_type="iphone")

        sel_iphone = [n + ".jpg" for n in selection if "frame_" in n]
        sel_dslr = [n + ".JPG" for n in selection if "frame_" not in n]

        for sel_cam, img_idx, img_infos, rgb_dir, mask_dir in [
                (sel_dslr, img_idx_dslr, img_infos_dslr,
                 osp.join(dir_dslr, "resized_images"),
                 osp.join(dir_dslr, "resized_anon_masks")),
                (sel_iphone, img_idx_iphone, img_infos_iphone,
                 osp.join(dir_iphone, "rgb"),
                 osp.join(dir_iphone, "rgb_masks"))]:
            for imgname in sel_cam:
                info = img_infos[img_idx[imgname]]
                rgb = np.array(Image.open(osp.join(rgb_dir, info["path"])))
                mask = np.array(Image.open(
                    osp.join(mask_dir, info["path"][:-3] + "png")))

                _, _, K, rgb, mask = undistort_images(
                    info["intrinsics"], rgb, mask)
                K_cv = colmap_to_opencv_intrinsics(K)
                image, mask, K_cv = rescale_image_depthmap(
                    rgb, mask, K_cv,
                    (target_resolution, target_resolution * 3.0 / 4))
                W, H = image.size
                K = opencv_to_colmap_intrinsics(K_cv)
                info["intrinsics"] = K
                image.save(osp.join(out_rgb, info["path"][:-3] + "jpg"))

                # metric depth seen by the rescaled camera
                depth = renderer.render(K, W, H, info["cam_to_world"])
                depth = (depth * 1000).astype("uint16")
                depth[mask < 255] = 0
                Image.fromarray(depth).save(
                    osp.join(out_depth, info["path"][:-3] + "png"))

        trajectories, intrinsics = [], []
        for imgname in selection:
            if "frame_" in imgname:
                info = img_infos_iphone[img_idx_iphone[imgname + ".jpg"]]
            elif "DSC" in imgname:
                info = img_infos_dslr[img_idx_dslr[imgname + ".JPG"]]
            else:
                raise ValueError(f"invalid image name {imgname}")
            intrinsics.append(info["intrinsics"])
            trajectories.append(info["cam_to_world"])
        np.savez(meta_path, trajectories=np.stack(trajectories),
                 intrinsics=np.stack(intrinsics), images=selection,
                 pairs=pairs)

    # concat all scenes
    offset = 0
    counts, scene_names, sceneids = [], [], []
    images, intrinsics, trajectories, pairs = [], [], [], []
    for scene_idx, scene_subdir in enumerate(scenes):
        with np.load(osp.join(output_dir, scene_subdir,
                              "scene_metadata.npz")) as data:
            num_imgs = data["images"].shape[0]
            img_pairs = data["pairs"].copy()
            scene_names.append(scene_subdir)
            sceneids.extend([scene_idx] * num_imgs)
            images.append(data["images"])
            intrinsics.append(data["intrinsics"])
            trajectories.append(data["trajectories"])
            img_pairs[:, 0:2] += offset
            pairs.append(img_pairs)
            counts.append(offset)
            offset += num_imgs
    np.savez(osp.join(output_dir, "all_metadata.npz"),
             counts=counts, scenes=scene_names, sceneids=sceneids,
             images=np.concatenate(images, axis=0),
             intrinsics=np.concatenate(intrinsics, axis=0),
             trajectories=np.concatenate(trajectories, axis=0),
             pairs=np.concatenate(pairs, axis=0))
    print("all done")


if __name__ == "__main__":
    args = get_parser().parse_args()
    if args.pyopengl_platform.strip():
        os.environ["PYOPENGL_PLATFORM"] = args.pyopengl_platform
    process_scenes(args.scannetpp_dir, args.precomputed_pairs,
                   args.output_dir, args.target_resolution)
