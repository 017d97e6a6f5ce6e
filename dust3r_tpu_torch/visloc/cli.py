"""Visual localization benchmark: counterpart of the root `visloc.py`.

    python -m dust3r_tpu_torch.visloc --dataset "VislocCambridgeLandmarks(...)" \\
        --weights ckpt.pth [--device cpu] [--output_dir out]

Per query (`localize_query`): the two-view network on (query, map view)
for each of its top-k map views, one `inference([pair], engine)` call a
map view at batch 1, as the root `visloc.py` runs it; the confidence threshold;
reciprocal 3D nearest neighbours; the matches lifted to the map's sparse
3D; the query's pixels taken back to its original resolution; RANSAC-PnP.
`localize_dataset` runs that over a dataset and returns the names, poses
and errors; `main` adds the LTVL export and the stats line that
`visloc.py` prints. The engine is the port's `InferenceEngine` on
`--device` (the CUDA card unless `--device cpu`; bf16 body and fp32 heads
on the card, fp32 on the CPU), the model comes from `from_pretrained`.
`--quantize int8` runs the transformer's projections on int8 operands;
`--serving` sets bf16 body, bf16 heads and `--quantize int8`, as the root
`visloc.py` does. `--mesh N` runs each map view's pair padded to a batch
of N over the first N cards (`InferenceEngine(mesh=)`), as `visloc.py`
does; more cards than are visible raises.
"""
from __future__ import annotations

import argparse
import math
import os
import random
import time

import numpy as np

from ..cloud_opt.init_im_poses import pixel_grid
from ..inference import inference
from ..utils.geometry import find_reciprocal_matches, geotrf
from .datasets import (VislocAachenDayNight, VislocCambridgeLandmarks,  # noqa: F401
                       VislocInLoc, VislocSevenScenes)
from .evaluation import aggregate_stats, export_results, get_pose_error
from .localization import ransac_pnp, run_pnp


def get_args_parser():
    parser = argparse.ArgumentParser(prog="python -m dust3r_tpu_torch.visloc")
    parser.add_argument("--dataset", type=str, required=True)
    parser_weights = parser.add_mutually_exclusive_group(required=True)
    parser_weights.add_argument("--weights", type=str, default=None)
    parser_weights.add_argument("--model_name", type=str,
                                choices=["DUSt3R_ViTLarge_BaseDecoder_512_dpt",
                                         "DUSt3R_ViTLarge_BaseDecoder_512_linear",
                                         "DUSt3R_ViTLarge_BaseDecoder_224_linear"])
    parser.add_argument("--confidence_threshold", type=float, default=3.0)
    parser.add_argument("--device", type=str, default=None,
                        help="where the model runs: the CUDA card unless 'cpu' is named")
    parser.add_argument("--pnp_mode", type=str, default="cv2",
                        choices=["cv2", "poselib", "pycolmap"])
    parser_reproj = parser.add_mutually_exclusive_group()
    parser_reproj.add_argument("--reprojection_error", type=float, default=5.0)
    parser_reproj.add_argument("--reprojection_error_diag_ratio", type=float, default=None)
    parser.add_argument("--pnp_max_points", type=int, default=100_000)
    parser.add_argument("--viz_matches", type=int, default=0)
    parser.add_argument("--quantize", type=str, default=None, choices=["int8"],
                        help="int8 serving mode: the transformer's projections on int8 "
                             "operands (ops/quant.py)")
    parser.add_argument("--serving", action="store_true",
                        help="the serving configuration: bf16 body, bf16 heads and "
                             "--quantize int8")
    parser.add_argument("--mesh", type=int, default=0,
                        help="shard inference over this many cards (0: one device, --device)")
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--output_label", type=str, default="")
    return parser


def localize_query(engine, views, conf_thr, pnp_mode, reprojection_error,
                   reprojection_error_diag_ratio, pnp_max_points, viz_matches=0,
                   viz_path_prefix=None, stats=None):
    """Estimate one query's pose from its top-k map views.

    With viz_matches > 0, draws that many reciprocal matches per map view,
    saved to {viz_path_prefix}_k.png (without a prefix nothing is drawn:
    the JAX version would show a window). `stats`, a dict, gathers host
    seconds of "inference", "matching" and "pnp", the lifted "matches"
    and, in the "cv2" mode, the RANSAC's "iterations" and "inliers".

    Returns (success, cam2world or None)."""
    stats = {} if stats is None else stats
    for key in ("inference", "matching", "pnp", "matches"):
        stats.setdefault(key, 0)
    query_view = views[0]
    map_views = views[1:]

    query_pts2d = []
    query_pts3d = []
    for map_view in map_views:
        imgs = []
        for idx, img in enumerate([query_view["rgb_rescaled"], map_view["rgb_rescaled"]]):
            imgs.append(dict(img=np.asarray(img, np.float32)[None],
                             true_shape=np.int32([img.shape[:2]]), idx=idx, instance=str(idx)))
        t0 = time.perf_counter()
        output = inference([tuple(imgs)], engine, verbose=False)
        t1 = time.perf_counter()
        stats["inference"] += t1 - t0
        pred1, pred2 = output["pred1"], output["pred2"]
        conf_masks = [np.asarray(pred1["conf"])[0] >= conf_thr,
                      (np.asarray(pred2["conf"])[0] >= conf_thr)
                      & np.asarray(map_view["valid_rescaled"])]
        pts3d = [np.asarray(pred1["pts3d"])[0], np.asarray(pred2["pts3d_in_other_view"])[0]]

        pts2d_list, pts3d_list = [], []
        for i in range(2):
            conf_i = conf_masks[i]
            H, W = imgs[i]["true_shape"][0]
            pts2d_list.append(pixel_grid(H, W)[conf_i])  # visloc.py's xy_grid(W, H)
            pts3d_list.append(pts3d[i][conf_i])

        PQ, PM = pts3d_list[0], pts3d_list[1]
        if len(PQ) == 0 or len(PM) == 0:
            stats["matching"] += time.perf_counter() - t1
            continue
        reciprocal_in_PM, nnM_in_PQ, num_matches = find_reciprocal_matches(PQ, PM)
        matches_im1 = pts2d_list[1][reciprocal_in_PM].astype(np.int64)
        matches_im0 = pts2d_list[0][nnM_in_PQ][reciprocal_in_PM]
        valid_pts3d = np.asarray(map_view["pts3d_rescaled"])[matches_im1[:, 1], matches_im1[:, 0]]

        # cv2 -> colmap -> original resolution -> cv2
        matches_im0 = matches_im0.astype(np.float64) + 0.5
        matches_im0 = np.asarray(geotrf(query_view["to_orig"], matches_im0, norm=True)) - 0.5

        if viz_matches > 0 and viz_path_prefix:
            from .utils import plot_matches

            # the map view's matches at its own original resolution
            m1_orig = np.asarray(geotrf(map_view["to_orig"], matches_im1.astype(np.float64) + 0.5,
                                        norm=True)) - 0.5
            plot_matches(query_view["rgb"], map_view["rgb"], matches_im0, m1_orig,
                         n_viz=viz_matches,
                         save_path=f"{viz_path_prefix}_{map_view.get('idx', 0)}.png")

        finite = np.isfinite(valid_pts3d.sum(axis=-1))
        if finite.any():
            query_pts3d.append(valid_pts3d[finite])
            query_pts2d.append(matches_im0[finite])
        stats["matching"] += time.perf_counter() - t1
        stats["matches"] += int(finite.sum())

    if len(query_pts2d) == 0:
        return False, None
    query_pts2d = np.concatenate(query_pts2d, axis=0).astype(np.float32)
    query_pts3d = np.concatenate(query_pts3d, axis=0)
    if len(query_pts2d) > pnp_max_points:
        idxs = random.sample(range(len(query_pts2d)), pnp_max_points)
        query_pts3d = query_pts3d[idxs]
        query_pts2d = query_pts2d[idxs]

    W, H = query_view["rgb"].size
    if reprojection_error_diag_ratio is not None:
        reproj = reprojection_error_diag_ratio * math.sqrt(W ** 2 + H ** 2)
    else:
        reproj = reprojection_error
    t0 = time.perf_counter()
    ransac_pnp.last_stats = {}
    result = run_pnp(query_pts2d, query_pts3d, query_view["intrinsics"],
                     query_view["distortion"], pnp_mode, reproj, img_size=[W, H])
    stats["pnp"] += time.perf_counter() - t0
    stats.update(ransac_pnp.last_stats)
    return result


def localize_dataset(engine, dataset, conf_thr=3.0, pnp_mode="cv2", reprojection_error=5.0,
                     reprojection_error_diag_ratio=None, pnp_max_points=100_000, viz_matches=0,
                     output_dir=None, queries=None, on_query=None):
    """`localize_query` over the dataset's queries (all, or the indices in
    `queries`). `on_query(name, success, cam2world, stats)` is called after
    each. Returns (query names, cam2world poses or None, translation errors,
    angular errors), a failed query's errors infinite."""
    query_names, poses_pred, pose_errors, angular_errors = [], [], [], []
    for idx in range(len(dataset)) if queries is None else queries:
        views = dataset[idx]
        query_view = views[0]
        query_names.append(query_view["image_name"])

        viz_prefix = None
        if viz_matches > 0 and output_dir:
            viz_dir = os.path.join(output_dir, "viz")
            os.makedirs(viz_dir, exist_ok=True)
            viz_prefix = os.path.join(viz_dir, query_view["image_name"].replace("/", "_"))
        stats = {}
        success, pr_c2w = localize_query(
            engine, views, conf_thr, pnp_mode, reprojection_error,
            reprojection_error_diag_ratio, pnp_max_points, viz_matches=viz_matches,
            viz_path_prefix=viz_prefix, stats=stats)

        if not success:
            te, ae = float("inf"), float("inf")
        else:
            te, ae = get_pose_error(pr_c2w, query_view["cam_to_world"])
        pose_errors.append(te)
        angular_errors.append(ae)
        poses_pred.append(pr_c2w)
        if on_query is not None:
            on_query(query_view["image_name"], success, pr_c2w, stats)
    return query_names, poses_pred, pose_errors, angular_errors


def main(argv=None):
    """What the root `visloc.py` does, on the port."""
    import torch

    from ..checkpoint import from_pretrained
    from ..inference import InferenceEngine, serving_overrides
    from ..utils.device import default_device

    from ..parallel.mesh import cli_pair_mesh

    args = get_args_parser().parse_args(argv)
    mesh, batch_size = cli_pair_mesh(args.mesh)
    device = torch.device(args.device) if args.device else \
        default_device("dust3r_tpu_torch.visloc (--device)")
    args.device = str(device)
    model = from_pretrained(args.weights or "naver/" + args.model_name, device=device,
                            **serving_overrides(args))
    # visloc.py's batch: one pair, or one a card with --mesh
    engine = InferenceEngine(model, batch_size=batch_size, quantize=args.quantize, mesh=mesh)

    dataset = eval(args.dataset)  # noqa: S307 - the reference's CLI DSL, in this module's names
    dataset.set_resolution(model)

    query_names, poses_pred, pose_errors, angular_errors = localize_dataset(
        engine, dataset, args.confidence_threshold, args.pnp_mode, args.reprojection_error,
        args.reprojection_error_diag_ratio, args.pnp_max_points, args.viz_matches,
        args.output_dir)

    xp_label = f"tol_conf_{args.confidence_threshold}"
    if args.output_label:
        xp_label = args.output_label + "_" + xp_label
    if args.reprojection_error_diag_ratio is not None:
        xp_label += f"_reproj_diag_{args.reprojection_error_diag_ratio}"
    else:
        xp_label += f"_reproj_err_{args.reprojection_error}"
    export_results(args.output_dir, xp_label, query_names, poses_pred)
    print(aggregate_stats(f"{args.dataset}", pose_errors, angular_errors))
    return 0
