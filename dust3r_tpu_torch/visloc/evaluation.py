"""Visloc metrics and the Long-Term Visual Localization export.

Counterpart of `dust3r_tpu/visloc/evaluation.py` (reference
dust3r_visloc/evaluation.py:15-65): the same strings and the same files,
byte for byte. Quaternions are written wxyz, the LTVL convention.
"""
from __future__ import annotations

import collections
import os

import numpy as np

from ..utils.pose import rotmat_to_quat

THRESHOLDS = [(0.1, 1), (0.25, 2), (0.5, 5), (5, 10)]


def get_pose_error(pr_camtoworld, gt_cam_to_world):
    """(translation error, angular error in degrees)."""
    pr = np.asarray(pr_camtoworld)
    gt = np.asarray(gt_cam_to_world)
    transl_err = float(np.linalg.norm(pr[:3, 3] - gt[:3, 3]))
    R = pr[:3, :3].T @ gt[:3, :3]
    cos = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    ang_err = float(np.degrees(np.arccos(cos)))
    return transl_err, ang_err


def aggregate_stats(info_str, pose_errors, angular_errors):
    """The stats line: medians, then the share of queries under each of
    THRESHOLDS (metres, degrees)."""
    stats = collections.Counter()
    median_pos_error = np.median(pose_errors)
    median_angular_error = np.median(angular_errors)
    out_str = (f"{info_str}: {len(pose_errors)} images - "
               f"{median_pos_error=}, {median_angular_error=}")
    for trl_thr, ang_thr in THRESHOLDS:
        for pe, ae in zip(pose_errors, angular_errors):
            stats[trl_thr, ang_thr] += (pe < trl_thr) and (ae < ang_thr)
    stats = {f"acc@{k[0]:g}m,{k[1]}deg": 100 * v / len(pose_errors) for k, v in stats.items()}
    for metric, perf in stats.items():
        out_str += f"  - {metric:12s}={float(perf):.3f}"
    return out_str


def export_results(output_dir, xp_label, query_names, poses_pred):
    """Write `<xp_label>_results.txt` (full query names) and
    `<xp_label>_ltvl.txt` (base names), one `name qw qx qy qz tx ty tz`
    world2cam line a query; a failed query (None) writes the identity."""
    if output_dir is None:
        return
    os.makedirs(output_dir, exist_ok=True)
    lines = ""
    lines_ltvl = ""
    for query_name, pr_c2w in zip(query_names, poses_pred):
        w2c = np.eye(4) if pr_c2w is None else np.linalg.inv(pr_c2w)
        q_xyzw = np.asarray(rotmat_to_quat(w2c[:3, :3]))
        q_wxyz = [q_xyzw[3], q_xyzw[0], q_xyzw[1], q_xyzw[2]]
        t = w2c[:3, 3]
        line_pose = list(map(float, q_wxyz)) + t.flatten().tolist()
        lines += " ".join(str(v) for v in [query_name] + line_pose) + "\n"
        shortname = os.path.basename(query_name)
        lines_ltvl += " ".join(str(v) for v in [shortname] + line_pose) + "\n"
    with open(os.path.join(output_dir, xp_label + "_results.txt"), "wt") as f:
        f.write(lines)
    with open(os.path.join(output_dir, xp_label + "_ltvl.txt"), "wt") as f:
        f.write(lines_ltvl)
