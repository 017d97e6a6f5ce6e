"""Scene-graph container and shared accessors of the global aligner.

Counterpart of `dust3r_tpu/cloud_opt/base_opt.py`, with the card's layout
of the observations: one row per edge. `pred_i`/`pred_j` are (E, A, 3)
and `w_i`/`w_j` (E, A) in `obs_dtype` (bf16 by default, as in the JAX
package), A the largest image area, zero-padded with zero weights for
smaller images. With `obs_dtype="int8"` they are stored as the JAX package
stores them (symmetric max-abs scales: one a coordinate plane and edge for
the predictions, one an edge for the weights; `rint`, clipped to ±127),
with the same q and scales for every edge, and the loss dequantizes
`edge_chunk` edges at a time under activation checkpointing, so its fp32
temporaries, forward and backward, never exceed one chunk. The loss
gathers each edge's world points by image index and applies the edge's
sim(3) to all of them at once (`rigid_apply`);
distances are fp32 either way. It computes the JAX package's loss; the
JAX package's TPU layout (coordinate-planar observations grouped by image,
the edge-chunk scan) is not carried over: at 512x384, a few thousand edges
of bf16 observations fit the card's memory without chunking.

The observations are built on the scene's device from the predictions as
they come: device tensors from `InferenceEngine.infer_pairs(...,
to_cpu=False)` stay there, host numpy is copied once (to the CUDA card
unless a `device` is given). The init and the
confidence maps work on host copies (numpy), as in the JAX package. The
parameters are a dict of tensors on the device; the masks that freeze them
are host numpy.
"""
from __future__ import annotations

import copy
import math
import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..utils.device import default_device
from ..utils.geometry import geotrf, inv
from ..utils.image import rgb
from ..utils.pose import matrix_to_pose_vec, pose_vec_to_matrix
from .commons import (ALL_DISTS, compute_edge_scores, edge_str, get_conf_trf,
                      get_conf_trf_np, get_imshapes)


def _ravel_pad(arr, fill):
    """(H, W, ...) -> (H*W, ...) zero-padded to length `fill` (host)."""
    arr = np.asarray(arr, dtype=np.float32)
    flat = arr.reshape((arr.shape[0] * arr.shape[1],) + arr.shape[2:])
    if len(flat) < fill:
        flat = np.concatenate([flat, np.zeros((fill - len(flat),) + flat.shape[1:],
                                              np.float32)])
    return flat


def _per_edge(x, n):
    """Predictions arrive stacked (uniform shapes) or as lists (mixed), as
    numpy or as torch tensors: one entry per edge, and their host copies
    (one device-to-host copy for a stacked tensor)."""
    rows = list(x) if isinstance(x, (list, tuple)) else [x[k] for k in range(n)]
    if isinstance(x, torch.Tensor):
        host = x.detach().float().cpu().numpy()
        return rows, [host[k] for k in range(n)]
    return rows, [r.detach().float().cpu().numpy() if isinstance(r, torch.Tensor)
                  else np.asarray(r, np.float32) for r in rows]


def quantize_int8(rows, A):
    """Host float32 rows ((H, W, ...) each) -> (q int8 (E, A, ...), scale
    float32 (E, ...)): zero-padded to A, symmetric max-abs scales over A
    (one a coordinate plane for (H, W, 3) rows), `rint`, clipped to ±127;
    the JAX package's arithmetic (`dust3r_tpu/cloud_opt/base_opt.py:526-531`),
    so q and scales agree with its own for every edge. Non-negative rows
    (the weights) are quantized symmetrically too, as there."""
    g = np.stack([_ravel_pad(r, A) for r in rows])
    g = np.moveaxis(g, 1, -1)  # A last, as the JAX planes hold it
    s = np.maximum(np.abs(g).max(axis=-1), 1e-12) / 127.0
    q = np.rint(g / s[..., None]).clip(-127, 127).astype(np.int8)
    return np.ascontiguousarray(np.moveaxis(q, -1, 1)), s.astype(np.float32)


def dequantize(q, scale):
    """int8 (B, A, ...) times its scales (B, ...) -> float32."""
    return q.float() * scale.unsqueeze(1)


def rigid_apply(R, t, pts):
    """pts (B, A, 3) -> R pts + t per batch entry (R (B, 3, 3), t (B, 3)),
    as three broadcast multiply-adds in the JAX loss's order. Not a batched
    matmul: at k = 3 its backward's (3, A) x (A, 3) products fall to a cuBLAS
    kernel that took 17.7 ms of a 22.0 ms iteration at 30 edges of 512x384
    on an H100."""
    out = t[:, None, :] + pts[..., 0:1] * R[:, None, :, 0]
    out = out + pts[..., 1:2] * R[:, None, :, 1]
    return out + pts[..., 2:3] * R[:, None, :, 2]


def _scene_device(device, pts):
    """`device`, else the predictions' device when they are tensors, else
    the CUDA card (raises without one)."""
    if device is not None:
        return torch.device(device)
    first = pts[0] if isinstance(pts, (list, tuple)) else pts
    return first.device if isinstance(first, torch.Tensor) else default_device("global_aligner")


class BasePCOptimizer:
    """Graph of images (nodes) and pairwise predictions (edges).

    Parameters (the `params` dict of tensors on the scene's device):
      pw_poses    (E, 8)  per-edge sim(3): quat(4) + signed-log t(3) + log s
      pw_adaptors (E, 2)  per-edge xy/z scale adaptation (off by default)
    Subclasses add per-image params (depthmaps, poses, focals, pp).
    """

    POSE_DIM = 7

    def __init__(self, view1, view2, pred1, pred2, dist="l1", conf="log", min_conf_thr=3,
                 base_scale=0.5, allow_pw_adaptors=False, pw_break=20, rand_pose=None,
                 seed=0, verbose=True, obs_dtype=torch.bfloat16, edge_chunk=64, device=None,
                 mesh=None, **_ignored):
        if mesh is not None:
            raise NotImplementedError("the aligner's mesh path is not ported "
                                      "(ROADMAP.md, queue A item 10)")
        if obs_dtype in ("int8", torch.int8):
            obs_dtype = torch.int8
        elif obs_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"obs_dtype {obs_dtype}: observations are stored in bf16, fp32 "
                             f"or int8")
        self.verbose = verbose
        self.obs_dtype = obs_dtype
        self.obs_quant = obs_dtype == torch.int8
        self.edge_chunk = edge_chunk  # edges a dequantized chunk of int8 observations
        self.min_conf_thr = min_conf_thr
        self.base_scale = base_scale
        self.pw_break = pw_break
        self.norm_pw_scale = True
        self.has_im_poses = False
        self.dist = ALL_DISTS[dist]
        self.conf_trf = get_conf_trf(conf)
        self.conf_trf_np = get_conf_trf_np(conf)
        dev = self.device = _scene_device(device, pred1["pts3d"])

        idx1 = [int(i) for i in np.asarray(view1["idx"]).reshape(-1)]
        idx2 = [int(j) for j in np.asarray(view2["idx"]).reshape(-1)]
        self.edges = list(zip(idx1, idx2))
        self.is_symmetrized = set(self.edges) == {(j, i) for i, j in self.edges}
        self.n_imgs = self._check_edges()

        E = self.n_edges
        pred_i, host_pred_i = _per_edge(pred1["pts3d"], E)
        pred_j, host_pred_j = _per_edge(pred2["pts3d_in_other_view"], E)
        conf_i, host_conf_i = _per_edge(pred1["conf"], E)
        conf_j, host_conf_j = _per_edge(pred2["conf"], E)

        self.imshapes = get_imshapes(self.edges, host_pred_i, host_pred_j)
        self.im_areas = [h * w for h, w in self.imshapes]
        self.max_area = A = max(self.im_areas)

        # host copies of the raw predictions and confidences, for the init
        strs = self.str_edges
        self.pred_i = dict(zip(strs, host_pred_i))
        self.pred_j = dict(zip(strs, host_pred_j))
        self.conf_i = dict(zip(strs, host_conf_i))
        self.conf_j = dict(zip(strs, host_conf_j))

        # the observations, built on the device, zero-padded to A
        def padded(rows, fn=None):
            out = None
            for e, r in enumerate(rows):
                r = torch.as_tensor(r, device=dev).float()
                if fn is not None:
                    r = fn(r)
                if out is None:
                    out = torch.zeros((E, A) + r.shape[2:], dtype=obs_dtype, device=dev)
                out[e, :r.shape[0] * r.shape[1]] = r.flatten(0, 1)
            return out

        self.obs_scale = {}
        if self.obs_quant:
            # quantized on the host from host copies, as the JAX package does,
            # the weights through the numpy confidence transform
            w_i = [self.conf_trf_np(c) for c in host_conf_i]
            w_j = [self.conf_trf_np(c) for c in host_conf_j]
            for name, rows in (("pred_i", host_pred_i), ("pred_j", host_pred_j),
                               ("w_i", w_i), ("w_j", w_j)):
                q, scale = quantize_int8(rows, A)
                setattr(self, "obs_" + name, torch.from_numpy(q).to(dev))
                self.obs_scale[name] = torch.from_numpy(scale).to(dev)
        else:
            self.obs_pred_i = padded(pred_i)
            self.obs_pred_j = padded(pred_j)
            self.obs_w_i = padded(conf_i, self.conf_trf)
            self.obs_w_j = padded(conf_j, self.conf_trf)
        self.idx_i = torch.tensor(idx1, device=dev)
        self.idx_j = torch.tensor(idx2, device=dev)
        self.total_area_i = float(sum(self.im_areas[i] for i, j in self.edges))
        self.total_area_j = float(sum(self.im_areas[j] for i, j in self.edges))

        # per-image max-confidence maps (host)
        self.im_conf = self._compute_img_conf(host_conf_i, host_conf_j)

        # learnable pairwise pose parameters, drawn as the JAX package draws them
        rng = np.random.default_rng(seed)
        if rand_pose is None:
            def rand_pose(shape):
                return rng.standard_normal(shape).astype(np.float32)
        self.rand_pose = rand_pose
        self.params = {
            "pw_poses": torch.as_tensor(rand_pose((E, 1 + self.POSE_DIM)), device=dev),
            "pw_adaptors": torch.zeros((E, 2), device=dev),
        }
        self.masks = {
            "pw_poses": np.ones((E, 1 + self.POSE_DIM), np.float32),
            "pw_adaptors": np.full((E, 2), float(allow_pw_adaptors), np.float32),
        }

        # the display images ([0, 1] host numpy), where the views carry them
        self.imgs = None
        if "img" in view1 and "img" in view2:
            imgs = [None] * self.n_imgs
            _, host_img1 = _per_edge(view1["img"], E)
            _, host_img2 = _per_edge(view2["img"], E)
            for e in range(E):
                imgs[idx1[e]] = host_img1[e]
                imgs[idx2[e]] = host_img2[e]
            self.imgs = [rgb(im) for im in imgs]

    # ------------------------------------------------------------------ #
    # basic graph properties
    # ------------------------------------------------------------------ #

    @property
    def n_edges(self):
        return len(self.edges)

    @property
    def str_edges(self):
        return [edge_str(i, j) for i, j in self.edges]

    def state_dict(self, trainable=True):
        """trainable=True: the optimized parameters (host numpy); False: the
        frozen observation buffers and confidence maps."""
        if trainable:
            return {k: v.detach().cpu().numpy() for k, v in self.params.items()}
        obs = dict(pred_i=self.obs_pred_i, pred_j=self.obs_pred_j, w_i=self.obs_w_i,
                   w_j=self.obs_w_j)
        obs = {k: v.cpu().numpy() if self.obs_quant else v.float().cpu().numpy()
               for k, v in obs.items()}
        obs.update({k + "_scale": v.cpu().numpy() for k, v in self.obs_scale.items()})
        return dict(obs=obs, im_conf=[np.asarray(c) for c in self.im_conf])

    def load_state_dict(self, data):
        for k, v in data.items():
            if k in self.params:
                self.params[k] = torch.tensor(np.asarray(v), dtype=torch.float32,
                                              device=self.device)
        return self

    def _check_edges(self):
        indices = sorted({i for e in self.edges for i in e})
        assert indices == list(range(len(indices))), "bad pair indices: missing values"
        return len(indices)

    def _compute_img_conf(self, conf_i, conf_j):
        im_conf = [np.zeros(hw, np.float32) for hw in self.imshapes]
        for e, (i, j) in enumerate(self.edges):
            im_conf[i] = np.maximum(im_conf[i], conf_i[e])
            im_conf[j] = np.maximum(im_conf[j], conf_j[e])
        return im_conf

    def edge_scores(self):
        return compute_edge_scores(self.edges, [self.conf_i[s] for s in self.str_edges],
                                   [self.conf_j[s] for s in self.str_edges])

    # ------------------------------------------------------------------ #
    # pairwise pose access
    # ------------------------------------------------------------------ #

    def get_adaptors(self, params=None):
        """(sxy, sxy, sz) per edge."""
        p = (params or self.params)["pw_adaptors"]
        adapt = torch.cat([p[:, 0:1], p], dim=-1)
        if self.norm_pw_scale:
            adapt = adapt - adapt.mean(dim=1, keepdim=True)
        return (adapt / self.pw_break).exp()

    def get_pw_norm_scale_factor(self, params=None):
        if self.norm_pw_scale:
            p = (params or self.params)["pw_poses"]
            return (math.log(self.base_scale) - p[:, -1].mean()).exp()
        return torch.ones((), device=self.device)

    def get_pw_scale(self, params=None):
        p = (params or self.params)["pw_poses"]
        return p[:, -1].exp() * self.get_pw_norm_scale_factor(params)

    def get_pw_poses(self, params=None):
        """Per-edge sim(3) matrices (E, 4, 4): rotation and translation rows
        scaled by the edge's scale."""
        p = (params or self.params)["pw_poses"]
        RT = pose_vec_to_matrix(p[:, :self.POSE_DIM])
        scale = self.get_pw_scale(params)
        return torch.cat([RT[:, :3] * scale[:, None, None], RT[:, 3:]], dim=1)

    # ------------------------------------------------------------------ #
    # host-side parameter writes (init & presets)
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def _set_pose(self, name, idx, pose_or_R, T=None, scale=None, force=False):
        """Write a pose into params[name][idx] (respects the masks unless
        force)."""
        if not (self.masks[name][idx].any() or force):
            return
        pose_or_R = np.asarray(pose_or_R)
        if pose_or_R.shape == (4, 4):
            assert T is None
            M = pose_or_R
        else:
            M = np.eye(4, dtype=np.float32)
            M[:3, :3] = pose_or_R
            M[:3, 3] = np.asarray(T).reshape(3)
        vec = matrix_to_pose_vec(M, scale=scale)
        self.params[name][idx, :len(vec)] = torch.as_tensor(vec, dtype=torch.float32)

    def get_masks(self):
        return [c > self.min_conf_thr for c in self.im_conf]

    def get_conf(self, mode=None):
        trf = self.conf_trf_np if mode is None else get_conf_trf_np(mode)
        return [trf(c) for c in self.im_conf]

    # subclass responsibilities ----------------------------------------- #

    def depth_to_pts3d(self, params=None):
        raise NotImplementedError

    @torch.no_grad()
    def get_pts3d(self, raw=False, params=None):
        res = self.depth_to_pts3d(params)
        if not raw:
            res = [res[n, :h * w].reshape(h, w, 3) for n, (h, w) in enumerate(self.imshapes)]
        return res

    def get_im_poses(self):
        raise NotImplementedError

    def get_focals(self):
        raise NotImplementedError

    def get_principal_points(self):
        raise NotImplementedError

    def get_depthmaps(self, raw=False):
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # loss
    # ------------------------------------------------------------------ #

    def loss_fn(self, params=None):
        """Confidence-weighted 3D consistency over all edges: for each side,
        the distance between the world points of the side's image and the
        edge's prediction moved by its adaptor and sim(3), weighted and
        normalized by the side's total image area."""
        poses = self.get_pw_poses(params)
        adapt = self.get_adaptors(params)
        proj = self.depth_to_pts3d(params)  # (N, A, 3)

        def term(poses, adapt, proj, pred, w, idx):
            aligned = rigid_apply(poses[:, :3, :3], poses[:, :3, 3],
                                  adapt[:, None, :] * pred.float())
            return self.dist(proj.index_select(0, idx), aligned, w.float()).sum()

        def side(name, idx, total):
            pred, w = getattr(self, "obs_pred_" + name), getattr(self, "obs_w_" + name)
            if not self.obs_quant:
                return term(poses, adapt, proj, pred, w, idx) / total
            return self._chunked_term(term, poses, adapt, proj, pred, w, idx,
                                      self.obs_scale["pred_" + name],
                                      self.obs_scale["w_" + name]) / total

        return (side("i", self.idx_i, self.total_area_i)
                + side("j", self.idx_j, self.total_area_j))

    def _chunked_term(self, term, poses, adapt, proj, q_pred, q_w, idx, s_pred, s_w):
        """The sum of `term` over edge chunks of int8 observations, each
        dequantized alone; under autograd each chunk is checkpointed (its
        dequantized observations and temporaries are recomputed in the
        backward, not kept), so the fp32 temporaries never exceed one
        chunk's."""
        def chunk(poses, adapt, proj, q_pred, q_w, idx, s_pred, s_w):
            return term(poses, adapt, proj, self.dequantize(q_pred, s_pred),
                        self.dequantize(q_w, s_w), idx)

        total = 0.0
        for a in range(0, self.n_edges, self.edge_chunk):
            e = slice(a, a + self.edge_chunk)
            args = (poses[e], adapt[e], proj, q_pred[e], q_w[e], idx[e], s_pred[e], s_w[e])
            if torch.is_grad_enabled():
                total = total + checkpoint(chunk, *args, use_reentrant=False)
            else:
                total = total + chunk(*args)
        return total

    dequantize = staticmethod(dequantize)

    @torch.no_grad()
    def forward(self):
        return float(self.loss_fn())

    __call__ = forward

    # ------------------------------------------------------------------ #
    # main entry point
    # ------------------------------------------------------------------ #

    def compute_global_alignment(self, init=None, niter_PnP=10, **kw):
        """Init (None, 'mst' or 'known_poses'), then the Adam loop of
        `optimizer.global_alignment_loop` (kw: lr, niter, schedule, lr_min).
        Returns the final loss; `self.seconds` holds the host seconds of the
        init and of the loop (which ends waiting for the device)."""
        from . import init_im_poses as init_fun

        t0 = time.perf_counter()
        if init is None:
            pass
        elif init in ("msp", "mst"):
            init_fun.init_minimum_spanning_tree(self, niter_PnP=niter_PnP)
        elif init == "known_poses":
            init_fun.init_from_known_poses(self, min_conf_thr=self.min_conf_thr,
                                           niter_PnP=niter_PnP)
        else:
            raise ValueError(f"bad value for init={init!r}")

        from .optimizer import global_alignment_loop

        t1 = time.perf_counter()
        loss = global_alignment_loop(self, **kw)
        self.seconds = dict(init=t1 - t0, align=time.perf_counter() - t1)
        return loss

    # ------------------------------------------------------------------ #
    # post-processing
    # ------------------------------------------------------------------ #

    def mask_sky(self):
        """A shallow copy whose confidence maps are zero on the sky
        (`viz.segment_sky` of each image); the observations are shared."""
        from ..viz import segment_sky

        if self.imgs is None:
            raise ValueError("mask_sky needs the scene's images (views with 'img')")
        res = copy.copy(self)
        res.im_conf = [np.array(c, copy=True) for c in self.im_conf]
        for i in range(self.n_imgs):
            res.im_conf[i] = np.where(segment_sky(self.imgs[i]), 0.0, res.im_conf[i])
        return res

    def get_dense_pts3d(self):
        """(pointmaps, depthmaps, confidence maps) per image."""
        return self.get_pts3d(), self.get_depthmaps(), [np.asarray(c) for c in self.im_conf]

    def show(self, **kw):
        raise NotImplementedError("show needs trimesh, which the port does not carry "
                                  "(ROADMAP.md, queue A item 4)")

    def clean_pointcloud(self, tol=0.001, bad_conf=0, max_bad_conf=None):
        """Lower the confidence of points occluded by more confident geometry
        in other views (host numpy, per source image over every other
        camera)."""
        assert 0 <= tol < 1
        K = self.get_intrinsics().cpu().numpy()
        cams = inv(self.get_im_poses().cpu().numpy())  # world2cam
        depthmaps = [d.cpu().numpy() for d in self.get_depthmaps()]
        all_pts3d = [p.cpu().numpy() for p in self.get_pts3d()]
        res = [c.copy() for c in self.im_conf]
        for i, pts3d in enumerate(all_pts3d):
            for j in range(self.n_imgs):
                if i == j:
                    continue
                Hj, Wj = self.imshapes[j]
                proj = geotrf(cams[j], pts3d)  # (H, W, 3) in cam j
                z = proj[..., 2]
                uv = geotrf(K[j], proj, norm=1, ncol=2)
                u = np.round(uv[..., 0]).astype(np.int64)
                v = np.round(uv[..., 1]).astype(np.int64)
                msk = (z > 0) & (u >= 0) & (u < Wj) & (v >= 0) & (v < Hj)
                uc, vc = np.clip(u, 0, Wj - 1), np.clip(v, 0, Hj - 1)
                bad = msk & (z < (1 - tol) * depthmaps[j][vc, uc]) & (res[i] < res[j][vc, uc])
                res[i] = np.where(bad, np.minimum(res[i], bad_conf), res[i])
        self.im_conf = res
        return self
