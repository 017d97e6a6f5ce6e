"""PointCloudOptimizer and the Adam loop of the global aligner.

Counterpart of `dust3r_tpu/cloud_opt/optimizer.py`. The loop is Adam with
b1 = b2 = 0.9 and eps 1e-8, written out as `optax.scale_by_adam` computes
it, on the scene's dict of parameter tensors; frozen entries get their
gradient multiplied by 0. It runs eagerly on the scene's device and does not
wait for it: the per-iteration losses stay there and are copied to the host
once, at the end. (The JAX package runs the same steps as jitted scans of
100 iterations, a workaround for a remote-execution deadline that the card
does not have.)
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.geometry import xy_grid
from ..utils.pose import pose_vec_to_matrix
from .base_opt import BasePCOptimizer, _ravel_pad, rigid_apply
from .commons import make_lr_schedule

ADAM_B1 = ADAM_B2 = 0.9
ADAM_EPS = 1e-8


class PointCloudOptimizer(BasePCOptimizer):
    """Adds per-image learnables: log-depthmaps, 7-dof poses, log-focals
    (scaled by focal_break), optional principal points."""

    def __init__(self, *args, optimize_pp=False, focal_break=20, fx_and_fy=False, **kwargs):
        super().__init__(*args, **kwargs)
        self.has_im_poses = True
        self.focal_break = focal_break
        self.optimize_pp = optimize_pp
        self.n_focals = 2 if fx_and_fy else 1

        N, A, dev = self.n_imgs, self.max_area, self.device
        rng = np.random.default_rng(1)
        depth_init = np.stack([
            _ravel_pad(rng.standard_normal(hw).astype(np.float32) / 10 - 3, A)
            for hw in self.imshapes])
        self.params.update({
            "im_depthmaps": torch.as_tensor(depth_init, device=dev),  # log depth, (N, A)
            "im_poses": torch.as_tensor(self.rand_pose((N, self.POSE_DIM)), device=dev),
            "im_focals": torch.tensor([[focal_break * np.log(max(hw))] * self.n_focals
                                       for hw in self.imshapes], dtype=torch.float32,
                                      device=dev),
            "im_pp": torch.zeros((N, 2), device=dev),
        })
        self.masks.update({
            "im_depthmaps": np.ones((N, A), np.float32),
            "im_poses": np.ones((N, self.POSE_DIM), np.float32),
            "im_focals": np.ones((N, self.n_focals), np.float32),
            "im_pp": np.full((N, 2), float(optimize_pp), np.float32),
        })
        self.pp_base = torch.tensor([(w / 2, h / 2) for h, w in self.imshapes],
                                    dtype=torch.float32, device=dev)
        # (N, A, 2) pixel grids, zero-padded like the depthmaps
        self.grid = torch.as_tensor(np.stack([_ravel_pad(xy_grid(w, h).numpy(), A)
                                              for h, w in self.imshapes]), device=dev)

    # ------------------------------------------------------------------ #
    # presets (known poses / intrinsics)
    # ------------------------------------------------------------------ #

    def _get_msk_indices(self, msk):
        if msk is None:
            return list(range(self.n_imgs))
        if isinstance(msk, int):
            return [msk]
        msk = np.asarray(msk)
        if msk.dtype == bool:
            assert len(msk) == self.n_imgs
            return list(np.where(msk)[0])
        return [int(i) for i in msk.reshape(-1)]

    def _freeze(self, name, indices):
        self.masks[name][np.asarray(indices, dtype=np.int64)] = 0.0

    def _check_all_imgs_are_selected(self, msk):
        """Presets must cover every image ('incomplete mask!', as the
        reference); partial presets are the Modular variant's."""
        assert np.array_equal(np.asarray(self._get_msk_indices(msk)),
                              np.arange(self.n_imgs)), "incomplete mask!"

    @staticmethod
    def _check_counts_match(idxs, values, what):
        assert len(values) == len(idxs), (
            f"{len(values)} {what} given for {len(idxs)} selected images")

    def preset_pose(self, known_poses, pose_msk=None):
        self._check_all_imgs_are_selected(pose_msk)
        idxs = self._get_msk_indices(pose_msk)
        known_poses = np.asarray(known_poses)
        if known_poses.ndim == 2:
            known_poses = known_poses[None]
        self._check_counts_match(idxs, known_poses, "poses")
        for idx, pose in zip(idxs, known_poses):
            if self.verbose:
                print(f" (setting pose #{idx} = {pose[:3, 3]})")
            self._set_pose("im_poses", idx, pose, force=True)
        # every pose known: the absolute scale is pinned
        self.norm_pw_scale = False
        self._freeze("im_poses", idxs)

    def preset_focal(self, known_focals, msk=None):
        self._check_all_imgs_are_selected(msk)
        idxs = self._get_msk_indices(msk)
        self._check_counts_match(idxs, known_focals, "focals")
        for idx, focal in zip(idxs, known_focals):
            if self.verbose:
                print(f" (setting focal #{idx} = {focal})")
            self._set_focal(idx, focal, force=True)
        self._freeze("im_focals", idxs)

    def preset_principal_point(self, known_pp, msk=None):
        self._check_all_imgs_are_selected(msk)
        idxs = self._get_msk_indices(msk)
        known_pp = np.asarray(known_pp).reshape(-1, 2)
        self._check_counts_match(idxs, known_pp, "principal points")
        for idx, pp in zip(idxs, known_pp):
            if self.verbose:
                print(f" (setting principal point #{idx} = {pp})")
            self._set_principal_point(idx, pp, force=True)
        self._freeze("im_pp", idxs)

    def preset_intrinsics(self, known_K, msk=None):
        known_K = np.asarray(known_K)
        if known_K.ndim == 2:
            known_K = known_K[None]
        self.preset_focal([K.diagonal()[:2].mean() for K in known_K], msk)
        self.preset_principal_point([K[:2, 2] for K in known_K], msk)

    # ------------------------------------------------------------------ #
    # parameter writes
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def _set_focal(self, idx, focal, force=False):
        if self.masks["im_focals"][idx].any() or force:
            # degenerate pointmaps can give a focal ~ 0 (Weiszfeld on noise):
            # clamped so the log stays finite
            vals = np.atleast_1d(np.asarray(focal, np.float64))
            self.params["im_focals"][idx] = torch.as_tensor(
                self.focal_break * np.log(np.maximum(vals, 1e-4)), dtype=torch.float32)

    @torch.no_grad()
    def _set_principal_point(self, idx, pp, force=False):
        if self.masks["im_pp"][idx].any() or force:
            h, w = self.imshapes[idx]
            self.params["im_pp"][idx] = torch.as_tensor(
                (np.asarray(pp) - (w / 2, h / 2)) / 10, dtype=torch.float32)

    @torch.no_grad()
    def _set_depthmap(self, idx, depth, force=False):
        depth = np.asarray(depth, np.float32)
        logd = np.log(depth, out=np.zeros_like(depth), where=depth > 0)  # <= 0 -> 0
        if self.masks["im_depthmaps"][idx].any() or force:
            self.params["im_depthmaps"][idx] = torch.as_tensor(
                _ravel_pad(logd.reshape(self.imshapes[idx]), self.max_area))

    # ------------------------------------------------------------------ #
    # accessors
    # ------------------------------------------------------------------ #

    def get_focals(self, params=None):
        """(N, 1), or (N, 2) with fx_and_fy."""
        return ((params or self.params)["im_focals"] / self.focal_break).exp()

    def get_known_focal_mask(self):
        return ~self.masks["im_focals"][:, 0].astype(bool)

    def get_principal_points(self, params=None):
        return self.pp_base + 10 * (params or self.params)["im_pp"]

    @torch.no_grad()
    def get_intrinsics(self):
        focals = self.get_focals()
        K = torch.zeros((self.n_imgs, 3, 3), device=self.device)
        K[:, 0, 0] = focals[:, 0]
        K[:, 1, 1] = focals[:, -1]  # == fx when a single focal is stored
        K[:, :2, 2] = self.get_principal_points()
        K[:, 2, 2] = 1
        return K

    def get_im_poses(self, params=None):
        return pose_vec_to_matrix((params or self.params)["im_poses"])

    def get_depthmaps(self, raw=False, params=None):
        d = (params or self.params)["im_depthmaps"].exp()
        if raw:
            return d
        return [d[n, :h * w].reshape(h, w) for n, (h, w) in enumerate(self.imshapes)]

    def depth_to_pts3d(self, params=None):
        """(N, A, 3) world points: exp(log-depth) back-projected through
        focal and principal point, moved by the image's pose."""
        params = params or self.params
        focals = self.get_focals(params)
        pp = self.get_principal_points(params)
        T = pose_vec_to_matrix(params["im_poses"])
        depth = params["im_depthmaps"].exp()
        rel = torch.stack([depth * (self.grid[..., 0] - pp[:, :1]) / focals[:, :1],
                           depth * (self.grid[..., 1] - pp[:, 1:2]) / focals[:, -1:],
                           depth], dim=-1)
        return rigid_apply(T[:, :3, :3], T[:, :3, 3], rel)


def adam_step(params, grads, masks, mu, nu, step, lr):
    """One Adam(b1 = b2 = 0.9, eps 1e-8) update in place, as
    `optax.scale_by_adam` computes it, the gradients masked first; `step`
    counts from 1."""
    c1 = 1 - ADAM_B1 ** step
    c2 = 1 - ADAM_B2 ** step
    for k, g in grads.items():
        g = g * masks[k]
        mu[k].mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
        nu[k].mul_(ADAM_B2).add_(g * g, alpha=1 - ADAM_B2)
        params[k].sub_(lr * (mu[k] / c1) / ((nu[k] / c2).sqrt() + ADAM_EPS))


def global_alignment_loop(scene, lr=0.01, niter=300, schedule="cosine", lr_min=1e-6):
    """Run the alignment on the scene's device; returns the final loss
    (float). `scene.last_losses` holds the loss of every iteration."""
    if not any(m.any() for m in scene.masks.values()):
        return float("nan")
    if scene.verbose:
        print("Global alignment - optimizing for:")
        print([k for k, m in scene.masks.items() if m.any()])
    lrs = make_lr_schedule(schedule, niter, lr, lr_min)
    params = scene.params
    masks = {k: torch.as_tensor(m, device=scene.device) for k, m in scene.masks.items()}
    mu = {k: torch.zeros_like(p) for k, p in params.items()}
    nu = {k: torch.zeros_like(p) for k, p in params.items()}
    losses = torch.zeros(niter, device=scene.device)
    names = list(params)
    for p in params.values():
        p.requires_grad_(True)
    try:
        for it in range(niter):
            loss = scene.loss_fn(params)
            grads = torch.autograd.grad(loss, [params[k] for k in names])
            with torch.no_grad():
                losses[it] = loss
                adam_step(params, dict(zip(names, grads)), masks, mu, nu, it + 1,
                          float(lrs[it]))
    finally:
        for p in params.values():
            p.requires_grad_(False)
    scene.last_losses = losses.cpu().numpy()  # the loop's one wait for the device
    final = scene.forward()
    if scene.verbose:
        print(f" final loss = {final:g}")
    return final


class ModularPointCloudOptimizer(PointCloudOptimizer):
    """Not ported yet (ROADMAP.md, queue A item 4)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("ModularPointCloudOptimizer is not ported yet "
                                  "(ROADMAP.md, queue A item 4)")
