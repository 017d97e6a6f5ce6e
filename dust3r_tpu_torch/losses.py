"""Training losses: confidence-weighted 3D regression and its DSL.

Counterpart of `dust3r_tpu/losses.py`. As there, every loss is computed
densely and reduced with masked means (the same numbers as the reference's
boolean indexing, with static shapes); detail dicts hold 0-dim tensors.
The DSL of the reference's command lines holds:

    ConfLoss(Regr3D(L21, norm_mode='avg_dis'), alpha=0.2)
    Regr3D_ScaleShiftInv(L21, gt_scale=True)
    loss_a + 0.1 * loss_b

In a data-parallel step each rank holds a slice of the batch; inside
`global_batch(group)` every batch-wide masked mean (`batch_mean`: the
pixel losses' mean, ConfLoss's, Regr3D's details) is the mean over the
valid pixels of the whole batch across the ranks, as JAX's sharded step
computes it on its global batch: the valid count is all-reduced (no
gradient) and each rank's masked sum is scaled by world_size / count, so
DistributedDataParallel's average of the ranks' gradients is the gradient
of the global mean, and the mean of the ranks' losses its value. (The
reference's DDP averages each rank's own mean instead, which differs
wherever the ranks' valid counts do: ROADMAP.md §C.)
"""
from __future__ import annotations

import contextlib
import copy

import torch
import torch.distributed as dist

from .inference import get_pred_pts3d
from .utils.geometry import (geotrf, get_joint_pointcloud_center_scale,
                             get_joint_pointcloud_depth, masked_mean, normalize_pointcloud)


class _GlobalBatch:
    """The ranks of `group` share one batch: each mask's valid count is
    all-reduced once (cached by the mask tensor's identity while the
    context lasts)."""

    def __init__(self, group):
        self.group = group
        self.world_size = dist.get_world_size(group)
        self.counts = []

    def count(self, mask, dtype):
        for m, d, c in self.counts:
            if m is mask and d == dtype:
                return c
        c = mask.detach().to(dtype).sum()
        dist.all_reduce(c, group=self.group)
        self.counts.append((mask, dtype, c))
        return c


_GLOBAL_BATCH = None


@contextlib.contextmanager
def global_batch(group=None):
    """Within: `batch_mean` is the mean over the batch of every rank of
    `group` (torch.distributed's default group for None)."""
    global _GLOBAL_BATCH
    prev, _GLOBAL_BATCH = _GLOBAL_BATCH, _GlobalBatch(group)
    try:
        yield
    finally:
        _GLOBAL_BATCH = prev


def batch_mean(x, mask):
    """The mean of x over the batch's valid pixels, 0 where none is: this
    process's batch (`masked_mean`), or inside `global_batch` the ranks'
    whole batch, as world_size / global count times this rank's masked
    sum."""
    if _GLOBAL_BATCH is None:
        return masked_mean(x, mask)
    count = _GLOBAL_BATCH.count(mask, x.dtype)
    return (x * mask.to(x.dtype)).sum() * (_GLOBAL_BATCH.world_size / count.clamp(min=1e-8))


class BaseCriterion:
    def __init__(self, reduction="mean"):
        self.reduction = reduction


class LLoss(BaseCriterion):
    """A pixelwise distance; 'mean' averages over the mask, 'sum' sums over
    it, 'none' returns the dense map."""

    def __call__(self, a, b, mask=None):
        dist = self.distance(a, b)
        if self.reduction == "none":
            return dist
        if mask is None:
            mask = torch.ones_like(dist, dtype=torch.bool)
        if self.reduction == "sum":
            total = torch.where(mask, dist, torch.zeros_like(dist)).sum()
            # the ranks' whole batch: DDP's average of world_size x each sum
            return total if _GLOBAL_BATCH is None else total * _GLOBAL_BATCH.world_size
        if self.reduction == "mean":
            return batch_mean(dist, mask)
        raise ValueError(f"bad reduction {self.reduction}")

    def distance(self, a, b):
        raise NotImplementedError


class L21Loss(LLoss):
    """Euclidean distance between 3D points, with a gradient at 0."""

    def distance(self, a, b):
        return (a - b).square().sum(-1).clamp(min=1e-16).sqrt()

    def __repr__(self):
        return "L21Loss()"


L21 = L21Loss()


class MultiLoss:
    """`loss_a + 0.1 * loss_b`: a flat list of (weight, leaf) terms; a call
    sums the weighted leaf values and merges their detail dicts (each leaf's
    unweighted value under its name when it returns a bare scalar)."""

    def compute_loss(self, *args, **kw):
        raise NotImplementedError

    def get_name(self):
        raise NotImplementedError

    def _terms(self):
        return [(1, self)]

    def __mul__(self, alpha):
        if not isinstance(alpha, (int, float)):
            raise TypeError(f"a loss is weighted by a number, not {alpha!r}")
        return _WeightedSum([(alpha * w, leaf) for w, leaf in self._terms()])

    __rmul__ = __mul__

    def __add__(self, other):
        if not isinstance(other, MultiLoss):
            raise TypeError(f"a loss adds to a loss, not {other!r}")
        return _WeightedSum(self._terms() + other._terms())

    def __repr__(self):
        return " + ".join(leaf.get_name() if w == 1 else f"{w:g}*{leaf.get_name()}"
                          for w, leaf in self._terms())

    def __call__(self, *args, **kw):
        total = None
        details = {}
        for weight, leaf in self._terms():
            out = leaf.compute_loss(*args, **kw)
            if isinstance(out, tuple):
                value, d = out
            elif getattr(out, "ndim", 0) == 0:
                value, d = out, {leaf.get_name(): out}
            else:
                value, d = out, {}
            if isinstance(value, tuple):
                # per-pixel output (reduction='none'): a lone, unweighted term
                if not (weight == 1 and len(self._terms()) == 1):
                    raise ValueError("per-pixel losses cannot be weighted or summed")
                total = value
            else:
                term = weight * value
                total = term if total is None else total + term
            details.update(d)
        return total, details


class _WeightedSum(MultiLoss):
    def __init__(self, terms):
        self.terms = list(terms)

    def _terms(self):
        return self.terms


class Criterion:
    def __init__(self, criterion=None):
        if not isinstance(criterion, BaseCriterion):
            raise TypeError(f"{criterion} is not a proper criterion!")
        self.criterion = copy.copy(criterion)

    def get_name(self):
        return f"{type(self).__name__}({self.criterion})"

    def with_reduction(self, mode="none"):
        """A copy with every leaf's reduction set to `mode`."""
        res = copy.deepcopy(self)
        for _, leaf in res._terms():
            leaf.criterion.reduction = mode
        return res


class Regr3D(Criterion, MultiLoss):
    """3D regression in view1's camera frame, both sides normalized by
    their mean distance (norm_mode), the gt left at its scale with
    gt_scale."""

    def __init__(self, criterion, norm_mode="avg_dis", gt_scale=False):
        Criterion.__init__(self, criterion)
        MultiLoss.__init__(self)
        self.norm_mode = norm_mode
        self.gt_scale = gt_scale

    def get_all_pts3d(self, gt1, gt2, pred1, pred2, dist_clip=None):
        in_camera1 = torch.linalg.inv(gt1["camera_pose"])
        gt_pts1 = geotrf(in_camera1, gt1["pts3d"])
        gt_pts2 = geotrf(in_camera1, gt2["pts3d"])
        valid1, valid2 = gt1["valid_mask"], gt2["valid_mask"]
        if dist_clip is not None:
            valid1 = valid1 & (gt_pts1.norm(dim=-1) <= dist_clip)
            valid2 = valid2 & (gt_pts2.norm(dim=-1) <= dist_clip)
        pr_pts1 = get_pred_pts3d(gt1, pred1, use_pose=False)
        pr_pts2 = get_pred_pts3d(gt2, pred2, use_pose=True)
        if self.norm_mode:
            pr_pts1, pr_pts2 = normalize_pointcloud(pr_pts1, pr_pts2, self.norm_mode,
                                                    valid1, valid2)
        if self.norm_mode and not self.gt_scale:
            gt_pts1, gt_pts2 = normalize_pointcloud(gt_pts1, gt_pts2, self.norm_mode,
                                                    valid1, valid2)
        return gt_pts1, gt_pts2, pr_pts1, pr_pts2, valid1, valid2, {}

    def compute_loss(self, gt1, gt2, pred1, pred2, **kw):
        gt_pts1, gt_pts2, pred_pts1, pred_pts2, mask1, mask2, monitoring = \
            self.get_all_pts3d(gt1, gt2, pred1, pred2, **kw)
        l1 = self.criterion(pred_pts1, gt_pts1, mask1)
        l2 = self.criterion(pred_pts2, gt_pts2, mask2)
        name = type(self).__name__
        if self.criterion.reduction == "none":
            details = {name + "_pts3d_1": batch_mean(l1, mask1),
                       name + "_pts3d_2": batch_mean(l2, mask2)}
            return ((l1, mask1), (l2, mask2)), {**details, **monitoring}
        details = {name + "_pts3d_1": l1, name + "_pts3d_2": l2}
        return l1 + l2, {**details, **monitoring}


class ConfLoss(MultiLoss):
    """conf · err − alpha · log(conf), averaged over the valid pixels of
    each view (0 where none is valid)."""

    def __init__(self, pixel_loss, alpha=1):
        super().__init__()
        if not alpha > 0:
            raise ValueError(f"alpha must be positive, got {alpha}")
        self.alpha = alpha
        self.pixel_loss = pixel_loss.with_reduction("none")

    def get_name(self):
        return f"ConfLoss({self.pixel_loss})"

    def compute_loss(self, gt1, gt2, pred1, pred2, **kw):
        ((loss1, msk1), (loss2, msk2)), details = self.pixel_loss(gt1, gt2, pred1, pred2, **kw)
        conf1, conf2 = pred1["conf"], pred2["conf"]
        conf_loss1 = batch_mean(loss1 * conf1 - self.alpha * torch.log(conf1), msk1)
        conf_loss2 = batch_mean(loss2 * conf2 - self.alpha * torch.log(conf2), msk2)
        return conf_loss1 + conf_loss2, {"conf_loss_1": conf_loss1, "conf_loss2": conf_loss2,
                                         **details}


def _shift_z(pts, shift):
    return torch.cat([pts[..., :2], pts[..., 2:] - shift[..., None]], -1)


class Regr3D_ShiftInv(Regr3D):
    """Regr3D invariant to a global depth shift (joint median z)."""

    def get_all_pts3d(self, gt1, gt2, pred1, pred2):
        gt_pts1, gt_pts2, pred_pts1, pred_pts2, mask1, mask2, monitoring = \
            super().get_all_pts3d(gt1, gt2, pred1, pred2)
        gt_shift = get_joint_pointcloud_depth(gt_pts1[..., 2], gt_pts2[..., 2], mask1,
                                              mask2)[:, None, None]
        pred_shift = get_joint_pointcloud_depth(pred_pts1[..., 2], pred_pts2[..., 2], mask1,
                                                mask2)[:, None, None]
        return (_shift_z(gt_pts1, gt_shift), _shift_z(gt_pts2, gt_shift),
                _shift_z(pred_pts1, pred_shift), _shift_z(pred_pts2, pred_shift), mask1, mask2,
                monitoring)


class Regr3D_ScaleInv(Regr3D):
    """Regr3D with median-distance scale matching; gt_scale puts the
    predictions at the gt's scale."""

    def get_all_pts3d(self, gt1, gt2, pred1, pred2):
        gt_pts1, gt_pts2, pred_pts1, pred_pts2, mask1, mask2, monitoring = \
            super().get_all_pts3d(gt1, gt2, pred1, pred2)
        _, gt_scale = get_joint_pointcloud_center_scale(gt_pts1, gt_pts2, mask1, mask2)
        _, pred_scale = get_joint_pointcloud_center_scale(pred_pts1, pred_pts2, mask1, mask2)
        pred_scale = pred_scale.clamp(1e-3, 1e3)
        if self.gt_scale:
            pred_pts1 = pred_pts1 * (gt_scale / pred_scale)
            pred_pts2 = pred_pts2 * (gt_scale / pred_scale)
        else:
            gt_pts1, gt_pts2 = gt_pts1 / gt_scale, gt_pts2 / gt_scale
            pred_pts1, pred_pts2 = pred_pts1 / pred_scale, pred_pts2 / pred_scale
        return gt_pts1, gt_pts2, pred_pts1, pred_pts2, mask1, mask2, monitoring


class Regr3D_ScaleShiftInv(Regr3D_ScaleInv, Regr3D_ShiftInv):
    """The shift first, then the scale (the reference's MRO)."""


CRITERION_NAMES = ("L21", "Regr3D", "ConfLoss", "Regr3D_ShiftInv", "Regr3D_ScaleInv",
                   "Regr3D_ScaleShiftInv")


def build_criterion(criterion_str):
    """Evaluate the criterion DSL in a namespace of the loss names and
    `inf`, with no builtins."""
    import math

    namespace = {"__builtins__": {}, "inf": math.inf}
    namespace.update({name: globals()[name] for name in CRITERION_NAMES})
    return eval(criterion_str, namespace)  # noqa: S307 - restricted namespace
