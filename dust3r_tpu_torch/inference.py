"""Pairwise inference engine.

Counterpart of `dust3r_tpu/inference.py` (the reference's {view1, view2,
pred1, pred2} output dict):
  * each UNIQUE image is encoded exactly once per scene and its encoder
    tokens are reused by every pair it takes part in;
  * pairs are grouped by (shape1, shape2) bucket and padded to a fixed
    batch size; each batch gathers its features on the device
    (`index_select`) and runs decoder and heads;
  * predictions come back as numpy (`to_cpu=True`) or stay on the device;
  * `quantize="int8"` converts the model to the int8 serving mode
    (`ops/quant.py`) at construction, in place, unless it already holds
    `QuantLinear`s.
`encoder_batches` and `pair_batches` count the batches the engine ran.
`get_pred_pts3d` and `find_opt_scaling` decode and scale predictions for
the training losses (`dust3r_tpu/inference.py:295-369`).
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch


def _pad_batch(arrs, bs):
    """Stack (H, W, C) arrays and pad the batch up to bs with the last one."""
    x = np.stack(arrs, axis=0)
    if len(arrs) < bs:
        x = np.concatenate([x, np.repeat(x[-1:], bs - len(arrs), axis=0)])
    return x


class InferenceEngine:
    """Two-view inference over a scene graph with an AsymmetricCroCo3DStereo."""

    def __init__(self, model, batch_size=8, quantize=None):
        """quantize: None or "int8" (any other value raises, as in JAX)."""
        if quantize is not None:
            if quantize != "int8":
                raise ValueError(f"unsupported quantize mode {quantize!r}")
            from .ops.quant import is_quantized, quantize_for_inference

            if not is_quantized(model):
                quantize_for_inference(model)
        self.model = model.eval()
        self.batch_size = batch_size
        self.device = next(model.parameters()).device
        self.encoder_batches = 0
        self.pair_batches = 0

    @torch.inference_mode()
    def encode_views(self, views):
        """Encode unique view dicts once each.

        Returns ({id(view): (shape, slot)}, {shape: (feats, pos)}) with
        features stacked (U, S, D) per shape bucket.
        """
        unique = {}
        for v in views:
            unique.setdefault(id(v), v)
        by_shape = defaultdict(list)
        for key, v in unique.items():
            img = v["img"]
            if img.ndim != 4 or img.shape[0] != 1:
                raise ValueError(f"views hold (1, H, W, 3) images, got {tuple(img.shape)}")
            by_shape[tuple(img.shape[1:3])].append(key)

        bs = self.batch_size
        slots, stacked = {}, {}
        for shape, keys in by_shape.items():
            chunks_f, chunks_p = [], []
            for i in range(0, len(keys), bs):
                chunk = keys[i:i + bs]
                arrs = [unique[k]["img"] for k in chunk]
                if all(isinstance(a, torch.Tensor) for a in arrs):
                    imgs = torch.cat(arrs + arrs[-1:] * (bs - len(arrs)))
                else:
                    imgs = torch.from_numpy(_pad_batch([np.asarray(a)[0] for a in arrs], bs))
                f, pos = self.model.encode(imgs.to(self.device))
                self.encoder_batches += 1
                chunks_f.append(f[:len(chunk)])
                chunks_p.append(pos[:len(chunk)])
                for n, k in enumerate(chunk):
                    slots[k] = (shape, i + n)
            stacked[shape] = (torch.cat(chunks_f), torch.cat(chunks_p))
        return slots, stacked

    @torch.inference_mode()
    def infer_pairs(self, pairs, verbose=False, to_cpu=True):
        """Run the two-view model over a list of (view1, view2) dict pairs.

        Returns the reference-format output dict; predictions are numpy
        when to_cpu, else tensors on the device.
        """
        model = self.model
        views = [v for pair in pairs for v in pair]
        slots, stacked = self.encode_views(views)

        by_bucket = defaultdict(list)
        for n, (v1, v2) in enumerate(pairs):
            by_bucket[(tuple(v1["img"].shape[1:3]), tuple(v2["img"].shape[1:3]))].append(n)

        pred1 = [None] * len(pairs)
        pred2 = [None] * len(pairs)
        bs = self.batch_size
        for (s1, s2), idxs in by_bucket.items():
            feats1, pos1 = stacked[s1]
            feats2, pos2 = stacked[s2]
            parts1, parts2 = [], []
            for i in range(0, len(idxs), bs):
                chunk = idxs[i:i + bs]
                pad = bs - len(chunk)
                slot1 = [slots[id(pairs[n][0])][1] for n in chunk]
                slot2 = [slots[id(pairs[n][1])][1] for n in chunk]
                i1 = torch.tensor(slot1 + slot1[-1:] * pad, device=self.device)
                i2 = torch.tensor(slot2 + slot2[-1:] * pad, device=self.device)
                dec1, dec2 = model.decode(feats1.index_select(0, i1), pos1.index_select(0, i1),
                                          feats2.index_select(0, i2), pos2.index_select(0, i2))
                r1 = model.head(1, dec1, s1)
                r2 = model.head(2, dec2, s2)
                r2["pts3d_in_other_view"] = r2.pop("pts3d")
                self.pair_batches += 1
                parts1.append(r1)
                parts2.append(r2)

            total = len(idxs)  # concatenate once per bucket, trim the pad
            bucket1 = {k: torch.cat([p[k] for p in parts1])[:total] for k in parts1[0]}
            bucket2 = {k: torch.cat([p[k] for p in parts2])[:total] for k in parts2[0]}
            if to_cpu:
                bucket1 = {k: v.cpu().numpy() for k, v in bucket1.items()}
                bucket2 = {k: v.cpu().numpy() for k, v in bucket2.items()}
            if len(by_bucket) == 1:
                # uniform shapes: bucket order is pair order
                return dict(view1=_collate_views([p[0] for p in pairs], False, numpy=to_cpu),
                            view2=_collate_views([p[1] for p in pairs], False, numpy=to_cpu),
                            pred1=bucket1, pred2=bucket2)
            for m, n in enumerate(idxs):
                pred1[n] = {k: v[m] for k, v in bucket1.items()}
                pred2[n] = {k: v[m] for k, v in bucket2.items()}

        return collate_inference_output(pairs, pred1, pred2, True, numpy=to_cpu)


def serving_overrides(args):
    """The model's dtypes for the CLI's flags: the card runs the transformer
    body in bf16 (its kernels' type), the CPU in fp32; `--serving` sets the
    body and the heads to bf16 and `args.quantize` to "int8", as the JAX
    CLIs do."""
    on_card = torch.device(args.device).type == "cuda"
    overrides = dict(dtype=torch.bfloat16 if on_card else torch.float32)
    if args.serving:
        overrides.update(dtype=torch.bfloat16, head_dtype=torch.bfloat16)
        args.quantize = args.quantize or "int8"
    return overrides


def _collate_views(views, multiple_shapes, numpy=True):
    out = {}
    for k in views[0].keys():
        vals = [v[k] for v in views]
        if k == "img":
            if not numpy:
                out[k] = [v[0] for v in vals]
            else:
                vals = [np.asarray(v)[0] for v in vals]
                out[k] = vals if multiple_shapes else np.stack(vals)
        elif k == "true_shape":
            out[k] = np.concatenate([np.asarray(v) for v in vals])
        else:
            out[k] = list(vals)
    return out


def collate_inference_output(pairs, pred1, pred2, multiple_shapes, numpy=True):
    """Build the reference-format result dict: stacked arrays for uniform
    shapes, lists for mixed shapes; numpy=False keeps device tensors."""
    def collate_preds(preds):
        out = {}
        for k in preds[0].keys():
            vals = [p[k] for p in preds]
            if numpy:
                vals = [np.asarray(v) for v in vals]
            if multiple_shapes:
                out[k] = vals
            else:
                out[k] = np.stack(vals) if numpy else torch.stack(vals)
        return out

    return dict(
        view1=_collate_views([p[0] for p in pairs], multiple_shapes, numpy=numpy),
        view2=_collate_views([p[1] for p in pairs], multiple_shapes, numpy=numpy),
        pred1=collate_preds(pred1),
        pred2=collate_preds(pred2),
    )


def inference(pairs, model, batch_size=8, verbose=True):
    """Reference-compatible entry point. `model` is an InferenceEngine or
    an AsymmetricCroCo3DStereo (then an engine is built for this call)."""
    if verbose:
        print(f">> Inference with model on {len(pairs)} image pairs")
    engine = model if hasattr(model, "infer_pairs") else InferenceEngine(model, batch_size)
    return engine.infer_pairs(pairs, verbose=verbose)


# ---------------------------------------------------------------------- #
# prediction decoding for the losses
# ---------------------------------------------------------------------- #

def get_pred_pts3d(gt, pred, use_pose=False):
    """A prediction's pointmap: from depth and pseudo focal, from pts3d, or
    pts3d_in_other_view (use_pose must then be True); with use_pose, moved
    by pred's camera_pose."""
    from .utils.geometry import depthmap_to_pts3d, geotrf

    if "depth" in pred and "pseudo_focal" in pred:
        pp = gt["camera_intrinsics"][..., :2, 2] if "camera_intrinsics" in gt else None
        pts3d = depthmap_to_pts3d(pred["depth"], pred["pseudo_focal"], pp=pp)
    elif "pts3d" in pred:
        pts3d = pred["pts3d"]
    elif "pts3d_in_other_view" in pred:
        if use_pose is not True:
            raise ValueError("pts3d_in_other_view is already in the other view's frame")
        return pred["pts3d_in_other_view"]
    if use_pose:
        camera_pose = pred.get("camera_pose")
        if camera_pose is None:
            raise ValueError("use_pose needs pred['camera_pose']")
        pts3d = geotrf(camera_pose, pts3d)
    return pts3d


def find_opt_scaling(gt_pts1, gt_pts2, pr_pts1, pr_pts2=None,
                     fit_mode="weiszfeld_stop_grad", valid1=None, valid2=None):
    """Per-sample scale that fits the gt points onto the predictions (fit
    modes avg, median, weiszfeld; '_stop_grad' detaches it), clipped at
    1e-3; invalid pixels are masked out."""
    from .utils.geometry import masked_mean, masked_median

    if not gt_pts1.dim() == pr_pts1.dim() == 4:
        raise ValueError("want (B, H, W, 3) pointmaps")

    def flat(x):
        return x.reshape(x.shape[0], -1, 3)

    def flatm(m, like):
        if m is None:
            return torch.ones(like.shape[0], like.shape[1] * like.shape[2], dtype=torch.bool,
                              device=like.device)
        return m.reshape(m.shape[0], -1)

    all_gt, all_pr, mask = flat(gt_pts1), flat(pr_pts1), flatm(valid1, gt_pts1)
    if gt_pts2 is not None:
        all_gt = torch.cat([all_gt, flat(gt_pts2)], 1)
        all_pr = torch.cat([all_pr, flat(pr_pts2)], 1)
        mask = torch.cat([mask, flatm(valid2, gt_pts2)], 1)
    dot_gt_pr = (all_pr * all_gt).sum(-1)
    dot_gt_gt = (all_gt * all_gt).sum(-1)
    if fit_mode.startswith("avg") or fit_mode.startswith("weiszfeld"):
        scaling = masked_mean(dot_gt_pr, mask, dim=1) / masked_mean(dot_gt_gt, mask, dim=1)
        if fit_mode.startswith("weiszfeld"):
            for _ in range(10):
                dis = (all_pr - scaling[:, None, None] * all_gt).norm(dim=-1)
                w = 1.0 / dis.clamp(min=1e-8)
                scaling = (masked_mean(w * dot_gt_pr, mask, dim=1)
                           / masked_mean(w * dot_gt_gt, mask, dim=1))
    elif fit_mode.startswith("median"):
        scaling = masked_median(dot_gt_pr / dot_gt_gt.clamp(min=1e-12), mask, dim=1)
    else:
        raise ValueError(f"bad fit_mode {fit_mode}")
    if fit_mode.endswith("stop_grad"):
        scaling = scaling.detach()
    return scaling.clamp(min=1e-3)
