"""The comparison that decides `correct`: what the timed path produced,
against the plain reference (`reference.py`), at the timed sizes, after
the window.

Numbers (each the worst over the views compared; a cell's limits file
names those it compares):
  pts3d_err  relative L2 distance of a pointmap (each view of each compared
             pair: pts3d, pts3d_in_other_view) from the reference's
  pts3d_rmse RMS over the pixels of a pointmap's distance from the
             reference's, in the model's units
  conf_err   relative L2 distance of the confidence's logit, log(conf - 1)
  conf_rmse  RMS of the confidence logit's distance
  head_pts3d_err, head_conf_err
             pts3d_err and conf_err of the heads alone: each head's outputs
             for one batch of the window against the reference's head on
             the decoder outputs the program handed that head
  head_stage_err
             the same of the stages of the head that run in its precision
             alone (the DPT head's act_postprocess blocks)
A non-finite output, a missing pair or a wrong shape reads as infinity.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def rel_l2(a, b):
    """||a - b|| / ||b|| over all but the first axis, per row (float64)."""
    a, b = a.double().flatten(1), b.double().flatten(1)
    err = (a - b).norm(dim=1) / b.norm(dim=1).clamp(min=1e-30)
    return torch.where(torch.isfinite(a).all(1), err, torch.full_like(err, math.inf))


def rms(a, b):
    """Per row, the RMS over the pixels of |a - b| (a pointmap's 3D distance,
    or a map's difference), float64."""
    d = (a.double() - b.double()).square()
    d = d.sum(-1) if d.dim() == 4 else d
    err = d.flatten(1).mean(1).sqrt()
    return torch.where(torch.isfinite(a).flatten(1).all(1), err, torch.full_like(err, math.inf))


def _rows(x, idx, device):
    """Rows `idx` of a prediction: a stacked array or tensor, or a list."""
    if isinstance(x, (list, tuple)):
        x = [x[i] for i in idx]
        x = [torch.as_tensor(np.asarray(t)) if not isinstance(t, torch.Tensor) else t
             for t in x]
        return torch.stack([t.to(device) for t in x]).float()
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return x[torch.as_tensor(idx, device=x.device)].to(device).float()


def encode_scene(ref, views, device, block):
    """The reference's encoder tokens and positions of a scene's images, by
    their `idx`."""
    imgs = torch.from_numpy(np.concatenate([v["img"] for v in views])).to(device)
    feats, poss = [], []
    for a in range(0, len(views), block):
        f, p = ref.encode(imgs[a:a + block])
        feats.append(f)
        poss.append(p)
    return torch.cat(feats), torch.cat(poss)


PAIR_NUMBERS = ("pts3d_err", "pts3d_rmse", "conf_err", "conf_rmse")


def compare_pairs(ref, pairs, out, pick, device, block=8):
    """{pts3d_err, pts3d_rmse, conf_err, conf_rmse} of pairs `pick` of a
    scene's output `out`."""
    worst = dict.fromkeys(PAIR_NUMBERS, 0.0)
    views = sorted({id(v): v for p in pairs for v in p}.values(), key=lambda v: v["idx"])
    if [v["idx"] for v in views] != list(range(len(views))):
        raise ValueError("a scene's views are indexed 0..n-1")
    H, W = views[0]["img"].shape[1:3]
    try:
        n_out = len(out["pred1"]["pts3d"])
    except (KeyError, TypeError):
        n_out = -1
    if n_out != len(pairs):
        return dict.fromkeys(PAIR_NUMBERS, math.inf)
    feats, poss = encode_scene(ref, views, device, block)
    for a in range(0, len(pick), block):
        idx = list(pick[a:a + block])
        i1 = torch.tensor([pairs[k][0]["idx"] for k in idx], device=device)
        i2 = torch.tensor([pairs[k][1]["idx"] for k in idx], device=device)
        r = ref.pairs(feats, poss, (H, W), i1, i2)
        got = (_rows(out["pred1"]["pts3d"], idx, device), _rows(out["pred1"]["conf"], idx, device),
               _rows(out["pred2"]["pts3d_in_other_view"], idx, device),
               _rows(out["pred2"]["conf"], idx, device))
        for n, (g, w) in enumerate(zip(got, r)):
            key = "pts3d" if n % 2 == 0 else "conf"
            if g.shape != w.shape:
                worst[key + "_err"] = worst[key + "_rmse"] = math.inf
                continue
            if n % 2:
                g, w = torch.log(g - 1), torch.log(w - 1)
            worst[key + "_err"] = max(worst[key + "_err"], float(rel_l2(g, w).max()))
            worst[key + "_rmse"] = max(worst[key + "_rmse"], float(rms(g, w).max()))
    return worst


def compare_heads(ref, taps, device, block=4):
    """{head_pts3d_err, head_conf_err, head_stage_err} of the batches a
    `run.HeadTap` kept: the heads alone, on the decoder outputs the program
    handed them."""
    worst = {}

    def worse(key, g, w):
        err = float(rel_l2(g, w).max()) if g.shape == w.shape else math.inf
        worst[key] = max(worst.get(key, 0.0), err)

    for t in taps:
        last = max(t["decout"])
        for a in range(0, len(t["pts3d"]), block):
            decout = [t["decout"][i][a:a + block].to(device) if i in t["decout"] else None
                      for i in range(last + 1)]
            want = ref.head(decout, t["shape"], t["head"])
            worse("head_pts3d_err", t["pts3d"][a:a + block].to(device), want[0])
            worse("head_conf_err", torch.log(t["conf"][a:a + block].to(device).float() - 1),
                  torch.log(want[1] - 1))
            if t["stages"]:
                stages = ref.act_postprocess(decout, t["shape"], t["head"])
                for name, w in zip(ref.head_stages(), stages):
                    worse("head_stage_err", t["stages"][name][a:a + block].to(device), w)
    return worst


def verdict(numbers, limits):
    """(correct, {name: {value, limit}}) of the numbers the limits name: each
    at most its limit; one that was not computed reads as infinity."""
    checks = {k: dict(value=numbers.get(k, math.inf), limit=limits[k]) for k in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
