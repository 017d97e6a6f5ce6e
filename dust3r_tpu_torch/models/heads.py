"""Prediction heads: linear (pixel-shuffle) and DPT, plus the postprocess.

Counterpart of `dust3r_tpu/models/heads.py`, with the reference's torch
tensor names (`proj`, `dpt.act_postprocess.*`, `dpt.scratch.*`,
`dpt.head.*`). Heads compute in the dtype of the tokens they are given
(the model's `head_dtype`: fp32 by default, bf16 in the serving
configuration; every conv casts its weights to it, as the JAX heads run at
their `dtype`), and the postprocess always in fp32. The DPT trunk's tensors
are NCHW-shaped in `torch.channels_last` memory (NHWC, the layout of the
JAX heads and of the kernels; the tokens reshape into it with no copy).
Three dispatchers carry it, each to its CUDA kernel for CUDA tensors by
default: 19 of its 20 stride-1 3x3 convolutions are `Conv3x3` modules
through `ops/conv3x3.py`, its five 2x upsamples `Upsample2x` modules
through `ops/upsample.py`, and its tail (the last 3x3 conv, the ReLU, the
1x1 conv and the postprocess) is one `ops/dpt_tail.py` call that reads the
`dpt.head.2` and `dpt.head.4` modules' weights. The model's `conv_impl`
goes to all three; each takes fp32 or bf16 (the kernels' bf16 modes).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv3x3 import conv3x3 as conv3x3_op
from ..ops.conv3x3 import pack_weight
from ..ops.dpt_tail import dpt_tail as dpt_tail_op
from ..ops.dpt_tail import kernel_conf_vmin, pack_w2
from ..ops.upsample import up2x as up2x_op

Mode = Tuple[str, float, float]


def reg_dense_depth(xyz, mode: Mode):
    """Raw xyz channels to 3D points; ('exp', -inf, inf) in every published
    config: direction * expm1(norm)."""
    mode_name, vmin, vmax = mode
    if not (vmin == -math.inf and vmax == math.inf):
        raise ValueError("bounded depth modes are not used by any published config")
    if mode_name == "linear":
        return xyz
    d = xyz.norm(dim=-1, keepdim=True)
    xyz = xyz / d.clamp(min=1e-8)
    if mode_name == "square":
        return xyz * d.square()
    if mode_name == "exp":
        return xyz * torch.expm1(d)
    raise ValueError(f"bad depth mode {mode_name}")


def reg_dense_conf(x, mode: Mode):
    """Raw channel to confidence."""
    mode_name, vmin, vmax = mode
    if mode_name == "exp":
        return vmin + torch.clamp(x.exp(), max=vmax - vmin)
    if mode_name == "sigmoid":
        return (vmax - vmin) * torch.sigmoid(x) + vmin
    raise ValueError(f"bad conf mode {mode_name}")


def postprocess(fmap, depth_mode: Mode, conf_mode):
    """fmap: (B, H, W, 3[+1]) NHWC raw head output -> dict(pts3d[, conf])."""
    res = dict(pts3d=reg_dense_depth(fmap[..., 0:3], depth_mode))
    if conf_mode is not None:
        res["conf"] = reg_dense_conf(fmap[..., 3], conf_mode)
    return res


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` computed in its input's dtype (weight and bias cast to
    it): the DPT head's 1x1 and stride-2 convs, on cuDNN."""

    def forward(self, x):
        dt = x.dtype
        return self._conv_forward(x, self.weight.to(dt),
                                  None if self.bias is None else self.bias.to(dt))


class ConvTranspose2d(nn.ConvTranspose2d):
    """`nn.ConvTranspose2d` (kernel = stride, no padding) computed in its
    input's dtype, on cuDNN."""

    def forward(self, x):
        dt = x.dtype
        return F.conv_transpose2d(x, self.weight.to(dt),
                                  None if self.bias is None else self.bias.to(dt),
                                  self.stride, self.padding, self.output_padding, self.groups,
                                  self.dilation)


class LinearPts3d(nn.Module):
    """Per-token linear projection to a (patch x patch) block of 3D points,
    in the tokens' dtype, then upcast to fp32 for the postprocess; the JAX
    rearrange 'b (h w) (c ph pw) -> b (h ph) (w pw) c' is a pixel_shuffle."""

    def __init__(self, patch_size, depth_mode, conf_mode, has_conf=True,
                 dim_in=768):
        super().__init__()
        self.patch_size = patch_size
        self.depth_mode = depth_mode
        self.conf_mode = conf_mode if has_conf else None
        self.proj = nn.Linear(dim_in, (3 + int(has_conf)) * patch_size ** 2)

    def forward(self, decout, img_shape):
        H, W = img_shape
        p = self.patch_size
        x = decout[-1]
        feat = F.linear(x, self.proj.weight.to(x.dtype),
                        self.proj.bias.to(x.dtype)).float()  # (B, S, nch*p*p)
        B = feat.shape[0]
        feat = feat.transpose(1, 2).reshape(B, -1, H // p, W // p)
        feat = F.pixel_shuffle(feat, p).permute(0, 2, 3, 1)
        return postprocess(feat, self.depth_mode, self.conf_mode)


class Upsample2x(nn.Module):
    """Bilinear 2x upsample with align_corners=True (NCHW-shaped, channels_last
    memory) through the up2x dispatcher. `impl` is the dispatcher's."""

    def __init__(self, impl=None):
        super().__init__()
        self.impl = impl

    def forward(self, x):
        return up2x_op(x, self.impl)


def _kept_packing(module, attr, w, pack):
    """`pack(w)`, kept on `module` as `attr` = (key, packing) and made again
    when the weight changes: another version (as an in-place update or a
    load makes), another tensor or another device. A module whose
    `keep_packing` is cleared packs at every call: a sharded model's
    (`parallel.mesh.shard_params`), whose weights FSDP2 gathers in place
    under `_unsafe_preserve_version_counter`, a change no key can see."""
    key = (w._version, w.data_ptr(), w.device)
    kept = getattr(module, attr)
    if kept is None or kept[0] != key or not module.keep_packing:
        kept = (key, pack(w))
        setattr(module, attr, kept)
    return kept[1]


class Conv3x3(nn.Conv2d):
    """3x3 stride-1 same-pad conv through the conv3x3 dispatcher, with
    `nn.Conv2d`'s parameters (`weight` (Cout, Cin, 3, 3), `bias`), as the
    JAX `Conv3x3` keeps `nn.Conv`'s. `impl` is the dispatcher's. The
    kernel's packed weight is kept between calls and packed again when the
    weight changes (another version, as an in-place update or a load makes,
    or another tensor; `_kept_packing`)."""

    keep_packing = True  # False: packed at every call (a sharded model's)

    def __init__(self, cin, cout, bias=True, impl=None):
        super().__init__(cin, cout, 3, padding=1, bias=bias)
        self.impl = impl
        self._packed = None  # (weight version, data_ptr, device), packed weight

    def packed_weight(self):
        """`pack_weight(self.weight)`, packed once per version of the weight."""
        return _kept_packing(self, "_packed", self.weight, pack_weight)

    def forward(self, x):
        if x.is_cuda and self.impl in (None, "kernel"):
            return conv3x3_op(x, self.weight, self.bias, self.impl,
                              packed=self.packed_weight())
        return conv3x3_op(x, self.weight, self.bias, self.impl)


class ResidualConvUnit(nn.Module):
    def __init__(self, features, conv_impl=None):
        super().__init__()
        self.conv1 = Conv3x3(features, features, impl=conv_impl)
        self.conv2 = Conv3x3(features, features, impl=conv_impl)

    def forward(self, x):
        out = self.conv1(F.relu(x))
        return self.conv2(F.relu(out)) + x


class FeatureFusionBlock(nn.Module):
    """Fusion refinenet. `has_residual=False` (refinenet4) builds no
    resConfUnit1: its forward never receives a residual input, and a JAX
    init has no such tensors either."""

    def __init__(self, features, has_residual=True, conv_impl=None):
        super().__init__()
        if has_residual:
            self.resConfUnit1 = ResidualConvUnit(features, conv_impl)
        self.resConfUnit2 = ResidualConvUnit(features, conv_impl)
        self.out_conv = Conv2d(features, features, 1)
        self.upsample = Upsample2x(conv_impl)

    def forward(self, x, res=None):
        out = x if res is None else x + self.resConfUnit1(res)
        out = self.resConfUnit2(out)
        # out_conv before the upsample: a 1x1 conv commutes with bilinear
        # interpolation (as the JAX head does), at a quarter of the pixels
        return self.upsample(self.out_conv(out))


class _Scratch(nn.Module):
    def __init__(self, layer_dims, features, conv_impl=None):
        super().__init__()
        for k, cin in enumerate(layer_dims, start=1):
            self.add_module(f"layer{k}_rn", Conv3x3(cin, features, bias=False,
                                                    impl=conv_impl))
        for k in range(1, 5):
            self.add_module(f"refinenet{k}",
                            FeatureFusionBlock(features, k != 4, conv_impl))


class DPTOutputAdapter(nn.Module):
    """DPT fusion trunk over 4 hooked decoder layers (entry 0 of the hook
    list is the encoder output) and the regression head, up to the
    postprocessed pointmap and confidence. `conv_impl` goes to its
    `Conv3x3`s, its `Upsample2x`s and its tail. The tail kernel's packing of
    head[2]'s weight is kept between calls, as `Conv3x3` keeps its own."""

    keep_packing = True

    def __init__(self, dim_tokens, hooks, nch, depth_mode, conf_mode,
                 layer_dims=(96, 192, 384, 768), feature_dim=256, conv_impl=None):
        super().__init__()
        self.hooks = tuple(hooks)
        self.depth_mode, self.conf_mode = depth_mode, conf_mode
        self.conv_impl = conv_impl
        # the tail kernel's conf offset; None: modes it does not take
        self.conf_vmin = kernel_conf_vmin(depth_mode, conf_mode)
        self._packed_w2 = None  # (weight version, data_ptr, device), pack_w2(head[2].weight)
        l0, l1, l2, l3 = layer_dims
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(Conv2d(dim_tokens[0], l0, 1), ConvTranspose2d(l0, l0, 4, stride=4)),
            nn.Sequential(Conv2d(dim_tokens[1], l1, 1), ConvTranspose2d(l1, l1, 2, stride=2)),
            nn.Sequential(Conv2d(dim_tokens[2], l2, 1)),
            nn.Sequential(Conv2d(dim_tokens[3], l3, 1),
                          Conv2d(l3, l3, 3, stride=2, padding=1)),
        ])
        self.scratch = _Scratch(layer_dims, feature_dim, conv_impl)
        self.head = nn.Sequential(
            Conv3x3(feature_dim, feature_dim // 2, impl=conv_impl), Upsample2x(conv_impl),
            Conv3x3(feature_dim // 2, 32, impl=conv_impl), nn.ReLU(),
            Conv2d(32, nch, 1))

    def forward(self, decout, img_shape, patch_size):
        nh, nw = img_shape[0] // patch_size, img_shape[1] // patch_size
        layers = []
        for idx, hook in enumerate(self.hooks):
            t = decout[hook]  # (B, S, D)
            # (B, D, nh, nw) in channels_last memory: a view of the tokens
            x = t.reshape(t.shape[0], nh, nw, t.shape[2]).permute(0, 3, 1, 2)
            x = self.act_postprocess[idx](x)
            layers.append(getattr(self.scratch, f"layer{idx + 1}_rn")(x))
        s = self.scratch
        path = s.refinenet4(layers[3])[:, :, :layers[2].shape[2], :layers[2].shape[3]]
        path = s.refinenet3(path, layers[2])
        path = s.refinenet2(path, layers[1])
        path = s.refinenet1(path, layers[0])
        return self.tail(self.head[1](self.head[0](path)))

    def packed_w2(self):
        """`pack_w2(self.head[2].weight)`, packed once per version of the
        weight."""
        return _kept_packing(self, "_packed_w2", self.head[2].weight, pack_w2)

    def tail(self, y):
        """head[2:] and the postprocess on y (B, 128, H, W), fp32 or bf16:
        one dpt_tail call with the weights of head[2] (3x3, 128 -> 32) and
        head[4] (1x1, 32 -> 4). Modes the tail kernel does not take run the
        modules themselves, and raise where the kernel was asked for."""
        if self.conf_vmin is not None:
            conv2, conv3 = self.head[2], self.head[4]
            args = (y, conv2.weight, conv2.bias, conv3.weight, conv3.bias, self.conf_vmin,
                    self.conv_impl)
            if y.is_cuda and self.conv_impl in (None, "kernel"):
                pts3d, conf = dpt_tail_op(*args, packed=self.packed_w2())
            else:
                pts3d, conf = dpt_tail_op(*args)
            return dict(pts3d=pts3d, conf=conf)
        if self.conv_impl == "kernel" or (self.conv_impl is None and y.is_cuda):
            raise ValueError(f"the dpt_tail kernel takes depth mode ('exp', -inf, inf) and "
                             f"conf mode ('exp', vmin, inf), not {self.depth_mode} and "
                             f"{self.conf_mode}; conv_impl='ref' runs any mode")
        out = self.head[2:](y).float().permute(0, 2, 3, 1)  # NHWC, postprocess in fp32
        return postprocess(out, self.depth_mode, self.conf_mode)


class DPTHead(nn.Module):
    """DPT regression head (reference create_dpt_head: feature_dim 256,
    layer_dims (96, 192, 384, 768), dim_tokens (enc, dec, dec, dec))."""

    def __init__(self, patch_size, depth_mode, conf_mode, has_conf=True,
                 hooks: Sequence[int] = (0, 6, 9, 12), enc_dim=1024, dec_dim=768,
                 conv_impl=None):
        super().__init__()
        self.patch_size = patch_size
        self.dpt = DPTOutputAdapter((enc_dim, dec_dim, dec_dim, dec_dim), hooks,
                                    3 + int(has_conf), depth_mode,
                                    conf_mode if has_conf else None, conv_impl=conv_impl)

    def forward(self, decout, img_shape):
        return self.dpt(decout, img_shape, self.patch_size)


def head_factory(head_type, output_mode, *, patch_size, dec_depth, depth_mode,
                 conf_mode, has_conf, enc_dim, dec_dim, conv_impl=None):
    if output_mode != "pts3d":
        raise NotImplementedError(f"unexpected {output_mode=}")
    if head_type == "linear":
        return LinearPts3d(patch_size, depth_mode, conf_mode, has_conf, dec_dim)
    if head_type == "dpt":
        if dec_depth <= 9:
            raise ValueError("the DPT head hooks need dec_depth > 9")
        hooks = (0, dec_depth * 2 // 4, dec_depth * 3 // 4, dec_depth)
        return DPTHead(patch_size, depth_mode, conf_mode, has_conf, hooks,
                       enc_dim, dec_dim, conv_impl)
    raise NotImplementedError(f"unexpected {head_type=}")
