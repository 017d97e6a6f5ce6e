"""AsymmetricCroCo3DStereo: siamese ViT encoder, twin cross-attention
decoders and pointmap/confidence heads.

Counterpart of `dust3r_tpu/models/model.py`: encode / decode / head are
separate methods so the inference engine encodes each unique image once;
images are NHWC at their true orientation, or, in a training batch, stored
landscape with per-sample `is_portrait` flags (the ManyAR path: both
patchify orientations, both head orientations, selected per sample);
`symmetrized=True` encodes view1 only and swaps pairs for view2; `remat`
recomputes each block's activations in the backward (torch activation
checkpointing, memory only), all of them under `remat_policy="full"` and,
under "dots", all but the 2-D GEMM outputs (`DotsPolicy`, JAX's
`dots_with_no_batch_dims_saveable`); params are fp32,
the transformer body computes in `dtype` (bf16 on the card) and the heads
in `head_dtype` (fp32, the parity default; bf16 in the serving
configuration, `--serving`), their postprocess in fp32. The int8 serving
mode swaps the body's projections for `ops.quant.QuantLinear`
(`quantize_for_inference`, `InferenceEngine(quantize="int8")`).
`attn_impl` and `conv_impl` pick the attention and DPT head
paths (conv3x3, up2x and dpt_tail; None: the kernels for CUDA tensors). Submodule names are the
reference's torch tensor names, so
`checkpoint.state_dict_from_jax` output loads with `load_state_dict`.
Parameters are made from a seeded `torch.Generator` on `device`: the CUDA
card when none is given (it raises without one; pass device="cpu" for the
CPU, device="meta" for shapes only).
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.rope import rope_tables
from ..utils.device import default_device
from .blocks import Block, DecoderBlock, LayerNormF32, Linear, PatchEmbed
from .heads import head_factory

inf = math.inf
INIT_STD = 0.02  # normal init of every weight; biases 0, norms 1
REMAT_POLICIES = ("full", "dots")


class DotsPolicy:
    """The "dots" remat policy, JAX's `dots_with_no_batch_dims_saveable` as
    a policy of torch's selective activation checkpointing: the outputs of
    the 2-D GEMMs (`aten.mm`, `aten.addmm`: qkv, proj, projq / projk /
    projv, fc1, fc2) are saved, everything else is recomputed in the
    backward (the attention's batched products, LayerNorm, GELU, RoPE and
    the attention kernel's Function, whose launch is repeated, as JAX
    recomputes its pallas_call). `record`: None, or a list that gets the
    (op, output shape, dtype) of each output saved in a forward."""

    SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def __init__(self):
        self.record = None

    def __call__(self, ctx, op, *args, **kwargs):
        if op in self.SAVED:
            if self.record is not None and not ctx.is_recompute:
                a, b = args[-2:]  # mm(a, b), addmm(bias, a, b)
                self.record.append((str(op), (a.shape[0], b.shape[1]), a.dtype))
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE


class AsymmetricCroCo3DStereo(nn.Module):
    def __init__(self, img_size: Tuple[int, int] = (224, 224), patch_size=16,
                 enc_embed_dim=1024, enc_depth=24, enc_num_heads=16,
                 dec_embed_dim=768, dec_depth=12, dec_num_heads=12,
                 mlp_ratio=4.0, pos_embed="RoPE100", output_mode="pts3d",
                 head_type="linear", depth_mode=("exp", -inf, inf),
                 conf_mode: Optional[tuple] = ("exp", 1, inf),
                 dtype=torch.float32, head_dtype=torch.float32, attn_impl=None,
                 conv_impl=None, device=None, seed=0, remat=False, remat_policy="full"):
        super().__init__()
        if not pos_embed.startswith("RoPE"):
            raise NotImplementedError(f"unsupported pos_embed {pos_embed}")
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r} not in {REMAT_POLICIES}")
        device = (torch.device(device) if device is not None
                  else default_device(type(self).__name__))
        self.img_size = tuple(img_size)
        self.patch_size = patch_size
        self.enc_embed_dim, self.enc_depth, self.enc_num_heads = (enc_embed_dim, enc_depth,
                                                                  enc_num_heads)
        self.dec_embed_dim, self.dec_depth, self.dec_num_heads = (dec_embed_dim, dec_depth,
                                                                  dec_num_heads)
        self.mlp_ratio = mlp_ratio
        self.pos_embed = pos_embed
        self.output_mode = output_mode
        self.head_type = head_type
        self.depth_mode = tuple(depth_mode)
        self.conf_mode = tuple(conf_mode) if conf_mode else conf_mode
        self.dtype = dtype
        self.head_dtype = head_dtype
        self.remat = remat
        self.remat_policy = remat_policy
        self.dots_policy = DotsPolicy()
        rope_base = float(pos_embed[len("RoPE"):])
        self.rope_base = rope_base
        self.enc_head_dim = enc_embed_dim // enc_num_heads
        self.dec_head_dim = dec_embed_dim // dec_num_heads
        enc_args = (enc_embed_dim, enc_num_heads, mlp_ratio, rope_base, dtype, attn_impl)
        dec_args = (dec_embed_dim, dec_num_heads, mlp_ratio, rope_base, dtype, attn_impl)
        head_kw = dict(patch_size=patch_size, dec_depth=dec_depth,
                       depth_mode=depth_mode, conf_mode=conf_mode,
                       has_conf=bool(conf_mode), enc_dim=enc_embed_dim,
                       dec_dim=dec_embed_dim, conv_impl=conv_impl)
        # built on the meta device, then materialised on `device` and drawn
        # from the seeded generator: the global RNG is left untouched
        with torch.device("meta"):
            self.patch_embed = PatchEmbed(patch_size, enc_embed_dim, dtype)
            self.enc_blocks = nn.ModuleList(Block(*enc_args) for _ in range(enc_depth))
            self.enc_norm = LayerNormF32(enc_embed_dim)
            self.decoder_embed = Linear(enc_embed_dim, dec_embed_dim, dtype=dtype)
            self.dec_blocks = nn.ModuleList(
                DecoderBlock(*dec_args) for _ in range(dec_depth))
            self.dec_blocks2 = nn.ModuleList(
                DecoderBlock(*dec_args) for _ in range(dec_depth))
            self.dec_norm = LayerNormF32(dec_embed_dim)
            self.downstream_head1 = head_factory(head_type, output_mode, **head_kw)
            self.downstream_head2 = head_factory(head_type, output_mode, **head_kw)
        self.to_empty(device=device)
        if self.patch_embed.proj.weight.device.type != "meta":  # meta: shapes only
            self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed):
        """Seeded random weights: N(0, INIT_STD) weights, zero biases, unit
        norms, drawn in parameter order from one generator."""
        device = next(self.parameters()).device
        gen = torch.Generator(device=device).manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                mod.weight.normal_(0.0, INIT_STD, generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()

    def _block(self, blk, *args):
        """blk(*args), its activations recomputed in the backward under
        `remat` while autograd records: all of them, or under "dots" all
        but its GEMMs' outputs."""
        if self.remat and torch.is_grad_enabled():
            kw = {}
            if self.remat_policy == "dots":
                kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                           self.dots_policy)
            return checkpoint(blk, *args, use_reentrant=False, **kw)
        return blk(*args)

    def encode(self, img, is_portrait=None):
        """img: (B, H, W, 3) normalized -> (tokens (B, N, C), pos (B, N, 2)).

        is_portrait: optional (B,) bool of a ManyAR batch (images stored
        landscape, flagged samples portrait in truth): both patchify
        orientations run and tokens and positions are selected per sample,
        as the JAX `encode` does."""
        x, pos = self.patch_embed(img)
        if is_portrait is not None:
            xp, posp = self.patch_embed(img.transpose(1, 2))
            sel = is_portrait.to(x.device)[:, None, None]
            x, pos = torch.where(sel, xp, x), torch.where(sel, posp, pos)
        rope = rope_tables(pos, self.enc_head_dim, self.rope_base)  # for all layers
        for blk in self.enc_blocks:
            x = self._block(blk, x, pos, rope)
        return self.enc_norm(x), pos

    def decode(self, f1, pos1, f2, pos2):
        """Dual-stream decoder. Returns two lists of length dec_depth + 1:
        entry 0 is the encoder output, then each decoder layer's output,
        the last passed through dec_norm."""
        out1, out2 = [f1], [f2]
        x1 = self.decoder_embed(f1)
        x2 = self.decoder_embed(f2)
        rope1 = rope_tables(pos1, self.dec_head_dim, self.rope_base)  # for all layers
        rope2 = rope_tables(pos2, self.dec_head_dim, self.rope_base)
        for blk1, blk2 in zip(self.dec_blocks, self.dec_blocks2):
            x1, x2 = (self._block(blk1, x1, x2, pos1, pos2, rope1, rope2)[0],
                      self._block(blk2, x2, x1, pos2, pos1, rope2, rope1)[0])
            out1.append(x1)
            out2.append(x2)
        out1[-1] = self.dec_norm(out1[-1])
        out2[-1] = self.dec_norm(out2[-1])
        return out1, out2

    def head(self, head_num, decout, img_shape):
        """Downstream head `head_num` (1 or 2), in `head_dtype` (the
        postprocess in fp32)."""
        decout = [t.to(self.head_dtype) for t in decout]
        h = self.downstream_head1 if head_num == 1 else self.downstream_head2
        return h(decout, img_shape)

    def _head_manyar(self, head_num, decout, img_shape, is_portrait):
        """The ManyAR head (the JAX `_head_manyar`): the head at both
        orientations on the whole batch, the portrait result transposed back
        to storage orientation, selected per sample."""
        H, W = img_shape
        res_l = self.head(head_num, decout, (H, W))
        res_p = self.head(head_num, decout, (W, H))
        out = {}
        for k, land in res_l.items():
            sel = is_portrait.to(land.device).reshape((-1,) + (1,) * (land.dim() - 1))
            out[k] = torch.where(sel, res_p[k].transpose(1, 2), land)
        return out

    def forward(self, img1, img2, is_portrait1=None, is_portrait2=None, symmetrized=False):
        """Pair forward. img1/img2: (B, H, W, 3). Returns (res1, res2):
        res1 = {pts3d, conf}; res2 = {pts3d_in_other_view, conf}.

        is_portrait1/2: (B,) bool flags of a ManyAR training batch, both or
        neither (see `encode`); outputs come back at storage orientation.
        symmetrized: the batch is (I, J), (J, I) interleaved, so only img1
        is encoded and view2's tokens are view1's with each pair swapped."""
        shape1, shape2 = tuple(img1.shape[1:3]), tuple(img2.shape[1:3])
        if (is_portrait1 is None) != (is_portrait2 is None):
            raise ValueError("pass is_portrait flags for both views or neither")
        manyar = is_portrait1 is not None
        if symmetrized:
            if shape1 != shape2:
                raise ValueError("symmetrized batches share one shape")
            f1, pos1 = self.encode(img1, is_portrait1)
            f2, pos2 = swap_pairs(f1), swap_pairs(pos1)
        elif shape1 == shape2:  # shared-shape path: one encoder batch
            flags = torch.cat([is_portrait1, is_portrait2]) if manyar else None
            feat, pos = self.encode(torch.cat([img1, img2]), flags)
            B = img1.shape[0]
            f1, f2, pos1, pos2 = feat[:B], feat[B:], pos[:B], pos[B:]
        else:
            f1, pos1 = self.encode(img1, is_portrait1)
            f2, pos2 = self.encode(img2, is_portrait2)
        dec1, dec2 = self.decode(f1, pos1, f2, pos2)
        if manyar:
            res1 = self._head_manyar(1, dec1, shape1, is_portrait1)
            res2 = self._head_manyar(2, dec2, shape2, is_portrait2)
        else:
            res1 = self.head(1, dec1, shape1)
            res2 = self.head(2, dec2, shape2)
        res2["pts3d_in_other_view"] = res2.pop("pts3d")
        return res1, res2


def swap_pairs(t):
    """Swap the entries of each consecutive pair along the batch axis."""
    B = t.shape[0]
    return t.reshape(B // 2, 2, *t.shape[1:]).flip(1).reshape(t.shape)


# ---------------------------------------------------------------------- #
# published configurations
# ---------------------------------------------------------------------- #

def dust3r_224_linear(**kw) -> AsymmetricCroCo3DStereo:
    """DUSt3R_ViTLarge_BaseDecoder_224_linear."""
    kw.setdefault("img_size", (224, 224))
    kw.setdefault("head_type", "linear")
    return AsymmetricCroCo3DStereo(**kw)


def dust3r_512_linear(**kw) -> AsymmetricCroCo3DStereo:
    """DUSt3R_ViTLarge_BaseDecoder_512_linear."""
    kw.setdefault("img_size", (512, 512))
    kw.setdefault("head_type", "linear")
    return AsymmetricCroCo3DStereo(**kw)


def dust3r_512_dpt(**kw) -> AsymmetricCroCo3DStereo:
    """DUSt3R_ViTLarge_BaseDecoder_512_dpt."""
    kw.setdefault("img_size", (512, 512))
    kw.setdefault("head_type", "dpt")
    return AsymmetricCroCo3DStereo(**kw)


NAMED_MODELS = {
    "DUSt3R_ViTLarge_BaseDecoder_224_linear": dust3r_224_linear,
    "DUSt3R_ViTLarge_BaseDecoder_512_linear": dust3r_512_linear,
    "DUSt3R_ViTLarge_BaseDecoder_512_dpt": dust3r_512_dpt,
}
