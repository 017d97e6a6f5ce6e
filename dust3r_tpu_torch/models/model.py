"""AsymmetricCroCo3DStereo: siamese ViT encoder, twin cross-attention
decoders and pointmap/confidence heads.

Counterpart of `dust3r_tpu/models/model.py` for inference: encode / decode
/ head are separate methods so the inference engine encodes each unique
image once; images are NHWC at their true orientation; params are fp32,
the transformer body computes in `dtype` (bf16 on the card) and the heads
in fp32. `attn_impl` and `conv_impl` pick the attention and DPT head
paths (conv3x3, up2x and dpt_tail; None: the kernels for CUDA tensors). Submodule names are the
reference's torch tensor names, so
`checkpoint.state_dict_from_jax` output loads with `load_state_dict`.
Parameters are made from a seeded `torch.Generator` on `device`: the CUDA
card when none is given (it raises without one; pass device="cpu" for the
CPU, device="meta" for shapes only).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.rope import rope_tables
from ..utils.device import default_device
from .blocks import Block, DecoderBlock, LayerNormF32, Linear, PatchEmbed
from .heads import head_factory

inf = math.inf
INIT_STD = 0.02  # normal init of every weight; biases 0, norms 1


class AsymmetricCroCo3DStereo(nn.Module):
    def __init__(self, img_size: Tuple[int, int] = (224, 224), patch_size=16,
                 enc_embed_dim=1024, enc_depth=24, enc_num_heads=16,
                 dec_embed_dim=768, dec_depth=12, dec_num_heads=12,
                 mlp_ratio=4.0, pos_embed="RoPE100", output_mode="pts3d",
                 head_type="linear", depth_mode=("exp", -inf, inf),
                 conf_mode: Optional[tuple] = ("exp", 1, inf),
                 dtype=torch.float32, attn_impl=None, conv_impl=None, device=None,
                 seed=0):
        super().__init__()
        if not pos_embed.startswith("RoPE"):
            raise NotImplementedError(f"unsupported pos_embed {pos_embed}")
        device = (torch.device(device) if device is not None
                  else default_device(type(self).__name__))
        self.img_size = tuple(img_size)
        self.patch_size = patch_size
        self.enc_depth = enc_depth
        self.dec_depth = dec_depth
        self.head_type = head_type
        self.dtype = dtype
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

    def encode(self, img):
        """img: (B, H, W, 3) normalized -> (tokens (B, N, C), pos (B, N, 2))."""
        x, pos = self.patch_embed(img)
        rope = rope_tables(pos, self.enc_head_dim, self.rope_base)  # for all layers
        for blk in self.enc_blocks:
            x = blk(x, pos, rope)
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
            x1, x2 = (blk1(x1, x2, pos1, pos2, rope1, rope2)[0],
                      blk2(x2, x1, pos2, pos1, rope2, rope1)[0])
            out1.append(x1)
            out2.append(x2)
        out1[-1] = self.dec_norm(out1[-1])
        out2[-1] = self.dec_norm(out2[-1])
        return out1, out2

    def head(self, head_num, decout, img_shape):
        """Downstream head `head_num` (1 or 2), in fp32."""
        decout = [t.float() for t in decout]
        h = self.downstream_head1 if head_num == 1 else self.downstream_head2
        return h(decout, img_shape)

    def forward(self, img1, img2):
        """Pair forward. img1/img2: (B, H, W, 3). Returns (res1, res2):
        res1 = {pts3d, conf}; res2 = {pts3d_in_other_view, conf}."""
        shape1, shape2 = tuple(img1.shape[1:3]), tuple(img2.shape[1:3])
        if shape1 == shape2:  # shared-shape path: one encoder batch
            feat, pos = self.encode(torch.cat([img1, img2]))
            B = img1.shape[0]
            f1, f2, pos1, pos2 = feat[:B], feat[B:], pos[:B], pos[B:]
        else:
            f1, pos1 = self.encode(img1)
            f2, pos2 = self.encode(img2)
        dec1, dec2 = self.decode(f1, pos1, f2, pos2)
        res1 = self.head(1, dec1, shape1)
        res2 = self.head(2, dec2, shape2)
        res2["pts3d_in_other_view"] = res2.pop("pts3d")
        return res1, res2


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
