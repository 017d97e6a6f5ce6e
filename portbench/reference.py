"""The plain reference of the DUSt3R two-view network, at the precision
that the configuration states.

Written from the published model (arXiv:2312.14132; naver/dust3r and
naver/croco: `AsymmetricCroCo3DStereo`, `Block`, `DecoderBlock`, `RoPE2D`,
`LinearPts3d`, `DPTOutputAdapter_fix`), not from the program under test:
it imports neither `jax` nor `dust3r_tpu` nor `dust3r_tpu_torch`, and takes
the benchmark's state dict (the published checkpoints' tensor names) and
host images. Plain `torch` operations, TF32 off, no kernels, no cache, no
batching beyond the blocks the caller hands it.

Conventions of the published model kept here: images are (B, H, W, 3) in
[-1, 1]; patches of 16 pixels in row-major order with (y, x) positions;
2D RoPE with base 100 (the head dimension split in a y half and an x half,
each rotated by rotate-half pairs of frequencies base^(-2i/D)); LayerNorm
eps 1e-6; exact GELU; the decoder's two streams read each other's previous
layer; the DPT fusion block upsamples (bilinear, align_corners=True) and
then applies its 1x1 conv; the depth mode is ('exp', -inf, inf) and the
confidence mode ('exp', 1, inf).

The precision (a configuration's "precision"): the body (patch embedding,
encoder, decoder) computes in `body`. In bfloat16 its activations and
residual stream are bfloat16, and it rounds at these points only: each
projection and the patch embedding multiply bfloat16 operands and sum in
float32; LayerNorm runs in float32 on the weights as they are; GELU takes
its tanh form where `gelu_bfloat16` says so; attention applies RoPE in
float32, rounds the rotated (scaled) q and the rotated k, computes the
logits and the softmax in float32 and rounds P before P v, then divides
by the float32 row sum. The heads compute in float32 on the body's
outputs; their stride-1 3x3 convolutions round x and w to
`conv3x3_operands` and sum in float32. Everything in float32 is the
published model's arithmetic.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DPT_LAYER_DIMS = (96, 192, 384, 768)
DPT_FEATURES = 256


def fp32_only():
    """float32 products stay float32 on the card: TF32 off for matmuls and
    cuDNN convolutions (PyTorch turns it on for cuDNN by default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def param_shapes(arch):
    """{name: shape} of every tensor of the published checkpoint of `arch`
    (the config file's "arch"), in the checkpoint's order."""
    E, D = arch["enc_embed_dim"], arch["dec_embed_dim"]
    p, r = arch["patch_size"], arch["mlp_ratio"]
    shapes = {"patch_embed.proj.weight": (E, 3, p, p), "patch_embed.proj.bias": (E,)}

    def ln(prefix, c):
        shapes[prefix + ".weight"] = (c,)
        shapes[prefix + ".bias"] = (c,)

    def lin(prefix, cin, cout):
        shapes[prefix + ".weight"] = (cout, cin)
        shapes[prefix + ".bias"] = (cout,)

    for i in range(arch["enc_depth"]):
        b = f"enc_blocks.{i}"
        ln(b + ".norm1", E)
        lin(b + ".attn.qkv", E, 3 * E)
        lin(b + ".attn.proj", E, E)
        ln(b + ".norm2", E)
        lin(b + ".mlp.fc1", E, int(E * r))
        lin(b + ".mlp.fc2", int(E * r), E)
    ln("enc_norm", E)
    lin("decoder_embed", E, D)
    for stream in ("dec_blocks", "dec_blocks2"):
        for i in range(arch["dec_depth"]):
            b = f"{stream}.{i}"
            ln(b + ".norm1", D)
            lin(b + ".attn.qkv", D, 3 * D)
            lin(b + ".attn.proj", D, D)
            ln(b + ".norm_y", D)
            ln(b + ".norm2", D)
            for name in ("projq", "projk", "projv", "proj"):
                lin(f"{b}.cross_attn.{name}", D, D)
            ln(b + ".norm3", D)
            lin(b + ".mlp.fc1", D, int(D * r))
            lin(b + ".mlp.fc2", int(D * r), D)
    ln("dec_norm", D)
    for n in (1, 2):
        h = f"downstream_head{n}"
        if arch["head_type"] == "linear":
            lin(h + ".proj", D, 4 * p * p)
            continue
        a = h + ".dpt"
        l0, l1, l2, l3 = DPT_LAYER_DIMS
        f = DPT_FEATURES
        conv = {  # name: (cout, cin, k, bias)
            "act_postprocess.0.0": (l0, E, 1, True), "act_postprocess.0.1": (l0, l0, 4, True),
            "act_postprocess.1.0": (l1, D, 1, True), "act_postprocess.1.1": (l1, l1, 2, True),
            "act_postprocess.2.0": (l2, D, 1, True),
            "act_postprocess.3.0": (l3, D, 1, True), "act_postprocess.3.1": (l3, l3, 3, True),
        }
        for k, cin in enumerate(DPT_LAYER_DIMS, start=1):
            conv[f"scratch.layer{k}_rn"] = (f, cin, 3, False)
        for k in range(1, 5):
            units = ("resConfUnit1", "resConfUnit2") if k != 4 else ("resConfUnit2",)
            for unit in units:
                for c in ("conv1", "conv2"):
                    conv[f"scratch.refinenet{k}.{unit}.{c}"] = (f, f, 3, True)
            conv[f"scratch.refinenet{k}.out_conv"] = (f, f, 1, True)
        conv.update({"head.0": (f // 2, f, 3, True), "head.2": (32, f // 2, 3, True),
                     "head.4": (4, 32, 1, True)})
        for name, (cout, cin, k, bias) in conv.items():
            # a transposed conv's weight is (cin, cout, k, k); both are square here
            shapes[f"{a}.{name}.weight"] = (cout, cin, k, k)
            if bias:
                shapes[f"{a}.{name}.bias"] = (cout,)
    return shapes


def head_layers(arch):
    """The entries of `Reference.decode`'s lists that a head reads: the DPT
    head's four hooks, the linear head's last layer."""
    d = arch["dec_depth"]
    return (0, d * 2 // 4, d * 3 // 4, d) if arch["head_type"] == "dpt" else (d,)


def head_stages(arch):
    """The published names, under a head, of its first stages that run in
    the head's precision alone (no 3x3 conv): the DPT head's four
    `act_postprocess` blocks; none in the linear head."""
    if arch["head_type"] != "dpt":
        return ()
    return tuple(f"dpt.act_postprocess.{i}" for i in range(len(DPT_LAYER_DIMS)))


# ---------------------------------------------------------------------- #
# the transformer
# ---------------------------------------------------------------------- #

def positions(B, ht, wt, device):
    """(B, ht*wt, 2) (y, x) patch positions, row-major."""
    y = torch.arange(ht, device=device).repeat_interleave(wt)
    x = torch.arange(wt, device=device).repeat(ht)
    return torch.stack([y, x], -1)[None].expand(B, -1, -1)


def rope2d(t, pos, base):
    """RoPE2D of t (B, heads, N, d) at pos (B, N, 2): the first d/2
    channels rotated by the y position, the last d/2 by the x position."""
    d = t.shape[-1] // 2
    inv = 1.0 / base ** (torch.arange(0, d, 2, device=t.device, dtype=torch.float32) / d)
    out = []
    for c, part in enumerate((t[..., :d], t[..., d:])):
        ang = pos[..., c].float()[..., None] * inv  # (B, N, d/2)
        ang = torch.cat([ang, ang], -1)[:, None]
        cos, sin = ang.cos(), ang.sin()
        rot = torch.cat([-part[..., d // 2:], part[..., :d // 2]], -1)
        out.append(part * cos + rot * sin)
    return torch.cat(out, -1)


def attention(q, k, v, qpos, kpos, base):
    """softmax(rope(q) rope(k)^T / sqrt(d)) v in v's dtype: RoPE, the logits
    and the softmax in float32, the rotated and scaled q, the rotated k and
    P rounded to v's dtype (no rounding in float32), P v summed in float32
    and divided by the float32 row sum."""
    dt = v.dtype
    q = (rope2d(q.float(), qpos, base) * q.shape[-1] ** -0.5).to(dt).float()
    k = rope2d(k.float(), kpos, base).to(dt).float()
    logits = q @ k.transpose(-1, -2)
    p = (logits - logits.amax(-1, keepdim=True)).exp()
    return ((p.to(dt).float() @ v.float()) / p.sum(-1, keepdim=True)).to(dt)


class Reference:
    """The network on a state dict `sd` of float32 tensors (on the device
    it runs on), an `arch` and a `precision` (the configuration file's;
    None: float32 throughout)."""

    def __init__(self, sd, arch, precision=None):
        precision = precision or {}
        self.sd, self.arch = sd, arch
        self.p = arch["patch_size"]
        self.base = float(arch["pos_embed"][len("RoPE"):])
        dt = DTYPES[precision.get("body", "float32")]
        self.gelu = "tanh" if dt != torch.float32 and precision.get("gelu_bfloat16") == "tanh" \
            else "none"
        self.conv_operands = DTYPES[precision.get("conv3x3_operands", "float32")]
        # the body's projections and patch embedding in its dtype, cast once
        self.w = {name: t if name.startswith("downstream_head") else t.to(dt)
                  for name, t in sd.items()}

    def _lin(self, x, name):
        w = self.w[name + ".weight"]
        return F.linear(x.to(w.dtype), w, self.w[name + ".bias"])

    def _ln(self, x, name):
        """LayerNorm in float32, the output in x's dtype."""
        return F.layer_norm(x.float(), x.shape[-1:], self.sd[name + ".weight"],
                            self.sd[name + ".bias"], LN_EPS).to(x.dtype)

    def _heads(self, t, h):
        B, N, C = t.shape
        return t.reshape(B, N, h, C // h).transpose(1, 2)

    def _self_attn(self, x, pos, name, h):
        B, N, C = x.shape
        q, k, v = self._lin(x, name + ".qkv").reshape(B, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
        o = attention(q, k, v, pos, pos, self.base)
        return self._lin(o.transpose(1, 2).reshape(B, N, C), name + ".proj")

    def _cross_attn(self, x, y, xpos, ypos, name, h):
        B, N, C = x.shape
        q = self._heads(self._lin(x, name + ".projq"), h)
        k = self._heads(self._lin(y, name + ".projk"), h)
        v = self._heads(self._lin(y, name + ".projv"), h)
        o = attention(q, k, v, xpos, ypos, self.base)
        return self._lin(o.transpose(1, 2).reshape(B, N, C), name + ".proj")

    def _mlp(self, x, name):
        return self._lin(F.gelu(self._lin(x, name + ".fc1"), approximate=self.gelu),
                         name + ".fc2")

    @torch.no_grad()
    def encode(self, img):
        """img (B, H, W, 3) -> (tokens (B, N, enc_dim), positions (B, N, 2))."""
        B, H, W, _ = img.shape
        w = self.w["patch_embed.proj.weight"]
        x = F.conv2d(img.permute(0, 3, 1, 2).to(w.dtype), w, self.w["patch_embed.proj.bias"],
                     stride=self.p)
        x = x.flatten(2).transpose(1, 2)
        pos = positions(B, H // self.p, W // self.p, img.device)
        h = self.arch["enc_num_heads"]
        for i in range(self.arch["enc_depth"]):
            b = f"enc_blocks.{i}"
            x = x + self._self_attn(self._ln(x, b + ".norm1"), pos, b + ".attn", h)
            x = x + self._mlp(self._ln(x, b + ".norm2"), b + ".mlp")
        return self._ln(x, "enc_norm"), pos

    @torch.no_grad()
    def decode(self, f1, pos1, f2, pos2):
        """Both streams; returns two lists: the encoder tokens, then each
        decoder layer's output (the last one normalized)."""
        h = self.arch["dec_num_heads"]
        out1, out2 = [f1], [f2]
        x1, x2 = self._lin(f1, "decoder_embed"), self._lin(f2, "decoder_embed")

        def block(b, x, y, xpos, ypos):
            x = x + self._self_attn(self._ln(x, b + ".norm1"), xpos, b + ".attn", h)
            y_ = self._ln(y, b + ".norm_y")
            x = x + self._cross_attn(self._ln(x, b + ".norm2"), y_, xpos, ypos,
                                     b + ".cross_attn", h)
            return x + self._mlp(self._ln(x, b + ".norm3"), b + ".mlp")

        for i in range(self.arch["dec_depth"]):
            x1, x2 = (block(f"dec_blocks.{i}", x1, x2, pos1, pos2),
                      block(f"dec_blocks2.{i}", x2, x1, pos2, pos1))
            out1.append(x1)
            out2.append(x2)
        out1[-1] = self._ln(out1[-1], "dec_norm")
        out2[-1] = self._ln(out2[-1], "dec_norm")
        return out1, out2

    # ------------------------------------------------------------------ #
    # the heads
    # ------------------------------------------------------------------ #

    def _conv(self, x, name, stride=1, padding=None):
        """A head's conv in float32; a stride-1 3x3 one on x and w rounded to
        the configuration's `conv3x3_operands`."""
        w = self.sd[name + ".weight"]
        pad = w.shape[-1] // 2 if padding is None else padding
        if w.shape[-1] == 3 and stride == 1:
            x, w = x.to(self.conv_operands).float(), w.to(self.conv_operands).float()
        return F.conv2d(x, w, self.sd.get(name + ".bias"), stride=stride, padding=pad)

    def _rcu(self, x, name):
        out = self._conv(F.relu(x), name + ".conv1")
        return self._conv(F.relu(out), name + ".conv2") + x

    def _fusion(self, x, res, name):
        out = x if res is None else x + self._rcu(res, name + ".resConfUnit1")
        out = self._rcu(out, name + ".resConfUnit2")
        out = F.interpolate(out, scale_factor=2, mode="bilinear", align_corners=True)
        return self._conv(out, name + ".out_conv")

    def head_layers(self):
        return head_layers(self.arch)

    def head_stages(self):
        return head_stages(self.arch)

    @torch.no_grad()
    def act_postprocess(self, decout, shape, head):
        """The DPT head's four `act_postprocess` outputs (B, C_i, h_i, w_i)."""
        a = f"downstream_head{head}.dpt"
        nh, nw = shape[0] // self.p, shape[1] // self.p
        out = []
        for idx, hook in enumerate(self.head_layers()):
            t = decout[hook].float()
            x = t.transpose(1, 2).reshape(t.shape[0], t.shape[2], nh, nw)
            x = self._conv(x, f"{a}.act_postprocess.{idx}.0")
            if idx in (0, 1):
                w = self.sd[f"{a}.act_postprocess.{idx}.1.weight"]
                x = F.conv_transpose2d(x, w, self.sd[f"{a}.act_postprocess.{idx}.1.bias"],
                                       stride=w.shape[-1])
            elif idx == 3:
                x = self._conv(x, f"{a}.act_postprocess.3.1", stride=2, padding=1)
            out.append(x)
        return out

    def dpt_features(self, decout, shape, head):
        """The DPT head up to its last 3x3 conv and ReLU: (B, 32, H, W)."""
        a = f"downstream_head{head}.dpt"
        layers = [self._conv(x, f"{a}.scratch.layer{idx + 1}_rn")
                  for idx, x in enumerate(self.act_postprocess(decout, shape, head))]
        s = f"{a}.scratch"
        path = self._fusion(layers[3], None, s + ".refinenet4")
        path = path[:, :, :layers[2].shape[2], :layers[2].shape[3]]
        path = self._fusion(path, layers[2], s + ".refinenet3")
        path = self._fusion(path, layers[1], s + ".refinenet2")
        path = self._fusion(path, layers[0], s + ".refinenet1")
        y = self._conv(path, f"{a}.head.0")
        y = F.interpolate(y, scale_factor=2, mode="bilinear", align_corners=True)
        return F.relu(self._conv(y, f"{a}.head.2"))

    @torch.no_grad()
    def head(self, decout, shape, head):
        """Head `head` (1 or 2) on one stream's decoder outputs (a list
        indexed as `decode`'s; only `head_layers` are read) -> (pts3d (B, H,
        W, 3), conf (B, H, W))."""
        if self.arch["head_type"] == "linear":
            name = f"downstream_head{head}.proj"
            x = self._lin(decout[self.head_layers()[-1]].float(), name)  # (B, N, 4 p p)
            B = x.shape[0]
            x = x.transpose(1, 2).reshape(B, -1, shape[0] // self.p, shape[1] // self.p)
            raw = F.pixel_shuffle(x, self.p).permute(0, 2, 3, 1)
        else:
            feat = self.dpt_features(decout, shape, head)
            raw = self._conv(feat, f"downstream_head{head}.dpt.head.4").permute(0, 2, 3, 1)
        xyz = raw[..., :3]
        d = xyz.norm(dim=-1, keepdim=True)
        pts3d = xyz / d.clamp(min=1e-8) * torch.expm1(d)
        return pts3d, 1 + raw[..., 3].exp()

    def pairs(self, feats, poss, shape, i1, i2):
        """Pairs (i1[k], i2[k]) of one shape's encoded images (feats (U, N,
        C), poss (U, N, 2)) -> (pts3d1, conf1, pts3d2 in view 1's frame,
        conf2)."""
        dec1, dec2 = self.decode(feats[i1], poss[i1], feats[i2], poss[i2])
        p1, c1 = self.head(dec1, shape, 1)
        p2, c2 = self.head(dec2, shape, 2)
        return p1, c1, p2, c2


def init_tensors(shapes, seed, device, std=0.02):
    """Seeded weights for `shapes`, drawn on `device` in one call from a
    generator there: N(0, std) for every tensor; LayerNorm weights are 1
    plus that draw. Returns {name: float32 tensor}, views of one buffer."""
    n = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(n, device=device).normal_(0.0, std, generator=gen)
    sd, off = {}, 0
    for name, shape in shapes.items():
        t = flat[off:off + math.prod(shape)].view(shape)
        off += t.numel()
        if "norm" in name.rsplit(".", 2)[-2] and name.endswith(".weight"):
            t += 1.0
        sd[name] = t
    return sd
