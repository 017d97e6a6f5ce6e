"""The port's conv3x3 (plain versions, kernel wrapper, dispatcher) and the
DPT head that routes through it, against the JAX package on the CPU.

Inputs come from a seeded numpy generator in the JAX layout (x NHWC, w
HWIO) and go to the port in its own (x NCHW-shaped, channels_last memory;
w (Cout, Cin, 3, 3)). The JAX Pallas conv runs in interpret mode, set up as
tests/test_torch_port_ops.py sets up the attention. On CPU tensors the
kernel's wrapper runs its plain version `conv3x3_bf16_ref`; the CUDA kernel
itself is checked on the card by tests/test_torch_port_kernels.py and
chip_smoke.py. Tolerances, relative to max |y|: 1e-2 against the Pallas
kernel (it stores its per-tap partial sums Z in bf16, the port does not),
1e-5 against XLA convs in fp32 on the same operands.
"""
import importlib
import os
import os.path as osp
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

from dust3r_tpu.models import heads as jheads  # noqa: E402
from dust3r_tpu.ops.conv3x3 import conv3x3_ref as jax_conv3x3_ref  # noqa: E402
from dust3r_tpu_torch.checkpoint import state_dict_from_jax  # noqa: E402
from dust3r_tpu_torch.models import heads  # noqa: E402
from dust3r_tpu_torch.ops.conv3x3 import (conv3x3, conv3x3_bf16_ref, conv3x3_kernel,  # noqa: E402
                                          conv3x3_ref, pack_weight, plan, unpack_weight)
from dust3r_tpu_torch.ops.dpt_tail import dpt_tail_kernel  # noqa: E402
from dust3r_tpu_torch.ops.upsample import up2x_kernel  # noqa: E402

CASES = {  # name: (B, H, W, Cin, Cout)
    "cin16_cout8": (2, 7, 9, 16, 8),
    "cin16_cout32": (1, 5, 11, 16, 32),
    "cin96_cout8": (1, 9, 7, 96, 8),
    "cin96_cout32": (2, 5, 5, 96, 32),
}


@pytest.fixture(scope="module")
def pallas_conv():
    os.environ["DUST3R_TPU_PALLAS_INTERPRET"] = "1"
    import dust3r_tpu.ops.conv3x3 as jconv
    importlib.reload(jconv)
    yield jconv._conv3x3_pallas_raw
    del os.environ["DUST3R_TPU_PALLAS_INTERPRET"]
    importlib.reload(jconv)


def _inputs(case, bias, seed=0):
    B, H, W, cin, cout = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32) if bias else None
    return x, w, b


def _port(x, w, b):
    """JAX-layout numpy -> the port's tensors."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # channels_last memory, no copy
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    return xt, wt, None if b is None else torch.from_numpy(b)


def _nhwc(y):
    return y.permute(0, 2, 3, 1).numpy()


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_plain_version_matches_pallas_kernel(pallas_conv, case, bias):
    x, w, b = _inputs(case, bias)
    want = np.asarray(pallas_conv(jnp.asarray(x), jnp.asarray(w)))
    if b is not None:
        want = want + b
    got = _nhwc(conv3x3_bf16_ref(*_port(x, w, b)))
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-2


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_plain_version_and_wrapper_match_xla_on_rounded_operands(case, bias):
    """The kernel's function: an fp32 conv of bf16-rounded x and w. The
    wrapper and the dispatcher ('kernel') run it for CPU tensors."""
    x, w, b = _inputs(case, bias, seed=1)
    want = np.asarray(jax_conv3x3_ref(jnp.asarray(_bf16(x)), jnp.asarray(_bf16(w)),
                                      None if b is None else jnp.asarray(b)))
    xt, wt, bt = _port(x, w, b)
    before = conv3x3_kernel.launches
    for got in (conv3x3_bf16_ref(xt, wt, bt), conv3x3_kernel(xt, wt, bt),
                conv3x3(xt, wt, bt, impl="kernel")):
        assert _rel(_nhwc(got), want) <= 1e-5
    assert conv3x3_kernel.launches == before  # the plain version launches nothing


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ref_matches_jax_ref(case, bias):
    x, w, b = _inputs(case, bias, seed=2)
    want = np.asarray(jax_conv3x3_ref(jnp.asarray(x), jnp.asarray(w),
                                      None if b is None else jnp.asarray(b)))
    xt, wt, bt = _port(x, w, b)
    for got in (conv3x3_ref(xt, wt, bt), conv3x3(xt, wt, bt), conv3x3(xt, wt, bt, impl="ref")):
        assert _rel(_nhwc(got), want) <= 1e-5


def test_pack_weight_is_the_kernels_layout():
    """Entry [c, dy * 3 + dx, co, i] of the packed (Cin / 32, 9, Cout, 32)
    weight is w[co, c * 32 + i, dy, dx], rounded to bf16; unpack_weight
    inverts it."""
    w = torch.randn(8, 64, 3, 3, generator=torch.Generator().manual_seed(0))
    p = pack_weight(w)
    assert p.shape == (2, 9, 8, 32) and p.dtype == torch.bfloat16 and p.is_contiguous()
    for dy, dx, ci, co in ((0, 0, 0, 0), (1, 2, 37, 3), (2, 1, 63, 7)):
        assert p[ci // 32, dy * 3 + dx, co, ci % 32] == w[co, ci, dy, dx].to(torch.bfloat16)
    assert torch.equal(unpack_weight(p), w.to(torch.bfloat16))


@pytest.mark.parametrize("case", ["cin96_cout8", "cin96_cout32"])
def test_packed_weight_unpacked_matches_f_conv2d_and_jax(case):
    """The kernel's packed weight, unpacked, is the bf16-rounded weight:
    F.conv2d with it equals the JAX conv3x3_ref on the same rounded
    operands."""
    x, w, b = _inputs(case, bias=True, seed=3)
    xt, wt, bt = _port(x, w, b)
    unpacked = unpack_weight(pack_weight(wt)).float()
    assert unpacked.shape == wt.shape and torch.equal(unpacked, wt.to(torch.bfloat16).float())
    got = _nhwc(torch.nn.functional.conv2d(xt.to(torch.bfloat16).float(), unpacked, bt,
                                           padding=1))
    want = np.asarray(jax_conv3x3_ref(jnp.asarray(_bf16(x)), jnp.asarray(_bf16(w)),
                                      jnp.asarray(b)))
    assert _rel(got, want) <= 1e-5
    assert _rel(got, _nhwc(conv3x3_bf16_ref(xt, wt, bt))) <= 1e-5


PLANS = {  # (B, H, W, Cin, Cout): (channels a block, tiles, splits) on 132 SMs
    (8, 96, 128, 96, 256): (128, 1536, 1),   # layer1_rn
    (8, 48, 64, 192, 256): (128, 384, 1),    # layer2_rn
    (8, 24, 32, 384, 256): (128, 96, 1),     # layer3_rn: 2 splits would pass one wave
    (8, 12, 16, 768, 256): (128, 32, 4),     # layer4_rn
    (8, 12, 16, 256, 256): (128, 32, 4),     # refinenet4
    (8, 11, 16, 256, 256): (128, 32, 4),     # its 512x336 grid
    (8, 21, 32, 256, 256): (128, 96, 1),     # refinenet3 at 512x336
    (8, 192, 256, 256, 128): (128, 3072, 1),  # head.0
    (2, 384, 512, 128, 32): (32, 3072, 1),   # head.2's shape
    (1, 5, 5, 32, 96): (32, 3, 1),           # 3 steps: no split
    (1, 5, 5, 64, 64): (64, 1, 2),
    (1, 4, 4, 256, 128): (128, 1, 8),        # 24 steps, 3 a split
    (1, 24, 32, 256, 128): (128, 6, 8),      # 22 blocks a tile would pass 24 steps / 3
    (2, 24, 32, 256, 128): (128, 12, 8),
    (4, 24, 32, 768, 128): (128, 24, 5),
}


@pytest.mark.parametrize("shape", sorted(PLANS))
def test_plan_fills_the_card(shape):
    """The kernel's launch: the widest block of channels dividing Cout, a
    tile per 8 x 16 pixel patch and channel block, and on grids of under
    half as many tiles as SMs the reduction split over up to 16 blocks a
    tile, at least 3 (chunk, tap row) steps each, the blocks in one wave."""
    bn, tiles, splits = plan(*shape, sms=132)
    assert (bn, tiles, splits) == PLANS[shape]
    steps = 3 * shape[3] // 32
    assert 1 <= splits <= min(16, steps) and (splits == 1 or steps // splits >= 3)
    assert splits == 1 or tiles * splits <= 132


def test_conv3x3_module_repacks_its_weight_when_it_changes():
    """A Conv3x3 packs its weight once per version: the same tensor while
    the weight is unchanged, a new packing after an in-place update or a
    load."""
    m = heads.Conv3x3(64, 32)
    first = m.packed_weight()
    assert m.packed_weight() is first
    assert torch.equal(first, pack_weight(m.weight))
    with torch.no_grad():
        m.weight.mul_(2.0)
    second = m.packed_weight()
    assert second is not first and torch.equal(second, pack_weight(m.weight))
    assert not torch.equal(second, first)
    m.load_state_dict({"weight": torch.ones(32, 64, 3, 3), "bias": torch.zeros(32)})
    third = m.packed_weight()
    assert torch.equal(third, torch.ones(2, 9, 32, 32, dtype=torch.bfloat16))
    assert m.packed_weight() is third


def test_dispatcher_rejects_unknown_impl():
    x = torch.zeros(1, 32, 4, 4)
    with pytest.raises(ValueError, match="impl"):
        conv3x3(x, torch.zeros(32, 32, 3, 3), impl="pallas")


@pytest.fixture(scope="module")
def dpt_pair():
    """The small DPT config of tests/test_torch_port_model.py: the JAX head's
    seeded parameters and decoder outputs at a 2x3 patch grid."""
    from test_torch_port_model import CONFIGS, IMG_HW, _decout, jax_model, seeded_variables

    cfg = CONFIGS["small_dpt"]
    variables = seeded_variables(jax_model("small_dpt"), 12)
    decout = _decout(cfg, 6)
    modes = dict(depth_mode=("exp", -np.inf, np.inf), conf_mode=("exp", 1, np.inf))
    jhead = jheads.DPTHead(16, modes["depth_mode"], modes["conf_mode"], hooks=(0, 6, 9, 12))
    want = jhead.apply({"params": variables["params"]["downstream_head2"]},
                       [jnp.asarray(t) for t in decout], IMG_HW)
    sd = state_dict_from_jax(variables, cfg["enc_depth"], cfg["dec_depth"], "dpt")
    prefix = "downstream_head2."
    head_sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return cfg, modes, decout, want, head_sd, IMG_HW


@pytest.mark.parametrize("conv_impl", [None, "ref", "kernel"])
def test_dpt_head_through_the_dispatcher_matches_jax(dpt_pair, conv_impl):
    """The head's 3x3 convs, upsamples and tail go through their dispatchers
    on CPU tensors. None and 'ref' run the fp32 plain versions and hold to
    the JAX head at the model tests' 2e-4 of mean |x|; 'kernel' runs the
    kernels' plain versions (bf16 conv operands) and holds to the fp32 JAX
    head at the repo's bf16-vs-fp32 pointmap parity budget, normalized RMSE
    1e-2."""
    cfg, modes, decout, want, head_sd, img_hw = dpt_pair
    head = heads.DPTHead(16, modes["depth_mode"], modes["conf_mode"], hooks=(0, 6, 9, 12),
                         enc_dim=cfg["enc_embed_dim"], dec_dim=cfg["dec_embed_dim"],
                         conv_impl=conv_impl)
    convs = [m for m in head.modules() if isinstance(m, heads.Conv3x3)]
    assert len(convs) == 20 and all(m.impl == conv_impl for m in convs)
    head.load_state_dict(head_sd, strict=True)
    kernels = (conv3x3_kernel, up2x_kernel, dpt_tail_kernel)
    before = [k.launches for k in kernels]
    with torch.no_grad():
        got = head([torch.from_numpy(t) for t in decout], img_hw)
    assert [k.launches for k in kernels] == before  # CPU tensors: no kernel launch
    for key in ("pts3d", "conf"):
        a, b = got[key].numpy(), np.asarray(want[key])
        if conv_impl == "kernel":
            assert np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)) <= 1e-2
        else:
            scale = max(float(np.abs(b).mean()), 1e-6)
            np.testing.assert_allclose(a / scale, b / scale, rtol=2e-4, atol=2e-4)


def test_dpt_trunk_feeds_every_conv_channels_last(monkeypatch):
    """The trunk's tensors reach each 3x3 conv, each upsample and the tail
    in channels_last memory (what the kernels read), with no copy for the
    layout, at both buckets' row counts (24 and 21 patch rows): 19 convs (the
    20th, head.2, is the tail's), 5 upsamples and 1 tail per forward."""
    seen = {"conv3x3": [], "up2x": [], "dpt_tail": []}

    def spy(name, fn):
        def wrapped(x, *args):
            seen[name].append(x.is_contiguous(memory_format=torch.channels_last))
            return fn(x, *args)
        return wrapped

    for name, attr in (("conv3x3", "conv3x3_op"), ("up2x", "up2x_op"),
                       ("dpt_tail", "dpt_tail_op")):
        monkeypatch.setattr(heads, attr, spy(name, getattr(heads, attr)))
    head = heads.DPTHead(16, ("exp", -np.inf, np.inf), ("exp", 1, np.inf), hooks=(0, 1, 2, 3),
                         enc_dim=32, dec_dim=32)
    rng = np.random.default_rng(4)
    for rows in (24, 21):
        decout = [torch.from_numpy(rng.standard_normal((1, rows * 2, 32)).astype(np.float32))
                  for _ in range(4)]
        with torch.no_grad():
            out = head(decout, (rows * 16, 32))
        assert out["pts3d"].shape == (1, rows * 16, 32, 3)
    assert [len(seen[k]) for k in ("conv3x3", "up2x", "dpt_tail")] == [38, 10, 2]
    assert all(all(v) for v in seen.values())
