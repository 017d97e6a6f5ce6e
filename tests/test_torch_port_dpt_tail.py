"""The port's DPT-head tail and 2x upsample (plain versions, kernel wrappers,
dispatchers, and the head that routes through them) against the JAX
package's TPU kernels and plain references, on the CPU.

The TPU kernels are the experiment scripts' Pallas kernels, loaded from
`scripts/` by path (it is no package) and run in TPU interpret mode
(`pltpu.force_tpu_interpret_mode()`), with no edit to the scripts:
  * row 12, `exp_tailk_r2.tail_pallas` (8-row blocks: H % 8 == 0);
  * row 14, `exp_tailk2_r2.tail3_pallas` (16-row blocks: H % 16 == 0);
  * row 15, `exp_up_pallas_r2.up2x_phase_pallas` (4-row blocks: Hc % 4
    == 0), whose four phase channel groups are reassembled into the fine
    map as the script itself does.
The plain JAX references are the scripts' `tail_xla` (conf = 1 + e^c) and
`dust3r_tpu.models.heads.upsample2x_align_corners` ('lerp' and 'matmul').
Inputs come from a seeded numpy generator in the JAX layout (NHWC, HWIO)
at the scripts' scales, and go to the port in its own. On CPU tensors the
kernel wrappers run their plain versions; the CUDA kernels are checked on
the card by tests/test_torch_port_kernels.py and chip_smoke.py.

Tolerances are max abs error over max |ref|, per output: 1e-6 for the
upsample (two fp32 lerps either way); 1e-5 for the fp32 tail and for the
bf16-operand tail on operands already rounded to bf16 (the same products;
only the order of fp32 sums and the TPU kernels' exp(d) - 1 for expm1(d)
differ).
"""
import importlib.util
import math
import os.path as osp
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

from dust3r_tpu.models import heads as jheads  # noqa: E402
from dust3r_tpu_torch.checkpoint import state_dict_from_jax  # noqa: E402
from dust3r_tpu_torch.models import heads  # noqa: E402
from dust3r_tpu_torch.ops.dpt_tail import (dpt_tail, dpt_tail_bf16_ref,  # noqa: E402
                                           dpt_tail_kernel, dpt_tail_ref, kernel_conf_vmin,
                                           pack_w2, unpack_w2)
from dust3r_tpu_torch.ops.upsample import up2x, up2x_kernel, up2x_ref  # noqa: E402

SCRIPTS = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "scripts")
UP_TOL = 1e-6
TAIL_TOL = 1e-5
INF = math.inf


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_tpu_{name}", osp.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tpu():
    """The experiment scripts holding TPU rows 12, 14 and 15."""
    return dict(tail=_script("exp_tailk_r2"), tail2=_script("exp_tailk2_r2"),
                up=_script("exp_up_pallas_r2"))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _bf16(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


# ---------------------------------------------------------------------- #
# up2x (row 15)
# ---------------------------------------------------------------------- #

def _up_input(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port_up(fn, x):
    """NHWC numpy through a port function on (B, C, H, W) channels_last."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    y = fn(xt)
    assert y.shape == (x.shape[0], x.shape[3], 2 * x.shape[1], 2 * x.shape[2])
    assert y.is_contiguous(memory_format=torch.channels_last)
    return y.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", [(2, 8, 12, 8), (1, 4, 5, 16)])
def test_up2x_ref_matches_tpu_kernel(tpu, shape):
    x = _up_input(shape)
    with pltpu.force_tpu_interpret_mode():
        phases = np.asarray(tpu["up"].up2x_phase_pallas(jnp.asarray(x)))
    B, H, W, C = shape
    fine = phases.reshape(B, H, W, 2, 2, C).transpose(0, 1, 3, 2, 4, 5).reshape(
        B, 2 * H, 2 * W, C)
    assert _rel(_port_up(up2x_ref, x), fine) <= UP_TOL


@pytest.mark.parametrize("impl", ["lerp", "matmul"])
@pytest.mark.parametrize("shape", [(2, 8, 12, 8), (1, 11, 16, 8), (1, 1, 5, 4), (1, 3, 1, 12)])
def test_up2x_ref_matches_jax_upsample(shape, impl):
    """Ragged and single-sample axes too: the 336 bucket's 11-row grid."""
    x = _up_input(shape, seed=1)
    want = np.asarray(jheads.upsample2x_align_corners(jnp.asarray(x), impl))
    assert _rel(_port_up(up2x_ref, x), want) <= UP_TOL


def test_up2x_wrapper_and_dispatcher_run_the_plain_version_on_cpu():
    x = _up_input((2, 5, 7, 8), seed=2)
    want = _port_up(up2x_ref, x)
    before = up2x_kernel.launches
    for fn in (up2x_kernel, lambda t: up2x(t, impl="kernel"), up2x,
               lambda t: up2x(t, impl="ref")):
        np.testing.assert_array_equal(_port_up(fn, x), want)
    assert up2x_kernel.launches == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="impl"):
        up2x(torch.zeros(1, 4, 2, 2), impl="interpolate")


# ---------------------------------------------------------------------- #
# dpt_tail (rows 12 and 14)
# ---------------------------------------------------------------------- #

def _tail_inputs(B, H, W, seed=0):
    """The scripts' inputs and scales: y (B, H, W, 128), w2 HWIO, b2, w3
    (32, 4), b3."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((B, H, W, 128)) * 0.3).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, 128, 32)) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal(32) * 0.05).astype(np.float32)
    w3 = (rng.standard_normal((32, 4)) * 0.2).astype(np.float32)
    b3 = (rng.standard_normal(4) * 0.1).astype(np.float32)
    return y, w2, b2, w3, b3


def _port_tail(y, w2, b2, w3, b3):
    """JAX-layout numpy -> the port's tensors."""
    return (torch.from_numpy(y).permute(0, 3, 1, 2),  # channels_last, no copy
            torch.from_numpy(w2).permute(3, 2, 0, 1).contiguous(), torch.from_numpy(b2),
            torch.from_numpy(np.ascontiguousarray(w3.T)).reshape(4, 32, 1, 1),
            torch.from_numpy(b3))


def _check_tail(got, want, tol=TAIL_TOL):
    pts, conf = got
    assert pts.is_contiguous() and conf.is_contiguous()
    for ours, theirs in zip((pts, conf), want):
        assert _rel(ours.numpy(), theirs) <= tol


@pytest.mark.parametrize("row", ["12", "14"])
@pytest.mark.parametrize("shape", [(1, 16, 16), (2, 16, 12)])
def test_dpt_tail_ref_matches_tpu_kernels_and_tail_xla(tpu, shape, row):
    args = _tail_inputs(*shape)
    fn = tpu["tail"].tail_pallas if row == "12" else tpu["tail2"].tail3_pallas
    with pltpu.force_tpu_interpret_mode():
        want = fn(*map(jnp.asarray, args), mm="f32")
    _check_tail(dpt_tail_ref(*_port_tail(*args), 1.0), want)
    _check_tail(dpt_tail_ref(*_port_tail(*args), 1.0), tpu["tail"].tail_xla(*args))


@pytest.mark.parametrize("row", ["12", "14"])
def test_dpt_tail_bf16_ref_matches_tpu_kernels_on_rounded_operands(tpu, row):
    """The kernel's function: fed y and w2 already rounded to bf16, the TPU
    kernels at mm='f32' form the same products."""
    y, w2, b2, w3, b3 = _tail_inputs(1, 16, 16, seed=1)
    y, w2 = _bf16(y), _bf16(w2)
    fn = tpu["tail"].tail_pallas if row == "12" else tpu["tail2"].tail3_pallas
    with pltpu.force_tpu_interpret_mode():
        want = fn(*map(jnp.asarray, (y, w2, b2, w3, b3)), mm="f32")
    _check_tail(dpt_tail_bf16_ref(*_port_tail(y, w2, b2, w3, b3), 1.0), want)


@pytest.mark.parametrize("shape", [(1, 13, 7), (2, 5, 9), (1, 1, 1), (2, 21, 37), (1, 17, 16),
                                   (1, 1, 5), (1, 5, 1)])
def test_dpt_tail_at_ragged_sizes_matches_tail_xla(tpu, shape):
    args = _tail_inputs(*shape, seed=2)
    want = tpu["tail"].tail_xla(*args)
    _check_tail(dpt_tail_ref(*_port_tail(*args), 1.0), want)
    want16 = tpu["tail"].tail_xla(_bf16(args[0]), _bf16(args[1]), *args[2:])
    _check_tail(dpt_tail_bf16_ref(*_port_tail(*args), 1.0), want16)


def test_dpt_tail_conf_offset_is_the_conf_modes():
    args = _port_tail(*_tail_inputs(1, 4, 4, seed=3))
    pts1, conf1 = dpt_tail_ref(*args, 1.0)
    pts0, conf0 = dpt_tail_ref(*args, 0.25)
    torch.testing.assert_close(pts0, pts1, rtol=0, atol=0)
    torch.testing.assert_close(conf0, conf1 - 0.75, rtol=1e-6, atol=1e-6)
    assert kernel_conf_vmin(("exp", -INF, INF), ("exp", 1, INF)) == 1.0
    for depth, conf in ((("linear", -INF, INF), ("exp", 1, INF)),
                        (("exp", -INF, INF), ("sigmoid", 0, 1)),
                        (("exp", -INF, INF), ("exp", 1, 10)),
                        (("exp", -INF, INF), None)):
        assert kernel_conf_vmin(depth, conf) is None


def test_dpt_tail_wrapper_and_dispatcher_on_cpu():
    args = _port_tail(*_tail_inputs(2, 6, 5, seed=4))
    want16, want32 = dpt_tail_bf16_ref(*args, 1.0), dpt_tail_ref(*args, 1.0)
    before = dpt_tail_kernel.launches
    for got in (dpt_tail_kernel(*args, 1.0), dpt_tail(*args, 1.0, impl="kernel")):
        for a, b in zip(got, want16):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    for got in (dpt_tail(*args, 1.0), dpt_tail(*args, 1.0, impl="ref")):
        for a, b in zip(got, want32):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert dpt_tail_kernel.launches == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="impl"):
        dpt_tail(*args, 1.0, impl="pallas")


def test_pack_w2_is_the_kernels_layout():
    """Row (dy * 3 + dx) * 128 + c, column n of the packed (9 * 128, 32)
    W2 is w2[n, c, dy, dx] rounded to bf16; unpack_w2 inverts it."""
    w2 = torch.randn(32, 128, 3, 3, generator=torch.Generator().manual_seed(0))
    p = pack_w2(w2)
    assert p.shape == (9 * 128, 32) and p.dtype == torch.bfloat16 and p.is_contiguous()
    for dy, dx, c, n in ((0, 0, 0, 0), (1, 2, 37, 3), (2, 1, 127, 31), (2, 2, 64, 17)):
        assert p[(dy * 3 + dx) * 128 + c, n] == w2[n, c, dy, dx].to(torch.bfloat16)
    assert torch.equal(unpack_w2(p), w2.to(torch.bfloat16))


@pytest.mark.parametrize("tap", range(9))
def test_pack_w2_tap_block_is_the_taps_weight(tap):
    """Rows tap * 128 ... tap * 128 + 127 of the packed W2 are the tap's
    (Cin, Cout) weight w2[:, :, dy, dx].T rounded to bf16, whole."""
    dy, dx = divmod(tap, 3)
    w2 = torch.randn(32, 128, 3, 3, generator=torch.Generator().manual_seed(tap))
    block = pack_w2(w2)[tap * 128:(tap + 1) * 128]
    assert torch.equal(block, w2[:, :, dy, dx].t().to(torch.bfloat16))


def test_packed_w2_unpacked_gives_the_tail_of_tail_xla(tpu):
    """The kernel's packed W2, unpacked, is w2 rounded to bf16: the fp32
    tail with it on bf16-rounded y equals the script's tail_xla on the same
    rounded operands, and the kernel's plain version."""
    y, w2, b2, w3, b3 = _tail_inputs(2, 7, 9, seed=7)
    args = _port_tail(y, w2, b2, w3, b3)
    unpacked = unpack_w2(pack_w2(args[1])).float()
    assert torch.equal(unpacked, args[1].to(torch.bfloat16).float())
    yr = args[0].to(torch.bfloat16).float()
    got = dpt_tail_ref(yr, unpacked, *args[2:], 1.0)
    _check_tail(got, tpu["tail"].tail_xla(_bf16(y), _bf16(w2), b2, w3, b3))
    for a, b in zip(got, dpt_tail_bf16_ref(*args, 1.0)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------- #
# the head that routes through them
# ---------------------------------------------------------------------- #

def _small_head(conv_impl=None, conf_mode=("exp", 1, INF), has_conf=True):
    return heads.DPTHead(16, ("exp", -INF, INF), conf_mode, has_conf, hooks=(0, 1, 2, 3),
                         enc_dim=32, dec_dim=32, conv_impl=conv_impl)


def _decout(rows, seed=5):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, rows * 2, 32)).astype(np.float32))
            for _ in range(4)]


@pytest.mark.parametrize("conv_impl", [None, "ref", "kernel"])
def test_dpt_head_calls_each_dispatcher(monkeypatch, conv_impl):
    """Per forward: 19 conv3x3 calls (head.2 is read by the tail, not
    called), 5 up2x calls (four fusion blocks and the head), one dpt_tail
    call with head.2's weights; each gets the head's conv_impl."""
    calls = {"conv3x3": [], "up2x": [], "dpt_tail": []}

    def spy(name, fn):
        def wrapped(x, *args):
            calls[name].append(args[-1])
            return fn(x, *args)
        return wrapped

    for name, attr in (("conv3x3", "conv3x3_op"), ("up2x", "up2x_op"),
                       ("dpt_tail", "dpt_tail_op")):
        monkeypatch.setattr(heads, attr, spy(name, getattr(heads, attr)))
    head = _small_head(conv_impl)
    w2 = head.dpt.head[2].weight
    seen_w2 = []
    orig_tail = heads.dpt_tail_op

    def tail_spy(y, w, *args):
        seen_w2.append(w)
        return orig_tail(y, w, *args)

    monkeypatch.setattr(heads, "dpt_tail_op", tail_spy)
    with torch.no_grad():
        out = head(_decout(3), (48, 32))
    assert out["pts3d"].shape == (1, 48, 32, 3) and out["conf"].shape == (1, 48, 32)
    assert [len(calls[k]) for k in ("conv3x3", "up2x", "dpt_tail")] == [19, 5, 1]
    assert all(impl == conv_impl for k in calls for impl in calls[k])
    assert len(seen_w2) == 1 and seen_w2[0] is w2


def test_dpt_adapter_packs_w2_once_per_weight_version():
    """The adapter keeps pack_w2(head.2's weight) between calls and packs
    again after an in-place update, as a Conv3x3 keeps its packing."""
    adapter = _small_head().dpt
    w2 = adapter.head[2].weight
    packed = adapter.packed_w2()
    assert adapter.packed_w2() is packed
    assert torch.equal(packed, pack_w2(w2))
    with torch.no_grad():
        w2.mul_(-0.5)
    again = adapter.packed_w2()
    assert again is not packed and torch.equal(again, pack_w2(w2))
    assert adapter.packed_w2() is again


@pytest.mark.parametrize("change", ["load_state_dict", "new_storage", "in_place_slice"])
def test_dpt_adapter_repacks_w2_after_each_kind_of_weight_change(change):
    """Whatever changes head.2's weight (a checkpoint loaded into it, its
    data replaced by another tensor, an in-place update of a part), the
    adapter's next packing follows it."""
    adapter = _small_head().dpt
    conv2 = adapter.head[2]
    packed = adapter.packed_w2()
    new = torch.randn(conv2.weight.shape, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        if change == "load_state_dict":
            conv2.load_state_dict({"weight": new, "bias": conv2.bias.clone()})
        elif change == "new_storage":
            conv2.weight.data = new
        else:
            conv2.weight[:, :7].zero_()
    again = adapter.packed_w2()
    assert again is not packed and torch.equal(again, pack_w2(conv2.weight))
    assert not torch.equal(again, packed)


def test_dpt_head_other_modes_run_the_modules_under_ref():
    """Modes the tail kernel does not take: 'ref' runs head.2-head.4 and the
    postprocess as modules; the kernel, asked for, raises."""
    decout = _decout(2, seed=6)
    exp_head = _small_head("ref")
    sig_head = _small_head("ref", conf_mode=("sigmoid", 0, 1))
    sig_head.load_state_dict(exp_head.state_dict(), strict=True)
    with torch.no_grad():
        want = exp_head(decout, (32, 32))
        got = sig_head(decout, (32, 32))
        # the raw conf channel from the exp head's confidence
        raw = torch.log(want["conf"] - 1.0)
    torch.testing.assert_close(got["pts3d"], want["pts3d"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got["conf"], torch.sigmoid(raw), rtol=1e-4, atol=1e-5)
    no_conf = _small_head("ref", has_conf=False)
    assert no_conf.dpt.head[4].out_channels == 3
    with torch.no_grad():
        assert sorted(no_conf(decout, (32, 32))) == ["pts3d"]
        _small_head(None, conf_mode=("sigmoid", 0, 1))(decout, (32, 32))  # auto: CPU -> 'ref'
        with pytest.raises(ValueError, match="dpt_tail kernel"):
            _small_head("kernel", conf_mode=("sigmoid", 0, 1))(decout, (32, 32))


def test_jax_weights_load_into_the_head_by_name():
    """state_dict_from_jax output loads into the head with strict=True, and
    the tail's weights keep their names (dpt.head.{0,2,4})."""
    from test_torch_port_model import CONFIGS, jax_model, seeded_variables

    cfg = CONFIGS["small_dpt"]
    sd = state_dict_from_jax(seeded_variables(jax_model("small_dpt"), 12), cfg["enc_depth"],
                             cfg["dec_depth"], "dpt")
    prefix = "downstream_head1."
    head_sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    head = heads.DPTHead(16, ("exp", -INF, INF), ("exp", 1, INF), hooks=(0, 6, 9, 12),
                         enc_dim=cfg["enc_embed_dim"], dec_dim=cfg["dec_embed_dim"])
    head.load_state_dict(head_sd, strict=True)
    names = {k for k in head.state_dict() if k.startswith("dpt.head.")}
    assert names == {f"dpt.head.{i}.{p}" for i in (0, 2, 4) for p in ("weight", "bias")}
    assert tuple(head.dpt.head[2].weight.shape) == (32, 128, 3, 3)
    assert tuple(head.dpt.head[4].weight.shape) == (4, 32, 1, 1)
    torch.testing.assert_close(head.dpt.head[4].bias, head_sd["dpt.head.4.bias"])
