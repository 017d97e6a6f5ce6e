"""TPU kernel rows 10, 11 (the tap-sum 3x3 conv) and 13 (the DPT tail's
epilogue) against the port's plain versions on the CPU.

The TPU kernels are the experiment scripts' Pallas kernels, loaded from
`scripts/` by path (they are no package) and run in TPU interpret mode
(`pltpu.force_tpu_interpret_mode()`), with no edit to the scripts:
  * row 11, `exp_convk2_r3.conv3x3_pallas`, as it is;
  * row 10, `exp_convk_r3._tap_kernel` under a `pallas_call` of its
    wrapper's specs, fed the weight packed as row 11 packs it: the
    script's own wrapper packs it wrongly (`exp_convk_r3.py:72-74` mixes dx
    with Cin), which `test_row10_wrapper_packs_its_weight_wrongly` shows;
  * row 13, `exp_tailk2_r2.post_pallas` (32-row blocks: H % 32 == 0).
Their port counterparts run on CPU tensors, so the wrappers return their
plain versions (the kernels are held to them on the card by
tests/test_torch_port_kernels.py and chip_smoke.py). Weights cross over by
transposing HWIO to (Cout, Cin, 3, 3) and (32, 4) to (4, 32, 1, 1).

Tolerances, max abs error over max |TPU output|:
  * rows 10 and 11, 2^-8, one bf16 unit of the largest output: both round
    Z to bf16 after fp32 sums, and a sum ordered otherwise can round the
    other way (at (2,16,16,96->64) one element of 32,768 does, 1.3e-3);
  * row 13, 1e-5 of max |pts| and of max |conf|: fp32 throughout; the
    script's exp(d) - 1 against expm1 differs by ~6e-8.
"""
import importlib.util
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dust3r_tpu_torch.ops.conv3x3_taps import (CORES, VARIANTS, combine_rows,
                                               conv3x3_taps_kernel, conv3x3_taps_ref, pack_for,
                                               pack_tap_weight, pack_tap_weight_kmajor,
                                               tap_inputs, tap_sums)
from dust3r_tpu_torch.ops.dpt_post import dpt_post_kernel, dpt_post_ref

SCRIPTS = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "scripts")
CONV_SHAPES = [(2, 8, 12, 32, 32), (2, 16, 16, 96, 64)]  # B, H, W, Cin, Cout
CONV_TOL = 2.0 ** -8
# the port's bf16 result against the fp32 conv: two bf16 units of the
# largest output (Z's rounding and y's; measured 5.7e-3 and 5.6e-3)
EXACT_TOL = 2.0 ** -7
POST_TOL = 1e-5


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_tpu_{name}", osp.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tpu():
    return {row: _script(name) for row, name in (
        (10, "exp_convk_r3"), (11, "exp_convk2_r3"), (13, "exp_tailk2_r2"))}


def _conv_inputs(shape, seed=0):
    """x NHWC and w HWIO as the scripts draw them, and their torch forms:
    x (B, Cin, H, W) channels_last, w (Cout, Cin, 3, 3)."""
    B, H, W, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    tw = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    assert tx.is_contiguous(memory_format=torch.channels_last)
    return jnp.asarray(x), jnp.asarray(w), tx, tw


def _rel(ours, theirs):
    ours = ours.float().permute(0, 2, 3, 1).numpy() if isinstance(ours, torch.Tensor) else ours
    theirs = np.asarray(theirs, np.float32)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    return float(np.abs(ours - theirs).max() / np.abs(theirs).max())


def _row10(module, x, w):
    """Row 10's kernel body under its wrapper's specs, the weight packed as
    row 11 packs it: (dy, dx, Cin, Cout) -> (dx, Cin, dy * Cout)."""
    B, H, W, cin = x.shape
    cout = w.shape[-1]
    th = module._pick_th(H)
    xb = jnp.pad(x.astype(jnp.bfloat16), ((0, 0), (0, 0), (1, 1), (0, 0)))
    wcat = w.astype(jnp.bfloat16).transpose(1, 2, 0, 3).reshape(3, cin, 3 * cout)
    z = pl.pallas_call(
        module._tap_kernel, grid=(B, H // th),
        in_specs=[pl.BlockSpec((1, th, W + 2, cin), lambda b, t: (b, t, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((3, cin, 3 * cout), lambda b, t: (0, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, th, W, 3 * cout), lambda b, t: (b, t, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((B, H, W, 3 * cout), jnp.bfloat16))(xb, wcat)
    zp = jnp.pad(z, ((0, 0), (1, 1), (0, 0), (0, 0)))  # the script's combine
    return sum(jax.lax.slice(zp, (0, dy, 0, dy * cout), (B, dy + H, W, (dy + 1) * cout))
               for dy in range(3))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tap_sum_conv_matches_the_tpu_kernel(tpu, shape, variant, monkeypatch):
    """Row 10 ("slices") and row 11 ("copies") against the plain version
    and the wrapper on CPU tensors (the same function for both variants).
    A spy on `conv3x3_taps_ref` shows that the wrapper returns its plain
    version's one call (two CPU calls need not agree to the bit under
    load); that result is held to the TPU kernel."""
    from dust3r_tpu_torch.ops import conv3x3_taps

    jx, jw, tx, tw = _conv_inputs(shape)
    with pltpu.force_tpu_interpret_mode():
        if variant == "slices":
            out = _row10(tpu[10], jx, jw)
        else:
            out = tpu[11].conv3x3_pallas(jx, jw)
    assert out.dtype == jnp.bfloat16
    calls = []

    def spy(*args):
        calls.append(conv3x3_taps_ref(*args))
        return calls[-1]

    monkeypatch.setattr(conv3x3_taps, "conv3x3_taps_ref", spy)
    before = (tap_sums.slices_launches, tap_sums.copies_launches)
    ours = conv3x3_taps_kernel(tx, tw, variant)
    assert (tap_sums.slices_launches, tap_sums.copies_launches) == before
    assert len(calls) == 1 and ours is calls[0] and ours.dtype == torch.bfloat16
    assert ours.is_contiguous(memory_format=torch.channels_last)
    assert _rel(ours, out.astype(jnp.float32)) <= CONV_TOL


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_row10_wrapper_packs_its_weight_wrongly(tpu, shape):
    """Row 10's own `conv3x3_pallas` reshapes the (dx, Cin, dy, Cout)
    transpose to (Cin, 3, 3 * Cout), mixing dx with Cin: it lies more than
    max |y| away from the script's `conv_ref` (1.31x and 1.39x here). The
    port packs as row 11 does and lies within two bf16 units of it."""
    jx, jw, tx, tw = _conv_inputs(shape, seed=1)
    exact = np.asarray(tpu[10].conv_ref(jx, jw))
    with pltpu.force_tpu_interpret_mode():
        wrong = tpu[10].conv3x3_pallas(jx, jw).astype(jnp.float32)
    assert _rel(np.asarray(wrong), exact) > 1.0
    assert _rel(conv3x3_taps_ref(tx, tw), exact) <= EXACT_TOL


def test_pack_tap_weight_is_row_11s_packing():
    _, jw, _, tw = _conv_inputs((1, 4, 4, 32, 64))
    want = np.asarray(jw.astype(jnp.bfloat16).transpose(1, 2, 0, 3).reshape(3, 32, 192)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(pack_tap_weight(tw).float().numpy(), want)


def test_pack_tap_weight_kmajor_is_a_permutation_of_row_11s():
    """The sm90 kernel's packing holds row 11's values with its last two
    dims swapped: [dx, dy * Cout + c, ci] = row 11's [dx, ci, dy * Cout + c]."""
    _, jw, _, tw = _conv_inputs((1, 4, 4, 96, 32))
    row11 = np.asarray(jw.astype(jnp.bfloat16).transpose(1, 2, 0, 3).reshape(3, 96, 96)
                       .astype(jnp.float32))
    kmajor = pack_tap_weight_kmajor(tw)
    assert kmajor.shape == (3, 96, 96) and kmajor.dtype == torch.bfloat16
    assert kmajor.is_contiguous()
    np.testing.assert_array_equal(kmajor.float().numpy(), row11.transpose(0, 2, 1))
    assert torch.equal(kmajor, pack_tap_weight(tw).transpose(1, 2))
    assert torch.equal(pack_for(tw), kmajor) and torch.equal(pack_for(tw, "sm90"), kmajor)
    assert torch.equal(pack_for(tw, "mma"), pack_tap_weight(tw))


@pytest.mark.parametrize("H", [1, 2, 7, 13])
def test_combine_rows_gives_the_padded_formulas_bits(H):
    """y = Z_1; y[1:] += Z_0[:-1]; y[:-1] += Z_2[1:] against the scripts'
    sum over the H-padded Z, (Z_0[h-1] + Z_1[h]) + Z_2[h+1], bit for bit."""
    cout = 32
    rng = np.random.default_rng(H)
    z = torch.from_numpy(rng.standard_normal((2, H, 5, 3 * cout)).astype(np.float32)).to(
        torch.bfloat16)
    zp = F.pad(z, (0, 0, 0, 0, 1, 1))
    want = (zp[:, 0:H, :, 0:cout] + zp[:, 1:H + 1, :, cout:2 * cout]) \
        + zp[:, 2:H + 2, :, 2 * cout:3 * cout]
    got = combine_rows(z, cout)
    assert got.dtype == torch.bfloat16 and got.shape == (2, cout, H, 5)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want.permute(0, 3, 1, 2))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("core", [None, *CORES], ids=["default", *CORES])
def test_cpu_tensors_take_the_plain_version_on_either_core(core, variant):
    _, _, tx, tw = _conv_inputs((2, 5, 7, 32, 64), seed=2)
    before = (tap_sums.slices_launches, tap_sums.copies_launches, tap_sums.mma_launches)
    out = conv3x3_taps_kernel(tx, tw, variant, core)
    assert torch.equal(out, conv3x3_taps_ref(tx, tw, variant))
    assert (tap_sums.slices_launches, tap_sums.copies_launches, tap_sums.mma_launches) == before


def test_conv_taps_refuse_an_unknown_core_and_a_weight_packed_for_another():
    _, _, tx, tw = _conv_inputs((1, 4, 4, 64, 32))
    taps = tap_inputs(tx.permute(0, 2, 3, 1).to(torch.bfloat16), "slices")
    before = (tap_sums.slices_launches, tap_sums.copies_launches, tap_sums.mma_launches)
    for call in (lambda: conv3x3_taps_kernel(tx, tw, "slices", "tma"),
                 lambda: conv3x3_taps_kernel(tx, tw, "copies", core="cuda"),
                 lambda: pack_for(tw, "mma.sync"),
                 lambda: tap_sums(taps, pack_for(tw), "slices", core="tma")):
        with pytest.raises(ValueError, match="core"):
            call()
    # Cin 64 and 3 * Cout 96: each core's packing has the other's shape wrong
    with pytest.raises(ValueError, match="pack_for"):
        tap_sums(taps, pack_for(tw, "mma"), "slices")
    with pytest.raises(ValueError, match="pack_for"):
        tap_sums(taps, pack_for(tw), "slices", core="mma")
    with pytest.raises(ValueError, match="tap_inputs"):
        tap_sums(taps, pack_for(tw), "copies")
    assert (tap_sums.slices_launches, tap_sums.copies_launches, tap_sums.mma_launches) == before


def test_conv_taps_refuse_what_the_kernel_cannot_take():
    _, _, tx, tw = _conv_inputs((1, 4, 4, 64, 32))
    before = (tap_sums.slices_launches, tap_sums.copies_launches)
    with pytest.raises(ValueError, match="multiples of 32"):
        conv3x3_taps_kernel(tx[:, :48].contiguous(memory_format=torch.channels_last),
                            tw[:, :48])
    with pytest.raises(ValueError, match="multiples of 32"):
        conv3x3_taps_kernel(tx, tw[:16])
    with pytest.raises(TypeError, match="fp32"):
        conv3x3_taps_kernel(tx.to(torch.bfloat16), tw)
    with pytest.raises(ValueError, match="channels_last"):
        conv3x3_taps_kernel(tx.contiguous(), tw)
    with pytest.raises(ValueError, match="variant"):
        conv3x3_taps_kernel(tx, tw, "rolls")
    with pytest.raises(ValueError, match="want"):
        conv3x3_taps_kernel(tx, tw[..., :2, :2])
    assert (tap_sums.slices_launches, tap_sums.copies_launches) == before


def _post_inputs(B, H, W, seed=0):
    """h = relu'd conv2 output NHWC, w3 (32, 4), b3 as the script draws
    them, and their torch forms."""
    rng = np.random.default_rng(seed)
    h = np.maximum(rng.standard_normal((B, H, W, 32)) * 0.5, 0).astype(np.float32)
    w3 = (rng.standard_normal((32, 4)) * 0.2).astype(np.float32)
    b3 = (rng.standard_normal(4) * 0.1).astype(np.float32)
    th = torch.from_numpy(h).permute(0, 3, 1, 2)
    tw3 = torch.from_numpy(w3).t().reshape(4, 32, 1, 1).contiguous()
    return (jnp.asarray(h), jnp.asarray(w3), jnp.asarray(b3)), (th, tw3, torch.from_numpy(b3))


@pytest.mark.parametrize("B,H,W", [(2, 32, 12), (1, 64, 20)])
def test_dpt_post_matches_the_tpu_kernel(tpu, B, H, W):
    jargs, targs = _post_inputs(B, H, W, seed=H)
    with pltpu.force_tpu_interpret_mode():
        pts, conf = tpu[13].post_pallas(*jargs)
    before = dpt_post_kernel.launches
    ours = dpt_post_kernel(*targs, 1.0)
    assert dpt_post_kernel.launches == before
    ref = dpt_post_ref(*targs, 1.0)
    for got, want, theirs in zip(ours, ref, (pts, conf)):
        assert torch.equal(got, want) and got.is_contiguous() and got.dtype == torch.float32
        theirs = np.asarray(theirs)
        assert got.shape == theirs.shape
        assert np.abs(got.numpy() - theirs).max() <= POST_TOL * np.abs(theirs).max()


def test_dpt_post_refuses_what_the_kernel_cannot_take():
    _, (h, w3, b3) = _post_inputs(1, 4, 4)
    before = dpt_post_kernel.launches
    with pytest.raises(ValueError, match="channels_last"):
        dpt_post_kernel(h.contiguous(), w3, b3)
    with pytest.raises(ValueError, match="want"):
        dpt_post_kernel(h[:, :16].contiguous(memory_format=torch.channels_last), w3[:, :16], b3)
    with pytest.raises(TypeError, match="fp32"):
        dpt_post_kernel(h.double(), w3, b3)
    assert dpt_post_kernel.launches == before


def test_taps_probe_needs_a_card(monkeypatch):
    from dust3r_tpu_torch.tools import taps_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        taps_probe.main([])


@pytest.mark.parametrize("name", ["no_store", "no_tma", "a_once", "b_once"])
def test_taps_probe_takes_one_cost_out_of_the_kernel_source(name):
    """Each probe variant is the kernel's source with its own lines guarded
    (and, for the loads, the bytes the stage waits for), nothing else."""
    from dust3r_tpu_torch.ops import _build
    from dust3r_tpu_torch.tools import taps_probe as tp

    src = (_build.CSRC / "conv3x3_taps.cu").read_text()
    assert tp.variant_source(src, "base") == src
    out = tp.variant_source(src, name)
    want = {"no_store": [tp.NEVER + tp.STORE], "no_tma": [tp.NEVER + tp.TMA],
            "a_once": ["if (it < kS || dx == 0) " + tp.ALOAD, "if (true) " + tp.BLOAD],
            "b_once": ["if (true) " + tp.ALOAD, "if (it < kS) " + tp.BLOAD]}[name]
    for guarded in want:
        assert out.count(guarded) == 1
    changed = [a for a, b in zip(src.splitlines(), out.splitlines()) if a != b]
    assert len(src.splitlines()) == len(out.splitlines())
    assert len(changed) == (1 if name in ("no_store", "no_tma") else 3)


def test_conv_variants_tool_needs_a_card(monkeypatch):
    from dust3r_tpu_torch.tools import conv_variants

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        conv_variants.main([])
