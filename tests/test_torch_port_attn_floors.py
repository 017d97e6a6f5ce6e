"""The floor modes of TPU kernel row 3 against the port's plain version on
the CPU.

The TPU kernel is `scripts/exp_attn_r2.py::attn_g`, loaded by path (the
scripts are no package) and run in TPU interpret mode
(`pltpu.force_tpu_interpret_mode()`), with no edit to the script, in each
floor mode at the heads a program the script runs it with: `nosmax` and
`copynr` at G = 1, 2, 4 (its live loop), `qkonly`, `copy` and `copymm` at
G = 1, 4 (its later loops). The port's counterpart, `attention_floor`, runs
on CPU tensors, so it returns its plain version, `attention_floor_ref` (the
kernels are held to it on the card by tests/test_torch_port_kernels.py and
chip_smoke.py).

The inputs are (2, 4, 96, 64) on an 8x12 token grid: the script's `qkonly`
writes `s[:, :d]`, which fails for fewer than d = 64 keys.

Tolerances, max abs error over max |TPU output|: fp32 1e-5, the same
arithmetic with fp32 sums in another order; bf16 2^-7, one bf16 unit of
the largest output, where one rounding of the two packages (q or k after
RoPE, a logit before P.v, the sum before its last rounding) falls the
other way.
"""
import importlib.util
import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dust3r_tpu_torch.ops.attention_floors import (COPY_MODES, MODES, attention_floor,
                                                   attention_floor_ref, rot_matrix, rot_tile)
from dust3r_tpu_torch.ops.rope import rotate_half
from dust3r_tpu_torch.tools.attn_variants import bf16_units_apart

SCRIPTS = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "scripts")
B, H, N, D = 2, 4, 96, 64  # an 8x12 token grid
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": 1e-5, "bf16": 2.0 ** -7}
CASES = ([(G, m) for m in ("nosmax", "copynr") for G in (1, 2, 4)]
         + [(G, m) for m in ("qkonly", "copy", "copymm") for G in (1, 4)])


@pytest.fixture(scope="module")
def row3():
    spec = importlib.util.spec_from_file_location("_tpu_exp_attn_r2",
                                                  osp.join(SCRIPTS, "exp_attn_r2.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _grid_positions(b=B, h=8, w=12):
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([ys.ravel(), xs.ravel()], -1)[None].repeat(b, 0).astype(np.int32)


def _inputs(seed, dtype, n=N, nk=N):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, H, m, D)).astype(np.float32) for m in (n, nk, nk)]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays], [torch.from_numpy(a).to(tdt) for a in arrays])


def _rel(ours, theirs):
    ours = ours.float().numpy()
    theirs = np.asarray(theirs, np.float32)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    return float(np.abs(ours - theirs).max() / np.abs(theirs).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("G,mode", CASES)
def test_row3_floor_matches_the_tpu_kernel(row3, G, mode, dtype, monkeypatch):
    """The wrapper on CPU tensors returns what its plain version returns:
    a spy on `attention_floor_ref` records its one call, and the wrapper's
    output is that call's result (the CPU fp32 matmul is not bit-stable
    from one call to the next under load, so a second call is no witness).
    That result is held to the TPU kernel."""
    from dust3r_tpu_torch.ops import attention_floors

    (jq, jk, jv), (tq, tk, tv) = _inputs(30 + MODES.index(mode), dtype)
    pos = _grid_positions()
    with pltpu.force_tpu_interpret_mode():
        out = row3.attn_g(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos), G, mode=mode)
    tpos = torch.from_numpy(pos)
    calls = []

    def spy(*args):
        calls.append(attention_floor_ref(*args))
        return calls[-1]

    monkeypatch.setattr(attention_floors, "attention_floor_ref", spy)
    before = attention_floor.launches
    ours = attention_floor(tq, tk, tv, tpos, tpos, mode=mode, heads_per_program=G)
    assert attention_floor.launches == before  # CPU tensors: the plain version
    assert len(calls) == 1 and ours is calls[0] and ours.dtype == tv.dtype
    assert _rel(ours, out) <= TOL[dtype]


def test_rot_matrix_is_the_scripts(row3):
    for d in (16, 64):
        np.testing.assert_array_equal(rot_matrix(d).numpy(), row3.rot_matrix(d))


@pytest.mark.parametrize("d", [16, 64])
def test_rot_tile_is_the_transpose_of_rot_matrix_and_rotates_exactly(d):
    """The P^T tile the sm90 kernel builds for copymm (mirrored by
    `rot_tile`): q times its transpose is rotate-half(q) within each half,
    bit for bit in bf16, as the kernel's product with fp32 sums gives it
    (one nonzero term a sum)."""
    tile = rot_tile(d)
    np.testing.assert_array_equal(tile.numpy(), rot_matrix(d).numpy().T)
    q = torch.from_numpy(np.random.default_rng(d).standard_normal((3, 5, 96, d))
                         .astype(np.float32)).to(torch.bfloat16)
    rot = torch.matmul(q.float(), tile.T).to(torch.bfloat16)
    want = torch.cat([rotate_half(q[..., :d // 2]), rotate_half(q[..., d // 2:])], -1)
    assert torch.equal(rot, want)


@pytest.mark.parametrize("mode", COPY_MODES)
def test_copy_floors_take_the_sm90_kernel_and_serve_cpu_tensors_plainly(mode):
    """core="sm90" names the kernel of every floor; on CPU tensors the call
    returns the plain version and launches nothing, whichever core it
    names."""
    _, (tq, tk, tv) = _inputs(43 + COPY_MODES.index(mode), "bf16")
    pos = torch.from_numpy(_grid_positions())
    before = (attention_floor.launches, attention_floor.core_launches)
    ref = attention_floor_ref(tq, tk, tv, pos, pos, 100.0, mode)
    for core in ("sm90", "mma", None):
        out = attention_floor(tq, tk, tv, pos, pos, mode=mode, core=core, heads_per_program=2)
        assert torch.equal(out, ref)
    assert (attention_floor.launches, attention_floor.core_launches) == before


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_copymm_is_copy_up_to_rounding(dtype):
    """The product with the signed permutation is exact, so copymm and copy
    differ only where an fp32 multiply-add is ordered differently."""
    _, (tq, tk, tv) = _inputs(40, dtype)
    pos = torch.from_numpy(_grid_positions())
    mm = attention_floor_ref(tq, tk, tv, pos, pos, mode="copymm")
    plain = attention_floor_ref(tq, tk, tv, pos, pos, mode="copy")
    assert _rel(mm, plain.float().numpy()) <= TOL[dtype]


def test_floors_refuse_what_they_cannot_serve():
    _, (tq, tk, tv) = _inputs(41, "fp32")
    pos = torch.from_numpy(_grid_positions())
    short = torch.from_numpy(_grid_positions(B, 6, 8))  # 48 keys < d
    before = attention_floor.launches
    with pytest.raises(ValueError, match="Nk = 48"):
        attention_floor(tq, tk[:, :, :48], tv[:, :, :48], pos, short, mode="qkonly")
    for G in (3, 8):
        with pytest.raises(ValueError, match="not in"):
            attention_floor(tq, tk, tv, pos, pos, mode="nosmax", heads_per_program=G)
    with pytest.raises(ValueError, match="mode"):
        attention_floor(tq, tk, tv, pos, pos, mode="nomax")
    with pytest.raises(ValueError, match="mode"):
        attention_floor_ref(tq, tk, tv, pos, pos, mode="plain")
    with pytest.raises(ValueError, match="positions"):
        attention_floor(tq, tk, tv, None, None, mode="copynr")
    with pytest.raises(ValueError, match="must agree"):
        attention_floor(tq, tk[:, :, :64], tv[:, :, :64], pos, short, mode="copy")
    assert attention_floor.launches == before


def test_nosmax_serves_fewer_keys_than_queries():
    """nosmax takes any Nk (the zero keys past a ragged tile add nothing);
    its plain version is bf16(q k^T) v."""
    _, (tq, tk, tv) = _inputs(42, "bf16", nk=48)
    pq = torch.from_numpy(_grid_positions())
    pk = torch.from_numpy(_grid_positions(B, 6, 8))
    out = attention_floor(tq, tk, tv, pq, pk, mode="nosmax")
    assert out.shape == tq.shape and torch.isfinite(out).all()


def test_bf16_units_apart_counts_bf16_steps():
    """The distance the card's tests hold the copy floors to: 0 for the same
    value (+0 and -0 too), 1 between neighbours, across zero the steps on
    both sides."""
    a = torch.tensor([1.0, 1.0, -2.0, 0.0, 3.0], dtype=torch.bfloat16)
    b = torch.tensor([1.0, 1.0078125, -2.015625, -0.0, -3.0], dtype=torch.bfloat16)
    tiny = torch.tensor([2.0 ** -133, -2.0 ** -133], dtype=torch.bfloat16)
    assert bf16_units_apart(a, b).tolist() == [0, 1, 1, 0, 2 * 0x4040]
    assert bf16_units_apart(tiny[:1], tiny[1:]).tolist() == [2]
