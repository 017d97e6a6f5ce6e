"""The yardstick's own arithmetic: the traffic generator, the frozen FLOP
count, the metric readers and the trace reader."""
from __future__ import annotations

import json
from collections import Counter

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench import check, flops, run, scenes, tracing

DPT = json.loads((ROOT / "portbench/configs/DUSt3R_ViTLarge_BaseDecoder_512_dpt.json").read_text())
LIN = dict(DPT, arch=dict(DPT["arch"], head_type="linear"))  # the published 512_linear


def metric(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    return run.load_file(path, "m_" + name.replace(".", "_"))


@pytest.mark.parametrize("mix", ["pose10"])
def test_each_mix_is_the_same_for_a_seed_and_the_same_sizes_for_any(mix):
    m = scenes.load_mix(mix)
    big = 2 ** 31 + 12345
    assert scenes.cycle(m, big) == scenes.cycle(m, big)
    assert Counter(scenes.cycle(m, big)) == Counter(scenes.cycle(m, 7))
    spec = m["scenes"][0]
    a, b = scenes.images(big, 0, 0, spec), scenes.images(big, 0, 0, spec)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], scenes.images(big + 1, 0, 0, spec)[0])
    assert a[0].shape == (spec["height"], spec["width"], 3) and a[0].dtype == np.uint8
    assert scenes.check_sample(m, big) == scenes.check_sample(m, big)


def test_frozen_flops_match_the_hand_counts():
    a, H, W = DPT["arch"], 384, 512
    assert flops.encoder_flops(a, H, W) == pytest.approx(5.2305e11, rel=1e-4)
    assert flops.decoder_flops(a, H, W) == pytest.approx(2.1864e11, rel=1e-4)
    assert flops.head_flops(a, H, W) == pytest.approx(1.5943e11, rel=1e-4)
    assert flops.head_flops(LIN["arch"], H, W) == pytest.approx(1.208e9, rel=1e-3)
    assert flops.scene_flops(a, 10, 90, H, W) / 90 == pytest.approx(8.1425e11, rel=1e-4)
    assert flops.scene_flops(LIN["arch"], 10, 90, H, W) / 90 == pytest.approx(4.9781e11, rel=1e-4)


def test_kernel_call_shapes():
    calls = flops.conv3x3_calls(384, 512, 16)
    assert len(calls) == 19
    assert Counter((m // 16, cin, cout) for m, cin, cout, _ in calls) == Counter(
        {(96 * 128, 96, 256): 1, (48 * 64, 192, 256): 1, (24 * 32, 384, 256): 1,
         (12 * 16, 768, 256): 1, (12 * 16, 256, 256): 2, (24 * 32, 256, 256): 4,
         (48 * 64, 256, 256): 4, (96 * 128, 256, 256): 4, (192 * 256, 256, 128): 1})
    assert [(m // 16) for m, *_ in flops.conv3x3_calls(336, 512, 16)][3] == 11 * 16
    enc, dec = flops.attention_calls(DPT["arch"], 384, 512, 16, 2, 6)
    assert enc == (16, 16, 768, 768, 64, 48) and dec == (16, 12, 768, 768, 64, 288)
    # the bf16 bound of PERF.md's row 1 shape: (8, 16, 768, 64)
    assert flops.attention_bound_s(8, 16, 768, 768, 64) == pytest.approx(19.5e-6, rel=0.01)


def _records(**kw):
    rec = dict(setup_s=12.5, batch_size=16, arch=DPT["arch"], window_s=2.0, encoder_batches=2,
               pair_batches=12, scenes=[dict(images=10, pairs=90, height=384, width=512,
                                             seconds=1.0)] * 2)
    rec.update(kw)
    return rec


def test_metric_readers_on_records():
    rec = _records()
    assert metric("pairs_per_s").read(rec) == 90.0
    assert metric("setup_s").read(rec) == 12.5
    assert metric("pad_pct").read(rec) == 6.25
    assert metric("enc_pad_pct").read(rec) == 37.5
    mfu = metric("mfu_pct.infer").read(rec)
    assert mfu == pytest.approx(100 * 180 * 8.1425e11 / 2.0 / 989e12, rel=1e-4)
    for name in ("attn_roofline_pct", "conv3x3_roofline_pct", "device_idle_pct.infer"):
        assert metric(name).read(rec) is None  # no trace: nothing to read


def test_rooflines_read_only_when_every_call_is_one_launch():
    traced = [dict(images=10, pairs=90, height=384, width=512, seconds=0.0)]
    calls = 24 * 1 + 48 * 6
    bound = sum(c * flops.attention_bound_s(*shape) for *shape, c in
                flops.attention_calls(DPT["arch"], 384, 512, 16, 1, 6))
    kernels = {"void attn_sm90_kernel<true, 0>": [calls, 0.05],
               "conv3x3_sm90_kernel<128>": [2 * 6 * 19, 0.1]}
    trace = dict(window_s=1.0, busy_s=0.75, kernels=kernels)
    rec = _records(trace=trace, traced_scenes=traced)
    assert metric("attn_roofline_pct").read(rec) == pytest.approx(100 * bound / 0.05)
    assert 0 < metric("conv3x3_roofline_pct").read(rec) < 100
    assert metric("device_idle_pct.infer").read(rec) == pytest.approx(25.0)
    trace["kernels"]["void attn_sm90_kernel<true, 0>"][0] += 1
    assert metric("attn_roofline_pct").read(rec) is None
    assert metric("conv3x3_roofline_pct").read(_records(trace=trace, traced_scenes=traced,
                                                        arch=LIN["arch"])) is None


def test_trace_reader(tmp_path):
    ev = [dict(ph="X", cat="user_annotation", name=tracing.SPAN, ts=0, dur=100, tid=1),
          dict(ph="X", cat="cpu_op", name="aten::addmm", ts=10, dur=30, tid=1),
          dict(ph="X", cat="cpu_op", name="aten::empty", ts=15, dur=2, tid=1),
          dict(ph="X", cat="cpu_op", name="other thread", ts=60, dur=30, tid=2),
          dict(ph="X", cat="kernel", name="k1", ts=5, dur=10),
          dict(ph="X", cat="kernel", name="k2", ts=12, dur=8),
          dict(ph="X", cat="gpu_memcpy", name="copy", ts=50, dur=10),
          dict(ph="X", cat="kernel", name="k1", ts=95, dur=20)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps(dict(traceEvents=ev)))
    t = tracing.read(path)
    assert t["window_s"] == pytest.approx(100e-6) and t["busy_s"] == pytest.approx(30e-6)
    assert t["kernels"]["k1"] == [2, pytest.approx(15e-6)]
    assert tracing.kernel_time(t, "k") == (3, pytest.approx(23e-6))
    gaps = dict(t["idle_gaps"])  # 0-5 and 60-95 outside ops, 20-50 in addmm
    assert gaps["aten::addmm"] == pytest.approx(30e-6)
    assert gaps[tracing.OUTSIDE] == pytest.approx(40e-6)
    assert t["device_ops"][0][0] == "k1"


def test_the_numbers_compared():
    ref = torch.zeros(2, 4, 6, 3)
    got = ref.clone()
    got[0, :, :, 0] = 3.0
    got[0, :, :, 1] = 4.0  # every pixel of view 0 lies 5 away
    assert check.rms(got, ref).tolist() == [5.0, 0.0]
    got[1, 0, 0, 2] = float("nan")
    assert check.rms(got, ref)[1] == float("inf")
    assert check.rel_l2(torch.ones(1, 2, 2) * 1.1, torch.ones(1, 2, 2)).item() == pytest.approx(0.1)
    ok, checks = check.verdict(dict(pts3d_rmse=1e-4, conf_err=9.0), dict(pts3d_rmse=1.5e-4))
    assert ok and list(checks) == ["pts3d_rmse"]
    assert not check.verdict({}, dict(pts3d_rmse=1.5e-4))[0]
