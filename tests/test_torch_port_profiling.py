"""The port's `utils/flops.py` and `utils/profiling.py` against the JAX
package's, on the CPU.

* Every count of `flops.py` equals JAX's for the same arguments: each head
  type, both `upsample` values, the five 512 buckets and 224; the
  constants too, but for the peak, which is the card's (H100 SXM5 dense
  bf16, 989 TFLOP/s) where JAX's is the v5e's.
* `trace` around a TINY forward with `annotate("encode")` around its
  encoder writes a Chrome trace that holds the span (also when the block
  raises).
* `PhaseTimer.summary()` and its repr equal JAX's under one patched clock.
"""
import json
import time

import numpy as np
import pytest
import torch

import dust3r_tpu.utils.flops as jflops
import dust3r_tpu.utils.profiling as jprofiling
from dust3r_tpu_torch.models.model import AsymmetricCroCo3DStereo
from dust3r_tpu_torch.utils import flops, profiling

SIZES = [(512, 384), (512, 336), (512, 288), (512, 256), (512, 160), (224, 224)]
COUNTS = ("encoder_flops_per_image", "decoder_flops_per_image", "linear_head_flops_per_image")


@pytest.mark.parametrize("W,H", SIZES)
def test_flop_counts_equal_jax(W, H):
    for name in COUNTS:
        assert getattr(flops, name)(H, W) == getattr(jflops, name)(H, W), name
        assert getattr(flops, name)(W, H) == getattr(jflops, name)(W, H), name
    for upsample in ("matmul", "lerp"):
        assert (flops.dpt_head_flops_per_image(H, W, upsample=upsample)
                == jflops.dpt_head_flops_per_image(H, W, upsample=upsample))
        for head in ("dpt", "linear"):
            got = flops.pair_forward_flops(H, W, head, upsample=upsample)
            assert got == jflops.pair_forward_flops(H, W, head, upsample=upsample) > 0
            for pairs_s in (1.0, 37.5):
                assert (flops.mfu_pct(pairs_s, H, W, head, peak_tflops=123.0, upsample=upsample)
                        == jflops.mfu_pct(pairs_s, H, W, head, peak_tflops=123.0,
                                          upsample=upsample))
                assert flops.mfu_pct(pairs_s, H, W, head, upsample=upsample) == pytest.approx(
                    100.0 * pairs_s * got / 989e12, rel=1e-12)
    n = (H // 16) * (W // 16)
    for c in (768, 1024):
        assert flops._block(n, c) == jflops._block(n, c)
        assert flops._dec_block(n, c) == jflops._dec_block(n, c)
        assert flops._attn(n, c) == jflops._attn(n, c)
    assert flops._conv(n, 3, 256, 128) == jflops._conv(n, 3, 256, 128)
    for upsample in ("matmul", "lerp"):
        assert flops._up2x(H // 4, W // 4, 256, upsample) == jflops._up2x(H // 4, W // 4, 256,
                                                                          upsample)


def test_flop_constants():
    for name in ("ENC_DIM", "ENC_DEPTH", "ENC_HEADS", "DEC_DIM", "DEC_DEPTH", "DEC_HEADS",
                 "PATCH", "MLP_RATIO"):
        assert getattr(flops, name) == getattr(jflops, name), name
    assert flops.PEAK_TFLOPS_BF16 == 989.0


def _tiny():
    return AsymmetricCroCo3DStereo(img_size=(32, 32), enc_embed_dim=32, enc_depth=1,
                                   enc_num_heads=2, dec_embed_dim=32, dec_depth=1,
                                   dec_num_heads=2, device="cpu")


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_holds_the_spans(tmp_path):
    model = _tiny()
    img = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 32, 32, 3),
                                                                   dtype=np.float32))
    with torch.no_grad(), profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("encode"):
            feat, pos = model.encode(img)
        with profiling.annotate("decode"):
            model.decode(feat[:1], pos[:1], feat[1:], pos[1:])
    names = [e.get("name") for e in _events(prof.trace_path)]
    assert prof.trace_path.startswith(str(tmp_path))
    assert "encode" in names and "decode" in names
    assert any(n and n.startswith("aten::") for n in names)  # the ops under the spans


def test_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(ValueError):
        with profiling.trace(str(tmp_path / "t")) as prof:
            with profiling.annotate("failing"):
                torch.ones(3).sum()
                raise ValueError("inside")
    assert "failing" in [e.get("name") for e in _events(prof.trace_path)]


def test_phase_timer_equals_jax(monkeypatch):
    """The same clock readings (one patched `time.perf_counter`) for both."""
    readings = np.cumsum([0.0, 0.125, 0.5, 0.0625, 1.75, 0.003, 2.0, 0.25]).tolist()
    timers = []
    for mod in (profiling, jprofiling):
        ticks = iter(readings)
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        t = mod.PhaseTimer()
        for name in ("load", "step", "load", "log"):
            with t.phase(name):
                pass
        timers.append(t)
    ours, theirs = timers
    assert ours.summary() == theirs.summary() and repr(ours) == repr(theirs)
    # each phase reads the clock twice: load 0 -> 0.125, step 0.625 -> 0.6875, ...
    assert ours.summary()["load"] == dict(total_s=0.128, count=2, mean_ms=64.0)
