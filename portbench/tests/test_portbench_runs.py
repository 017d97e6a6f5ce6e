"""Whole runs of the benchmark: tiny cells on the CPU (the harness's look
for a card skipped), the timed path broken underneath so that `correct`
comes out false, the modules a run loads, and the control at each cell's
own size on the card."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from conftest import ROOT, bench
from portbench import run

WORKLOADS = [w["name"] for w in bench()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(tiny_root, workload, trace=0, seconds=0.5, seed=2 ** 31 + 77):
    root, b = tiny_root
    cell = run.resolve(b, workload, root)
    result, details = run.run_cell(cell, seed, seconds, trace, "cpu")
    return cell, result, details


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_tiny_run_prints_its_result_last(tiny_root, workload, trace, capsys):
    root, b = tiny_root
    cell = run.resolve(b, workload, root)
    args = types.SimpleNamespace(seed=2 ** 31 + 3, seconds=0.5, trace=trace)
    assert run.report(cell, args, "cpu") == 0
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    want = cell["per_layer"] if trace else cell["end_to_end"]
    assert set(result["metrics"]) <= {m["name"] for m in want}
    if not trace:  # the host's clock serves every cell (a tail wants two scenes or more)
        assert "setup_s" in result["metrics"] and len(result["metrics"]) >= 2
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    lines = err.strip().splitlines()
    assert [ln.split()[1] for ln in lines[-len(result["checks"]):]] == list(result["checks"])


def _alter_one_answer(monkeypatch):
    from dust3r_tpu_torch.inference import InferenceEngine

    infer = InferenceEngine.infer_pairs

    def altered(self, pairs, *a, **kw):
        out = infer(self, pairs, *a, **kw)
        p = out["pred2"]["pts3d_in_other_view"]
        p = p.clone() if isinstance(p, torch.Tensor) else p.copy()
        p[len(p) // 2] = p[len(p) // 2] * 1.1
        out["pred2"]["pts3d_in_other_view"] = p
        return out
    monkeypatch.setattr(InferenceEngine, "infer_pairs", altered)


def _swap_two_answers(monkeypatch):
    from dust3r_tpu_torch.inference import InferenceEngine

    infer = InferenceEngine.infer_pairs

    def swapped(self, pairs, *a, **kw):
        out = infer(self, pairs, *a, **kw)
        for side in ("pred1", "pred2"):
            for k, v in out[side].items():
                v = v.clone() if isinstance(v, torch.Tensor) else v.copy()
                v[[0, -1]] = v[[-1, 0]]
                out[side][k] = v
        return out
    monkeypatch.setattr(InferenceEngine, "infer_pairs", swapped)


def _half_the_batch(monkeypatch):
    """Every pair of the second half of a scene given the first half's
    outputs: half of the work left out."""
    from dust3r_tpu_torch.inference import InferenceEngine

    infer = InferenceEngine.infer_pairs

    def halved(self, pairs, *a, **kw):
        out = infer(self, pairs, *a, **kw)
        n = len(pairs) // 2
        for side in ("pred1", "pred2"):
            for k, v in out[side].items():
                v = v.clone() if isinstance(v, torch.Tensor) else v.copy()
                v[n:2 * n] = v[:n]
                out[side][k] = v
        return out
    monkeypatch.setattr(InferenceEngine, "infer_pairs", halved)


FAULTS = [(w, f) for w in WORKLOADS for f in (_alter_one_answer, _swap_two_answers, _half_the_batch)]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny_root, workload, fault, monkeypatch):
    _, good, _ = _run(tiny_root, workload)
    assert good["correct"] is True
    fault(monkeypatch)
    _, result, details = _run(tiny_root, workload)
    assert result["correct"] is False, details["numbers"]


def test_a_run_loads_no_jax_and_the_reference_none_of_the_program(tiny_root, tmp_path):
    root, b = tiny_root
    (tmp_path / "bench.json").write_text(json.dumps(b))
    code = f"""
import json, sys, types
sys.path.insert(0, {str(ROOT)!r})
from portbench import check, flops, reference, scenes, tracing
first = sorted({{m.split('.')[0] for m in sys.modules}})
from portbench import run
b = json.load(open({str(tmp_path / 'bench.json')!r}))
cell = run.resolve(b, 'dpt512-pose10', {str(root)!r})
run.report(cell, types.SimpleNamespace(seed=5, seconds=0.3, trace=0), 'cpu')
print(json.dumps([first, run.forbidden_modules()]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    first, forbidden = json.loads(out.stdout.strip().splitlines()[-1])
    assert not {"dust3r_tpu_torch", "dust3r_tpu", "jax", "jaxlib", "flax"} & set(first)
    assert forbidden == []


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "dpt512-pose10",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not any(ln.startswith("{") for ln in out.stdout.splitlines())


def _forward_and_reference(cfg, precision, conv_impl=None):
    """The program's forward at `cfg`'s tiny sizes and `precision` on the
    CPU (its plain attention; `conv_impl`, the heads' convs: "kernel" runs
    the kernels' plain versions), and the reference's, on the same weights
    and images: ([program outputs], [reference outputs at `precision`],
    [reference outputs in float32])."""
    from dust3r_tpu_torch.models.model import AsymmetricCroCo3DStereo

    from portbench import reference

    a = cfg["arch"]
    sd = reference.init_tensors(reference.param_shapes(a), 11, "cpu")
    model = run.build_program(a, precision, sd, "cpu")
    assert isinstance(model, AsymmetricCroCo3DStereo)
    for m in model.modules():
        if hasattr(m, "impl"):
            m.impl = conv_impl
        if hasattr(m, "conv_impl"):
            m.conv_impl = conv_impl
    img = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (3, 48, 64, 3))
                           .astype(np.float32))
    r1, r2 = model(img[:2], img[1:])
    got = [r1["pts3d"], r1["conf"], r2["pts3d_in_other_view"], r2["conf"]]
    refs = []
    for prec in (precision, None):
        ref = reference.Reference(sd, a, prec)
        f, p = ref.encode(img)
        refs.append(list(ref.pairs(f, p, (48, 64), torch.tensor([0, 1]), torch.tensor([1, 2]))))
    return [g.detach().float() for g in got], refs[0], refs[1]


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _tiny_configs(tiny_root):
    """The tiny configurations, each with the DPT head and the linear one
    (the reference's other head)."""
    for c in tiny_root[1]["configs"]:
        cfg = json.loads(open(c["file"]).read())
        for head in ("dpt", "linear"):
            yield json.loads((ROOT / next(b["file"] for b in bench()["configs"]
                                          if b["name"] == c["name"])).read_text()), dict(
                cfg, arch=dict(cfg["arch"], head_type=head))


def test_the_reference_is_the_published_network(tiny_root):
    """The plain reference against the program's float32 forward on the CPU
    (plain attention and heads there) on the same weights."""
    for _, cfg in _tiny_configs(tiny_root):
        got, want, _ = _forward_and_reference(cfg, cfg["precision"])
        for g, w in zip(got, want):
            assert _rel(g, w) < 1e-5


@pytest.mark.parametrize("precision", ["conv3x3_operands", "the configuration's"])
def test_the_reference_rounds_where_the_configuration_says(tiny_root, precision):
    """With the heads' 3x3 convs on bfloat16 operands (the kernels' plain
    versions), and at the configurations' own precision (a bfloat16 body
    besides), the reference at that precision lies nearer the program's
    forward on the CPU than the float32 reference does. Not nearer by
    much: where two computations round to bfloat16, a last-bit difference
    in one rounding moves the roundings after it."""
    for cfg, tiny in _tiny_configs(tiny_root):
        if precision == "conv3x3_operands" and tiny["arch"]["head_type"] != "dpt":
            continue  # the linear head has no 3x3 conv
        prec = cfg["precision"] if precision != "conv3x3_operands" else dict(
            cfg["precision"], body="float32")
        got, want, fp32 = _forward_and_reference(tiny, prec, "kernel")
        for g, w, f in zip(got, want, fp32):
            assert _rel(g, w) < _rel(g, f), (_rel(g, w), _rel(g, f))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct_at_the_cells_size(workload, card):
    """Each control (the program's int8 engine in place of its bf16 body,
    its bf16 heads in place of its fp32 ones) fails the cell's limits at
    the cell's own size, on the card, comparing what a run compares."""
    import math

    from portbench import calibrate

    cell = run.resolve(bench(), workload)
    for variant in calibrate.CONTROLS:
        numbers = calibrate.readings(cell, 2 ** 31 + 404, 5.0, variant, card)["numbers"]
        assert all(math.isfinite(numbers[k]) for k in cell["limits"]), numbers
        assert any(numbers[k] > v for k, v in cell["limits"].items()), (variant, numbers)
