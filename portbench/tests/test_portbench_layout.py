"""The benchmark's files against the rules they keep (keys, names, units,
bounds, the time a full check of 24 cells may take), and the run finding
each cell's configuration, mix, limits and metrics by name."""
from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT, bench
from portbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in bench()["workloads"]]


def test_benchmark_json_keys_and_names():
    b = bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                       "per_layer"]
    assert b["paths"] == ["portbench"] and b["command"][:3] == ["python3", "-m", "portbench.run"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    metrics = b["end_to_end"] + b["per_layer"]
    names = [m["name"] for m in metrics] + WORKLOADS + [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m).issubset({"name", "unit", "better", "bound", "source", "layer", "moves",
                                "workloads"})
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert [m["bound"] for m in b["end_to_end"] if m["name"] == "setup_s"] == [0.25]
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(WORKLOADS)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reports = [m for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in reports} and len(reports) >= 2
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b)) <= 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_run_finds_each_piece_of_a_cell_by_name(workload):
    cell = run.resolve(bench(), workload)
    assert cell["workload"]["name"] == workload
    assert cell["config"]["name"] == cell["workload"]["config"]
    assert cell["limits"] and all(v > 0 for v in cell["limits"].values())
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert (cell["metrics_dir"] / f"{m['name']}.py").is_file(), m["name"]
    files = {p.stem for p in cell["metrics_dir"].glob("*.py")}
    b = bench()
    assert files == {m["name"] for m in b["end_to_end"] + b["per_layer"]}


def test_configs_are_the_published_widths():
    for c in bench()["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        a = cfg["arch"]
        assert (a["enc_embed_dim"], a["enc_depth"], a["enc_num_heads"]) == (1024, 24, 16)
        assert (a["dec_embed_dim"], a["dec_depth"], a["dec_num_heads"]) == (768, 12, 12)
        assert a["patch_size"] == 16 and a["pos_embed"] == "RoPE100" and c["reduced"] == []
        assert cfg["source"] == c["source"] and cfg["name"] == c["name"]
        assert (ROOT / (cfg["reference"].replace(".", "/") + ".py")).is_file()
