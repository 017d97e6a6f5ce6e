"""The benchmark of dust3r_tpu_torch, the PyTorch and CUDA port.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout that holds the port. `BENCHMARK.json`
names each workload's configuration (`configs/<name>.json`: the published
sizes, the precision, the plain reference beside it) and traffic mix
(`traffic/<mix>.json`, read by `scenes.py`); each metric is read from the
run's records by `metrics/<metric>.py`; each workload's correctness limits
are `limits/<workload>.json`. A new configuration, mix, metric or cell is
new files and entries; nothing here names one.

A run: the weights drawn on the card from the seed (`reference.init_tensors`),
the program built and
loaded, the mix's scenes made on the host (`views_from_arrays`,
`make_pairs`), every scene of one cycle run once to warm up (the first run
in a checkout builds the kernels here), then the window: one client sends
the scenes back to back, each call ends in `torch.cuda.synchronize()`, and
the window closes at the first scene boundary past `--seconds`. With
`--trace 1`, a traced stretch under `torch.profiler` follows the window.
Then the device's peak memory is read, the program freed, and the kept
scenes compared with the reference (`check.py`). The last line of standard
output is the result; the numbers compared, with their limits, are the last
lines of standard error and the result's last key.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "portbench"  # inside the checkout, at a fixed path
FORBIDDEN = ("jax", "jaxlib", "flax", "dust3r_tpu")


def set_environment():
    """Caches the program or its libraries may write go inside the
    checkout; no library loads JAX by itself."""
    os.environ["USE_FLAX"] = "0"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_file(path, name):
    """A module from a file of the benchmark (a metric's reader)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(bench, workload, root=ROOT):
    """The pieces of one cell: its entry, configuration, mix, limits and the
    metrics it reports."""
    from . import scenes

    try:
        wl = next(w for w in bench["workloads"] if w["name"] == workload)
    except StopIteration:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json") from None
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    here = Path(root) / "portbench"
    return dict(
        workload=wl, config=load_json(Path(root) / entry["file"]),
        mix=scenes.load_mix(wl["traffic"], here),
        limits=load_json(here / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])],
        per_layer=[m for m in bench["per_layer"] if workload in m.get("workloads", [workload])],
        metrics_dir=here / "metrics")


# ---------------------------------------------------------------------- #
# the program, its weights and its inputs
# ---------------------------------------------------------------------- #

def dtypes():
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_program(arch, precision, sd, device):
    """The port's model at the sizes `arch` and the `precision` (a
    configuration's), on `device`, holding the benchmark's weights `sd`."""
    from dust3r_tpu_torch.models.model import AsymmetricCroCo3DStereo

    a, p = arch, precision
    mode = lambda m: (m[0], float(m[1]), float(m[2]))  # noqa: E731
    model = AsymmetricCroCo3DStereo(
        img_size=tuple(a["img_size"]), patch_size=a["patch_size"], pos_embed=a["pos_embed"],
        enc_embed_dim=a["enc_embed_dim"], enc_depth=a["enc_depth"],
        enc_num_heads=a["enc_num_heads"], dec_embed_dim=a["dec_embed_dim"],
        dec_depth=a["dec_depth"], dec_num_heads=a["dec_num_heads"], mlp_ratio=a["mlp_ratio"],
        head_type=a["head_type"], output_mode=a["output_mode"],
        depth_mode=mode(a["depth_mode"]), conf_mode=mode(a["conf_mode"]),
        dtype=dtypes()[p["body"]], head_dtype=dtypes()[p["heads"]], device="meta")
    model.to_empty(device=device)
    model.load_state_dict(sd, strict=True)
    return model


def make_scenes(mix, seed):
    """One cycle of the mix's scenes: {views, pairs, images, pairs_n,
    height, width} each, in the order the window sends them."""
    from dust3r_tpu_torch.image_pairs import make_pairs
    from dust3r_tpu_torch.utils.image import views_from_arrays

    from . import scenes

    keys = scenes.cycle(mix, seed)
    built = {}
    for key in dict.fromkeys(keys):
        spec = mix["scenes"][key[0]]
        views = views_from_arrays(scenes.images(seed, key[0], key[1], spec))
        pairs = make_pairs(views, mix["scene_graph"], symmetrize=mix["symmetrize"])
        built[key] = dict(views=views, pairs=pairs, images=spec["images"], pairs_n=len(pairs),
                          height=spec["height"], width=spec["width"])
    return [built[k] for k in keys]


# ---------------------------------------------------------------------- #
# the stages the window drives
# ---------------------------------------------------------------------- #

def pairs_stage(engine, sync):
    """One scene through `InferenceEngine.infer_pairs`, predictions kept on
    the device, ended by a wait for the device."""
    def run(sc):
        out = engine.infer_pairs(sc["pairs"], to_cpu=False)
        sync()
        return out
    return run


class HeadTap:
    """Forward hooks on the program's two heads, and on the modules named
    `stages` under each (published names), that keep, in the scene armed,
    what batch `batch` handed each head (the decoder layers `layers`), each
    stage's output and the head's outputs, by reference: no copy, no
    launch. Unarmed, a hook returns at once."""

    def __init__(self, model, layers, stages):
        self.layers, self.batch, self.calls, self.kept, self.staged = layers, None, {}, [], {}
        self.handles = []
        for h in (1, 2):
            head = getattr(model, f"downstream_head{h}")
            self.handles += [head.get_submodule(n).register_forward_hook(self._stage(h, n))
                             for n in stages]
            self.handles.append(head.register_forward_hook(self._head(h)))

    def _stage(self, h, name):
        def hook(module, args, out):
            if self.batch is not None and self.calls.get(h, 0) == self.batch:
                self.staged.setdefault(h, {})[name] = out
        return hook

    def _head(self, h):
        def hook(module, args, out):
            if self.batch is None:
                return
            n = self.calls.get(h, 0)
            self.calls[h] = n + 1
            if n == self.batch:
                decout, shape = args
                self.kept.append(dict(head=h, shape=tuple(shape),
                                      decout={i: decout[i] for i in self.layers},
                                      stages=self.staged.pop(h, {}),
                                      pts3d=out["pts3d"], conf=out["conf"]))
        return hook

    def arm(self, batch):
        self.batch, self.calls = batch, {}

    def disarm(self):
        self.batch = None

    def remove(self):
        for handle in self.handles:
            handle.remove()


def window(stage, cycle, seconds, keep, tap=None, tap_at=None):
    """Scenes back to back from `cycle[0]` on, until the first scene
    boundary past `seconds`. Returns ({seconds, sent, latencies},
    {k: (scene, result)} of the scenes numbered in `keep`); `tap`, a
    `HeadTap`, is armed at batch `tap_at[1]` of scene `tap_at[0]`."""
    sent, lat, kept = [], [], {}
    k = 0
    t_first = time.perf_counter()
    while True:
        sc = cycle[k % len(cycle)]
        if tap is not None and k == tap_at[0]:
            tap.arm(tap_at[1])
        t0 = time.perf_counter()
        res = stage(sc)
        t1 = time.perf_counter()
        if tap is not None:
            tap.disarm()
        lat.append(t1 - t0)
        sent.append(sc)
        if k in keep:
            kept[k] = (sc, res)
        k += 1
        if t1 - t_first >= seconds:
            return dict(seconds=t1 - t_first, sent=sent, latencies=lat), kept


def scene_records(sent, latencies):
    return [dict(images=sc["images"], pairs=sc["pairs_n"], height=sc["height"],
                 width=sc["width"], seconds=s) for sc, s in zip(sent, latencies)]


# ---------------------------------------------------------------------- #
# one run
# ---------------------------------------------------------------------- #

def run_cell(cell, seed, seconds, trace, device, t_start=None, variant=None):
    """One run of a cell on `device`. Returns (result, details): the result
    line's dict and {numbers, records}. `variant`, a control of
    `calibrate.py` (the benchmark's own runs never set it): "int8", the
    engine's int8 projections in place of the configuration's bfloat16
    body; "bf16_heads", the heads in bfloat16 in place of its float32."""
    import torch

    from dust3r_tpu_torch.inference import InferenceEngine

    from . import check, scenes

    t_start = T_START if t_start is None else t_start
    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg, mix = cell["config"], cell["mix"]
    reference = importlib.import_module(cfg["reference"])  # the configuration's own
    reference.fp32_only()

    # set-up: weights, program, scenes, warm-up
    marks = [("start", time.perf_counter())]
    sd = reference.init_tensors(reference.param_shapes(cfg["arch"]), seed, device,
                                cfg["weights"]["std"])
    sync()
    marks.append(("weights", time.perf_counter()))
    cycle = make_scenes(mix, seed)
    marks.append(("scenes", time.perf_counter()))
    precision = dict(cfg["precision"], **({"heads": "bfloat16"} if variant == "bf16_heads" else {}))
    model = build_program(cfg["arch"], precision, sd, device)
    engine = InferenceEngine(model, batch_size=mix["batch_size"],
                             quantize="int8" if variant == "int8" else None)
    sync()
    marks.append(("program", time.perf_counter()))
    stage = pairs_stage(engine, sync)
    # every batch is padded to the batch size: one scene of each image
    # shape warms every kernel shape the window will launch
    for sc in {(sc["height"], sc["width"]): sc for sc in reversed(cycle)}.values():
        stage(sc)
    sync()
    marks.append(("warm-up", time.perf_counter()))
    gc.collect()
    gc.freeze()  # what set-up made is not scanned again by the collector
    keep = scenes.check_sample(mix, seed)
    # the heads' own check: one batch, drawn from the seed, of the first
    # scene compared
    tap = HeadTap(model, reference.head_layers(cfg["arch"]), reference.head_stages(cfg["arch"]))
    tap_at = (keep[0], int(scenes._rng(seed, 6).integers(
        -(-cycle[keep[0] % len(cycle)]["pairs_n"] // mix["batch_size"]))))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    b0 = (engine.encoder_batches, engine.pair_batches)
    setup_s = time.perf_counter() - t_start
    phases = dict(imports=marks[0][1] - t_start, **{
        b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])})

    # the window
    win, kept = window(stage, cycle, seconds, set(keep), tap, tap_at)
    tap.remove()
    gc.unfreeze()
    b1 = (engine.encoder_batches, engine.pair_batches)
    records = dict(setup_s=setup_s, setup_phases=phases, batch_size=mix["batch_size"],
                   arch=cfg["arch"], window_s=win["seconds"],
                   scenes=scene_records(win["sent"], win["latencies"]),
                   encoder_batches=b1[0] - b0[0], pair_batches=b1[1] - b0[1])

    # the traced stretch
    if trace:
        records["trace"], records["traced_scenes"] = traced(stage, cycle, len(win["sent"]), mix,
                                                            on_card, sync)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    # the program's state freed; the kept scenes' outputs compared
    del stage, engine, model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = reference.Reference(sd, cfg["arch"], cfg["precision"])
    numbers = {}
    for k, (sc, out) in sorted(kept.items()):
        for name, v in check.compare_pairs(ref, sc["pairs"], out, list(range(sc["pairs_n"])),
                                           device).items():
            numbers[name] = max(numbers.get(name, 0.0), v)
    numbers.update(check.compare_heads(ref, tap.kept, device))
    if not kept:
        numbers = {k: math.inf for k in cell["limits"]}
    correct, checks = check.verdict(numbers, cell["limits"])

    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        reader = load_file(cell["metrics_dir"] / f"{m['name']}.py",
                           "portbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(records)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    dev = dict(platform="gpu" if on_card else device.type,
               kind=torch.cuda.get_device_name(device) if on_card else device.type,
               count=1, memory_peak_bytes=int(peak))
    if trace and records["trace"]:
        dev.update(busy_s=records["trace"]["busy_s"], window_s=records["trace"]["window_s"])
    result = dict(correct=bool(correct), attempted=len(win["sent"]), failed=0,
                  metrics=metrics, device=dev)
    if trace and records["trace"]:
        result["breakdown"] = dict(device_ops=records["trace"]["device_ops"],
                                   idle_gaps=records["trace"]["idle_gaps"])
    result["checks"] = checks
    details = dict(numbers=numbers, records=records)
    return result, details


def traced(stage, cycle, start, mix, on_card, sync):
    """The mix's `trace.scenes` scenes after the window under the
    profiler: (trace summary or None, their scene records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import tracing

    n = mix["trace"]["scenes"]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sent = [cycle[(start + i) % len(cycle)] for i in range(n)]
    with profile(activities=acts) as prof:
        with record_function(tracing.SPAN):
            for sc in sent:
                stage(sc)
            sync()
    CACHE.mkdir(parents=True, exist_ok=True)
    path = CACHE / f"trace_{os.getpid()}.json"
    try:
        prof.export_chrome_trace(str(path))
        summary = tracing.read(path)
    finally:
        path.unlink(missing_ok=True)
    del prof
    return summary, scene_records(sent, [0.0] * n)


def main(argv=None):
    set_environment()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = resolve(load_json(ROOT / "BENCHMARK.json"), args.workload)
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    return report(cell, args, "cuda")


def report(cell, args, device):
    """Run the cell on `device` and print the result as the last line of
    standard output, the numbers compared as the last lines of standard
    error; 0, or 3 where a forbidden module was loaded (then no result)."""
    result, details = run_cell(cell, args.seed, args.seconds, args.trace, device)
    rec = details["records"]
    lat = [s["seconds"] for s in rec["scenes"]]
    print(f"portbench: {cell['workload']['name']} seed {args.seed}: {len(lat)} scenes, "
          f"{sum(s['pairs'] for s in rec['scenes'])} pairs in {rec['window_s']:.3f} s; scene "
          f"median {1e3 * statistics.median(lat):.3f} ms, longest {1e3 * max(lat):.3f} ms; "
          f"set-up {rec['setup_s']:.3f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in rec["setup_phases"].items()) + ")",
          file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
