"""Reading the profiler's trace of the traced stretch of a run.

`torch.profiler` (CPU and CUDA activities, CUPTI on the card) writes a
Chrome trace; this reads, inside the harness's span `SPAN`: the union of
the device's busy intervals (kernels, copies, sets), the device time of
each kernel by name, and each idle gap of the device, attributed to the
innermost host event of the harness's thread running at the gap's
midpoint ("host outside any op" where only the span covers it).
"""
from __future__ import annotations

import bisect
import json
from collections import Counter, defaultdict

SPAN = "portbench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
OUTSIDE = "host outside any op"


def read(path, top=10):
    """{window_s, busy_s, kernels {name: [count, seconds]}, device_ops
    [[name, seconds]], idle_gaps [[name, seconds]]} of the trace at `path`,
    or None where it has no span or no device event."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == SPAN]
    if not spans:
        return None
    span = spans[0]
    w0, w1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    dev = sorted((max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1), e["name"])
                 for e in events if e.get("cat") in DEVICE_CATS
                 and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0)
    if not dev:
        return None
    kernels = defaultdict(lambda: [0, 0.0])
    for a, b, name in dev:
        kernels[name][0] += 1
        kernels[name][1] += (b - a) * 1e-6
    busy, gaps, end = 0.0, [], w0
    for a, b, _ in dev:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((end, w1))

    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                  if e.get("cat") in HOST_CATS and e.get("tid") == span.get("tid")
                  and e is not span)
    starts = [h[0] for h in host]
    idle = Counter()
    for a, b in gaps:
        mid, name = (a + b) / 2, OUTSIDE
        for k in range(bisect.bisect_right(starts, mid) - 1, max(-1, bisect.bisect_right(
                starts, mid) - 5000), -1):
            if host[k][1] >= mid:
                name = host[k][2]
                break
        idle[name] += (b - a) * 1e-6
    device_ops = Counter({name: s for name, (_, s) in kernels.items()})
    return dict(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                kernels={k: list(v) for k, v in kernels.items()},
                device_ops=[[n[:64], s] for n, s in device_ops.most_common(top)],
                idle_gaps=[[n[:64], s] for n, s in idle.most_common(top)])


def kernel_time(trace, fragment):
    """(launches, seconds) of the kernels whose name holds `fragment`."""
    hits = [v for k, v in trace["kernels"].items() if fragment in k]
    return sum(v[0] for v in hits), sum(v[1] for v in hits)
