"""Profiling hooks: torch.profiler traces, named spans and phase timers.

Counterpart of `dust3r_tpu/utils/profiling.py`. `trace` records the host
and, where CUDA is present, the card (CUPTI) and writes a Chrome trace
(Perfetto, chrome://tracing); `annotate` names a span in that trace and,
on a card, an NVTX range; `PhaseTimer` is JAX's wall-clock phase account
of the host pipeline, as it is.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(log_dir):
    """Profile the enclosed block (CPU activities, and CUDA ones where a card
    is present) and write its Chrome trace into `log_dir` as
    `trace-<pid>-<ns>.json`, also when the block raises. Yields the
    `torch.profiler.profile`, whose `trace_path` is set once written."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.trace_path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
        prof.export_chrome_trace(prof.trace_path)


@contextlib.contextmanager
def annotate(name):
    """A named span in a `trace`'s timeline (`record_function`), and an NVTX
    range while CUDA is present."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


class PhaseTimer:
    """Accumulate wall-clock per named phase (host-side)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self):
        return {name: dict(total_s=round(self.totals[name], 4),
                           count=self.counts[name],
                           mean_ms=round(1e3 * self.totals[name]
                                         / max(self.counts[name], 1), 3))
                for name in self.totals}

    def __repr__(self):
        return "\n".join(f"{k}: {v['total_s']}s over {v['count']} calls "
                         f"({v['mean_ms']} ms avg)"
                         for k, v in self.summary().items())
