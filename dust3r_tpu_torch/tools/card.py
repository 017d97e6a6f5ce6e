"""The card's name and peaks, kernel timing with CUDA events, and the bound:
shared by `chip_smoke.py` and the measuring tools."""
from __future__ import annotations

import subprocess
import time

import torch

# the card's peaks (the H100 SXM data sheet, dense): HBM bytes/s, and
# operations/s by type; bounds are the larger of bytes and operations times
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = dict(bf16=989e12, fp32=67e12)


def card_name():
    """`nvidia-smi`'s name and power limit of the card, as one line."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip()


def time_ms(fn, iters=20, warmup=3):
    """Mean ms of `fn` over `iters` calls after `warmup`, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20, warmup=3):
    """Mean ms of `fn` over `iters` calls captured in one CUDA graph and
    replayed, by CUDA events: the device's time for the calls without the
    host's time to launch them. A kernel shorter than its wrapper's launch
    (tens of microseconds of Python) reads as the launch under `time_ms`.
    `fn` must only enqueue work on the current stream; its outputs live in
    the graph's pool (iters of them at once)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def warm_up(fn, seconds=0.5):
    """Call `fn` for `seconds` of wall time: the card's clocks rise under
    load, so the first kernel timed in a process reads slow without it."""
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()


def bound(nbytes, ops):
    """(ms, what bounds it): the least time the card could take to move
    `nbytes` (each input read once, each output written once) and to do
    `ops` ({type: operations}), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[k] for k, n in ops.items())
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def attention_bound(B, H, Nq, Nk, d, rope):
    """The bound of one bf16 attention call: q, k, v and the output in
    bf16, the four fp32 RoPE tables; QK^T and PV on bf16 tensor cores."""
    table_bytes = 8 * B * (Nq + Nk) * d if rope else 0
    return bound(2 * B * H * (2 * Nq + 2 * Nk) * d + table_bytes,
                 dict(bf16=4 * B * H * Nq * Nk * d))
