"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/*.cu` is compiled by `nvcc` for `sm_90a` into a shared library
with a plain C interface (no PyTorch headers: seconds, not minutes). The
library lands in `build/dust3r_tpu_torch/<hash>/`, keyed by a hash of the
source, the shared headers (`csrc/*.cuh`) and the flags, so an edited
source or header builds anew and an unchanged one is loaded as it is.
`build` starts one nvcc per source, all at once. A failed build raises;
nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "dust3r_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
_count_lock = threading.Lock()
build_seconds: dict[str, float] = {}  # seconds each library took to build


def count_launch(fn, attr="launches", n=1):
    """Add n to a wrapper's launch counter `fn.<attr>`, under a lock: the
    inference engine runs the shards of a mesh from one thread each."""
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + n)


def nvcc_path():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def _out_dir(name):
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    return src, BUILD_ROOT / digest.hexdigest()[:16]


def ptxas_log(name):
    """What `nvcc -Xptxas -v` said of the current build of `name` ('' if
    it was not built here): registers, shared memory and spills per kernel."""
    log = _out_dir(name)[1] / "ptxas.log"
    return log.read_text() if log.exists() else ""


def build(names):
    """Compile each `csrc/<name>.cu` of `names` that is not built yet, one
    nvcc process per source, all started together; raises if any fails."""
    started = {}
    for name in dict.fromkeys(names):
        src, out_dir = _out_dir(name)
        lib = out_dir / f"lib{name}.so"
        if lib.exists():
            continue
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        started[name] = (proc, src, tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, src, tmp, lib, t0) in started.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {src.name}:\n{out}\n{err}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
        build_seconds[name] = time.perf_counter() - t0
        (lib.parent / "ptxas.log").write_text(err)
    if failed:
        raise RuntimeError("\n".join(failed))


def library_path(name):
    """Where the current build of `csrc/<name>.cu` lies (or will lie)."""
    return _out_dir(name)[1] / f"lib{name}.so"


def load_library(name):
    """Build (if needed) and load `csrc/<name>.cu` as a ctypes library."""
    with _load_lock:  # the engine's shard threads may ask at once
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]
