"""Build the port's CUDA kernels and its host image core at first use and
load them with ctypes.

Each `csrc/*.cu` is compiled by `nvcc` for `sm_90a` into a shared library
with a plain C interface (no PyTorch headers: seconds, not minutes). The
library lands in `build/dust3r_tpu_torch/<hash>/`, keyed by a hash of the
source, the shared headers (`csrc/*.cuh`) and the flags, so an edited
source or header builds anew and an unchanged one is loaded as it is.
`build` starts one nvcc per source, all at once. The host route builds a
`csrc/*.cpp` (the image core, `csrc/fastimg.cpp`) with `g++` and the JAX
package's flags (OpenMP, `-march=native`) the same way, keyed also by what
`-march=native` means on this host. A failed build raises; nothing falls
back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "dust3r_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")  # the JAX core's

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


def gxx_path():
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the port's host image core (csrc/fastimg.cpp) is "
                           "built from source at first use; nothing falls back")
    return found


def _host_out_dir(name):
    """The build directory of `csrc/<name>.cpp`: a hash of the source, the
    flags and g++'s version and expansion of `-march=native` (a library
    built for another host's CPU is never loaded)."""
    src = CSRC / f"{name}.cpp"
    gxx = gxx_path()
    digest = hashlib.sha256(src.read_bytes() + " ".join(HOST_FLAGS).encode())
    for query in (["-dumpfullversion"], ["-march=native", "-Q", "--help=target"]):
        digest.update(subprocess.run([gxx, *query], capture_output=True, check=True).stdout)
    return src, BUILD_ROOT / digest.hexdigest()[:16]


def build_host(name):
    """Compile `csrc/<name>.cpp` with g++ unless built; returns the library's
    path. Each builder writes its own temporary file and publishes it with
    an atomic rename, so processes that race the first build (test
    workers, spawned loader workers) all load a whole library."""
    src, out_dir = _host_out_dir(name)
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".tmp.so", dir=out_dir)
    os.close(fd)
    try:
        t0 = time.perf_counter()
        proc = subprocess.run([gxx_path(), *HOST_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {src.name}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
        build_seconds[name] = time.perf_counter() - t0
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load_host_library(name):
    """Build (if needed) and load `csrc/<name>.cpp` as a ctypes library."""
    with _load_lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build_host(name)))
        return _loaded[name]


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
