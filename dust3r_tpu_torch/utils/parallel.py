"""Thread and process maps for the preprocess scripts.

Counterpart of `dust3r_tpu/utils/parallel.py`: star-args and keyword-args
calls, the first `front_num` calls run in the caller (easier debugging),
the rest on a pool; a progress bar where tqdm is installed. The call is a
module-level object, so a process pool can pickle it (JAX's is a lambda,
which a process pool cannot send: ROADMAP.md §C). Process pools are
spawned, not forked: their callers hold threads (torch's, a loader's). As
with the port's spawned loader workers, each child imports the caller's
`__main__`, so a script that maps over processes runs its work under `if
__name__ == "__main__":`, and a program read from stdin cannot spawn.
"""
from __future__ import annotations

import multiprocessing
from multiprocessing.dummy import Pool as ThreadPool

ProcessPool = multiprocessing.get_context("spawn").Pool


class _Caller:
    """function(*a[0], **a[1]), function(*a), function(**a) or function(a)."""

    def __init__(self, function, star_args, kw_args):
        self.function, self.star_args, self.kw_args = function, star_args, kw_args

    def __call__(self, a):
        if self.star_args and self.kw_args:
            return self.function(*a[0], **a[1])
        if self.star_args:
            return self.function(*a)
        if self.kw_args:
            return self.function(**a)
        return self.function(a)


def parallel_threads(function, args, workers=0, star_args=False,
                     kw_args=False, front_num=1, Pool=ThreadPool, **tqdm_kw):
    """Run function(*arg) over args with a thread pool + progress bar."""
    if workers <= 0:
        import os
        workers = os.cpu_count() or 4
    try:
        from tqdm import tqdm
    except ImportError:
        def tqdm(x, **kw):
            return x

    args = list(args)
    caller = _Caller(function, star_args, kw_args)

    # run the first few sequentially (easier debugging, like the reference)
    front = [caller(a) for a in args[:front_num]]

    if len(args) <= front_num:
        return front
    with Pool(workers) as pool:
        rest = list(tqdm(pool.imap(caller, args[front_num:]),
                         total=len(args) - front_num, **tqdm_kw))
    return front + rest


def parallel_processes(function, args, workers=0, **kw):
    """Process-pool variant (for CPU-bound preprocessing)."""
    kw["Pool"] = ProcessPool
    return parallel_threads(function, args, workers=workers, **kw)
