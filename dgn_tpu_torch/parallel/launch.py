"""Spawn the ranks of a one-host data-parallel run and collect their
results, with a deadline.

`spawn(fn, n, args)` starts n processes (multiprocessing "spawn": fresh
interpreters, nothing inherited but the arguments), calls fn(rank, n,
init_method, *args) in each, and returns the n return values in rank
order.  init_method is a `file://` rendezvous in a fresh directory (no TCP
port to collide with another run on the host).  A rank that raises, or a
run that outlives `timeout` seconds, terminates every rank and raises
RuntimeError with the ranks' tracebacks; no rank outlives the call.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, List, Optional


def _entry(fn, rank: int, n: int, init_method: str, args_path: str,
           results) -> None:
    try:
        with open(args_path, "rb") as f:
            args = pickle.load(f)
        # pickled here, whole: the queue would share a tensor's storage
        # through a handle that dies with this process
        results.put((rank, True, pickle.dumps(fn(rank, n, init_method,
                                                 *args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, n: int, args=(), timeout: Optional[float] = None,
          rendezvous_dir: Optional[str] = None) -> List:
    """fn(rank, n, init_method, *args) in n spawned processes; their
    return values in rank order.  fn must be importable by name (a
    module-level function) and its arguments and return value picklable."""
    ctx = mp.get_context("spawn")
    made = rendezvous_dir is None
    directory = tempfile.mkdtemp(prefix="dgn_rdzv_") if made \
        else rendezvous_dir
    path = os.path.join(directory, f"rdzv_{os.getpid()}_{time.time_ns()}")
    init_method = f"file://{path}"
    # the arguments go through a file: a large pickle written into the
    # process pipe blocks the parent for good if a child dies before
    # reading it
    args_path = path + ".args"
    with open(args_path, "wb") as f:
        pickle.dump(tuple(args), f)
    results = ctx.Queue()
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(fn, r, n, init_method, args_path, results))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    got, errors = {}, []
    try:
        while len(got) + len(errors) < n:
            wait = 1.0 if deadline is None else min(
                1.0, deadline - time.monotonic())
            if wait <= 0:
                errors.append(f"timed out after {timeout} s with ranks "
                              f"{sorted(set(range(n)) - set(got))} "
                              "unfinished")
                break
            try:
                rank, ok, out = results.get(timeout=wait)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    # a rank that died without reporting (killed, crashed)
                    time.sleep(0.5)
                    if results.empty():
                        errors.append(f"ranks {dead} exited with codes "
                                      f"{[procs[r].exitcode for r in dead]}")
                        break
                continue
            if ok:
                got[rank] = pickle.loads(out)
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
    finally:
        for p in procs:
            if p.is_alive() and (errors or p.exitcode is None):
                p.join(timeout=0 if errors else 10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        for f in (path, args_path):
            if os.path.exists(f):
                os.remove(f)
        if made:
            os.rmdir(directory)
    if errors:
        raise RuntimeError("data-parallel ranks failed: " + "\n".join(errors))
    return [got[r] for r in range(n)]
