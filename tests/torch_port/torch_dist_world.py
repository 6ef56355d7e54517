"""A gloo world of spawned processes for the port's distributed tests.

``World(size, store_dir)`` starts ``size`` ranks (``spawn``), each on one
intra-op thread, with its first ``exp`` taken as ``conftest.py`` takes
it, and joins them into a gloo group through a ``file://`` store in
``store_dir`` (no TCP port, so parallel test workers cannot collide),
with a 60 s collective timeout. ``world.run(fn, *args)`` runs the
importable function ``fn`` on every rank and returns the ranks' results
in rank order; a rank's traceback fails the call. Every wait is bounded:
a rank that neither answers nor dies within ``timeout`` seconds gets the
whole world killed and the call raises, so no test can hang. Rank bodies
receive and return picklable values (numpy arrays, numbers).
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing as mp
import os
import queue
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.dirname(os.path.abspath(__file__))
COLLECTIVE_TIMEOUT_S = 60
RUN_TIMEOUT_S = 240


def _rank_main(rank: int, size: int, store: str, tasks, results):
    for path in (REPO, HERE):
        if path not in sys.path:
            sys.path.insert(0, path)
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        torch.exp(torch.zeros(1 << 16))
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=size,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, "ready"))
    while True:
        task = tasks.get()
        if task is None:
            break
        module, name, args = task
        try:
            fn = getattr(importlib.import_module(module), name)
            results.put((rank, True, fn(*args)))
        except Exception:
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class World:
    def __init__(self, size: int, store_dir: str,
                 timeout: float = RUN_TIMEOUT_S):
        self.size, self.timeout = size, timeout
        ctx = mp.get_context("spawn")
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(size)]
        store = os.path.join(store_dir, f"gloo_store_{size}")
        self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                  args=(r, size, store, self.tasks[r],
                                        self.results))
                      for r in range(size)]
        for p in self.procs:
            p.start()
        self._collect("start")

    def _collect(self, what: str) -> list:
        got, errors = {}, []
        deadline = time.monotonic() + self.timeout
        while len(got) + len(errors) < self.size:
            try:
                rank, ok, value = self.results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs)
                        if not p.is_alive() and r not in got]
                if dead or time.monotonic() > deadline:
                    self.close(kill=True)
                    raise TimeoutError(
                        f"gloo world of {self.size}: {what} got no answer "
                        f"from ranks "
                        f"{sorted(set(range(self.size)) - set(got))} "
                        f"(dead: {dead}) within {self.timeout} s; the world "
                        f"was killed")
                continue
            if ok:
                got[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            self.close(kill=True)
            raise RuntimeError(f"gloo world of {self.size}: {what} failed\n"
                               + "\n".join(errors))
        return [got[r] for r in range(self.size)]

    def run(self, fn, *args) -> list:
        """``fn(*args)`` on every rank; the results in rank order."""
        for q in self.tasks:
            q.put((fn.__module__, fn.__name__, args))
        return self._collect(fn.__name__)

    def close(self, kill: bool = False):
        if not kill:
            for q in self.tasks:
                q.put(None)
            for p in self.procs:
                p.join(timeout=30)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
