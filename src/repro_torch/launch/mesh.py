"""The rank runtime: P processes in one ``torch.distributed`` group.

Counterpart of ``repro/launch/mesh.py``. What the JAX package gets from a
``Mesh`` over ``jax.devices()`` (one SPMD program over the devices of
one process), the port gets from P rank processes: a ``RankPool`` spawns
them (``torch.multiprocessing``, the ``spawn`` start method) and keeps
them; each ``run`` forms a gloo group of its first n members through a
``FileStore`` in a temporary directory (no port is opened for the
rendezvous), runs ``fn(rank, *args)`` (pickled once to a file in that
directory, which every rank reads) and returns each rank's result, in
rank order. ``run_ranks`` is a pool of one group; the resilient
orchestrator (``runtime/resilience.py``) keeps one pool across its
groups, re-formed on fewer ranks after a rescale.

Each rank runs on ``cuda:(rank % device_count)``, so P ranks share the
cards there are (four ranks share one H100 by time-slicing its SMs), or
on the CPU with ``device="cpu"``, one thread a rank. With no card and no
``device="cpu"`` a rank raises (``repro_torch.resolve_device``). On the
card the parent builds the GNN kernels before it spawns, so the ranks
load finished libraries (``kernels/build.py``).

The transport is gloo: NCCL does not admit two ranks of one communicator
on one device (another transport, NCCL with a card a rank or CUDA IPC,
is ROADMAP.md Queue 1, item 7 (5)). A rank that raises fails the whole call with that rank's
traceback; a rank that dies without one fails it with its exit code. The
group's ``timeout`` bounds every collective and wait, so a dead peer
cannot leave the others blocked in a receive.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable

import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from repro_torch import resolve_device

#: the libraries of the GNN kernels (``kernels/csrc/<name>.cu``)
GNN_LIBRARIES = ("bsr_spmm", "bsr_spmm_fused", "bsr_spmm_masked",
                 "bsr_attention", "fused_adam")


def rank_device(rank: int, device=None) -> torch.device:
    """Where rank ``rank`` runs: ``cuda:(rank % device_count)`` unless the
    caller asks for another device type."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _member_main(index: int, device, timeout_s: float, commands,
                 results) -> None:
    """A pool member's loop: its device set once, then for each command a
    gloo group formed (``FileStore``), ``fn(rank, *args)`` run, the group
    destroyed and the result reported, until told to stop."""
    dev = rank_device(index, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)  # P processes share the host's cores
    while True:
        cmd = commands.get()
        if cmd is None:
            return
        call, store_path, n_ranks, call_path = cmd
        try:
            with open(call_path, "rb") as fh:
                fn, args = pickle.load(fh)
            store = tdist.FileStore(store_path, n_ranks)
            tdist.init_process_group(
                "gloo", store=store, rank=index, world_size=n_ranks,
                timeout=datetime.timedelta(seconds=timeout_s))
            try:
                out = fn(index, *args)
                # no member closes its connections while a peer is still
                # connecting to it (an fn with no collective can be that fast)
                tdist.barrier()
            finally:
                tdist.destroy_process_group()
            results.put((call, index, True, out))
        except BaseException:  # reported to the parent, which raises
            results.put((call, index, False, traceback.format_exc()))


class RankPool:
    """``n_ranks`` rank processes kept alive from one group to the next:
    ``run(fn, n, args)`` forms a gloo group of the first ``n`` members,
    runs ``fn(rank, *args)`` in each and returns the results in rank
    order. A member keeps its device, its CUDA context and its loaded
    kernel libraries between groups, so a group re-formed on fewer ranks
    (an elastic rescale) does not pay the spawn again. Member ``i`` runs
    on ``rank_device(i, device)``. A run that fails (a rank raises or
    dies) raises ``RuntimeError`` with the tracebacks and stops every
    member: the pool is then closed. Use it as a context manager, or
    call ``close``."""

    def __init__(self, n_ranks: int, *, device=None, timeout_s: float = 300.0):
        if n_ranks < 1:
            raise ValueError("need at least one rank")
        if resolve_device(device).type == "cuda":
            from repro_torch.kernels import build

            build.build(GNN_LIBRARIES)
        self.n_ranks = int(n_ranks)
        self.timeout_s = float(timeout_s)
        self._tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
        self._calls = 0
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._commands = [ctx.Queue() for _ in range(n_ranks)]
        self._procs = [ctx.Process(target=_member_main, daemon=True, args=(
            i, device, timeout_s, self._commands[i], self._results))
            for i in range(n_ranks)]
        for proc in self._procs:
            proc.start()

    def run(self, fn: Callable, n_ranks: int, args: tuple = ()) -> list:
        """``fn(rank, *args)`` on members ``0..n_ranks - 1`` in one new
        group; ``fn`` and ``args`` are pickled once to a file every rank
        reads (``fn`` by its import path; a payload through the
        processes' own pipes would serialise their starts), each result
        on its way back."""
        n = int(n_ranks)
        if not 1 <= n <= self.n_ranks:
            raise ValueError(f"a group of {n} ranks from a pool of {self.n_ranks}")
        if self._procs is None:
            raise RuntimeError("the rank pool is closed")
        self._calls += 1
        call = self._calls
        call_path = os.path.join(self._tmp, f"call{call}.pkl")
        with open(call_path, "wb") as fh:
            pickle.dump((fn, args), fh, protocol=pickle.HIGHEST_PROTOCOL)
        store_path = os.path.join(self._tmp, f"store{call}")
        for i in range(n):
            self._commands[i].put((call, store_path, n, call_path))
        got: dict = {}
        failed: list = []
        while len(got) < n and not failed:
            try:
                c, rank, ok, out = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [(i, p.exitcode) for i, p in enumerate(self._procs[:n])
                        if p.exitcode is not None and i not in got]
                if dead:
                    try:  # a member that exited may still be flushing
                        c, rank, ok, out = self._results.get(timeout=5.0)
                    except queue.Empty:
                        failed.append((-1, f"ranks exited without a result: {dead}"))
                        break
                else:
                    continue
            if c != call:
                continue
            if ok:
                got[rank] = out
            else:
                failed.append((rank, out))
        os.remove(call_path)
        if failed:
            # the first failure may be a peer's broken collective: wait a
            # moment for the others, so the rank that raised first is named
            end = time.monotonic() + 5.0
            while len(got) + len(failed) < n and time.monotonic() < end:
                try:
                    c, rank, ok, out = self._results.get(timeout=0.5)
                except queue.Empty:
                    continue
                if c == call and not ok:
                    failed.append((rank, out))
            self.close(force=True)
            raise RuntimeError("rank processes failed:\n" + "\n".join(
                f"--- rank {r} ---\n{tb}" for r, tb in failed))
        return [got[r] for r in range(n)]

    def close(self, force: bool = False) -> None:
        """Stop every member (at once where ``force``, after a failure)."""
        if self._procs is None:
            return
        if not force:
            for q in self._commands:
                q.put(None)
        for p in self._procs:
            p.join(timeout=1 if force else 30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        for q in (*self._commands, self._results):
            q.close()
        self._procs = None
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close(force=exc[0] is not None)


def run_ranks(fn: Callable, n_ranks: int, args: tuple = (), *,
              device=None, timeout_s: float = 300.0) -> list:
    """Run ``fn(rank, *args)`` in each of ``n_ranks`` rank processes, in
    one gloo group, and return the results in rank order (a
    ``RankPool`` of one group). ``fn`` and ``args`` are pickled to every
    rank (``fn`` by its import path), and so is each result on its way
    back. ``timeout_s`` is the group's timeout: a collective or a receive
    that waits longer raises in its rank. Raises ``RuntimeError`` with the
    failing ranks' tracebacks if any rank raises or dies; the other ranks
    are then stopped."""
    with RankPool(n_ranks, device=device, timeout_s=timeout_s) as pool:
        return pool.run(fn, n_ranks, args)
