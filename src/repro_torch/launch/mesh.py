"""The rank runtime: P processes in one ``torch.distributed`` group.

Counterpart of ``repro/launch/mesh.py``. What the JAX package gets from a
``Mesh`` over ``jax.devices()`` (one SPMD program over the devices of
one process), the port gets from P rank processes: ``run_ranks`` spawns
them (``torch.multiprocessing``, the ``spawn`` start method), forms a
gloo group in each through a ``FileStore`` in a temporary directory (no
port is opened for the rendezvous), runs ``fn(rank, *args)`` and returns
each rank's result, in rank order.

Each rank runs on ``cuda:(rank % device_count)``, so P ranks share the
cards there are (four ranks share one H100 by time-slicing its SMs), or
on the CPU with ``device="cpu"``, one thread a rank. With no card and no
``device="cpu"`` a rank raises (``repro_torch.resolve_device``). On the
card the parent builds the GNN kernels before it spawns, so the ranks
load finished libraries (``kernels/build.py``).

The transport is gloo: NCCL does not admit two ranks of one communicator
on one device. A rank that raises fails the whole call with that rank's
traceback; a rank that dies without one fails it with its exit code. The
group's ``timeout`` bounds every collective and wait, so a dead peer
cannot leave the others blocked in a receive.
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
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


def _rank_main(rank: int, n_ranks: int, store_path: str, device,
               timeout_s: float, fn: Callable, args: tuple, results) -> None:
    try:
        dev = rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)  # P processes share the host's cores
        store = tdist.FileStore(store_path, n_ranks)
        tdist.init_process_group(
            "gloo", store=store, rank=rank, world_size=n_ranks,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, *args)
        finally:
            tdist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, n_ranks: int, args: tuple = (), *,
              device=None, timeout_s: float = 300.0) -> list:
    """Run ``fn(rank, *args)`` in each of ``n_ranks`` rank processes, in
    one gloo group, and return the results in rank order. ``fn`` and
    ``args`` are pickled to every rank (``fn`` by its import path), and
    so is each result on its way back. ``timeout_s`` is the group's
    timeout: a collective or a receive that waits longer raises in its
    rank. Raises ``RuntimeError`` with the failing ranks' tracebacks if
    any rank raises or dies; the other ranks are then stopped."""
    if n_ranks < 1:
        raise ValueError("need at least one rank")
    if resolve_device(device).type == "cuda":
        from repro_torch.kernels import build

        build.build(GNN_LIBRARIES)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got: dict = {}
    failed: list = []
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, n_ranks, store_path, device, timeout_s, fn, args, results))
            for r in range(n_ranks)]
        for p in procs:
            p.start()
        try:
            while len(got) < n_ranks and not failed:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    if any(p.exitcode is not None and r not in got
                           for r, p in enumerate(procs)):
                        try:  # a rank that exited may still be flushing
                            rank, ok, out = results.get(timeout=5.0)
                        except queue.Empty:
                            failed.append((-1, "ranks exited without a result: " + str(
                                [(r, p.exitcode) for r, p in enumerate(procs)
                                 if r not in got and p.exitcode is not None])))
                            break
                    else:
                        continue
                if ok:
                    got[rank] = out
                else:
                    failed.append((rank, out))
        finally:
            for p in procs:
                p.join(timeout=1 if failed else 30)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    if failed:
        raise RuntimeError("rank processes failed:\n" + "\n".join(
            f"--- rank {r} ---\n{tb}" for r, tb in failed))
    return [got[r] for r in range(n_ranks)]
