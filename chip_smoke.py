#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one NVIDIA card.

    python3 chip_smoke.py

Three phases; any failure raises, so the exit code is not 0 and no result
line is printed:

1. Card and build: the card's name and power limit (nvidia-smi), then the
   CUDA kernels built from ``src/repro_torch/kernels/csrc`` with nvcc for
   sm_90a (build seconds and the ptxas report).
2. Kernels against their plain PyTorch versions on the card: the
   ``bsr_spmm`` kernel on the serving configuration's real layer-0/1/2
   bucket operands and on edge cases (padding blocks, a block-row without
   blocks, ragged F=40, F=256), max abs error within 1e-4 (the two sum in
   different orders); kernel, plain and library (``torch.sparse.mm``)
   device times per call (``torch.profiler``) and wall times (CUDA
   events); the least time the card could take (bytes over 3.35 TB/s or
   fp32 operations over 67 TFLOP/s, whichever is larger).
3. Serving at full width: the ogbn-arxiv analog (169,343 nodes), GCN
   [128, 256, 256, 40], fanouts (15, 10, 5), 256-seed batches, through
   ``repro_torch.launch.serve``'s engine on the ``cuda`` backend and, with
   the same weights and request stream, on the ``torch`` reference backend.
   Every request answered, finite logits within 1e-4 of the reference,
   ``bsr_spmm`` launched 3 times per batch; then a cache-on pass whose hits
   equal its misses bitwise. Latency p50/p99, requests/s, warmup and
   sampling times, and where a batch's time goes (host sampling, copies,
   forward pass, the device's busy share).

The last lines are the card's name and power limit, one JSON object with
every kernel's numbers, and ``{"ok": true, "device": {...}}``. Details go
to ``chiprun_out/chip_smoke.json``. Needs one card and no network.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.graph.csr import csr_from_edges, csr_to_bsr  # noqa: E402
from repro_torch.graph.datasets import generate_dataset  # noqa: E402
from repro_torch.graph.sampling import _pad_bsr  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.bsr_spmm import bsr_spmm  # noqa: E402
from repro_torch.kernels.ref import bsr_spmm_ref  # noqa: E402
from repro_torch.launch.serve import build_engine, drive  # noqa: E402
from repro_torch.serving.gnn_engine import GNNServingEngine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
TOL = 1e-4


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The serving configuration; the defaults are the full-width run."""

    dataset: str = "ogbn-arxiv"
    scale: float = 1.0
    hidden: int = 256
    fanouts: tuple = (15, 10, 5)
    batch_size: int = 256
    n_buckets: int = 2
    wave_size: int = 8
    n_requests: int = 64


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, device, reps: int, warmup: int = 2) -> float:
    """Wall time of one call: CUDA events around ``reps`` calls on the card
    (after ``warmup`` calls), so host launch overhead shows where it is
    longer than the device work; the host clock off the card."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def busy_ms(prof) -> float:
    """Summed duration of every kernel, copy and memset a CUDA-only
    profiler window recorded (one stream: the device's busy time)."""
    us = sum(e.self_device_time_total for e in prof.key_averages())
    if not us > 0:
        raise AssertionError("torch.profiler recorded no device time")
    return us / 1e3


def device_ms(fn, device, reps: int, warmup: int = 2) -> float:
    """Device time of one call (``torch.profiler``, CUDA activity only):
    what the call keeps the card busy, without host launch gaps; the host
    clock off the card."""
    if device.type != "cuda":
        return time_ms(fn, device, reps, warmup)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    with warnings.catch_warnings():  # "profiler clears events each cycle"
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize(device)
    return busy_ms(prof) / reps


def spmm_bound(rows, cols, blocks, f: int, n_rows_padded: int) -> dict:
    """Least time for Y = A·X on these inputs: each input byte the product
    needs read once — the blocks that hold a nonzero, their indices and the
    X rows they reference (zero padding and empty-row blocks carry
    nothing) — and each output byte written once; fp32 operations on the
    nonzeros. ``dense_flop`` is the work on every stored block."""
    nb, br, bc = blocks.shape
    used = blocks.reshape(nb, -1).ne(0).any(dim=1)
    n_used = int(used.sum())
    x_rows = int(torch.unique(cols[used]).numel()) * bc
    nbytes = 4 * (2 * n_used + n_used * br * bc + x_rows * f + n_rows_padded * f)
    flop = 2.0 * int(torch.count_nonzero(blocks)) * f
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / FP32_FLOP_PER_S * 1e3
    return {"blocks_used": n_used, "bytes": nbytes, "flop": flop,
            "dense_flop": 2.0 * nb * br * bc * f,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_spmm(name, arrays, x, n_rows_padded, device) -> float:
    """Kernel against the plain version on the same device tensors."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in arrays.items()}
    y = bsr_spmm(t["rows"], t["cols"], t["blocks"], x, n_rows_padded)
    y_ref = bsr_spmm_ref(t["rows"], t["cols"], t["blocks"], x, n_rows_padded)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    err = float((y - y_ref).abs().max()) if y.numel() else 0.0
    if not err <= TOL:
        raise AssertionError(f"bsr_spmm {name}: max abs error {err} > {TOL}")
    print(f"[kernel] bsr_spmm {name}: max_abs_err={err:.3g}")
    return err


def edge_cases(device) -> float:
    """Padding blocks, a block-row with no blocks, F=40 and F=256."""
    r = np.random.default_rng(7)
    g = csr_from_edges(r.integers(0, 130, 300), r.integers(0, 150, 300), 150,
                       n_cols=130, data=r.standard_normal(300).astype(np.float32))
    bsr = csr_to_bsr(g, br=8, bc=8)
    padded = _pad_bsr(bsr, bsr.n_blocks + 9)
    no_blocks = {k: v[padded["rows"] != 4] for k, v in padded.items()}
    err = 0.0
    for f in (40, 256, 1):
        x = torch.randn((bsr.padded_cols, f), generator=torch.Generator().manual_seed(f)).to(device)
        err = max(err, check_spmm(f"padding blocks F={f}", padded, x,
                                  bsr.padded_rows, device))
        err = max(err, check_spmm(f"row without blocks F={f}", no_blocks, x,
                                  bsr.padded_rows, device))
    return err


def kernel_phase(ds, eng, device, reps: int = 20) -> dict:
    """``bsr_spmm`` on one largest-bucket batch's layer operands at the
    widths the main path gives them (u = X·W: hidden, ..., n_classes)."""
    sampler = eng.sampler
    seeds = np.random.default_rng(3).choice(ds.graph.n_rows, sampler.batch_size,
                                            replace=False)
    t0 = time.perf_counter()
    batch = sampler.sample_batch(seeds, eng.trainer.features)
    sample_s = time.perf_counter() - t0
    widths = eng.config.layer_dims[1:]
    layers, err = [], edge_cases(device)
    for l, blk in enumerate(batch.blocks):
        f = widths[l]
        n_out = batch.bucket.node_caps[l + 1]
        n_in = batch.bucket.node_caps[l]
        x = torch.randn((n_in, f), generator=torch.Generator().manual_seed(l)).to(device)
        err = max(err, check_spmm(f"layer {l} [{n_out}x{n_in}] F={f}",
                                  blk.fwd_bsr, x, n_out, device))
        t = {k: torch.from_numpy(v).to(device) for k, v in blk.fwd_bsr.items()}
        csr = blk.csr
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            a_lib = torch.sparse_csr_tensor(
                torch.from_numpy(csr.indptr.astype(np.int64)),
                torch.from_numpy(csr.indices.astype(np.int64)),
                torch.from_numpy(csr.data), size=(csr.n_rows, csr.n_cols),
                check_invariants=True).to(device)
        lib_err = float((torch.sparse.mm(a_lib, x)
                         - bsr_spmm_ref(t["rows"], t["cols"], t["blocks"], x,
                                        n_out)).abs().max())
        if not lib_err <= TOL:
            raise AssertionError(f"library yardstick disagrees: {lib_err}")
        row = {
            "layer": l, "n_rows_padded": n_out, "n_cols_padded": n_in, "F": f,
            "n_blocks": int(t["blocks"].shape[0]), "nnz": int(csr.nnz),
        }
        calls = {
            "": lambda: bsr_spmm(t["rows"], t["cols"], t["blocks"], x, n_out),
            "plain_": lambda: bsr_spmm_ref(t["rows"], t["cols"], t["blocks"], x, n_out),
            "library_": lambda: torch.sparse.mm(a_lib, x),
        }
        for prefix, fn in calls.items():
            row[prefix + "ms"] = device_ms(fn, device, reps)
            row[prefix + "wall_ms"] = time_ms(fn, device, reps)
        row.update(spmm_bound(t["rows"], t["cols"], t["blocks"], f, n_out))
        print(f"[kernel] bsr_spmm layer {l}: " + json.dumps(row))
        layers.append(row)
    return {"layers": layers, "max_abs_err": err, "sample_s": sample_s}


def serving_phase(ds, eng, ref, sizes: Sizes) -> dict:
    """The main path: two engines (cuda kernels, torch reference) on one
    request stream with one set of weights."""
    for a, b in zip(eng.trainer.params["layers"], ref.trainer.params["layers"]):
        if not all(torch.equal(a[k], b[k]) for k in a):
            raise AssertionError("the two engines must share weights")
    t0 = time.perf_counter()
    n_warm = eng.warmup()
    warmup_s = time.perf_counter() - t0
    ref.warmup()

    bsr_spmm.launches = 0
    done, wall = drive(eng, ds.graph.n_rows, sizes.n_requests)
    launches = bsr_spmm.launches
    batches = eng.n_batches
    # one launch per layer and batch on the card; CPU tensors run the plain
    # version and launch nothing (a CPU rehearsal of this phase)
    on_card = eng.trainer.device.type == "cuda"
    expected = len(sizes.fanouts) * batches if on_card else 0
    if launches != expected or (on_card and batches == 0):
        raise AssertionError(f"bsr_spmm launched {launches} times for "
                             f"{batches} batches of {len(sizes.fanouts)} layers")
    if eng.trainer.n_infer_traces != n_warm:
        raise AssertionError("new shape signatures after warmup")
    ref_done, _ = drive(ref, ds.graph.n_rows, sizes.n_requests)
    if len(done) != sizes.n_requests or len(ref_done) != sizes.n_requests:
        raise AssertionError("not every request was answered")
    worst = 0.0
    n_classes = eng.n_classes
    for r, rr in zip(done, ref_done):
        if r.rid != rr.rid or not r.done or r.rejected:
            raise AssertionError(f"request {r.rid} not answered in order")
        if r.logits.shape != (r.node_ids.shape[0], n_classes):
            raise AssertionError(f"request {r.rid}: logits {r.logits.shape}")
        if not np.isfinite(r.logits).all():
            raise AssertionError(f"request {r.rid}: non-finite logits")
        worst = max(worst, float(np.abs(r.logits - rr.logits).max()))
    if not worst <= TOL:
        raise AssertionError(f"cuda vs torch logits differ by {worst} > {TOL}")

    cached = GNNServingEngine(eng.trainer, wave_size=sizes.wave_size,
                              use_cache=True, seed=0)
    ids = np.unique(np.concatenate([r.node_ids for r in done]))[:64]
    miss = cached.serve(ids)
    hit = cached.serve(ids)
    c = cached.cache
    if c.hits != ids.size or c.misses != ids.size or not np.array_equal(miss, hit):
        raise AssertionError(f"cache pass: hits={c.hits} misses={c.misses}")

    lat = np.asarray([r.latency_s for r in done]) * 1e3
    return {"requests": len(done), "batches": batches, "waves": eng.n_waves,
            "launches": launches, "warmup_s": warmup_s, "wall_s": wall,
            "req_per_s": len(done) / wall, "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)), "max_logit_diff": worst,
            "cache_hits": c.hits, "signatures": n_warm}


def breakdown(eng, device, n_ids: int, reps: int = 5) -> dict:
    """Where one wave's batch spends its time, median of ``reps`` batches
    of ``n_ids`` seeds (host clock, synchronised): sampling and CSR→BSR on
    the host, the copy to the device, the forward pass, the logits back.
    On the card, one more batch runs under the profiler: the device's busy
    time in it, and the idle share of the batch's median wall time."""
    tr = eng.trainer
    rng = np.random.default_rng(11)
    parts = {"sample_ms": [], "to_device_ms": [], "forward_ms": [],
             "to_host_ms": []}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def one_batch(seeds):
        t0 = time.perf_counter()
        batch = eng.sampler.sample_batch(seeds, tr.features, rng=rng)
        t1 = time.perf_counter()
        data = tr._batch_arrays(batch)
        sync()
        t2 = time.perf_counter()
        out = tr._infer(tr.params, data)
        sync()
        t3 = time.perf_counter()
        out.cpu()
        return t0, t1, t2, t3, time.perf_counter()

    for _ in range(reps):
        t0, t1, t2, t3, t4 = one_batch(rng.choice(tr.n_nodes, n_ids, replace=False))
        for k, a, b in (("sample_ms", t0, t1), ("to_device_ms", t1, t2),
                        ("forward_ms", t2, t3), ("to_host_ms", t3, t4)):
            parts[k].append((b - a) * 1e3)
    out = {"seeds": n_ids, **{k: float(np.median(v)) for k, v in parts.items()}}
    if device.type == "cuda":
        seeds = rng.choice(tr.n_nodes, n_ids, replace=False)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            one_batch(seeds)
        busy = busy_ms(prof)
        out["device_busy_ms"] = busy
        out["idle_share"] = 1.0 - busy / sum(out[k] for k in parts)
    return out


def run(sizes: Sizes, device) -> dict:
    """Phases 2 and 3 at ``sizes`` on ``device``; returns the kernels line
    and the details."""
    t0 = time.perf_counter()
    ds = generate_dataset(sizes.dataset, scale=sizes.scale, seed=0)
    print(f"[data] {ds.name}: {ds.graph.n_rows} nodes, {ds.graph.nnz} nonzeros, "
          f"{ds.features.shape[1]} features in {time.perf_counter() - t0:.2f}s")
    kw = dict(arch="GCN", hidden=sizes.hidden, fanouts=sizes.fanouts,
              batch_size=sizes.batch_size, n_buckets=sizes.n_buckets,
              wave_size=sizes.wave_size, use_cache=False, device=device)
    eng = build_engine(ds, engine="cuda", **kw)
    ref = build_engine(ds, engine="torch", **kw)
    kern = kernel_phase(ds, eng, device)
    serve = serving_phase(ds, eng, ref, sizes)
    print(f"[serve] {json.dumps(serve)}")
    serve["breakdown"] = [breakdown(eng, device, n)
                          for n in (4 * sizes.wave_size, sizes.batch_size)]
    print(f"[serve] per-batch breakdown: {json.dumps(serve['breakdown'])}")
    layers = kern["layers"]
    total = {k: sum(row[k] for row in layers)
             for k in ("ms", "wall_ms", "plain_ms", "library_ms", "bound_ms",
                       "bytes", "flop")}
    entry = {
        "name": "bsr_spmm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bsr_spmm.cu",
        "replaces": "src/repro/kernels/bsr_spmm.py:105",
        "launches": serve["launches"], "max_abs_err": kern["max_abs_err"],
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": ("bytes" if total["bytes"] / HBM_BYTES_PER_S
                     >= total["flop"] / FP32_FLOP_PER_S else "operations"),
        "library_ms": total["library_ms"],
        "wall_ms": total["wall_ms"],
        "shape": "one largest-bucket batch: layers 0-2 summed; *_ms are "
                 "device time per call (torch.profiler), wall_ms CUDA events",
    }
    return {"kernels": [entry], "layers": layers, "serve": serve,
            "sample_s": kern["sample_s"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}")
    built = build.build(["bsr_spmm"])
    print(f"[build] nvcc sm_90a: " + ", ".join(f"{k} {v:.1f}s" for k, v in built.items()))
    log = build.library_path("bsr_spmm").with_suffix(".so.log")
    if log.exists():
        print("[build] ptxas: " + " | ".join(
            l.strip() for l in log.read_text().splitlines() if "Used" in l or "spill" in l))

    result = run(Sizes(), device)
    serve = result["serve"]
    print(f"[serve] {serve['requests']} requests, {serve['req_per_s']:.2f} req/s, "
          f"p50 {serve['p50_ms']:.2f} ms, p99 {serve['p99_ms']:.2f} ms, "
          f"warmup {serve['warmup_s']:.2f}s, sample one 256-seed batch "
          f"{result['sample_s']:.3f}s on {card}")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump({"card": card, "build_s": built, **result}, fh, indent=1)
    print(card)
    print(json.dumps({"kernels": result["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
