#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure raises, so the exit code is not 0 and no result line
is printed:

1. Card and build: the card's name and power limit (nvidia-smi), then the
   four CUDA libraries built in parallel from
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a (build seconds and
   the ptxas report).
2. ``bsr_spmm`` against its plain PyTorch version on the serving
   configuration's real layer-0/1/2 bucket operands and on edge cases
   (padding blocks, a block-row without blocks, F=1/40/256).
3. Serving at full width: the ogbn-arxiv analog (169,343 nodes), GCN
   [128, 256, 256, 40], fanouts (15, 10, 5), 256-seed batches, through
   ``repro_torch.launch.serve``'s engine on the ``cuda`` backend and, with
   the same weights and request stream, on the ``torch`` reference backend:
   logits within 1e-4, ``bsr_spmm`` launched 3 times per batch, a cache-on
   pass whose hits equal its misses bitwise; latency, throughput and where
   a batch's time goes.
4. Full-batch training, the main path (paper Listing 1): the same
   dataset and GCN through ``GNNProgram ... compile(engine="cuda",
   fused_optimizer=True) ... train_epoch`` for 10 epochs, against the
   ``torch`` program (plain versions, plain Adam) from the same weights:
   the first step's gradients leaf by leaf and the parameters after the
   last epoch within 1e-5 of each leaf's largest value, finite losses
   within 1e-3 relative at every epoch and falling, exactly fused 3 /
   masked 2 / bsr_spmm 1 / Adam 6 launches per epoch; the median epoch
   time, device ms per kernel and for the matmuls from a profiled epoch
   that recorded every launch, the idle share, peak memory and the
   operands' host build time.
5. The fused-epilogue, masked and Adam kernels against their plain versions
   on the main path's real operands (A and Aᵀ of the full graph): five
   epilogue specs at F=256 and F=40, a repeat launch bitwise equal, masks
   compared where |pre-activation| > 1e-5; the masked kernel on Aᵀ with a
   real ReLU mask; ``bsr_spmm`` on Aᵀ; edge cases; Adam on the six GCN
   leaves and on sizes 1 and 1,000,003 (1e-6). Time per call from CUDA
   events (these full-graph calls keep the card busy far longer than their
   launches take; Adam's short launches from ``torch.profiler``), plain
   ms, library ms
   (``torch.sparse.mm`` + the epilogue's torch ops; ``torch.optim.Adam(
   fused=True)``), the least time the card could take (bytes over 3.35 TB/s
   or fp32 operations over 67 TFLOP/s, whichever is larger; counted over
   the BSR layout's blocks, and over the nonzeros alone), and the hub
   row's cost against a mean row's.
6. The quickstart at full scale: the corafull analog (19,793 nodes, 8,710
   features, 95% zeros), GCN [8710, 32, 70], layer 0 on
   ``cuda.feature_matmul_sparse``; 10 epochs of cuda against torch with the
   same checks and exactly 2 / 1 / 3 / 4 launches per epoch; the fused
   pair's forward and backward on A and Aᵀ with unequal paddings (19,800
   rows, 19,840 columns), cuda against torch; ``bsr_spmm`` on BSR(X) and
   BSR(Xᵀ) at F=32 against its plain version.

The last lines are the card's name and power limit, one JSON object with
every kernel's numbers, and ``{"ok": true, "device": {...}}``. Details go
to ``chiprun_out/chip_smoke.json``. Needs one card and no network.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import warnings
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core.dsl import GNNProgram  # noqa: E402
from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.graph.csr import csr_from_dense, csr_from_edges, csr_to_bsr  # noqa: E402
from repro_torch.graph.datasets import generate_dataset  # noqa: E402
from repro_torch.graph.sampling import _pad_bsr  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.bsr_spmm import (  # noqa: E402
    bsr_spmm,
    bsr_spmm_fused_epilogue,
    bsr_spmm_masked,
)
from repro_torch.kernels.fused_adam import fused_adam  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    bsr_spmm_fused_ref,
    bsr_spmm_masked_ref,
    bsr_spmm_ref,
    fused_adam_ref,
)
from repro_torch.training.optimizer import bias_corrected_lr  # noqa: E402
from repro_torch.training.trainer import value_and_grad  # noqa: E402
from repro_torch.launch.serve import build_engine, drive  # noqa: E402
from repro_torch.serving.gnn_engine import GNNServingEngine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
TOL = 1e-4
ADAM_TOL = 1e-6
MASK_MARGIN = 1e-5
#: cuda against torch program, per leaf, the norm of the difference over the
#: leaf's norm: both programs' gradients at the same parameters, and each
#: program's parameters after the last epoch. Where a layer-0 pre-activation
#: lies within rounding of 0 (two of 43 M at the first step on ogbn-arxiv,
#: |pre| <= 1.5e-8), the programs' ReLU masks part. The analog's labels are
#: random, so its gradients nearly cancel: the two flips move layer 0's by
#: 6e-5, and Adam, which normalises gradients, carries such gaps into the
#: parameters (0.9-1e-2 after 10 epochs; the quickstart's 4e-7)
GRAD_RTOL = 1e-3
PARAM_RTOL = 5e-2
ADAM = ("adam", 0.01, 0.9, 0.999)

#: every kernel wrapper of the port, by the name the kernels line uses
KERNELS = {"bsr_spmm": bsr_spmm,
           "bsr_spmm_fused_epilogue": bsr_spmm_fused_epilogue,
           "bsr_spmm_masked": bsr_spmm_masked,
           "fused_adam": fused_adam}
#: the CUDA sources (kernels/csrc/<name>.cu) the kernels are built from
LIBRARIES = ["bsr_spmm", "bsr_spmm_fused", "bsr_spmm_masked", "fused_adam"]
SOURCES = {
    "bsr_spmm": ("src/repro_torch/kernels/csrc/bsr_spmm.cu",
                 "src/repro/kernels/bsr_spmm.py:105"),
    "bsr_spmm_fused_epilogue": ("src/repro_torch/kernels/csrc/bsr_spmm_fused.cu",
                                "src/repro/kernels/bsr_spmm.py:245"),
    "bsr_spmm_masked": ("src/repro_torch/kernels/csrc/bsr_spmm_masked.cu",
                        "src/repro/kernels/bsr_spmm.py:312"),
    "fused_adam": ("src/repro_torch/kernels/csrc/fused_adam.cu",
                   "src/repro/kernels/fused_adam.py:86"),
}

#: the epilogue specs the lowering emits: (self_term, bias, activation)
SPECS = {
    "gcn (bias+relu)": (False, True, "relu"),
    "gcn last (bias)": (False, True, "none"),
    "sage (self+bias+relu)": (True, True, "relu"),
    "gin sparse (self*alpha+bias+relu)": (True, True, "relu"),
    "gin dense (self*alpha)": (True, False, "none"),
}


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The configurations; the defaults are the full-width run."""

    dataset: str = "ogbn-arxiv"
    scale: float = 1.0
    hidden: int = 256
    fanouts: tuple = (15, 10, 5)
    batch_size: int = 256
    n_buckets: int = 2
    wave_size: int = 8
    n_requests: int = 64
    # full-batch training: GCN [F, train_hidden..., C] on `dataset`
    train_hidden: tuple = (256, 256)
    epochs: int = 10
    # the quickstart: GCN [F, 32, C] on the corafull analog
    quick_dataset: str = "corafull"
    quick_scale: float = 1.0
    quick_hidden: tuple = (32,)


def zero_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


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


#: profiler windows tried before a measurement falls back to CUDA events
PROFILE_TRIES = 3


def device_events(prof):
    """(name, device µs, launches) of every kernel, copy and memset the
    window recorded; the step's own annotation, which spans them, is left
    out."""
    return [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if not e.key.startswith("ProfilerStep")]


def window_complete(prof, expect: dict) -> bool:
    """Did the window record device time, and exactly ``expect[k]``
    launches of each kernel ``k`` (``classify``'s names)? In the
    full-width run, windows over a few back-to-back launches of the long
    full-graph SpMM kernels recorded only some of them (three 53 ms
    launches read as 17.7 ms each), and a window once recorded nothing,
    though each mode recorded every launch when run alone on the card."""
    got = defaultdict(int)
    busy = 0.0
    for name, us, n in device_events(prof):
        got[classify(name)] += n
        busy += us
    if busy > 0 and all(got[k] == v for k, v in expect.items()):
        return True
    print(f"[profile] incomplete window: {busy / 1e3:.3f} ms busy, launches "
          f"{ {k: got[k] for k in expect} }, expected {expect}")
    return False


def profiled(fn, device, expect: dict):
    """``torch.profiler`` (CUDA activity only) over one call of ``fn``,
    after one more call as the profiler's warmup step, which is discarded;
    the first of ``PROFILE_TRIES`` windows that is complete for ``expect``
    (``window_complete``) and its number, else (None, PROFILE_TRIES)."""
    for attempt in range(1, PROFILE_TRIES + 1):
        sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with warnings.catch_warnings():  # "profiler clears events each cycle"
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CUDA], schedule=sched) as prof:
                for _ in range(2):
                    fn()
                    torch.cuda.synchronize(device)
                    prof.step()
        if window_complete(prof, expect):
            return prof, attempt
    return None, PROFILE_TRIES


def busy_ms(prof) -> float:
    """Summed duration of every kernel, copy and memset a CUDA-only
    profiler window recorded (one stream: the device's busy time)."""
    return sum(t for _, t, _ in device_events(prof)) / 1e3


def device_ms(fn, device, reps: int, expect: dict):
    """Device time of one call of a short call: ``profiled`` over ``reps``
    back-to-back calls, busy time over ``reps`` — what the call keeps the
    card busy, without host launch gaps. ``expect`` is one call's launches
    by kernel. None where no window held them all (a window without the
    warmup step recorded 15 of 18 ``fused_adam`` launches, every time), or
    off the card."""
    if device.type != "cuda":
        return None
    prof, _ = profiled(lambda: [fn() for _ in range(reps)], device,
                       {k: v * reps for k, v in expect.items()})
    return None if prof is None else busy_ms(prof) / reps


def _bound(nbytes: float, flop: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def spmm_bound(rows, cols, blocks, f: int, n_rows_padded: int) -> dict:
    """Least time for Y = A·X on these inputs, counted two ways; fp32
    operations on the nonzeros in both. ``bound_ms``, the layout's: each
    input byte this BSR product needs read once — the blocks that hold a
    nonzero, whole, their indices and the X rows of their block-columns
    (zero padding and empty-row blocks carry nothing) — and each output
    byte written once. ``nnz_bound_ms``, any layout's: each nonzero's value
    and column index and a row pointer per row read once, the X rows the
    nonzeros reference, Y written once. ``dense_flop`` is the work on
    every stored block."""
    nb, br, bc = blocks.shape
    nz = blocks.ne(0)
    used = nz.reshape(nb, -1).any(dim=1)
    n_used = int(used.sum())
    x_rows = int(torch.unique(cols[used]).numel()) * bc
    nbytes = 4 * (2 * n_used + n_used * br * bc + x_rows * f + n_rows_padded * f)
    b_idx, _, j = torch.nonzero(nz, as_tuple=True)
    nnz = int(b_idx.numel())
    nnz_x_rows = int(torch.unique(cols[b_idx].long() * bc + j).numel())
    nnz_bytes = 4 * (2 * nnz + n_rows_padded + 1 + nnz_x_rows * f + n_rows_padded * f)
    flop = 2.0 * nnz * f
    out = {"blocks_used": n_used, "nnz": nnz, "x_rows": x_rows,
           "nnz_x_rows": nnz_x_rows, "bytes": nbytes, "nnz_bytes": nnz_bytes,
           "flop": flop, "dense_flop": 2.0 * nb * br * bc * f}
    out["bound_ms"], out["bound_by"] = _bound(nbytes, flop)
    out["nnz_bound_ms"], _ = _bound(nnz_bytes, flop)
    return out


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timings(calls: dict, device, reps: int,
            expect: "dict | None" = None) -> dict:
    """``<prefix>wall_ms`` (CUDA events over ``reps`` back-to-back calls
    after one more)
    and ``<prefix>ms`` for each named call, with ``<prefix>ms_by`` saying
    how ``ms`` was taken. ``expect`` maps a prefix to its call's launches
    by kernel: those calls are short, and ``ms`` is their device time from
    the profiler (``device_ms``), or the CUDA-event time where no window
    was complete. Calls without an entry are the full-graph calls, which
    keep the card busy far longer than their launches take: ``ms`` is the
    CUDA-event time (the host clock off the card)."""
    expect = expect or {}
    out = {}
    for prefix, fn in calls.items():
        out[prefix + "wall_ms"] = time_ms(fn, device, reps, warmup=1)
        ms = (device_ms(fn, device, reps, expect[prefix])
              if prefix in expect else None)
        out[prefix + "ms"] = out[prefix + "wall_ms"] if ms is None else ms
        out[prefix + "ms_by"] = ("profiler" if ms is not None else
                                 "cuda events" if device.type == "cuda"
                                 else "host clock")
    return out


def csr_tensor(csr, device):
    """The weighted graph as a ``torch.sparse`` CSR tensor: the library
    yardstick's operand (timed beside the kernels, never used by the port)."""
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(csr.indptr.astype(np.int64)),
            torch.from_numpy(csr.indices.astype(np.int64)),
            torch.from_numpy(csr.data), size=(csr.n_rows, csr.n_cols)).to(device)


def check_close(name, got, want, tol=TOL) -> float:
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not err <= tol:
        raise AssertionError(f"{name}: max abs error {err} > {tol}")
    return err


def check_fused(name, op, x, s, b, alpha, spec, device) -> float:
    """The fused kernel against its plain version on one operand and spec:
    y everywhere, the mask where |pre-activation| > MASK_MARGIN, and a
    repeat launch bitwise equal."""
    has_self, has_bias, act = spec
    args = (op.block_rows, op.block_cols, op.blocks, x, op.n_rows_padded,
            s if has_self else None, b if has_bias else None,
            alpha if has_self else None)
    y, mask = bsr_spmm_fused_epilogue(*args, act)
    y2, mask2 = bsr_spmm_fused_epilogue(*args, act)
    y_ref, mask_ref = bsr_spmm_fused_ref(*args, act)
    sync(device)
    err = check_close(f"bsr_spmm_fused_epilogue {name}", y, y_ref)
    if device.type == "cuda" and not torch.equal(y, y2):
        raise AssertionError(f"bsr_spmm_fused_epilogue {name}: a repeat "
                             "launch is not bitwise equal")
    if act == "relu":
        pre, _ = bsr_spmm_fused_ref(*args, "none")
        far = pre.abs() > MASK_MARGIN
        if not (torch.equal(mask[far], mask_ref[far]) and torch.equal(mask, mask2)):
            raise AssertionError(f"bsr_spmm_fused_epilogue {name}: masks differ")
    print(f"[kernel] bsr_spmm_fused_epilogue {name}: max_abs_err={err:.3g}")
    return err


def check_masked(name, op, x, mask, device) -> float:
    args = (op.block_rows, op.block_cols, op.blocks, x, mask, op.n_rows_padded)
    y = bsr_spmm_masked(*args)
    y2 = bsr_spmm_masked(*args)
    y_ref = bsr_spmm_masked_ref(*args)
    sync(device)
    err = check_close(f"bsr_spmm_masked {name}", y, y_ref)
    if device.type == "cuda" and not torch.equal(y, y2):
        raise AssertionError(f"bsr_spmm_masked {name}: repeat not bitwise equal")
    print(f"[kernel] bsr_spmm_masked {name}: max_abs_err={err:.3g}")
    return err


def on_device(arrays: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def check_spmm(name, rows, cols, blocks, x, n_rows_padded, device) -> float:
    """Kernel against the plain version on the same device tensors."""
    y = bsr_spmm(rows, cols, blocks, x, n_rows_padded)
    y_ref = bsr_spmm_ref(rows, cols, blocks, x, n_rows_padded)
    sync(device)
    err = check_close(f"bsr_spmm {name}", y, y_ref)
    print(f"[kernel] bsr_spmm {name}: max_abs_err={err:.3g}")
    return err


def edge_cases(device) -> dict:
    """The three SpMM kernels on padding blocks and on a block-row with no
    blocks, F = 1, 40, 256, every epilogue spec; max abs error of each."""
    r = np.random.default_rng(7)
    g = csr_from_edges(r.integers(0, 130, 300), r.integers(0, 150, 300), 150,
                       n_cols=130, data=r.standard_normal(300).astype(np.float32))
    bsr = csr_to_bsr(g, br=8, bc=8)
    padded = _pad_bsr(bsr, bsr.n_blocks + 9)
    no_blocks = {k: v[padded["rows"] != 4] for k, v in padded.items()}
    err = {"spmm": 0.0, "fused": 0.0, "masked": 0.0}
    for f in (1, 40, 256):
        gen = torch.Generator().manual_seed(f)
        x = torch.randn((bsr.padded_cols, f), generator=gen).to(device)
        s = torch.randn((bsr.padded_rows, f), generator=gen).to(device)
        b = torch.randn(f, generator=gen).to(device)
        m = (torch.randn((bsr.padded_cols, f), generator=gen) > 0).float().to(device)
        alpha = torch.full((1,), 0.7, device=device)
        for label, arrays in (("padding blocks", padded), ("row without blocks", no_blocks)):
            t = on_device(arrays, device)
            err["spmm"] = max(err["spmm"], check_spmm(
                f"{label} F={f}", t["rows"], t["cols"], t["blocks"], x,
                bsr.padded_rows, device))
            op = kops.BSRDevice(t["rows"], t["cols"], t["blocks"], bsr.n_rows,
                                bsr.n_cols, bsr.padded_rows, bsr.padded_cols, 8, 8)
            for spec_name, spec in SPECS.items():
                err["fused"] = max(err["fused"], check_fused(
                    f"{label} F={f} {spec_name}", op, x, s, b, alpha, spec, device))
            err["masked"] = max(err["masked"], check_masked(
                f"{label} F={f}", op, x, m, device))
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
    edge = edge_cases(device)
    layers, err = [], edge["spmm"]
    for l, blk in enumerate(batch.blocks):
        f = widths[l]
        n_out = batch.bucket.node_caps[l + 1]
        n_in = batch.bucket.node_caps[l]
        x = torch.randn((n_in, f), generator=torch.Generator().manual_seed(l)).to(device)
        t = on_device(blk.fwd_bsr, device)
        err = max(err, check_spmm(f"layer {l} [{n_out}x{n_in}] F={f}",
                                  t["rows"], t["cols"], t["blocks"], x, n_out,
                                  device))
        csr = blk.csr
        a_lib = csr_tensor(csr, device)
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
        row.update(timings(calls, device, reps,
                           expect={"": {"bsr_spmm": 1}, "plain_": {},
                                   "library_": {}}))
        row.update(spmm_bound(t["rows"], t["cols"], t["blocks"], f, n_out))
        print(f"[kernel] bsr_spmm layer {l}: " + json.dumps(row))
        layers.append(row)
    return {"layers": layers, "max_abs_err": err, "sample_s": sample_s,
            "edge": edge}


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

    zero_counts()
    done, wall = drive(eng, ds.graph.n_rows, sizes.n_requests)
    launched = counts()
    launches = launched["bsr_spmm"]
    batches = eng.n_batches
    # one launch per layer and batch on the card; CPU tensors run the plain
    # version and launch nothing (a CPU rehearsal of this phase)
    on_card = eng.trainer.device.type == "cuda"
    expected = len(sizes.fanouts) * batches if on_card else 0
    if launches != expected or (on_card and batches == 0):
        raise AssertionError(f"bsr_spmm launched {launches} times for "
                             f"{batches} batches of {len(sizes.fanouts)} layers")
    if sum(launched.values()) != launches:
        raise AssertionError(f"serving launched other kernels: {launched}")
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
    On the card, one more batch runs under the profiler (after a warmup
    batch): the device's busy time in it, and the idle share of the
    batch's median wall time; both None where no window recorded the
    batch's one ``bsr_spmm`` launch per layer."""
    tr = eng.trainer
    rng = np.random.default_rng(11)
    parts = {"sample_ms": [], "to_device_ms": [], "forward_ms": [],
             "to_host_ms": []}

    def one_batch(seeds):
        t0 = time.perf_counter()
        batch = eng.sampler.sample_batch(seeds, tr.features, rng=rng)
        t1 = time.perf_counter()
        data = tr._batch_arrays(batch)
        sync(device)
        t2 = time.perf_counter()
        out = tr._infer(tr.params, data)
        sync(device)
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
        n_layers = len(eng.config.layer_dims) - 1
        prof, _ = profiled(lambda: one_batch(rng.choice(tr.n_nodes, n_ids,
                                                        replace=False)),
                           device, {"bsr_spmm": n_layers})
        busy = None if prof is None else busy_ms(prof)
        out["device_busy_ms"] = busy
        out["idle_share"] = (None if busy is None
                             else 1.0 - busy / sum(out[k] for k in parts))
    return out


def fused_bound(op, f, self_term: bool, bias: bool, relu: bool,
                masked: bool = False) -> dict:
    """``spmm_bound`` (both counts) plus the epilogue's streams: self read
    once, bias read once, the mask written once; for the masked product
    the mask rows beside the X rows it reads."""
    out = spmm_bound(op.block_rows, op.block_cols, op.blocks, f, op.n_rows_padded)
    extra = 4 * f * (op.n_rows_padded * (int(self_term) + int(relu)) + int(bias))
    out["bytes"] += extra + (4 * f * out["x_rows"] if masked else 0)
    out["nnz_bytes"] += extra + (4 * f * out["nnz_x_rows"] if masked else 0)
    out["bound_ms"], out["bound_by"] = _bound(out["bytes"], out["flop"])
    out["nnz_bound_ms"], _ = _bound(out["nnz_bytes"], out["flop"])
    return out


def row_cost(op, f, device, reps: int) -> dict:
    """The fused kernel's time on a stream holding only the longest
    block-row (the in-degree hub: one CTA walks it serially) against one
    holding only a row of about the mean length; F=f, bias + ReLU."""
    rows = op.block_rows.long()
    per_row = torch.bincount(rows, minlength=op.n_rows_padded // op.br)
    hub = int(torch.argmax(per_row))
    mean = float(per_row.float().mean())
    typical = int(torch.argmin((per_row.float() - mean).abs()))
    x = torch.randn((op.n_cols_padded, f), generator=torch.Generator().manual_seed(5)).to(device)
    b = torch.zeros(f, device=device)
    out = {"hub_blocks": int(per_row[hub]), "mean_blocks": mean,
           "typical_blocks": int(per_row[typical])}
    for label, row in (("hub", hub), ("typical", typical)):
        sel = rows == row
        r_, c_, bl = (op.block_rows[sel].contiguous(), op.block_cols[sel].contiguous(),
                      op.blocks[sel].contiguous())
        out.update({f"{label}_{k}": v for k, v in timings({"": lambda: bsr_spmm_fused_epilogue(
            r_, c_, bl, x, op.n_rows_padded, bias=b, activation="relu")},
            device, reps).items()})
    return out


def fused_kernel_phase(prog, csr_a, device, reps: int) -> dict:
    """Phase 5 on the main path's operands: A (forward) and Aᵀ (backward)."""
    fwd, bwd = prog.plan.graph_op.fwd_operand, prog.plan.graph_op.bwd_operand
    a_lib, at_lib = csr_tensor(csr_a, device), csr_tensor(csr_a.transpose(), device)
    gen = torch.Generator().manual_seed(11)
    dims = prog.model.config.layer_dims
    widths = sorted(set(dims[1:]), reverse=True)  # 256, 40 at full width
    alpha = torch.full((1,), 1.25, device=device)
    err = {"fused": 0.0, "masked": 0.0, "spmm": 0.0, "adam": 0.0}
    rows = {}
    for f in widths:
        x = torch.randn((fwd.n_cols_padded, f), generator=gen).to(device)
        s = torch.randn((fwd.n_rows_padded, f), generator=gen).to(device)
        b = torch.randn(f, generator=gen).to(device)
        for spec_name, spec in SPECS.items():
            err["fused"] = max(err["fused"], check_fused(
                f"A F={f} {spec_name}", fwd, x, s, b, alpha, spec, device))
        # library yardstick: cuSPARSE CSR product + the epilogue's torch ops
        lib_y = torch.relu(torch.sparse.mm(a_lib, x[: fwd.n_cols]) + b)
        plain_y, _ = bsr_spmm_fused_ref(fwd.block_rows, fwd.block_cols, fwd.blocks,
                                        x, fwd.n_rows_padded, bias=b, activation="relu")
        check_close("library yardstick (fused)", lib_y, plain_y[: fwd.n_rows])
        for spec_name, act in (("bias+relu", "relu"), ("bias", "none")):
            args = (fwd.block_rows, fwd.block_cols, fwd.blocks, x, fwd.n_rows_padded)

            def library(act=act):
                z = torch.sparse.mm(a_lib, x[: fwd.n_cols]) + b
                return (torch.relu(z), z > 0) if act == "relu" else z

            row = {"kernel": "bsr_spmm_fused_epilogue", "operand": "A", "F": f,
                   "spec": spec_name, "n_blocks": int(fwd.blocks.shape[0]),
                   "nnz": csr_a.nnz}
            row.update(timings({
                "": lambda: bsr_spmm_fused_epilogue(*args, bias=b, activation=act),
                "plain_": lambda: bsr_spmm_fused_ref(*args, bias=b, activation=act),
                "library_": library}, device, reps))
            row.update(fused_bound(fwd, f, False, True, act == "relu"))
            rows[("fused", f, act)] = row
            print("[kernel] " + json.dumps(row))
    # the backward on Aᵀ: masked at the widest hidden width with a real
    # ReLU mask; bsr_spmm at the last layer's width
    f = dims[1]
    u = torch.randn((fwd.n_cols_padded, f), generator=gen).to(device)
    _, mask = bsr_spmm_fused_epilogue(fwd.block_rows, fwd.block_cols, fwd.blocks,
                                      u, fwd.n_rows_padded, activation="relu")
    t_in = -(-fwd.n_rows_padded // bwd.bc) * bwd.bc
    dy = kops._fit_rows(torch.randn((fwd.n_rows_padded, f), generator=gen).to(device), t_in)
    mask = kops._fit_rows(mask, t_in).contiguous()
    err["masked"] = max(err["masked"], check_masked(f"Aᵀ F={f} (real ReLU mask)",
                                                    bwd, dy, mask, device))
    margs = (bwd.block_rows, bwd.block_cols, bwd.blocks, dy, mask, bwd.n_rows_padded)
    lib_in = (mask * dy)[: bwd.n_cols]
    check_close("library yardstick (masked)", torch.sparse.mm(at_lib, lib_in),
                bsr_spmm_masked_ref(*margs)[: bwd.n_rows])
    row = {"kernel": "bsr_spmm_masked", "operand": "A^T", "F": f,
           "mask_share": float(mask.mean()), "n_blocks": int(bwd.blocks.shape[0])}
    row.update(timings({"": lambda: bsr_spmm_masked(*margs),
                        "plain_": lambda: bsr_spmm_masked_ref(*margs),
                        "library_": lambda: torch.sparse.mm(at_lib, (mask * dy)[: bwd.n_cols])},
                       device, reps))
    row.update(fused_bound(bwd, f, False, False, False, masked=True))
    rows[("masked", f)] = row
    print("[kernel] " + json.dumps(row))
    f = dims[-1]
    dy = torch.randn((t_in, f), generator=gen).to(device)
    sargs = (bwd.block_rows, bwd.block_cols, bwd.blocks, dy, bwd.n_rows_padded)
    y = bsr_spmm(*sargs)
    err["spmm"] = check_close(f"bsr_spmm Aᵀ F={f}", y, bsr_spmm_ref(*sargs))
    row = {"kernel": "bsr_spmm", "operand": "A^T", "F": f,
           "n_blocks": int(bwd.blocks.shape[0])}
    row.update(timings({"": lambda: bsr_spmm(*sargs),
                        "plain_": lambda: bsr_spmm_ref(*sargs),
                        "library_": lambda: torch.sparse.mm(at_lib, dy[: bwd.n_cols])},
                       device, reps))
    row.update(spmm_bound(*sargs[:3], f, bwd.n_rows_padded))
    rows[("spmm", f)] = row
    print("[kernel] " + json.dumps(row))
    rows["hub"] = row_cost(fwd, dims[1], device, reps)
    print("[kernel] hub row: " + json.dumps(rows["hub"]))
    rows["adam"], err["adam"] = adam_checks(prog, device, reps)
    return {"rows": rows, "err": err}


def adam_checks(prog, device, reps: int):
    """``fused_adam`` on the six GCN leaves (random gradients, after one
    step's moments) and on sizes 1 and 1,000,003, against its plain version
    at 1e-6; times summed over the six leaves; ``torch.optim.Adam(
    fused=True)``'s step on the same leaves as the library yardstick."""
    gen = torch.Generator().manual_seed(13)
    leaves = [t.detach() for t in
              [prog.params["layers"][i][k] for i in range(len(prog.params["layers"]))
               for k in sorted(prog.params["layers"][i])]]
    leaves += [torch.randn(1, generator=gen).to(device),
               torch.randn(1_000_003, generator=gen).to(device)]
    lr_t = bias_corrected_lr(0.01, 0.9, 0.999, 3)
    err = 0.0
    sets = []
    for p in leaves:
        g = torch.randn(p.shape, generator=gen).to(device)
        m = 0.1 * torch.randn(p.shape, generator=gen).to(device)
        v = 0.01 * torch.rand(p.shape, generator=gen).to(device)
        sets.append((p.contiguous(), g, m, v))
        for wd in (0.0, 0.01):
            out = fused_adam(p.contiguous(), g, m, v, lr_t, weight_decay=wd)
            ref = fused_adam_ref(p, g, m, v, lr_t, 0.9, 0.999, 1e-8, wd)
            for a, r in zip(out, ref):
                err = max(err, check_close(f"fused_adam {tuple(p.shape)}", a, r,
                                           ADAM_TOL))
    print(f"[kernel] fused_adam: max_abs_err={err:.3g} over "
          f"{[tuple(p.shape) for p in leaves]}")
    gcn = sets[:-2]
    lib_params = [p.clone().requires_grad_(True) for p, *_ in gcn]
    for lp, (_, g, _, _) in zip(lib_params, gcn):
        lp.grad = g.clone()
    lib = torch.optim.Adam(lib_params, lr=0.01, betas=(0.9, 0.999), eps=1e-8,
                           fused=device.type == "cuda")
    row = {"kernel": "fused_adam", "leaves": [tuple(p.shape) for p, *_ in gcn],
           "params": int(sum(p.numel() for p, *_ in gcn))}
    row.update(timings({
        "": lambda: [fused_adam(p, g, m, v, lr_t) for p, g, m, v in gcn],
        "plain_": lambda: [fused_adam_ref(p, g, m, v, lr_t, 0.9, 0.999, 1e-8, 0.0)
                           for p, g, m, v in gcn],
        "library_": lib.step}, device, reps,
        expect={"": {"fused_adam": len(gcn)}, "plain_": {}, "library_": {}}))
    nbytes = 28 * row["params"]
    row.update({"bytes": nbytes, "nnz_bytes": nbytes, "flop": 15.0 * row["params"]})
    row["bound_ms"], row["bound_by"] = _bound(nbytes, row["flop"])
    row["nnz_bound_ms"] = row["bound_ms"]
    print("[kernel] " + json.dumps(row))
    return row, err


def classify(name: str) -> str:
    """A profiler event's kernel, by its (demangled) name."""
    m = re.search(r"bsr_kernel<\s*\d+,\s*\d+,\s*(\w+),\s*(\w+),\s*(\w+),\s*(\w+)\s*>", name)
    if m:
        masked, *epilogue = (v == "true" for v in m.groups())
        if masked:
            return "bsr_spmm_masked"
        return "bsr_spmm_fused_epilogue" if any(epilogue) else "bsr_spmm"
    if "fused_adam_kernel" in name:
        return "fused_adam"
    low = name.lower()
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other (elementwise, reductions)"


def epoch_profile(prog, device, epoch_s: float, want: dict) -> dict:
    """One more epoch under the profiler (CUDA activity, after a warmup
    epoch): device ms and launches by kernel, busy total, and the idle
    share of the median epoch time. ``complete`` is False where none of
    ``PROFILE_TRIES`` windows held exactly ``want``'s launches of the
    port's kernels (or off the card)."""
    if device.type != "cuda":
        return {"complete": False}
    sync(device)
    prof, windows = profiled(prog.train_epoch, device, want)
    if prof is None:
        return {"complete": False, "windows": windows}
    by, launched = defaultdict(float), defaultdict(int)
    for name, us, n in device_events(prof):
        by[classify(name)] += us / 1e3
        launched[classify(name)] += n
    busy = sum(by.values())
    return {"complete": True, "windows": windows, "device_ms": dict(by),
            "launches": dict(launched),
            "busy_ms": busy, "idle_share": 1.0 - busy / (epoch_s * 1e3)}


def leaf_diffs(got: dict, want: dict) -> dict:
    """Per parameter leaf (or gradient leaf): the norm of got - want over
    the norm of want."""
    return {f"layer{i}.{k}": float((a[k] - b[k]).norm() / (b[k].norm() or 1.0))
            for i, (a, b) in enumerate(zip(got["layers"], want["layers"]))
            for k in sorted(b)}


def mask_flips(prog, params) -> dict:
    """Layer 0's ReLU mask from the fused kernel against its plain version
    on one u = X·W: how many of its elements differ, and the largest
    |pre-activation| among them. Where a pre-activation lies within
    rounding of 0 the two programs' masks, and so their gradients, part."""
    op = prog.plan.graph_op.fwd_operand
    layer = params["layers"][0]
    u = kops._fit_rows(prog.x @ layer["w"], op.n_cols_padded)
    args = (op.block_rows, op.block_cols, op.blocks, u, op.n_rows_padded)
    _, mask = bsr_spmm_fused_epilogue(*args, bias=layer["b"], activation="relu")
    pre, _ = bsr_spmm_fused_ref(*args, bias=layer["b"])
    differ = mask != (pre > 0).float()
    return {"elements": int(mask.numel()), "differ": int(differ.sum()),
            "max_abs_pre": float(pre[differ].abs().max()) if differ.any() else 0.0}


def train_path(name, gnn, device, epochs: int, expected: tuple) -> dict:
    """One training path: the ``cuda`` program (fused Adam) and the
    ``torch`` program (plain versions, plain Adam) from the same weights,
    ``epochs`` epochs each; counts zeroed just before the cuda run and read
    after every epoch."""
    t0 = time.perf_counter()
    prog = gnn.compile(engine="cuda", device=device, fused_optimizer=True)
    sync(device)
    build_s = time.perf_counter() - t0
    weights = {"layers": [{k: v.detach().cpu().numpy() for k, v in layer.items()}
                          for layer in prog.params["layers"]]}
    t0 = time.perf_counter()
    ref = gnn.compile(engine="torch", device=device, fused_optimizer=False,
                      params=weights)
    sync(device)
    ref_build_s = time.perf_counter() - t0
    print(f"[{name}] plan (operands built in {build_s:.1f}s + {ref_build_s:.1f}s "
          f"on the host and copied):\n{prog.describe_plan()}")
    on_card = device.type == "cuda"
    # expected: (fused, masked, bsr_spmm, adam) launches per epoch on the
    # card; CPU tensors run the plain versions and launch nothing
    want = dict(zip(("bsr_spmm_fused_epilogue", "bsr_spmm_masked", "bsr_spmm",
                     "fused_adam"), expected if on_card else (0, 0, 0, 0)))

    def grad_check(when: str, params) -> dict:
        """Both programs' gradients at the same parameters, leaf by leaf:
        Adam normalises a gradient's scale away, so the losses alone would
        pass a backward that is off by a constant factor."""
        grads = [value_and_grad(p.model.loss_fn, params, p.x, p.labels,
                                p.train_mask)[1] for p in (prog, ref)]
        out = {"grads": leaf_diffs(*grads), "layer0_mask_flips": mask_flips(prog, params)}
        print(f"[{name}] gradients {when}: {json.dumps(out)}")
        if not max(out["grads"].values()) <= GRAD_RTOL:
            raise AssertionError(f"[{name}] gradients {when} differ: {out}")
        return out

    grad_start = grad_check("at the first step", prog.params)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    losses, times = [], []
    zero_counts()
    for epoch in range(epochs):
        before = counts()
        t0 = time.perf_counter()
        losses.append(prog.train_epoch()["loss"])  # float(): synchronised
        times.append(time.perf_counter() - t0)
        got = {k: v - before[k] for k, v in counts().items()}
        if got != want:
            raise AssertionError(f"[{name}] epoch {epoch + 1} launched {got}, "
                                 f"expected {want}")
    launched = counts()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    # the trained parameters: bias terms no longer zero
    grad_end = grad_check(f"after {epochs} epochs", prog.params)
    ref_losses, ref_times = [], []
    for _ in range(epochs):
        t0 = time.perf_counter()
        ref_losses.append(ref.train_epoch()["loss"])
        ref_times.append(time.perf_counter() - t0)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    if not (np.isfinite(losses).all() and max(rel) <= 1e-3):
        raise AssertionError(f"[{name}] losses {losses} vs reference {ref_losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[{name}] loss did not fall: {losses}")
    param_diff = leaf_diffs(prog.params, ref.params)
    print(f"[{name}] parameters after {epochs} epochs: {json.dumps(param_diff)}")
    if not max(param_diff.values()) <= PARAM_RTOL:
        raise AssertionError(f"[{name}] parameters after {epochs} epochs "
                             f"differ: {param_diff}")
    epoch_s = float(np.median(times))
    out = {"losses": losses, "ref_losses": ref_losses, "max_rel_diff": max(rel),
           "epoch_ms_median": epoch_s * 1e3, "ref_epoch_ms_median":
           float(np.median(ref_times)) * 1e3, "epoch_ms": [t * 1e3 for t in times],
           "launches": launched, "per_epoch": want, "build_s": build_s,
           "ref_build_s": ref_build_s, "operand_bytes": prog.plan.graph_op.fwd_bytes,
           "peak_mem_bytes": peak, "accuracy": prog.accuracy(),
           "grad_start": grad_start, "grad_end": grad_end,
           "param_rel_diff": param_diff}
    out["profile"] = epoch_profile(prog, device, epoch_s, want)
    print(f"[{name}] " + json.dumps({k: v for k, v in out.items()
                                     if k not in ("epoch_ms",)}))
    return {"summary": out, "prog": prog, "ref": ref}


def pair_unequal_paddings(prog, device) -> float:
    """The fused pair's forward and backward on the quickstart's A and Aᵀ,
    whose paddings differ. The forward against the ``torch`` pair; the
    backward against Aᵀ·(mask ⊙ dY) and Σ mask ⊙ dY composed from plain
    ops with the kernel's own mask (y > 0), so a sign that rounds the other
    way within 1e-7 of 0 cannot fail the check."""
    fwd, bwd = prog.plan.graph_op.fwd_operand, prog.plan.graph_op.bwd_operand
    print(f"[quickstart] A padded {fwd.n_rows_padded} x {fwd.n_cols_padded}, "
          f"Aᵀ padded {bwd.n_rows_padded} x {bwd.n_cols_padded}")
    err = 0.0
    gen = torch.Generator().manual_seed(17)
    t_in = -(-fwd.n_rows_padded // bwd.bc) * bwd.bc
    for f, act in ((32, "relu"), (70, "none")):
        u = torch.randn((fwd.n_cols, f), generator=gen).to(device)
        b = torch.randn(f, generator=gen).to(device)
        dy = torch.randn((fwd.n_rows, f), generator=gen).to(device)
        ut, bt = u.clone().requires_grad_(True), b.clone().requires_grad_(True)
        y = kops.build_fused_epilogue(fwd, bwd, "cuda")(ut, bias=bt, activation=act)
        y.backward(dy)
        with torch.no_grad():
            y_ref = kops.build_fused_epilogue(fwd, bwd, "torch")(u, bias=b,
                                                                activation=act)
        dz = dy * (y > 0).float() if act == "relu" else dy
        du = bsr_spmm_ref(bwd.block_rows, bwd.block_cols, bwd.blocks,
                          kops._fit_rows(dz.detach(), t_in), bwd.n_rows_padded)
        du = kops._fit_rows(du, fwd.n_cols_padded)[: fwd.n_cols]
        for label, a, r in (("y", y.detach(), y_ref), ("du", ut.grad, du),
                            ("dbias", bt.grad, dz.detach().sum(0))):
            err = max(err, check_close(f"fused pair {act} F={f} {label}", a, r))
    print(f"[quickstart] fused pair, unequal paddings: max_abs_err={err:.3g}")
    return err


def feature_operand_checks(qds, prog, device) -> float:
    """``bsr_spmm`` on the quickstart's Alg-1 sparse layer 0 against its
    plain version, at the width the path gives it: X·W on BSR(X) and
    Xᵀ·dU on BSR(Xᵀ), built as the lowering builds them. The dense operand
    is scaled so that each output has unit variance: at N(0, 1) the
    outputs of these ~440- and ~990-term rows reach ~150, and fp32's
    rounding with them."""
    br, f = prog.plan.layers[0].layout.br, prog.plan.layers[0].d_out
    x_csr = csr_from_dense(qds.features)
    gen = torch.Generator().manual_seed(19)
    err = 0.0
    for label, csr in (("X", x_csr), ("Xᵀ", x_csr.transpose())):
        op = get_backend("cuda").build_spmm_operand(csr, br=br, device=device)
        w = torch.randn((op.n_cols_padded, f), generator=gen).to(device)
        w *= (csr.n_rows / csr.nnz) ** 0.5
        err = max(err, check_spmm(
            f"quickstart {label} [{op.n_rows_padded}x{op.n_cols_padded}] F={f}",
            op.block_rows, op.block_cols, op.blocks, w, op.n_rows_padded, device))
    return err


def sum_rows(rows: list) -> dict:
    """Timed or bounded calls summed: times, bounds, bytes and operations;
    ``ms_by`` and ``bound_by`` of the sum."""
    keys = ("ms", "wall_ms", "plain_ms", "library_ms", "bound_ms",
            "nnz_bound_ms", "bytes", "nnz_bytes", "flop")
    total = {k: sum(r[k] for r in rows) for k in keys}
    total["ms_by"] = "/".join(sorted({r["ms_by"] for r in rows}))
    _, total["bound_by"] = _bound(total["bytes"], total["flop"])
    return total


def kernel_entries(serving_entry, launches_by_path, fk, errs, dims,
                   epoch: dict) -> list:
    """The kernels line: one entry per kernel. ``launches`` sums every
    driven path (``launches_by_path`` splits it). For the three training
    kernels the numbers are one epoch of the main path: ``ms`` the
    kernel's device time in the profiled epoch (``epoch_profile``) where
    its window held every launch, else ``calls_ms`` (``ms_by`` says
    which); ``calls_ms``, ``wall_ms``, ``plain_ms``, ``library_ms``,
    ``bound_ms`` and ``nnz_bound_ms`` each layer's call timed or bounded
    alone in phase 5 at its width and spec, summed. ``bsr_spmm`` keeps its
    serving batch."""
    rows = fk["rows"]
    n = len(dims) - 1
    per_epoch = {
        "bsr_spmm_fused_epilogue": [rows[("fused", dims[l + 1],
                                          "relu" if l < n - 1 else "none")]
                                    for l in range(n)],
        "bsr_spmm_masked": [rows[("masked", dims[1])]] * (n - 1),
        "fused_adam": [rows["adam"]],
    }
    entries = [dict(serving_entry)]
    for name, calls in per_epoch.items():
        total = sum_rows(calls)
        entries.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": 0,
            "max_abs_err": errs[name],
            "ms": epoch["device_ms"][name] if epoch["complete"] else total["ms"],
            "ms_by": ("profiled epoch" if epoch["complete"] else
                      "calls_ms: no profiler window held every launch of an epoch"),
            "calls_ms": total["ms"], "calls_ms_by": total["ms_by"],
            "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": total["bound_by"], "nnz_bound_ms": total["nnz_bound_ms"],
            "library_ms": total["library_ms"], "wall_ms": total["wall_ms"],
            "shape": "one epoch of the main path at full width: ms as ms_by "
                     "says; the other times and the bounds each layer's call "
                     "alone, summed",
        })
    entries[0]["max_abs_err"] = errs["bsr_spmm"]
    entries[0]["training_aT"] = rows[("spmm", dims[-1])]
    for e in entries:
        by_path = {p: c[e["name"]] for p, c in launches_by_path.items()}
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path
    return entries


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
    total = sum_rows(layers)
    serving_entry = {
        "name": "bsr_spmm", "route": "cuda",
        "source": SOURCES["bsr_spmm"][0], "replaces": SOURCES["bsr_spmm"][1],
        "launches": serve["launches"], "max_abs_err": kern["max_abs_err"],
        "ms": total["ms"], "ms_by": total["ms_by"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"], "bound_by": total["bound_by"],
        "nnz_bound_ms": total["nnz_bound_ms"],
        "library_ms": total["library_ms"],
        "wall_ms": total["wall_ms"],
        "shape": "one largest-bucket serving batch: layers 0-2 summed; wall_ms "
                 "CUDA events",
    }
    del eng, ref

    # phase 4: full-batch training, the main path
    dims = [ds.features.shape[1], *sizes.train_hidden, ds.n_classes]
    n = len(dims) - 1
    gnn = (GNNProgram.load(ds, arch="GCN", aggregation="gcn")
           .initialize_layers(dims, "xavier", seed=0).set_optimizer(*ADAM))
    train = train_path("train", gnn, device, sizes.epochs, (n, n - 1, 1, 2 * n))
    if any(l.feature_path != "dense" for l in train["prog"].plan.layers):
        raise AssertionError("the main path's features are dense")
    # phase 5: the training kernels on the main path's operands
    t0 = time.perf_counter()
    fk = fused_kernel_phase(train["prog"], ds.graph.sym_normalized(), device,
                            reps=3)
    edge = kern["edge"]
    print(f"[kernel] phase 5 took {time.perf_counter() - t0:.1f}s")
    del train["prog"], train["ref"]
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # phase 6: the quickstart at full scale
    qds = generate_dataset(sizes.quick_dataset, scale=sizes.quick_scale, seed=0)
    print(f"[data] {qds.name}: {qds.graph.n_rows} nodes, {qds.graph.nnz} "
          f"nonzeros, {qds.features.shape[1]} features, sparsity "
          f"{qds.feature_sparsity:.4f}")
    qdims = [qds.features.shape[1], *sizes.quick_hidden, qds.n_classes]
    qn = len(qdims) - 1
    qgnn = (GNNProgram.load(qds, arch="GCN", aggregation="gcn")
            .initialize_layers(qdims, "xavier", seed=0).set_optimizer(*ADAM))
    quick = train_path("quickstart", qgnn, device, sizes.epochs,
                       (qn, qn - 1, 3, 2 * qn))
    if quick["prog"].plan.layers[0].primitive != "cuda.feature_matmul_sparse":
        raise AssertionError("the quickstart's layer 0 must bind "
                             "cuda.feature_matmul_sparse")
    pair_err = pair_unequal_paddings(quick["prog"], device)
    feature_err = feature_operand_checks(qds, quick["prog"], device)

    errs = {"bsr_spmm": max(kern["max_abs_err"], fk["err"]["spmm"], pair_err,
                            feature_err),
            "bsr_spmm_fused_epilogue": max(fk["err"]["fused"], edge["fused"], pair_err),
            "bsr_spmm_masked": max(fk["err"]["masked"], edge["masked"], pair_err),
            "fused_adam": fk["err"]["adam"]}
    serving_counts = {k: 0 for k in KERNELS}
    serving_counts["bsr_spmm"] = serve["launches"]
    by_path = {"serving": serving_counts,
               "train": train["summary"]["launches"],
               "quickstart": quick["summary"]["launches"]}
    entries = kernel_entries(serving_entry, by_path, fk, errs, dims,
                             train["summary"]["profile"])
    return {"kernels": entries, "layers": layers, "serve": serve,
            "sample_s": kern["sample_s"], "train": train["summary"],
            "quickstart": quick["summary"],
            "kernel_rows": {str(k): v for k, v in fk["rows"].items()}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}")
    t0 = time.perf_counter()
    built = build.build(LIBRARIES)
    print(f"[build] nvcc sm_90a, in parallel, {time.perf_counter() - t0:.1f}s: "
          + ", ".join(f"{k} {v:.1f}s" for k, v in built.items()))
    for name in LIBRARIES:
        log = build.library_path(name).with_suffix(".so.log")
        if log.exists():
            text = log.read_text()
            regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", text)})
            spills = sum(int(a) + int(b) for a, b in re.findall(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", text))
            print(f"[build] ptxas {name}: registers {regs[0]}-{regs[-1]}, "
                  f"spilled bytes {spills}")

    t_all = time.perf_counter()
    result = run(Sizes(), device)
    serve = result["serve"]
    print(f"[serve] {serve['requests']} requests, {serve['req_per_s']:.2f} req/s, "
          f"p50 {serve['p50_ms']:.2f} ms, p99 {serve['p99_ms']:.2f} ms, "
          f"warmup {serve['warmup_s']:.2f}s, sample one 256-seed batch "
          f"{result['sample_s']:.3f}s on {card}")
    for path in ("train", "quickstart"):
        r = result[path]
        print(f"[{path}] {len(r['losses'])} epochs, median epoch "
              f"{r['epoch_ms_median']:.1f} ms (torch reference "
              f"{r['ref_epoch_ms_median']:.1f} ms), loss {r['losses'][0]:.4f} -> "
              f"{r['losses'][-1]:.4f}, max rel diff {r['max_rel_diff']:.2e}, "
              f"peak {r['peak_mem_bytes'] / 2**30:.2f} GiB on {card}")
    print(f"[done] phases 2-6 in {time.perf_counter() - t_all:.1f}s")
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
