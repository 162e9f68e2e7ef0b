#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure raises, so the exit code is not 0 and no result line
is printed:

1. Card and build: the card's name and power limit (nvidia-smi), then the
   six CUDA libraries built in parallel from
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a (build seconds and
   the ptxas report).
2. ``bsr_spmm`` against its plain PyTorch version on the serving
   configuration's real layer-0/1/2 bucket operands, through each
   operand's nonzero columns built as the serving path builds them (build
   ms and host syncs beside the kernel's ms), a repeat bitwise equal; the
   three SpMM kernels on edge cases (padding blocks, a block-row without
   blocks, F=1/33/40/70/256, rows misaligned for float4, a hub row cut
   into segments) and with inf/NaN in X rows that no nonzero multiplies
   (the sparse product, finite; the plain versions give NaN).
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
   both programs' gradients at the first step and after the last epoch
   within 1e-3 a leaf (norm of the difference over the leaf's), with
   every ReLU decision the two part on within 1e-5 of 0 and taken from
   the cuda program; the parameters after the last epoch within 5e-2,
   finite losses within 1e-3 relative at every epoch and falling, exactly fused 3 /
   masked 2 / bsr_spmm 1 / Adam 6 launches per epoch; the median epoch
   time, device ms per kernel and for the matmuls from a profiled epoch
   that recorded every launch, the idle share, peak memory, the
   operands' host build time and the build time and size of their
   nonzero columns (the fused-epilogue and masked kernels' operand).
5. The fused-epilogue, masked and Adam kernels against their plain versions
   on the main path's real operands (A and Aᵀ of the full graph, the
   fused and masked kernels through their nonzero columns): five
   epilogue specs at F=256 and F=40, a repeat launch bitwise equal, masks
   compared where |pre-activation| > 1e-5; the masked kernel on Aᵀ with a
   real ReLU mask; ``bsr_spmm`` on Aᵀ at F=40 (and the non-finite case
   there); edge cases (phase 2's: ragged F, rows misaligned for float4, a
   hub row longer than a CTA's split); Adam
   on the six GCN leaves and on sizes 1 and 1,000,003 (1e-6). Time per call from CUDA
   events (these full-graph calls keep the card busy far longer than their
   launches take; Adam's short launches from ``torch.profiler``), plain
   ms, library ms
   (``torch.sparse.mm`` + the epilogue's torch ops; ``torch.optim.Adam(
   fused=True)``), the least time the card could take (bytes over 3.35 TB/s
   or fp32 operations over 67 TFLOP/s, whichever is larger; ``bound_ms``
   counted over the nonzeros alone, the bound the three SpMM kernels
   answer to, and ``layout_bound_ms`` over the BSR layout's blocks), and
   the hub row's cost against a mean row's and the whole call's, on A
   (fused) and Aᵀ (masked), each over the same clock as the call.
6. The quickstart at full scale: the corafull analog (19,793 nodes, 8,710
   features, 95% zeros), GCN [8710, 32, 70], layer 0 on
   ``cuda.feature_matmul_sparse``; 10 epochs of cuda against torch with the
   same checks and exactly 2 / 1 / 3 / 4 launches per epoch (and a second
   pass for each ``bsr_spmm`` call on a split operand); the fused pair's
   forward and backward on A and Aᵀ with unequal paddings (19,800 rows,
   19,840 columns), cuda against torch; ``bsr_spmm`` on all three of its
   operands there, BSR(X) and BSR(Xᵀ) at F=32 and Aᵀ at F=70, as in
   phase 5 (checked, a repeat bitwise equal, timed beside
   ``torch.sparse.mm``, bounded), the non-finite case on BSR(X), and the
   hub segment's cost on BSR(Xᵀ).

7. GAT training, the attention path's main run: the arxiv analog, GAT
   [128, 750, 750, 40] with 3 heads (DGL's ogbn-arxiv GAT widths: 250 per
   head, the last layer's 13 projected to 40) and that example's Adam (lr
   0.002), ``compile(engine="cuda", fused_optimizer=True)`` against the
   ``torch`` program from the same weights, 10 epochs with phase 4's
   checks (at 5 the loss has not yet come back below its first value)
   and exactly 3 / 3 / 3 attention launches (forward, row pass, column
   pass; the forward and the row pass over A's nonzero columns, the
   column pass over Aᵀ's, both built when the layer is bound, each with
   its split rows' second pass once a call) and 15 Adam launches per
   epoch, no BSR SpMM; every layer bound to ``cuda.spmm_attention``.
8. The three attention kernels against their plain versions on phase 7's
   real A and Aᵀ with the layers' real inputs (z, a_src, a_dst and the
   loss's cotangent dy, captured in one training step), each through its
   operand's nonzero columns: Dh 250, 250 and 13 at 3 heads, out / m / l
   / dc / dzv / dd within 1e-4, a repeat launch bitwise equal; edge cases
   (a block-row without blocks, a padding tail, a row whose max lies in
   its second block, H·Dh not a multiple of 32, and, with SPLIT_COLUMNS
   lowered, a row split into segments whose max lies in a later one);
   per call CUDA-event ms, plain ms, the bounds (``attention_bound``: the
   nonzeros', with the layout's beside it) and the segment path's ms
   (``segment_softmax_aggregate`` forward and backward: gather,
   ``scatter_reduce``, ``index_add_``; a composition of library calls, no
   single one computes edge-softmax attention, so ``library_ms`` is
   null); the hub row's cost against a mean row's, each pass's after
   the split (its segments and second-pass launches beside it).
9. GT on the quickstart at full scale: GT [8710, 32, 70], 4 heads, layer 0
   on ``cuda.feature_matmul_sparse``; 10 epochs cuda against torch with
   the same checks and exactly 2 / 2 / 2 attention, 2 ``bsr_spmm`` and 12
   Adam launches per epoch; the attention pair's forward and backward on
   corafull's unequal paddings, cuda against torch; one epoch of the
   program compiled with ``fuse_attention=False`` (the segment path on the
   card), its loss within 2e-4 of the fused first epoch's.
10. LM serving at full width: llama3.2-1b (16 layers, d_model 2048, 32
    heads with 8 KV heads of 64, vocab 128,256; 1,235,814,400 parameters,
    random from a seeded generator on the card) through
    ``ServingEngine(batch_slots=4, max_seq=1056)`` on the ``cuda`` model:
    8 requests of 128-1,024 prompt tokens (seed 0, the longest 1,024), 32
    new tokens each, two waves, after one untimed warmup run of the same
    requests. Exactly 16 ``flash_attention`` launches a wave, none in
    decode. The ``torch`` model (the plain version) fed the same inputs
    call by call: last-position logits within 1e-4 at every step, greedy
    tokens equal wherever the cuda program's top-2 margin exceeds 1e-3.
    Prefill ms a wave, decode ms a step, tokens/s, the run's peak memory,
    and device ms by kernel class and idle share of one prefill and one
    decode step (profiler).
11. The flash kernel against its plain version on each layer's real q, k,
    v from phase 10's 1,024-token prefill (B 4, H 32, Hkv 8, T 1024, D
    64), float32 within 2e-5 and bfloat16 copies within 5e-2, a repeat
    bitwise equal; edge cases (Tq != Tk causal and not, T = 1, 33, 1000, D
    = 8 and 128, K padding inside a tile, Hkv == H; every D and KV groups
    of 1-8 heads on ragged tiles, strided and misaligned views bitwise
    equal to the aligned call). Per call at layer 0's inputs: the
    kernel's, the plain version's and ``scaled_dot_product_attention``'s
    CUDA-event ms (on K/V repeated to 32 heads, and with
    ``enable_gqa=True``), the kernel's over SDPA's (``vs_library``), and
    the bound (fp32 operations over 67 TFLOP/s against bytes over 3.35
    TB/s).

The card's clocks, temperature and power draw are printed before and
after the phases. The last lines are the card's name and power limit,
one JSON object with every kernel's numbers, and ``{"ok": true,
"device": {...}}``. Details go
to ``chiprun_out/chip_smoke.json``. Needs one card and no network.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
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
from repro_torch.kernels import bsr_spmm as bsr_spmm_module  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.bsr_attention import (  # noqa: E402
    bsr_attention_bwd_col,
    bsr_attention_bwd_row,
    bsr_attention_fwd,
)
from repro_torch.kernels.bsr_spmm import (  # noqa: E402
    bsr_spmm,
    bsr_spmm_fused_epilogue,
    bsr_spmm_masked,
    nonzero_columns,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS,
    flash_attention,
)
from repro_torch.kernels.fused_adam import fused_adam  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    bsr_attention_bwd_col_ref,
    bsr_attention_bwd_row_ref,
    bsr_attention_fwd_ref,
    bsr_spmm_fused_ref,
    bsr_spmm_masked_ref,
    bsr_spmm_ref,
    flash_attention_ref,
    fused_adam_ref,
)
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.training.optimizer import bias_corrected_lr, tree_leaves  # noqa: E402
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
#: program's parameters after the last epoch. Where a pre-activation lies
#: within rounding of 0 the programs' ReLU masks may part: the kernels and
#: the plain versions sum in other orders, so such a sum may take either
#: sign in the two.
#: The analog's labels are random, so its gradients nearly cancel: one
#: flip moved layer 0's gradient by 6e-5 (ogbn-arxiv, the first step) and
#: by 1.9e-3 (the quickstart after 10 epochs, |pre| ~1e-7; H100 runs). So
#: the gradient check holds every decision the two part on to |pre| <=
#: MASK_MARGIN and gives the torch program the cuda program's there
#: (``decided_grads``). Adam, which normalises gradients, carries such gaps
#: into the parameters (0.9-1e-2 after 10 epochs; the quickstart's 4e-7)
GRAD_RTOL = 1e-3
PARAM_RTOL = 5e-2
ADAM = ("adam", 0.01, 0.9, 0.999)
#: DGL's ogbn-arxiv GAT example's optimizer (its widths are phase 7's). At
#: lr 0.01 Adam's first steps move every weight of the 750-wide layers by
#: about 0.01 and the loss leaps from 3.70 to 25-35 (an H100 run): in that
#: chaos the two programs' 1e-7 differences grow past 1e-3 by epoch 5
GAT_ADAM = ("adam", 0.002, 0.9, 0.999)

#: every kernel wrapper of the port, by the name the kernels line uses
KERNELS = {"bsr_spmm": bsr_spmm,
           "bsr_spmm_fused_epilogue": bsr_spmm_fused_epilogue,
           "bsr_spmm_masked": bsr_spmm_masked,
           "fused_adam": fused_adam,
           "bsr_attention_fwd": bsr_attention_fwd,
           "bsr_attention_bwd_row": bsr_attention_bwd_row,
           "bsr_attention_bwd_col": bsr_attention_bwd_col,
           "flash_attention": flash_attention}
#: one call's launches of each timed SpMM call (``timings``' ``expect``):
#: the kernel, its plain version, the library yardstick
SPMM_EXPECT = {"": {"bsr_spmm": 1}, "plain_": {}, "library_": {}}
#: the attention kernels and their plain versions, by pass
ATTENTION = {"fwd": ("bsr_attention_fwd", bsr_attention_fwd, bsr_attention_fwd_ref),
             "row": ("bsr_attention_bwd_row", bsr_attention_bwd_row,
                     bsr_attention_bwd_row_ref),
             "col": ("bsr_attention_bwd_col", bsr_attention_bwd_col,
                     bsr_attention_bwd_col_ref)}
#: the CUDA sources (kernels/csrc/<name>.cu) the kernels are built from
LIBRARIES = ["bsr_spmm", "bsr_spmm_fused", "bsr_spmm_masked", "fused_adam",
             "bsr_attention", "flash_attention"]
SOURCES = {
    "bsr_spmm": ("src/repro_torch/kernels/csrc/bsr_spmm.cu",
                 "src/repro/kernels/bsr_spmm.py:105"),
    "bsr_spmm_fused_epilogue": ("src/repro_torch/kernels/csrc/bsr_spmm_fused.cu",
                                "src/repro/kernels/bsr_spmm.py:245"),
    "bsr_spmm_masked": ("src/repro_torch/kernels/csrc/bsr_spmm_masked.cu",
                        "src/repro/kernels/bsr_spmm.py:312"),
    "fused_adam": ("src/repro_torch/kernels/csrc/fused_adam.cu",
                   "src/repro/kernels/fused_adam.py:86"),
    "bsr_attention_fwd": ("src/repro_torch/kernels/csrc/bsr_attention.cu",
                          "src/repro/kernels/bsr_attention.py:133"),
    "bsr_attention_bwd_row": ("src/repro_torch/kernels/csrc/bsr_attention.cu",
                              "src/repro/kernels/bsr_attention.py:190"),
    "bsr_attention_bwd_col": ("src/repro_torch/kernels/csrc/bsr_attention.cu",
                              "src/repro/kernels/bsr_attention.py:267"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:106"),
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
    # attention: GAT [F, gat_hidden..., C] on `dataset`, GT [F,
    # quick_hidden..., C] on `quick_dataset`
    gat_hidden: tuple = (750, 750)
    gat_heads: int = 3
    gt_heads: int = 4
    # LM serving: `lm_arch` (its reduced() variant where `lm_reduced`),
    # `lm_requests` prompts of lm_prompts[0]..lm_prompts[1] tokens (the
    # longest set to lm_prompts[1]), `lm_new_tokens` each, `lm_slots` slots
    lm_arch: str = "llama3.2-1b"
    lm_reduced: bool = False
    lm_requests: int = 8
    lm_prompts: tuple = (128, 1024)
    lm_new_tokens: int = 32
    lm_slots: int = 4


def zero_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def card_line(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


#: the card's clocks, temperature and power, read before and after the
#: phases: a card that runs below its clocks slows every timing of a run
#: alike, library calls included
CLOCKS = "clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu,power.draw"


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
    launches of each kernel ``k`` (``launch_key``'s names)? In the
    full-width run, windows over a few back-to-back launches of the long
    full-graph SpMM kernels recorded only some of them (three 53 ms
    launches read as 17.7 ms each), and a window once recorded nothing,
    though each mode recorded every launch when run alone on the card."""
    got = defaultdict(int)
    busy = 0.0
    for name, us, n in device_events(prof):
        got[launch_key(name)] += n
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
    operations on the nonzeros in both. ``bound_ms`` (``bytes``), the
    bound the three SpMM kernels answer to, since they read only nonzero
    columns: each nonzero's value and column index and a row pointer per
    row read once, the X rows the nonzeros reference, Y written once.
    ``layout_bound_ms`` (``layout_bytes``), the BSR layout's: the blocks
    that hold a nonzero, whole, their indices and the X rows of their
    block-columns (zero padding and empty-row blocks carry nothing), Y
    once. ``nnz_bound_ms`` is ``bound_ms``, under the key the attention
    kernels' any-layout bound has. ``dense_flop`` is the work on every
    stored block."""
    nb, br, bc = blocks.shape
    nz = blocks.ne(0)
    used = nz.reshape(nb, -1).any(dim=1)
    n_used = int(used.sum())
    x_rows = int(torch.unique(cols[used]).numel()) * bc
    layout_bytes = 4 * (2 * n_used + n_used * br * bc + x_rows * f + n_rows_padded * f)
    b_idx, _, j = torch.nonzero(nz, as_tuple=True)
    nnz = int(b_idx.numel())
    nnz_x_rows = int(torch.unique(cols[b_idx].long() * bc + j).numel())
    nbytes = 4 * (2 * nnz + n_rows_padded + 1 + nnz_x_rows * f + n_rows_padded * f)
    out = {"blocks_used": n_used, "nnz": nnz, "x_rows": x_rows,
           "nnz_x_rows": nnz_x_rows, "bytes": nbytes, "layout_bytes": layout_bytes,
           "flop": 2.0 * nnz * f, "dense_flop": 2.0 * nb * br * bc * f}
    return _spmm_bounds(out)


def _spmm_bounds(out: dict) -> dict:
    """``bound_ms``/``bound_by``, ``nnz_bound_ms`` and ``layout_bound_ms``
    of a ``spmm_bound`` count (``nnz_bytes`` the same count as ``bytes``,
    as ``sum_rows`` sums it over every sparse row)."""
    out["nnz_bytes"] = out["bytes"]
    out["bound_ms"], out["bound_by"] = _bound(out["bytes"], out["flop"])
    out["nnz_bound_ms"] = out["bound_ms"]
    out["layout_bound_ms"], _ = _bound(out["layout_bytes"], out["flop"])
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
    """The fused kernel (through the operand's nonzero columns) against its
    plain version on one operand and spec: y everywhere, the mask where
    |pre-activation| > MASK_MARGIN, and a repeat launch bitwise equal."""
    has_self, has_bias, act = spec
    args = (op.block_rows, op.block_cols, op.blocks, x, op.n_rows_padded,
            s if has_self else None, b if has_bias else None,
            alpha if has_self else None)
    nzc = op.nonzero_columns()
    y, mask = bsr_spmm_fused_epilogue(*args, act, nzc=nzc)
    y2, mask2 = bsr_spmm_fused_epilogue(*args, act, nzc=nzc)
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
    nzc = op.nonzero_columns()
    y = bsr_spmm_masked(*args, nzc=nzc)
    y2 = bsr_spmm_masked(*args, nzc=nzc)
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


def check_spmm(name, rows, cols, blocks, x, n_rows_padded, device, nzc) -> float:
    """The kernel (through the operand's nonzero columns ``nzc``) against
    the plain version on the same device tensors, and a repeat launch
    bitwise equal."""
    y = bsr_spmm(rows, cols, blocks, x, n_rows_padded, nzc=nzc)
    y2 = bsr_spmm(rows, cols, blocks, x, n_rows_padded, nzc=nzc)
    y_ref = bsr_spmm_ref(rows, cols, blocks, x, n_rows_padded)
    sync(device)
    err = check_close(f"bsr_spmm {name}", y, y_ref)
    if device.type == "cuda" and not torch.equal(y, y2):
        raise AssertionError(f"bsr_spmm {name}: a repeat launch is not bitwise equal")
    print(f"[kernel] bsr_spmm {name}: max_abs_err={err:.3g}")
    return err


def unread_rows(op, limit: int = 64) -> torch.Tensor:
    """Up to ``limit`` X rows inside a stored block's columns that no
    nonzero multiplies: the rows where the kernels and the whole-block
    plain versions part under a non-finite X."""
    covered = torch.zeros(op.n_cols_padded, dtype=torch.bool, device=op.blocks.device)
    span = torch.arange(op.bc, device=covered.device)
    covered[(op.block_cols.long()[:, None] * op.bc + span).flatten()] = True
    covered[op.nonzero_columns().x_rows.long()] = False
    return covered.nonzero().flatten()[:limit]


def reading_rows(op, row: int) -> torch.Tensor:
    """Bool [n_rows_padded]: the output rows whose block-row holds a
    nonzero in X row ``row``'s column. There the kernels (over the nonzero
    columns) and the plain versions (over whole blocks) both read that X
    row; elsewhere only the plain versions do."""
    bc = op.bc
    held = ((op.block_cols.long() == row // bc)
            & (op.blocks[:, :, row % bc] != 0).any(dim=1))
    out = torch.zeros(op.n_rows_padded // op.br, dtype=torch.bool,
                      device=op.blocks.device)
    out[op.block_rows.long()[held]] = True
    return out.repeat_interleave(op.br)


def check_nonfinite(name, op, x, device) -> float:
    """The three SpMM kernels with inf, -inf and NaN in X rows that no
    nonzero of the operand multiplies (``unread_rows``): each gives the
    sparse product (the JAX package's ``gather`` answer), finite and
    within 1e-4 of its plain version on X with those rows zeroed, where
    the plain version on the non-finite X (whole blocks, as the Pallas
    kernel) gives NaN. Then an inf in an X row that a nonzero multiplies,
    in a column that also holds a stored zero (0·inf = NaN): the fused
    kernel's ReLU keeps the NaN of its sum, as ``torch.relu`` and
    ``jnp.maximum`` do, equal (NaN for NaN, inf for inf, within 1e-4
    elsewhere) to the plain version with its ReLU on the rows whose
    block-row reads that X row (``reading_rows``) and to the plain version
    on the finite X on the others, with its mask 0 on the NaNs.
    Returns the largest error (0.0 off the card, where the wrappers run
    the plain versions)."""
    rows = unread_rows(op)
    if rows.numel() == 0:
        raise AssertionError(f"non-finite {name}: no unread X row to poison")
    bad = x.clone()
    bad[rows] = torch.tensor([float("inf"), float("-inf"), float("nan")],
                             device=x.device).repeat(rows.numel())[:rows.numel(), None]
    zeroed = x.clone()
    zeroed[rows] = 0.0
    mask = (torch.arange(x.numel(), device=x.device).reshape(x.shape) % 3 > 0).float()
    b = torch.linspace(-1.0, 1.0, x.shape[1], device=x.device)
    a = (op.block_rows, op.block_cols, op.blocks)
    n, nzc = op.n_rows_padded, op.nonzero_columns()
    got = {"bsr_spmm": (bsr_spmm(*a, bad, n, nzc=nzc), bsr_spmm_ref(*a, zeroed, n)),
           "bsr_spmm_fused_epilogue": (
               bsr_spmm_fused_epilogue(*a, bad, n, bias=b, activation="relu", nzc=nzc)[0],
               bsr_spmm_fused_ref(*a, zeroed, n, bias=b, activation="relu")[0]),
           "bsr_spmm_masked": (bsr_spmm_masked(*a, bad, mask, n, nzc=nzc),
                               bsr_spmm_masked_ref(*a, zeroed, mask, n))}
    plain = bsr_spmm_ref(*a, bad, n)
    sync(device)
    if bool(torch.isfinite(plain).all()):
        raise AssertionError(f"non-finite {name}: the plain version stayed finite")
    read = int(nzc.x_rows[int((nzc.values == 0).any(dim=1).nonzero()[0])])
    hit = x.clone()
    hit[read] = float("inf")
    y, y_mask = bsr_spmm_fused_epilogue(*a, hit, n, bias=b, activation="relu", nzc=nzc)
    plain_hit = bsr_spmm_fused_ref(*a, hit, n, bias=b, activation="relu")[0]
    # off the card the wrapper runs the plain version, whole blocks and all
    elsewhere = (bsr_spmm_fused_ref(*a, x, n, bias=b, activation="relu")[0]
                 if device.type == "cuda" else plain_hit)
    want = torch.where(reading_rows(op, read)[:, None], plain_hit, elsewhere)
    sync(device)
    nan = torch.isnan(want)
    if not bool(nan.any()) or not torch.equal(torch.isnan(y), nan):
        raise AssertionError(f"fused ReLU non-finite {name}: NaN where the "
                             f"plain version keeps one: {int(torch.isnan(y).sum())} "
                             f"against {int(nan.sum())}")
    if not torch.equal(torch.isinf(y), torch.isinf(want)):
        raise AssertionError(f"fused ReLU non-finite {name}: inf where the plain "
                             "version has none, or none where it has one")
    if bool(y_mask[nan].any()):
        raise AssertionError(f"fused ReLU non-finite {name}: mask 1 on a NaN")
    err = check_close(f"fused ReLU non-finite {name}", torch.nan_to_num(y),
                      torch.nan_to_num(want))
    if device.type != "cuda":
        return 0.0
    for kernel, (y, want) in got.items():
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{kernel} non-finite {name}: a non-finite output")
        err = max(err, check_close(f"{kernel} non-finite {name}", y, want))
    print(f"[kernel] non-finite X {name}: {rows.numel()} unread rows poisoned, the "
          f"three kernels finite within {err:.3g} of the plain versions on X with "
          f"those rows zeroed; an inf in read row {read}: the fused ReLU keeps "
          f"the plain version's {int(nan.sum())} NaNs")
    return err


def column_build(rows, cols, blocks, n_rows_padded, device, reps: int = 5) -> dict:
    """``nonzero_columns`` on one operand: its columns and bytes, the
    median build time of ``reps`` builds (synchronised host clock), and,
    on the card, its host syncs, counted by CUDA's sync debug mode."""
    times = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        nzc = nonzero_columns(rows, cols, blocks, n_rows_padded)
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"columns": int(nzc.x_rows.numel()), "nzc_bytes": nzc.nbytes,
           "split_rows": int(nzc.splits.shape[0]), "build_ms": float(np.median(times)),
           "host_syncs": None}
    if device.type == "cuda":
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                nonzero_columns(rows, cols, blocks, n_rows_padded)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out["host_syncs"] = sum("synchroniz" in str(w.message) for w in caught)
    return out, nzc


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` starting one float past a 16-byte
    boundary, so no row is aligned for float4 loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def edge_cases(device) -> dict:
    """The three SpMM kernels on padding blocks and on a block-row with no
    blocks, F = 1, 33, 40, 70, 256 (33 and 70 ragged on the scalar path),
    every epilogue spec; on rows misaligned for float4 (F = 36); on a hub
    row of 8x128 blocks whose ~5,000 nonzero columns the kernels cut into
    segments of SPLIT_COLUMNS (F = 32, 40, 256); and the non-finite case
    (``check_nonfinite``) at F = 33, 40. Max abs error of each kernel."""
    r = np.random.default_rng(7)
    g = csr_from_edges(r.integers(0, 130, 300), r.integers(0, 150, 300), 150,
                       n_cols=130, data=r.standard_normal(300).astype(np.float32))
    bsr = csr_to_bsr(g, br=8, bc=8)
    padded = _pad_bsr(bsr, bsr.n_blocks + 9)
    no_blocks = {k: v[padded["rows"] != 4] for k, v in padded.items()}
    hub_src = np.concatenate([r.integers(0, 16384, 6000), r.integers(0, 16384, 300)])
    hub_dst = np.concatenate([r.integers(0, 8, 6000), r.integers(8, 48, 300)])
    hub = csr_to_bsr(csr_from_edges(hub_src, hub_dst, 48, n_cols=16384,
                                    data=r.standard_normal(6300).astype(np.float32)),
                     br=8, bc=128)
    cases = [("padding blocks", padded, bsr, f, False) for f in (1, 33, 40, 70, 256)]
    cases += [("row without blocks", no_blocks, bsr, f, False) for f in (1, 33, 40, 70, 256)]
    cases += [("misaligned rows", padded, bsr, 36, True)]
    cases += [("hub row", _pad_bsr(hub, hub.n_blocks + 3), hub, f, False)
              for f in (32, 40, 256)]
    err = {"spmm": 0.0, "fused": 0.0, "masked": 0.0}
    for label, arrays, op_bsr, f, shift in cases:
        gen = torch.Generator().manual_seed(f)
        x = torch.randn((op_bsr.padded_cols, f), generator=gen).to(device)
        s = torch.randn((op_bsr.padded_rows, f), generator=gen).to(device)
        b = torch.randn(f, generator=gen).to(device)
        m = (torch.randn((op_bsr.padded_cols, f), generator=gen) > 0).float().to(device)
        if shift:
            x, s, m = misaligned(x), misaligned(s), misaligned(m)
        alpha = torch.full((1,), 0.7, device=device)
        t = on_device(arrays, device)
        op = kops.BSRDevice(t["rows"], t["cols"], t["blocks"], op_bsr.n_rows,
                            op_bsr.n_cols, op_bsr.padded_rows, op_bsr.padded_cols,
                            op_bsr.br, op_bsr.bc)
        err["spmm"] = max(err["spmm"], check_spmm(
            f"{label} F={f}", t["rows"], t["cols"], t["blocks"], x,
            op_bsr.padded_rows, device, op.nonzero_columns()))
        for spec_name, spec in SPECS.items():
            err["fused"] = max(err["fused"], check_fused(
                f"{label} F={f} {spec_name}", op, x, s, b, alpha, spec, device))
        err["masked"] = max(err["masked"], check_masked(
            f"{label} F={f}", op, x, m, device))
        if label == "padding blocks" and f in (33, 40):
            err["nonfinite"] = max(err.get("nonfinite", 0.0), check_nonfinite(
                f"edge case F={f}", op, x, device))
    return err


def kernel_phase(ds, eng, device, reps: int = 20) -> dict:
    """``bsr_spmm`` on one largest-bucket batch's layer operands at the
    widths the main path gives them (u = X·W: hidden, ..., n_classes),
    through each operand's nonzero columns, built as the serving path
    builds them (once per batch and layer, on the device after the copy):
    their build time and host syncs (``column_build``) beside the
    kernel's."""
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
        build, nzc = column_build(t["rows"], t["cols"], t["blocks"], n_out, device)
        err = max(err, check_spmm(f"layer {l} [{n_out}x{n_in}] F={f}",
                                  t["rows"], t["cols"], t["blocks"], x, n_out,
                                  device, nzc))
        csr = blk.csr
        a_lib = csr_tensor(csr, device)
        lib_err = float((torch.sparse.mm(a_lib, x)
                         - bsr_spmm_ref(t["rows"], t["cols"], t["blocks"], x,
                                        n_out)).abs().max())
        if not lib_err <= TOL:
            raise AssertionError(f"library yardstick disagrees: {lib_err}")
        row = {
            "layer": l, "n_rows_padded": n_out, "n_cols_padded": n_in, "F": f,
            "n_blocks": int(t["blocks"].shape[0]), "nnz": int(csr.nnz), **build,
        }
        calls = {
            "": lambda: bsr_spmm(t["rows"], t["cols"], t["blocks"], x, n_out, nzc=nzc),
            "plain_": lambda: bsr_spmm_ref(t["rows"], t["cols"], t["blocks"], x, n_out),
            "library_": lambda: torch.sparse.mm(a_lib, x),
        }
        row.update(timings(calls, device, reps, expect=SPMM_EXPECT))
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
    the host, the copy to the device, the forward pass (each layer's
    nonzero-column build inside it), the logits back.
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
    out["bytes"] += extra + (4 * f * out["nnz_x_rows"] if masked else 0)
    out["layout_bytes"] += extra + (4 * f * out["x_rows"] if masked else 0)
    return _spmm_bounds(out)


def row_cost(op, f, device, reps: int, kernel: str) -> dict:
    """``kernel``'s time (the fused one with bias + ReLU) on a stream
    holding only the block-row with the most nonzero columns (the hub:
    split into segments of SPLIT_COLUMNS, one CTA each, and the ordered
    second pass) against one holding only a row of about the mean count;
    F=f. Timed as the kernel's whole call is, so that the hub's share of
    the call divides like by like: ``bsr_spmm`` by profiler device time
    (``SPMM_EXPECT``), the fused and masked kernels by CUDA events
    (``timings``). Both streams keep every other block-row, empty, so both
    calls also write those rows."""
    per_row = op.nonzero_columns().columns_per_row()
    hub = int(torch.argmax(per_row))
    mean = float(per_row.float().mean())
    typical = int(torch.argmin((per_row.float() - mean).abs()))
    blocks_per_row = torch.bincount(op.block_rows.long(),
                                    minlength=op.n_rows_padded // op.br)
    gen = torch.Generator().manual_seed(5)
    n_in = op.n_cols_padded
    x = torch.randn((n_in, f), generator=gen).to(device)
    m = (torch.randn((n_in, f), generator=gen) > 0).float().to(device)
    b = torch.zeros(f, device=device)
    out = {"kernel": kernel, "F": f, "hub_columns": int(per_row[hub]), "mean_columns": mean,
           "typical_columns": int(per_row[typical]),
           "hub_blocks": int(blocks_per_row[hub]),
           "typical_blocks": int(blocks_per_row[typical])}
    for label, row in (("hub", hub), ("typical", typical)):
        sel = op.block_rows.long() == row
        r_, c_, bl = (op.block_rows[sel].contiguous(), op.block_cols[sel].contiguous(),
                      op.blocks[sel].contiguous())
        nz = nonzero_columns(r_, c_, bl, op.n_rows_padded)
        call = {"bsr_spmm_masked": lambda: bsr_spmm_masked(
                    r_, c_, bl, x, m, op.n_rows_padded, nzc=nz),
                "bsr_spmm_fused_epilogue": lambda: bsr_spmm_fused_epilogue(
                    r_, c_, bl, x, op.n_rows_padded, bias=b, activation="relu", nzc=nz),
                "bsr_spmm": lambda: bsr_spmm(r_, c_, bl, x, op.n_rows_padded,
                                             nzc=nz)}[kernel]
        expect = {"": {kernel: 1}} if kernel == "bsr_spmm" else None
        out.update({f"{label}_{k}": v for k, v in timings(
            {"": call}, device, reps, expect=expect).items()})
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
        nzc = fwd.nonzero_columns()
        for spec_name, act in (("bias+relu", "relu"), ("bias", "none")):
            args = (fwd.block_rows, fwd.block_cols, fwd.blocks, x, fwd.n_rows_padded)

            def library(act=act):
                z = torch.sparse.mm(a_lib, x[: fwd.n_cols]) + b
                return (torch.relu(z), z > 0) if act == "relu" else z

            row = {"kernel": "bsr_spmm_fused_epilogue", "operand": "A", "F": f,
                   "spec": spec_name, "n_blocks": int(fwd.blocks.shape[0]),
                   "nnz": csr_a.nnz}
            row.update(timings({
                "": lambda: bsr_spmm_fused_epilogue(*args, bias=b, activation=act,
                                                    nzc=nzc),
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
                                      u, fwd.n_rows_padded, activation="relu",
                                      nzc=fwd.nonzero_columns())
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
    bwd_nzc = bwd.nonzero_columns()
    row.update(timings({"": lambda: bsr_spmm_masked(*margs, nzc=bwd_nzc),
                        "plain_": lambda: bsr_spmm_masked_ref(*margs),
                        "library_": lambda: torch.sparse.mm(at_lib, (mask * dy)[: bwd.n_cols])},
                       device, reps))
    row.update(fused_bound(bwd, f, False, False, False, masked=True))
    rows[("masked", f)] = row
    print("[kernel] " + json.dumps(row))
    f = dims[-1]
    dy = torch.randn((t_in, f), generator=gen).to(device)
    rows[("spmm", f)], err["spmm"] = spmm_operand_row("A^T", bwd, at_lib, dy, device, reps)
    err["nonfinite"] = check_nonfinite(f"Aᵀ F={f}", bwd, dy, device)
    for key, op, kernel in (("hub", fwd, "bsr_spmm_fused_epilogue"),
                            ("hub_masked", bwd, "bsr_spmm_masked")):
        rows[key] = row_cost(op, dims[1], device, reps, kernel)
        call = (rows[("masked", dims[1])] if kernel == "bsr_spmm_masked"
                else rows[("fused", dims[1], "relu")])
        rows[key]["full_call_ms"] = call["ms"]
        rows[key]["full_call_ms_by"] = call["ms_by"]
        rows[key]["hub_share_of_call"] = rows[key]["hub_ms"] / call["ms"]
        print(f"[kernel] {key} row: " + json.dumps(rows[key]))
    rows["adam"], err["adam"] = adam_checks(prog, device, reps)
    return {"rows": rows, "err": err}


def spmm_operand_row(label, op, lib, x, device, reps: int):
    """``bsr_spmm`` on one full-batch operand at the path's width, through
    the nonzero columns its binding built: checked against its plain
    version (a repeat bitwise equal), then timed (device time, from the
    profiler: a call takes 0.03-0.5 ms, about what the wrapper's host
    side takes, so CUDA events over back-to-back calls would time the
    host; ``wall_ms`` beside) beside the plain version and
    ``torch.sparse.mm`` on the operand's CSR (``lib``), with both bounds
    (``spmm_bound``) and the columns' count and bytes."""
    f = x.shape[1]
    args = (op.block_rows, op.block_cols, op.blocks, x, op.n_rows_padded)
    nzc = op.nonzero_columns()
    err = check_spmm(f"{label} [{op.n_rows_padded}x{op.n_cols_padded}] F={f}",
                     *args, device, nzc)
    check_close(f"library yardstick ({label})", torch.sparse.mm(lib, x[: op.n_cols]),
                bsr_spmm_ref(*args)[: op.n_rows])
    row = {"kernel": "bsr_spmm", "operand": label, "F": f,
           "n_blocks": int(op.blocks.shape[0]), "columns": int(nzc.x_rows.numel()),
           "nzc_bytes": nzc.nbytes, "split_rows": int(nzc.splits.shape[0])}
    row.update(timings({"": lambda: bsr_spmm(*args, nzc=nzc),
                        "plain_": lambda: bsr_spmm_ref(*args),
                        "library_": lambda: torch.sparse.mm(lib, x[: op.n_cols])},
                       device, reps, expect=SPMM_EXPECT))
    row.update(spmm_bound(*args[:3], f, op.n_rows_padded))
    print("[kernel] " + json.dumps(row))
    return row, err


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


#: what a kernel's second pass is counted under in a profiled window: the
#: split rows' pass (``nzc_split_reduce``, ``bsr_spmm_reduce``,
#: ``attn_<pass>_reduce``) combines their partials after the first pass,
#: inside the same wrapper call, so its time is the kernel's and its
#: launches are counted apart from the calls
SECOND_PASS = " second pass"


def launch_key(name: str) -> str:
    """What a profiler event's launches are counted under: its kernel, or
    the kernel's ``SECOND_PASS``."""
    kernel = classify(name)
    second = ("nzc_split_reduce<" in name or "bsr_spmm_reduce<" in name
              or re.search(r"attn_(?:fwd|bwd_row|bwd_col)_reduce", name))
    return kernel + SECOND_PASS if second else kernel


def classify(name: str) -> str:
    """A profiler event's kernel, by its (demangled) name: the three SpMM
    kernels' two passes over the nonzero-column loop (bsr_nzc.cuh) by
    their names, bsr_spmm.cu's own or the fused and masked kernels' (by
    their MASKED flag); each attention pass's two kernels
    (``attn_<pass>_kernel``, ``attn_<pass>_reduce``) as one kernel."""
    if "bsr_spmm_kernel<" in name or "bsr_spmm_reduce<" in name:
        return "bsr_spmm"
    m = re.search(r"nzc_(?:kernel|split_reduce)<\s*\d+,\s*\d+,\s*(\w+),", name)
    if m:
        return "bsr_spmm_masked" if m.group(1) == "true" else "bsr_spmm_fused_epilogue"
    if "fused_adam_kernel" in name:
        return "fused_adam"
    m = re.search(r"attn_(fwd|bwd_row|bwd_col)_(?:kernel|reduce)", name)
    if m:
        return f"bsr_attention_{m.group(1)}"
    if "flash_fwd_kernel" in name:
        return "flash_attention"
    low = name.lower()
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other (elementwise, reductions)"


def epoch_profile(prog, device, epoch_s: float, want: dict) -> dict:
    """One more epoch under the profiler (CUDA activity, after a warmup
    epoch): device ms and launches by kernel, busy total, and the idle
    share of the median epoch time. A kernel's device ms hold both of its
    passes; its launches count the row pass (one a call) and its
    ``SECOND_PASS`` apart. ``complete`` is False where none of
    ``PROFILE_TRIES`` windows held exactly ``want``'s launches of the
    port's kernels and their second passes (or off the card)."""
    if device.type != "cuda":
        return {"complete": False}
    sync(device)
    prof, windows = profiled(prog.train_epoch, device, want)
    if prof is None:
        return {"complete": False, "windows": windows}
    by, launched = defaultdict(float), defaultdict(int)
    for name, us, n in device_events(prof):
        by[classify(name)] += us / 1e3
        launched[launch_key(name)] += n
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


@contextlib.contextmanager
def fused_executor(inner: str, hook):
    """Route the ``inner`` programs' fused-epilogue calls through
    ``hook(fn, *args, **kw)``, ``fn`` the executor they would have called."""
    table = kops._EXECUTORS[inner]
    fn = table["fused"]
    table["fused"] = functools.partial(hook, fn)
    try:
        yield
    finally:
        table["fused"] = fn


def spmm_second_passes(prog) -> int:
    """``bsr_spmm``'s second passes in one training step: its calls on an
    operand with split rows (the feature operands X, Xᵀ; rarely Aᵀ),
    recorded over one step's forward and backward through the ``cuda``
    executor."""
    table = kops._EXECUTORS["cuda"]
    fn = table["spmm"]
    split = []

    def record(*args, nzc=None, **kw):
        split.append(nzc is not None and nzc.splits.shape[0] > 0)
        return fn(*args, nzc=nzc, **kw)

    table["spmm"] = record
    try:
        value_and_grad(prog.model.loss_fn, prog.params, prog.x, prog.labels,
                       prog.train_mask)
    finally:
        table["spmm"] = fn
    return sum(split)


def decided_grads(prog, ref, params) -> tuple:
    """Both programs' gradients at ``params``, the torch program's ReLU
    decisions taken from the cuda program's where the two part within
    MASK_MARGIN of 0: there the sign is rounding's, and one flip moves a
    nearly cancelling gradient past GRAD_RTOL. Returns (cuda grads, torch
    grads, per ReLU call: elements, decisions parted, those beyond the
    margin, the largest |pre| among them)."""
    masks, calls = [], []

    def record(fn, *args, **kw):
        y, mask = fn(*args, **kw)
        if mask is not None:
            masks.append(mask)
        return y, mask

    def decide(fn, rows, cols, blocks, x, n, self_term=None, bias=None,
               alpha=None, activation="none"):
        if activation != "relu":
            return fn(rows, cols, blocks, x, n, self_term, bias, alpha, activation)
        pre, _ = fn(rows, cols, blocks, x, n, self_term, bias, alpha, "none")
        want, mask = masks[len(calls)], (pre > 0).float()
        parted = mask != want
        beyond = parted & (pre.abs() > MASK_MARGIN)
        calls.append({"elements": mask.numel(), "parted": int(parted.sum()),
                      "beyond_margin": int(beyond.sum()),
                      "max_abs_pre": float(pre[parted].abs().max())
                      if parted.any() else 0.0})
        mask = torch.where(parted & ~beyond, want, mask)
        return torch.where(mask > 0, pre, torch.zeros_like(pre)), mask

    with fused_executor("cuda", record):
        got = value_and_grad(prog.model.loss_fn, params, prog.x, prog.labels,
                             prog.train_mask)[1]
    with fused_executor("torch", decide):
        want = value_and_grad(ref.model.loss_fn, params, ref.x, ref.labels,
                              ref.train_mask)[1]
    if len(calls) != len(masks):
        raise AssertionError(f"{len(masks)} ReLU calls in the cuda program, "
                             f"{len(calls)} in the torch program")
    return got, want, calls


def nzc_build(prog, device) -> dict:
    """The SpMM kernels' operand (the nonzero columns of A and Aᵀ), which
    ``compile`` built once on the device: ``column_build`` of each
    (building it again), beside its blocks and their bytes."""
    return {label: {**column_build(op.block_rows, op.block_cols, op.blocks,
                                   op.n_rows_padded, device, reps=3)[0],
                    "blocks": int(op.blocks.shape[0]),
                    "block_bytes": op.blocks.numel() * 4}
            for label, op in (("A", prog.plan.graph_op.fwd_operand),
                              ("A^T", prog.plan.graph_op.bwd_operand))}


def train_path(name, gnn, device, epochs: int, expected: dict) -> dict:
    """One training path: the ``cuda`` program (fused Adam) and the
    ``torch`` program (plain versions, plain Adam) from the same weights,
    ``epochs`` epochs each; counts zeroed just before the cuda run and read
    after every epoch, each epoch's launches exactly ``expected`` (kernel
    name -> launches; every other kernel 0)."""
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
    nzc = nzc_build(prog, device)
    print(f"[{name}] nonzero columns of A and Aᵀ: {json.dumps(nzc)}")
    on_card = device.type == "cuda"
    # per epoch on the card; CPU tensors run the plain versions and launch
    # nothing
    want = {k: expected.get(k, 0) if on_card else 0 for k in KERNELS}

    def grad_check(when: str, params) -> dict:
        """Both programs' gradients at the same parameters, leaf by leaf:
        Adam normalises a gradient's scale away, so the losses alone would
        pass a backward that is off by a constant factor. Every ReLU
        decision the two programs part on must lie within MASK_MARGIN of 0
        (``decided_grads``)."""
        cuda_grads, torch_grads, calls = decided_grads(prog, ref, params)
        out = {"grads": leaf_diffs(cuda_grads, torch_grads),
               "relu_decisions": calls}
        print(f"[{name}] gradients {when}: {json.dumps(out)}")
        if any(c["beyond_margin"] for c in calls):
            raise AssertionError(f"[{name}] ReLU masks {when} differ beyond "
                                 f"|pre| > {MASK_MARGIN}: {calls}")
        if not max(out["grads"].values()) <= GRAD_RTOL:
            raise AssertionError(f"[{name}] gradients {when} differ: {out}")
        return out

    grad_start = grad_check("at the first step", prog.params)
    spmm_second = spmm_second_passes(prog) if on_card else 0
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
           "nonzero_columns": nzc,
           "peak_mem_bytes": peak, "accuracy": prog.accuracy(),
           "grad_start": grad_start, "grad_end": grad_end,
           "param_rel_diff": param_diff}
    # each fused call and attention forward and row pass runs on A, each
    # masked call and attention column pass on Aᵀ, bsr_spmm on the
    # operands recorded in one step: a call on an operand with split rows
    # launches its second pass once
    fwd_op, bwd_op = prog.plan.graph_op.fwd_operand, prog.plan.graph_op.bwd_operand
    split = {"bsr_spmm_fused_epilogue": fwd_op, "bsr_spmm_masked": bwd_op,
             "bsr_attention_fwd": fwd_op, "bsr_attention_bwd_row": fwd_op,
             "bsr_attention_bwd_col": bwd_op}
    second = {k + SECOND_PASS: want[k] if op.nzc is not None and op.nzc.splits.shape[0] else 0
              for k, op in split.items()}
    second["bsr_spmm" + SECOND_PASS] = spmm_second
    out["profile"] = epoch_profile(prog, device, epoch_s, {**want, **second})
    print(f"[{name}] " + json.dumps({k: v for k, v in out.items()
                                     if k not in ("epoch_ms",)}))
    return {"summary": out, "prog": prog, "ref": ref, "weights": weights}


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


def feature_operand_checks(qds, prog, device, reps: int) -> dict:
    """``bsr_spmm`` on the quickstart's three operands, at the widths the
    path gives them: X·W on BSR(X) and Xᵀ·dU on BSR(Xᵀ) (the Alg-1 sparse
    layer 0, built as the lowering builds them, F = hidden) and Aᵀ·dY on
    corafull's Aᵀ (the plan's own, F = n_classes), each through
    ``spmm_operand_row``; the non-finite case on BSR(X); and the hub
    segment's cost on BSR(Xᵀ), whose every row is split. The dense
    operand is scaled so that each output has unit variance: at N(0, 1)
    the outputs of these ~440- and ~990-term rows reach ~150, and fp32's
    rounding with them."""
    br, f = prog.plan.layers[0].layout.br, prog.plan.layers[0].d_out
    x_csr = csr_from_dense(qds.features)
    gen = torch.Generator().manual_seed(19)
    rows, err = {}, 0.0
    for label, csr in (("X", x_csr), ("X^T", x_csr.transpose())):
        op = get_backend("cuda").build_spmm_operand(csr, br=br, device=device)
        w = torch.randn((op.n_cols_padded, f), generator=gen).to(device)
        w *= (csr.n_rows / csr.nnz) ** 0.5
        rows[label], e = spmm_operand_row(label, op, csr_tensor(csr, device), w,
                                          device, reps)
        err = max(err, e)
        if label == "X":
            err = max(err, check_nonfinite("BSR(X)", op, w, device))
        else:
            rows["hub X^T"] = row_cost(op, f, device, reps, "bsr_spmm")
            rows["hub X^T"]["full_call_ms"] = rows[label]["ms"]
            rows["hub X^T"]["full_call_ms_by"] = rows[label]["ms_by"]
            rows["hub X^T"]["hub_share_of_call"] = (rows["hub X^T"]["hub_ms"]
                                                    / rows[label]["ms"])
            print("[kernel] hub row of BSR(Xᵀ): " + json.dumps(rows["hub X^T"]))
        del op
    bwd = prog.plan.graph_op.bwd_operand
    c = prog.model.config.layer_dims[-1]
    dy = torch.randn((bwd.n_cols_padded, c), generator=gen).to(device)
    rows["A^T"], e = spmm_operand_row(
        "A^T", bwd, csr_tensor(qds.graph.sym_normalized().transpose(), device), dy,
        device, reps)
    return {"rows": rows, "err": max(err, e)}


def capture_attention(prog) -> list:
    """One training step of ``prog`` at its current parameters, recording
    each attention layer's real inputs: z [N, H*Dh], a_src, a_dst, the
    head count and the loss's cotangent of the layer's output, dy [N, H,
    Dh]. Measurement only: the plan's operator is wrapped for this step."""
    op = prog.plan.graph_op
    inner = op.aggregate_attention
    layers = []

    def spy(z, a_src, a_dst, heads):
        out = inner(z, a_src, a_dst, heads)
        rec = {"z": z.detach(), "a_src": a_src.detach(),
               "a_dst": a_dst.detach(), "heads": heads}
        layers.append(rec)
        out.register_hook(lambda g: rec.__setitem__("dy", g.detach()))
        return out

    op.aggregate_attention = spy
    try:
        value_and_grad(prog.model.loss_fn, prog.params, prog.x, prog.labels,
                       prog.train_mask)
    finally:
        op.aggregate_attention = inner
    return layers


def attention_operands(fwd, bwd, rec) -> dict:
    """The three passes' arguments for one captured layer, built as
    ``kernels/ops.py:_SparseMHAPair`` builds them: the statistics (m, l)
    and the output from the plain forward, r = Σ_d dy·out. The loss's
    cotangent is a mean over the training nodes (~1e-5 at the last layer,
    less below), so dy is rescaled to unit variance, as
    ``feature_operand_checks`` scales its dense operand: otherwise dc,
    dzv and dd would lie below the check's absolute tolerance."""
    fit = kops._fit_rows
    h = rec["heads"]
    n, hd = rec["z"].shape
    dy3 = rec["dy"] / rec["dy"].std()
    z3 = rec["z"].reshape(n, h, hd // h)
    asrc = torch.einsum("nhd,hd->nh", z3, rec["a_src"])
    adst = torch.einsum("nhd,hd->nh", z3, rec["a_dst"])
    nr, nc, ntr, ntc = (fwd.n_rows_padded, fwd.n_cols_padded,
                        bwd.n_rows_padded, bwd.n_cols_padded)
    a = (fwd.block_rows, fwd.block_cols, fwd.blocks)
    at = (bwd.block_rows, bwd.block_cols, bwd.blocks)
    fargs = (*a, fit(adst, nr).contiguous(), fit(asrc, nc).contiguous(),
             fit(rec["z"], nc).contiguous(), nr, h)
    out, m, l = bsr_attention_fwd_ref(*fargs)
    dy = dy3.reshape(n, hd)
    r = torch.einsum("nhd,nhd->nh", dy3, out[:n].reshape(n, h, hd // h))
    m, l = m[:n], l[:n]
    rargs = (*a, fargs[3], fargs[4], fargs[5], fit(dy, nr).contiguous(),
             fit(r, nr).contiguous(), fit(m, nr).contiguous(),
             fit(l, nr).contiguous(), nr, h)
    cargs = (*at, fit(asrc, ntr).contiguous(), fit(adst, ntc).contiguous(),
             fit(rec["z"], ntr).contiguous(), fit(dy, ntc).contiguous(),
             fit(r, ntc).contiguous(), fit(m, ntc).contiguous(),
             fit(l, ntc).contiguous(), ntr, h)
    return {"fwd": fargs, "row": rargs, "col": cargs}


def attention_bound(rows, cols, blocks, heads: int, hd: int,
                    n_rows_padded: int, kind: str) -> dict:
    """Least time for one attention pass on these inputs, counted two ways,
    as ``spmm_bound`` does. Row-side inputs are indexed by the stream's
    block rows, column-side ones by its block columns, per row in floats:
    forward z + asrc (columns), adst (rows), writes out + m + l; row pass
    z + asrc (columns), adst + dy + r + m + l (rows), writes dc; column
    pass over Aᵀ adst + dy + r + m + l (columns: destinations), asrc + z
    (rows: sources), writes dzv + dd. ``layout_bound_ms``, the layout's:
    each block that holds a nonzero, whole, and its two indices, the
    column-side rows of its block-column and the row-side rows of its
    block-row, once. ``nnz_bound_ms``, any layout's: each nonzero's column
    index and a row pointer per row, the rows the nonzeros reference on
    each side, once. Both write every output row once. ``bound_ms`` (and
    ``bytes``) is the one the kernels answer to, the nonzeros': every pass
    reads its operand's nonzero columns and no block. Operations:
    fp32 on the nonzeros x heads (score, exp and the 2·Dh-long product per
    pass; the column pass two products)."""
    col_w, row_w, out_w = {
        "fwd": (hd + heads, heads, hd + 2 * heads),
        "row": (hd + heads, hd + 4 * heads, heads),
        "col": (hd + 4 * heads, hd + heads, hd + heads)}[kind]
    nb, br, bc = blocks.shape
    nz = blocks.ne(0)
    used = nz.reshape(nb, -1).any(dim=1)
    n_used = int(used.sum())
    col_rows = int(torch.unique(cols[used]).numel()) * bc
    row_rows = int(torch.unique(rows[used]).numel()) * br
    out_bytes = 4 * n_rows_padded * out_w
    nbytes = (4 * (2 * n_used + n_used * br * bc + col_rows * col_w
                   + row_rows * row_w) + out_bytes)
    b_idx, i, j = torch.nonzero(nz, as_tuple=True)
    nnz = int(b_idx.numel())
    nnz_cols = int(torch.unique(cols[b_idx].long() * bc + j).numel())
    nnz_rows = int(torch.unique(rows[b_idx].long() * br + i).numel())
    nnz_bytes = (4 * (nnz + n_rows_padded + 1 + nnz_cols * col_w
                      + nnz_rows * row_w) + out_bytes)
    dh = hd // heads
    per = {"fwd": 2 * dh + 6, "row": 2 * dh + 10, "col": 4 * dh + 10}[kind]
    flop = float(nnz) * heads * per
    out = {"blocks_used": n_used, "nnz": nnz, "bytes": nnz_bytes,
           "layout_bytes": nbytes, "nnz_bytes": nnz_bytes, "flop": flop}
    out["bound_ms"], out["bound_by"] = _bound(out["bytes"], flop)
    out["nnz_bound_ms"], _ = _bound(nnz_bytes, flop)
    out["layout_bound_ms"], _ = _bound(nbytes, flop)
    return out


def attention_call(kind, args, nzc):
    """A thunk of the ``kind`` pass's kernel on ``args``, reading ``nzc``,
    the nonzero columns of its stream (A's, or Aᵀ's for the column pass)."""
    _, kernel, _ = ATTENTION[kind]
    return lambda: kernel(*args, nzc=nzc)


def stream_columns(args):
    """The nonzero columns of an attention pass's stream (``args`` as the
    pass takes them: the stream first, its padded rows second to last),
    built on its device."""
    return nonzero_columns(args[0], args[1], args[2], args[-2])


def check_attention(label, kind, args, device, nzc) -> float:
    """One attention kernel against its plain version on the same device
    tensors, every output within the JAX suite's tolerance (|got - want| <=
    1e-4 + 1e-4·|want|: the softmax denominator l of a row with 17k
    nonzeros is ~1e4, summed in another order) and within 1e-4 of its
    norm (||got - want|| <= 1e-4·||want||, which holds small outputs to
    their own scale), and a repeat launch bitwise equal. The kernel reads
    ``nzc``, its stream's nonzero columns. Returns the largest absolute
    error."""
    name, _, plain = ATTENTION[kind]
    call = attention_call(kind, args, nzc)
    got = call()
    again = call()
    want = plain(*args)
    sync(device)
    got, again, want = ((t,) if isinstance(t, torch.Tensor) else t
                        for t in (got, again, want))
    errs = []
    for a, w in zip(got, want):
        if not a.numel():
            errs.append((0.0, 0.0, 0.0))
            continue
        diff = (a - w).abs()
        gap, scale = float(diff.norm()), float(w.norm())
        errs.append((float(diff.max()), float((diff - TOL * w.abs()).max()),
                     gap / scale if scale else (0.0 if gap == 0 else float("inf"))))
    if not all(excess <= TOL and rel <= TOL for _, excess, rel in errs):
        raise AssertionError(f"{name} {label}: (max abs error, max excess over "
                             f"the relative part, error norm over the output's) "
                             f"per output {errs} > {TOL}")
    if device.type == "cuda" and not all(torch.equal(a, b)
                                         for a, b in zip(got, again)):
        raise AssertionError(f"{name} {label}: a repeat launch is not bitwise equal")
    print(f"[kernel] {name} {label}: max abs error per output "
          f"{[e for e, _, _ in errs]}, relative norm error {[r for _, _, r in errs]}")
    return max(e for e, _, _ in errs)


@contextlib.contextmanager
def split_columns(n: int):
    """Inside the ``with`` statement ``nonzero_columns`` splits rows longer
    than ``n`` columns (``SPLIT_COLUMNS``, restored after)."""
    saved = bsr_spmm_module.SPLIT_COLUMNS
    bsr_spmm_module.SPLIT_COLUMNS = n
    try:
        yield
    finally:
        bsr_spmm_module.SPLIT_COLUMNS = saved


def attention_edge_cases(device) -> float:
    """The three passes on small operands, each through its stream's
    nonzero columns: a padding tail, a block-row without blocks, H·Dh not
    a multiple of 32 (2 x 5, 4 x 17), rows split into segments of 3
    columns and whole; a row whose max lies in its second block; and,
    split at 3 columns, a row whose max lies in its last segment beside a
    row whose first segments hold none of its nonzeros."""
    err = 0.0
    gen = torch.Generator().manual_seed(23)
    for split in (3, bsr_spmm_module.SPLIT_COLUMNS):
        for heads, dh in ((2, 5), (4, 17)):
            r = np.random.default_rng(heads)
            g = csr_from_edges(r.integers(0, 150, 700), r.integers(0, 150, 700), 150)
            a, at = csr_to_bsr(g, br=8, bc=8), csr_to_bsr(g.transpose(), br=8, bc=8)
            arrays = _pad_bsr(a, a.n_blocks + 9)
            keep = arrays["rows"] != 3  # block-row 3 loses its blocks
            t = on_device({k: v[keep] for k, v in arrays.items()}, device)
            tt = on_device({"rows": at.block_rows, "cols": at.block_cols,
                            "blocks": at.blocks}, device)
            nr, nc, hd = a.padded_rows, a.padded_cols, heads * dh

            def rnd(*shape):
                return torch.randn(shape, generator=gen).to(device)

            z, dy = rnd(nc, hd), rnd(nr, hd)
            adst, asrc, rr = rnd(nr, heads), rnd(nc, heads), rnd(nr, heads)
            fargs = (t["rows"], t["cols"], t["blocks"], adst, asrc, z, nr, heads)
            label = f"edge cases H={heads} Dh={dh} split {split}"
            with split_columns(split):
                nzc = stream_columns(fargs)
                nzc_t = nonzero_columns(tt["rows"], tt["cols"], tt["blocks"],
                                        at.padded_rows)
            err = max(err, check_attention(label, "fwd", fargs, device, nzc))
            out, m, l = bsr_attention_fwd(*fargs, nzc=nzc)
            if not (torch.all(out[24:32] == 0) and torch.all(m[24:32] == 0)
                    and torch.all(l[24:32] == 0)):
                raise AssertionError("a block-row without blocks must give out, m, l = 0")
            rargs = (*fargs[:3], adst, asrc, z, dy, rr, m, l, nr, heads)
            err = max(err, check_attention(label, "row", rargs, device, nzc))
            src_side = [kops._fit_rows(x, at.padded_rows).contiguous()
                        for x in (asrc, z)]
            dst_side = [kops._fit_rows(x, at.padded_cols).contiguous()
                        for x in (adst, dy, rr, m, l + 1.0)]
            err = max(err, check_attention(label, "col", (
                tt["rows"], tt["cols"], tt["blocks"], src_side[0], dst_side[0],
                src_side[1], *dst_side[1:], at.padded_rows, heads), device, nzc_t))
    # row 0 attends sources {0, 1} in block-column 0 and {14, 15} in
    # block-column 1, whose scores are the larger: the running max rises
    blocks = torch.zeros((2, 8, 8))
    blocks[0, 0, :2] = 1.0
    blocks[1, 0, 6:] = 1.0
    asrc = torch.zeros((16, 1))
    asrc[:2, 0] = torch.tensor([-1.0, 0.5])
    asrc[14:, 0] = torch.tensor([4.0, 6.0])
    adst = torch.full((8, 1), 0.3)
    z = torch.randn((16, 3), generator=gen)
    fargs = tuple(x.to(device) for x in (torch.zeros(2, dtype=torch.int32),
                                          torch.tensor([0, 1], dtype=torch.int32),
                                          blocks, adst, asrc, z)) + (8, 1)
    nzc = stream_columns(fargs)
    err = max(err, check_attention("max in the second block", "fwd", fargs, device, nzc))
    _, m, _ = bsr_attention_fwd(*fargs, nzc=nzc)
    if abs(float(m[0, 0]) - 6.3) > 1e-5:
        raise AssertionError(f"row max {float(m[0, 0])}, expected 6.3")
    # one block-row over 24 sources, 9 columns holding a nonzero: split at
    # 3 columns, row 0's scores rise to its last segment's; row 1's
    # nonzeros lie in the last segment only, so its first two carry no
    # nonzero (m_s = NEG_INF, l_s = 0) and must add nothing
    blocks = torch.zeros((3, 8, 8))
    for b, ks in enumerate(([1, 4, 6], [0, 3, 7], [2, 5, 6])):
        blocks[b, 0, ks] = 1.0
    blocks[2, 1, [2, 5, 6]] = 1.0
    asrc = torch.linspace(-2.0, 5.0, 24)[:, None]
    fargs = tuple(x.to(device) for x in (torch.zeros(3, dtype=torch.int32),
                                          torch.arange(3, dtype=torch.int32), blocks,
                                          torch.full((8, 1), 0.3), asrc,
                                          torch.randn((24, 3), generator=gen))) + (8, 1)
    with split_columns(3):
        nzc = stream_columns(fargs)
    if nzc.splits.tolist() != [[0, 0, 3]]:
        raise AssertionError(f"the late-max row must split in 3: {nzc.splits.tolist()}")
    err = max(err, check_attention("max in the last segment", "fwd", fargs, device, nzc))
    _, m, _ = bsr_attention_fwd(*fargs, nzc=nzc)
    want = 0.3 + float(asrc[22, 0])
    if abs(float(m[0, 0]) - want) > 1e-5:
        raise AssertionError(f"row max {float(m[0, 0])}, expected {want}")
    return err


def attention_row_cost(kind, args, device, reps: int) -> dict:
    """One attention pass on a stream holding only its hub block-row (A's
    in-degree hub, or Aᵀ's out-degree hub), the row with
    the most nonzeros, blocks breaking a tie, as ``row_cost`` picks by
    nonzero columns; against one holding only a row of about the mean
    length in blocks, at these inputs' width. Also the row with the most
    blocks (the first of a tie), with its blocks and nonzeros: several
    rows may tie on blocks and hold very different nonzeros. Every pass
    walks each sub-stream's own nonzero columns, so a row longer than
    SPLIT_COLUMNS columns is cut into segments, one CTA each, combined by
    one second-pass launch a call: ``<row>_segments`` and
    ``<row>_second_pass_launches`` say so."""
    rows, cols, blocks, *rest = args
    per_row = torch.bincount(rows.long())
    nnz_row = torch.zeros_like(per_row).index_add_(
        0, rows.long(), blocks.ne(0).flatten(1).sum(1))
    # nonzeros first, blocks second, the first row of a full tie
    key = nnz_row * (int(per_row.max()) + 1) + per_row
    hub = int(torch.argmax(key))
    by_blocks = int(torch.argmax(per_row))
    mean = float(per_row[per_row > 0].float().mean())
    typical = int(torch.argmin((per_row.float() - mean).abs()))
    out = {"hub_row": hub, "hub_blocks": int(per_row[hub]), "mean_blocks": mean,
           "typical_blocks": int(per_row[typical]),
           "most_blocks_row": by_blocks, "most_blocks_blocks": int(per_row[by_blocks]),
           "most_blocks_nnz": int(nnz_row[by_blocks]),
           "rows_with_most_blocks": int((per_row == per_row.max()).sum())}
    for label, row in (("hub", hub), ("typical", typical)):
        sel = rows == row
        out[f"{label}_nnz"] = int(blocks[sel].ne(0).sum())
        sub = (rows[sel].contiguous(), cols[sel].contiguous(),
               blocks[sel].contiguous(), *rest)
        nzc = stream_columns(sub)
        out[f"{label}_segments"] = nzc.n_slots
        out[f"{label}_second_pass_launches"] = int(nzc.splits.shape[0] > 0)
        out.update({f"{label}_{k}": v for k, v in timings(
            {"": attention_call(kind, sub, nzc)}, device, reps).items()})
    return out


def segment_ms(rec, op, device, reps: int) -> dict:
    """The port's segment path (``segment_softmax_aggregate``: gather,
    ``scatter_reduce`` amax, ``index_add_``) on the same graph and inputs,
    the PyG-style composition of library calls the fused kernels replace:
    ``fwd`` the forward, ``bwd`` its autograd backward with the captured
    cotangent (the graph kept between calls)."""
    h = rec["heads"]
    n, hd = rec["z"].shape
    backend = get_backend("cuda")
    z = rec["z"].reshape(n, h, hd // h).clone().requires_grad_(True)
    a_src = rec["a_src"].clone().requires_grad_(True)
    a_dst = rec["a_dst"].clone().requires_grad_(True)

    def forward():
        return backend.segment_softmax_aggregate(z, a_src, a_dst, op.src,
                                                 op.dst, n)

    with torch.no_grad():
        fwd = time_ms(forward, device, reps, warmup=1)
    out = forward()
    bwd = time_ms(lambda: torch.autograd.grad(out, (z, a_src, a_dst), rec["dy"],
                                              retain_graph=True),
                  device, reps, warmup=1)
    return {"fwd": fwd, "bwd": bwd}


def attention_phase(prog, device, reps: int) -> dict:
    """Phase 8 on phase 7's operands: A (forward, row pass) and Aᵀ (column
    pass), each layer's real inputs, each pass through its operand's
    nonzero columns, which the program built when it bound the layer."""
    op = prog.plan.graph_op
    fwd, bwd = op.fwd_operand, op.bwd_operand
    if fwd.nzc is None or bwd.nzc is None:
        raise AssertionError("the cuda program must build A's and Aᵀ's nonzero "
                             "columns when it binds the attention pair")
    columns = {"fwd": fwd.nzc, "row": fwd.nzc, "col": bwd.nzc}
    captured = capture_attention(prog)
    sync(device)
    err = {k: 0.0 for k in ATTENTION}
    rows = {}
    hub = None
    for layer, rec in enumerate(captured):
        args = attention_operands(fwd, bwd, rec)
        h = rec["heads"]
        hd = rec["z"].shape[1]
        label = f"layer {layer} H={h} Dh={hd // h}"
        for kind, a in args.items():
            err[kind] = max(err[kind], check_attention(label, kind, a, device,
                                                       columns[kind]))
        seg = segment_ms(rec, op, device, reps)
        for kind, a in args.items():
            name, _, plain = ATTENTION[kind]
            stream = bwd if kind == "col" else fwd
            row = {"kernel": name, "operand": "A^T" if kind == "col" else "A",
                   "layer": layer, "heads": h, "Dh": hd // h,
                   "n_blocks": int(stream.blocks.shape[0])}
            row.update(timings({"": attention_call(kind, a, columns[kind]),
                                "plain_": lambda: plain(*a)}, device, reps))
            row.update(attention_bound(stream.block_rows, stream.block_cols,
                                       stream.blocks, h, hd, stream.n_rows_padded,
                                       kind))
            row["library_ms"] = None
            # the segment path's forward beside ours, its whole backward
            # beside each of our two backward passes
            row["segment_ms"] = seg["fwd" if kind == "fwd" else "bwd"]
            rows[(kind, layer)] = row
            print("[kernel] " + json.dumps(row))
        if layer == 0:
            hub = {kind: attention_row_cost(kind, a, device, reps)
                   for kind, a in args.items()}
            print("[kernel] attention hub rows: " + json.dumps(hub))
        del args
    err["edge"] = attention_edge_cases(device)
    return {"rows": rows, "err": err, "hub": hub, "layers": len(captured)}


def attention_pair_unequal(prog, device) -> float:
    """The attention pair's forward and backward on the quickstart's A and
    Aᵀ (19,800 rows against 19,840 columns), cuda against torch: out and
    dz within 1e-4, da_src / da_dst within 1e-4 of their norm (sums over
    every node)."""
    op = prog.plan.graph_op
    fwd, bwd = op.fwd_operand, op.bwd_operand
    print(f"[gt] A padded {fwd.n_rows_padded} x {fwd.n_cols_padded}, "
          f"Aᵀ padded {bwd.n_rows_padded} x {bwd.n_cols_padded}")
    gen = torch.Generator().manual_seed(29)
    err = 0.0
    for heads, dh in ((4, 8), (4, 17)):
        z = torch.randn((fwd.n_cols, heads, dh), generator=gen).to(device)
        a_src, a_dst = (torch.randn((heads, dh), generator=gen).to(device) / dh ** 0.5
                        for _ in range(2))
        dy = torch.randn((fwd.n_rows, heads, dh), generator=gen).to(device)
        got = {}
        for inner in ("cuda", "torch"):
            zt, st, dt = (t.clone().requires_grad_(True) for t in (z, a_src, a_dst))
            out = kops.build_sparse_mha(fwd, bwd, inner)(zt, st, dt)
            out.backward(dy)
            got[inner] = (out.detach(), zt.grad, st.grad, dt.grad)
        c, t = got["cuda"], got["torch"]
        for label, a, b in (("out", c[0], t[0]), ("dz", c[1], t[1])):
            err = max(err, check_close(f"attention pair H={heads} Dh={dh} {label}", a, b))
        for label, a, b in (("da_src", c[2], t[2]), ("da_dst", c[3], t[3])):
            rel = float((a - b).norm() / b.norm())
            if not rel <= TOL:
                raise AssertionError(f"attention pair {label}: relative {rel}")
    print(f"[gt] attention pair, unequal paddings: max_abs_err={err:.3g}")
    return err


# ---------------------------------------------------------------------------
# Phases 10-11: LM serving at llama3.2-1B width and the flash attention kernel
# ---------------------------------------------------------------------------

#: the flash kernel against its plain version: the JAX suite's float32
#: tolerance (test_flash_matches_ref) and its bfloat16 one (test_flash_bf16),
#: each |got - want| <= tol + tol·|want|
FLASH_TOL = 2e-5
FLASH_BF16_TOL = 5e-2
#: greedy tokens must agree where the cuda program's top-2 logit margin
#: exceeds this (below it, float32 rounding may pick either)
TOKEN_MARGIN = 1e-3


class RecordingLM:
    """The cuda model's entry points as ``ServingEngine`` calls them. Each
    call's token input, last-position logits, synchronised host time and
    flash launches are recorded, so that the reference program can be fed
    the same inputs afterwards. Measurement only."""

    def __init__(self, model, device):
        self.model, self.device = model, device
        self.calls = []  # dicts: wave, kind, tokens, logits, s, flash
        self.wave = -1

    def init_cache(self, *args, **kw):
        return self.model.init_cache(*args, **kw)

    def _call(self, kind, fn, tokens):
        sync(self.device)
        before = flash_attention.launches
        t0 = time.perf_counter()
        logits, cache = fn()
        sync(self.device)
        self.calls.append({"wave": self.wave, "kind": kind, "tokens": tokens.clone(),
                           "logits": logits.clone(), "s": time.perf_counter() - t0,
                           "flash": flash_attention.launches - before})
        return logits, cache

    def prefill(self, params, tokens, cache):
        self.wave += 1
        return self._call("prefill", lambda: self.model.prefill(params, tokens, cache),
                          tokens)

    def decode_step(self, params, cache, tokens):
        return self._call("decode", lambda: self.model.decode_step(params, cache, tokens),
                          tokens)


def lm_requests(sizes: Sizes, vocab: int) -> list:
    """``lm_requests`` prompts of random tokens, lengths drawn from seed 0
    in lm_prompts[0]..lm_prompts[1], the longest set to lm_prompts[1]."""
    rng = np.random.default_rng(0)
    lo, hi = sizes.lm_prompts
    lengths = rng.integers(lo, hi + 1, sizes.lm_requests)
    lengths[int(np.argmax(lengths))] = hi
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(n)).astype(np.int32),
                    max_new_tokens=sizes.lm_new_tokens)
            for i, n in enumerate(lengths)]


def lm_profile(fn, device, n_flash: int, wall_ms: float) -> dict:
    """One call of ``fn`` under the profiler: device ms by kernel class,
    busy total and the idle share of ``wall_ms`` (the call's synchronised
    time in the engine's run)."""
    if device.type != "cuda":
        return {"complete": False}
    prof, windows = profiled(fn, device, {"flash_attention": n_flash})
    if prof is None:
        return {"complete": False, "windows": windows}
    by = defaultdict(float)
    for name, us, _ in device_events(prof):
        by[classify(name)] += us / 1e3
    busy = sum(by.values())
    return {"complete": True, "windows": windows, "device_ms": dict(by),
            "busy_ms": busy, "wall_ms": wall_ms, "idle_share": 1.0 - busy / wall_ms}


def lm_serving_phase(sizes: Sizes, device) -> dict:
    """Phase 10, LM serving: ``ServingEngine`` over the ``cuda`` model
    (prefill attention on the flash kernel) at the configuration's full
    width, random weights from a seeded generator on the card; counts
    zeroed just before ``run()`` and read after it. Then the ``torch``
    model (the plain version) fed the same inputs call by call: its
    logits within 1e-4 at every step, and its greedy tokens equal where
    the cuda program's top-2 margin exceeds ``TOKEN_MARGIN``."""
    base = get_config(sizes.lm_arch)
    cfg = base.reduced() if sizes.lm_reduced else base
    model, ref = build_model(cfg, inner="cuda"), build_model(cfg, inner="torch")
    on_card = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen, device=device)
    sync(device)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads ({cfg.n_kv_heads} KV) of {cfg.resolved_head_dim}, "
          f"vocab {cfg.vocab_size}: {n_params:,} parameters drawn in {init_s:.2f}s")
    max_seq = sizes.lm_prompts[1] + sizes.lm_new_tokens
    # warmup: the same requests once, untimed (the flash library's load,
    # cuBLAS's first calls at these shapes)
    warm = ServingEngine(model, params, batch_slots=sizes.lm_slots, max_seq=max_seq,
                         device=device)
    for r in lm_requests(sizes, cfg.vocab_size):
        warm.submit(r)
    t0 = time.perf_counter()
    warm.run()
    sync(device)
    warmup_s = time.perf_counter() - t0
    rec = RecordingLM(model, device)
    engine = ServingEngine(rec, params, batch_slots=sizes.lm_slots, max_seq=max_seq,
                           device=device)
    reqs = lm_requests(sizes, cfg.vocab_size)
    for r in reqs:
        engine.submit(r)
    mem_before = torch.cuda.memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    zero_counts()
    t0 = time.perf_counter()
    done = engine.run()
    sync(device)
    wall = time.perf_counter() - t0
    launched = counts()
    # the run's own peak: what earlier phases left allocated is not counted
    peak = torch.cuda.max_memory_allocated(device) - mem_before if on_card else 0

    waves = rec.wave + 1
    per_wave = cfg.n_layers if on_card else 0
    if [r.rid for r in done] != list(range(len(reqs))):
        raise AssertionError("requests not answered in order")
    for r in done:
        if not r.done or len(r.output) != sizes.lm_new_tokens:
            raise AssertionError(f"request {r.rid}: {len(r.output)} tokens")
    for c in rec.calls:
        want = per_wave if c["kind"] == "prefill" else 0
        if c["flash"] != want:
            raise AssertionError(f"a {c['kind']} of wave {c['wave']} launched "
                                 f"flash_attention {c['flash']} times, expected {want}")
    if launched["flash_attention"] != per_wave * waves or (on_card and waves == 0):
        raise AssertionError(f"flash_attention launched {launched['flash_attention']} "
                             f"times for {waves} waves of {cfg.n_layers} layers")
    if sum(launched.values()) != launched["flash_attention"]:
        raise AssertionError(f"LM serving launched other kernels: {launched}")

    worst, steps, sure_steps, ref_s = 0.0, 0, 0, defaultdict(list)
    cache = None
    for c in rec.calls:
        logits = c["logits"]
        if logits.shape != (c["tokens"].shape[0], cfg.padded_vocab()) \
                or not torch.isfinite(logits).all():
            raise AssertionError(f"{c['kind']} logits {tuple(logits.shape)} not finite "
                                 f"or of the wrong shape")
        sync(device)
        t0 = time.perf_counter()
        if c["kind"] == "prefill":
            cache = ref.init_cache(c["tokens"].shape[0], max_seq, dtype=torch.float32,
                                   device=device)
            want, cache = ref.prefill(params, c["tokens"], cache)
        else:
            want, cache = ref.decode_step(params, cache, c["tokens"])
        sync(device)
        ref_s[c["kind"]].append(time.perf_counter() - t0)
        worst = max(worst, float((logits - want).abs().max()))
        top = torch.topk(logits, 2, dim=-1).values
        sure = (top[:, 0] - top[:, 1]) > TOKEN_MARGIN
        steps += sure.numel()
        sure_steps += int(sure.sum())
        if not torch.equal(logits.argmax(-1)[sure], want.argmax(-1)[sure]):
            raise AssertionError(f"greedy tokens differ in a {c['kind']} of wave "
                                 f"{c['wave']} where the top-2 margin > {TOKEN_MARGIN}")
    if not worst <= TOL:
        raise AssertionError(f"cuda vs torch LM logits differ by {worst} > {TOL}")
    print(f"[lm] cuda vs torch, the torch model fed the cuda program's tokens: "
          f"logits within {worst:.3g}; greedy tokens equal at all {sure_steps} of "
          f"{steps} (slot, step) pairs whose top-2 margin > {TOKEN_MARGIN}")

    prefill_s = [c["s"] for c in rec.calls if c["kind"] == "prefill"]
    decode_s = [c["s"] for c in rec.calls if c["kind"] == "decode"]
    tokens = sum(len(r.output) for r in done)
    longest = max((c for c in rec.calls if c["kind"] == "prefill"),
                  key=lambda c: c["tokens"].shape[1])
    b = longest["tokens"].shape[0]
    median_ms = float(np.median(decode_s)) * 1e3 if decode_s else 0.0
    # a cache filled by the longest prefill, for a decode step's profile
    _, filled = model.prefill(params, longest["tokens"], model.init_cache(
        b, max_seq, dtype=torch.float32, device=device))
    cur = longest["logits"].argmax(-1)[:, None]
    out = {
        "arch": cfg.name, "n_params": n_params, "init_s": init_s, "warmup_s": warmup_s,
        "requests": len(done),
        "waves": waves, "slots": sizes.lm_slots, "max_seq": max_seq,
        "prompt_lengths": [len(r.prompt) for r in reqs],
        "wave_prompt_tokens": [int(c["tokens"].shape[1]) for c in rec.calls
                               if c["kind"] == "prefill"],
        "launches": launched, "flash_per_wave": per_wave,
        "max_logit_diff": worst, "token_pairs": steps, "token_pairs_compared": sure_steps,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "prefill_ms": [x * 1e3 for x in prefill_s],
        "decode_step_ms_median": median_ms,
        "decode_ms_per_token": median_ms / sizes.lm_slots,
        "ref_prefill_ms": [x * 1e3 for x in ref_s["prefill"]],
        "ref_decode_step_ms_median": float(np.median(ref_s["decode"])) * 1e3
        if ref_s["decode"] else 0.0,
        "peak_mem_bytes": peak, "params_bytes": 4 * n_params,
        "profile_prefill": lm_profile(
            lambda: model.prefill(params, longest["tokens"], model.init_cache(
                b, max_seq, dtype=torch.float32, device=device)),
            device, per_wave, longest["s"] * 1e3),
        "profile_decode": lm_profile(
            lambda: model.decode_step(params, filled, cur), device, 0, median_ms),
    }
    print("[lm] " + json.dumps(out))
    return {"summary": out, "model": model, "params": params, "tokens": longest["tokens"],
            "max_seq": max_seq}


def flash_bound(b, h, hkv, tq, tk, d, causal: bool, elem: int) -> dict:
    """Least time for one flash call on these shapes: q, k, v read once and
    the output written once, against 4·D fp32 operations (two products)
    per visible (query, key) pair of each head — with the top-left causal
    mask row i sees min(i + 1, Tk) keys."""
    if causal:
        n = min(tq, tk)
        pairs = n * (n + 1) // 2 + (tq - n) * tk
    else:
        pairs = tq * tk
    flop = 4.0 * b * h * d * pairs
    nbytes = elem * (2 * b * h * tq * d + 2 * b * hkv * tk * d)
    out = {"bytes": nbytes, "flop": flop}
    out["bound_ms"], out["bound_by"] = _bound(nbytes, flop)
    return out


def capture_flash(model, params, tokens, max_seq: int, device) -> list:
    """One prefill of ``tokens`` through ``model``, recording each layer's
    flash inputs (q, k, v as the layer passes them: [B, H, T, D] views of
    the projections and of the cache). Measurement only: the executor is
    wrapped for this call."""
    table = kops._EXECUTORS["cuda"]
    inner = table["flash"]
    layers = []

    def spy(q, k, v, **kw):
        layers.append((q, k, v))
        return inner(q, k, v, **kw)

    table["flash"] = spy
    try:
        model.prefill(params, tokens, model.init_cache(
            tokens.shape[0], max_seq, dtype=torch.float32, device=device))
    finally:
        table["flash"] = inner
    return layers


def check_flash(label, q, k, v, causal: bool, device, tol: float = FLASH_TOL) -> float:
    """The flash kernel against its plain version on the same device
    tensors (|got - want| <= tol + tol·|want|), and a repeat launch bitwise
    equal; returns the largest absolute error."""
    got = flash_attention(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    sync(device)
    if got.dtype != q.dtype or got.shape != want.shape:
        raise AssertionError(f"flash_attention {label}: {got.dtype} {tuple(got.shape)}")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if not float((diff - tol * want.float().abs()).max()) <= tol:
        raise AssertionError(f"flash_attention {label}: max abs error {err} > {tol} "
                             f"(+ {tol}·|want|)")
    if device.type == "cuda" and not torch.equal(got, again):
        raise AssertionError(f"flash_attention {label}: a repeat launch is not "
                             "bitwise equal")
    print(f"[kernel] flash_attention {label}: max_abs_err={err:.3g}")
    return err


def flash_edge_cases(device) -> dict:
    """Random inputs: Tq != Tk causal and not, T = 1, 33 and 1000, D = 8
    and 128, K padding inside a tile, Hkv == H; float32 and bfloat16. Then
    the kernel's tiles: every D in ``HEAD_DIMS`` at Tq = 150 and Tk = 97 /
    201 (multiples of neither a query tile, 128 rows or 128/hp a head, nor
    the 64-key tile), KV groups of 1, 2, 4 and 8 heads (1, 2, 4 and 4
    heads a CTA); the same inputs as strided [B, T, H, D] views and
    misaligned copies (the kernel's synchronous load path), bitwise equal
    to the aligned call; bfloat16."""
    gen = torch.Generator().manual_seed(31)
    err = {"f32": 0.0, "bf16": 0.0}
    for b, h, hkv, tq, tk, d, causal in (
            (1, 4, 2, 40, 72, 64, True), (1, 4, 2, 72, 40, 64, True),
            (1, 4, 2, 40, 72, 64, False), (2, 8, 2, 1, 1, 64, True),
            (1, 4, 4, 33, 33, 64, True), (1, 8, 2, 1000, 1000, 64, True),
            (2, 4, 4, 33, 33, 8, True), (1, 4, 1, 100, 100, 128, True),
            (1, 4, 1, 100, 100, 128, False), (1, 2, 2, 64, 100, 32, False)):
        q = torch.randn((b, h, tq, d), generator=gen).to(device)
        k, v = (torch.randn((b, hkv, tk, d), generator=gen).to(device) for _ in range(2))
        label = f"B={b} H={h} Hkv={hkv} Tq={tq} Tk={tk} D={d} causal={causal}"
        err["f32"] = max(err["f32"], check_flash(label, q, k, v, causal, device))
        err["bf16"] = max(err["bf16"], check_flash(
            label + " bf16", *(x.to(torch.bfloat16) for x in (q, k, v)), causal,
            device, FLASH_BF16_TOL))
    tiles = [(d, 2, causal) for d in HEAD_DIMS for causal in (True, False)]
    tiles += [(64, g, causal) for g in (1, 4, 8) for causal in (True, False)]
    for d, group, causal in tiles:
        h, tq, tk = 8, 150, 97 if causal else 201
        q = torch.randn((2, h, tq, d), generator=gen).to(device)
        k, v = (torch.randn((2, h // group, tk, d), generator=gen).to(device)
                for _ in range(2))
        label = f"tiles D={d} group={group} Tq={tq} Tk={tk} causal={causal}"
        err["f32"] = max(err["f32"], check_flash(label, q, k, v, causal, device))
        got = flash_attention(q, k, v, causal=causal)
        for layout, args in (
                ("strided", [x.transpose(1, 2).contiguous().transpose(1, 2)
                             for x in (q, k, v)]),
                ("misaligned", [misaligned(x) for x in (q, k, v)])):
            if device.type == "cuda" and not torch.equal(
                    flash_attention(*args, causal=causal), got):
                raise AssertionError(f"flash_attention {label} {layout}: not the "
                                     "aligned call's result")
        err["bf16"] = max(err["bf16"], check_flash(
            label + " bf16", *(x.to(torch.bfloat16) for x in (q, k, v)), causal,
            device, FLASH_BF16_TOL))
    return err


def flash_phase(lm: dict, device, reps: int) -> dict:
    """Phase 11 on phase 10's longest prefill: each layer's real q, k, v
    (B 4, T 1024, H 32, Hkv 8, D 64 at llama3.2-1b), the kernel against its
    plain version in float32 and on bfloat16 copies, a repeat bitwise
    equal; edge cases; per call at layer 0's inputs the kernel's, the
    plain version's and ``scaled_dot_product_attention``'s time (on K/V
    repeated to H heads, and with ``enable_gqa``; SDPA's ``is_causal`` is
    top-left too, and both are held to the plain version), the bound, and
    the kernel's time summed over every layer of the wave."""
    layers = capture_flash(lm["model"], lm["params"], lm["tokens"], lm["max_seq"], device)
    err = {"f32": 0.0, "bf16": 0.0}
    for i, (q, k, v) in enumerate(layers):
        shape = f"layer {i} q {tuple(q.shape)} k {tuple(k.shape)}"
        err["f32"] = max(err["f32"], check_flash(shape, q, k, v, True, device))
        err["bf16"] = max(err["bf16"], check_flash(
            shape + " bf16", *(x.to(torch.bfloat16) for x in (q, k, v)), True,
            device, FLASH_BF16_TOL))
    edge = flash_edge_cases(device)
    q, k, v = layers[0]
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    groups = h // hkv
    kr, vr = (x.repeat_interleave(groups, dim=1) for x in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    want = flash_attention_ref(q, k, v, causal=True)
    lib_err = max(float((sdpa(q, k, v, is_causal=True, enable_gqa=True) - want).abs().max()),
                  float((sdpa(q, kr, vr, is_causal=True) - want).abs().max()))
    if not lib_err <= TOL:
        raise AssertionError(f"scaled_dot_product_attention disagrees: {lib_err}")
    row = {"B": b, "H": h, "Hkv": hkv, "Tq": tq, "Tk": tk, "D": d, "causal": True,
           "layers": len(layers), "library_max_abs_err": lib_err}
    # each call keeps the card busy ~0.6-2.7 ms, far longer than its launch
    # takes: CUDA events (profiler windows over 10 back-to-back kernel
    # launches recorded 0, 8 and 7 of them on an H100)
    row.update(timings({
        "": lambda: flash_attention(q, k, v, causal=True),
        "plain_": lambda: flash_attention_ref(q, k, v, causal=True),
        "library_": lambda: sdpa(q, kr, vr, is_causal=True),
        "library_enable_gqa_": lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
    }, device, reps))
    row["vs_library"] = row["ms"] / row["library_ms"]
    row.update(flash_bound(b, h, hkv, tq, tk, d, True, q.element_size()))
    row["wave_ms"] = sum(time_ms(lambda a=a: flash_attention(*a, causal=True), device,
                                 reps, warmup=1) for a in layers)
    print("[kernel] flash_attention " + json.dumps(row))
    return {"row": row, "err": err, "edge": edge}


def flash_entry(fa: dict) -> dict:
    """The kernels line's ``flash_attention`` entry: one call at the
    captured shape (layer 0 of the longest prefill)."""
    row = fa["row"]
    return {
        "name": "flash_attention", "route": "cuda",
        "source": SOURCES["flash_attention"][0],
        "replaces": SOURCES["flash_attention"][1], "launches": 0,
        "max_abs_err": max(fa["err"]["f32"], fa["edge"]["f32"]),
        "bf16_max_abs_err": max(fa["err"]["bf16"], fa["edge"]["bf16"]),
        "ms": row["ms"], "ms_by": row["ms_by"], "wall_ms": row["wall_ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention(is_causal=True) "
                   "on K/V repeated to H heads beforehand",
        "library_enable_gqa_ms": row["library_enable_gqa_ms"],
        "vs_library": row["vs_library"],
        "wave_ms": row["wave_ms"],
        "shape": f"one call at layer 0's prefill inputs: B {row['B']}, H {row['H']}, "
                 f"Hkv {row['Hkv']}, T {row['Tq']}, D {row['D']}, causal, float32; "
                 f"wave_ms the kernel over all {row['layers']} layers (CUDA events)",
    }


def sum_rows(rows: list) -> dict:
    """Timed or bounded calls summed: times, bounds, bytes and operations;
    ``ms_by`` and ``bound_by`` of the sum."""
    keys = ("ms", "wall_ms", "plain_ms", "library_ms", "segment_ms",
            "bound_ms", "nnz_bound_ms", "layout_bound_ms", "bytes", "nnz_bytes",
            "flop")
    total = {k: None if any(r.get(k) is None for r in rows)
             else sum(r[k] for r in rows) for k in keys}
    total["ms_by"] = "/".join(sorted({r["ms_by"] for r in rows}))
    _, total["bound_by"] = _bound(total["bytes"], total["flop"])
    return total


def epoch_entry(name: str, calls: list, err: float, epoch: dict) -> dict:
    """One training kernel's entry: ``ms`` its device time in the profiled
    epoch ``epoch`` where the window held every launch, else ``calls_ms``
    (``ms_by`` says which); ``calls_ms``, ``wall_ms``, ``plain_ms``,
    ``library_ms``, the bounds (and ``segment_ms``) each layer's call timed
    or bounded alone at its width, summed."""
    total = sum_rows(calls)
    entry = {
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1], "launches": 0, "max_abs_err": err,
        "ms": epoch["device_ms"][name] if epoch["complete"] else total["ms"],
        "ms_by": ("profiled epoch" if epoch["complete"] else
                  "calls_ms: no profiler window held every launch of an epoch"),
        "calls_ms": total["ms"], "calls_ms_by": total["ms_by"],
        "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
        "bound_by": total["bound_by"], "nnz_bound_ms": total["nnz_bound_ms"],
        "library_ms": total["library_ms"], "wall_ms": total["wall_ms"],
        "shape": "one epoch of the path at full width: ms as ms_by says; the "
                 "other times and the bounds each layer's call alone, summed",
    }
    if total["layout_bound_ms"] is not None:
        entry["layout_bound_ms"] = total["layout_bound_ms"]
    if total["segment_ms"] is not None:
        entry["segment_ms"] = total["segment_ms"]
        entry["segment_ms_is"] = (
            "segment_softmax_aggregate per layer, summed: the forward beside "
            "the forward kernel, its whole autograd backward beside each "
            "backward pass; a composition of library calls (gather, "
            "scatter_reduce, index_add_), not one library kernel")
    return entry


def kernel_entries(serving_entry, launches_by_path, fk, ak, errs, dims,
                   epoch: dict, gat_epoch: dict, flash: dict) -> list:
    """The kernels line: one entry per kernel. ``launches`` sums every
    driven path (``launches_by_path`` splits it). The three GCN training
    kernels report one epoch of phase 4 (calls from phase 5), the three
    attention kernels one epoch of phase 7 (calls from phase 8), through
    ``epoch_entry``. ``bsr_spmm`` keeps its serving batch, and
    ``flash_attention`` (``flash``) one call of phase 10's prefill."""
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
    entries += [epoch_entry(name, calls, errs[name], epoch)
                for name, calls in per_epoch.items()]
    for kind, (name, _, _) in ATTENTION.items():
        calls = [ak["rows"][(kind, l)] for l in range(ak["layers"])]
        entries.append(epoch_entry(name, calls, errs[name], gat_epoch))
    entries[0]["max_abs_err"] = errs["bsr_spmm"]
    entries[0]["training_aT"] = rows[("spmm", dims[-1])]
    entries.append(dict(flash))
    for e in entries:
        by_path = {p: c[e["name"]] for p, c in launches_by_path.items()}
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path
    return entries


def run(sizes: Sizes, device) -> dict:
    """Phases 2 to 11 at ``sizes`` on ``device``; returns the kernels line
    and the details."""
    t_start = t0 = time.perf_counter()
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
        "layout_bound_ms": total["layout_bound_ms"],
        "library_ms": total["library_ms"],
        "wall_ms": total["wall_ms"],
        "column_build_ms": sum(l["build_ms"] for l in layers),
        "column_build_host_syncs": (None if layers[0]["host_syncs"] is None
                                    else sum(l["host_syncs"] for l in layers)),
        "shape": "one largest-bucket serving batch: layers 0-2 summed; wall_ms "
                 "CUDA events; column_build_ms the batch's nonzero columns, "
                 "built once per layer (synchronised host clock)",
    }
    del eng, ref

    # phase 4: full-batch training, the main path
    dims = [ds.features.shape[1], *sizes.train_hidden, ds.n_classes]
    n = len(dims) - 1
    gnn = (GNNProgram.load(ds, arch="GCN", aggregation="gcn")
           .initialize_layers(dims, "xavier", seed=0).set_optimizer(*ADAM))
    train = train_path("train", gnn, device, sizes.epochs, {
        "bsr_spmm_fused_epilogue": n, "bsr_spmm_masked": n - 1, "bsr_spmm": 1,
        "fused_adam": 2 * n})
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
    quick = train_path("quickstart", qgnn, device, sizes.epochs, {
        "bsr_spmm_fused_epilogue": qn, "bsr_spmm_masked": qn - 1,
        "bsr_spmm": 3, "fused_adam": 2 * qn})
    if quick["prog"].plan.layers[0].primitive != "cuda.feature_matmul_sparse":
        raise AssertionError("the quickstart's layer 0 must bind "
                             "cuda.feature_matmul_sparse")
    pair_err = pair_unequal_paddings(quick["prog"], device)
    qk = feature_operand_checks(qds, quick["prog"], device, reps=5)
    del quick["prog"], quick["ref"]
    phase_s = {"2-6": time.perf_counter() - t_start}

    # phase 7: GAT training on the arxiv analog, the attention main path
    t0 = time.perf_counter()
    gdims = [ds.features.shape[1], *sizes.gat_hidden, ds.n_classes]
    gn = len(gdims) - 1
    ggnn = (GNNProgram.load(ds, arch="GAT", aggregation="gcn",
                            gat_heads=sizes.gat_heads)
            .initialize_layers(gdims, "xavier", seed=0).set_optimizer(*GAT_ADAM))
    gat = train_path("gat", ggnn, device, sizes.epochs, {
        "bsr_attention_fwd": gn, "bsr_attention_bwd_row": gn,
        "bsr_attention_bwd_col": gn, "fused_adam": 5 * gn})
    if any(l.agg_primitive != "cuda.spmm_attention" for l in gat["prog"].plan.layers):
        raise AssertionError("every GAT layer must bind cuda.spmm_attention")
    phase_s["7"] = time.perf_counter() - t0
    # phase 8: the attention kernels on phase 7's operands and inputs
    t0 = time.perf_counter()
    ak = attention_phase(gat["prog"], device, reps=2)
    phase_s["8"] = time.perf_counter() - t0
    del gat["prog"], gat["ref"]
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # phase 9: GT on the quickstart at full scale
    t0 = time.perf_counter()
    tgnn = (GNNProgram.load(qds, arch="GT", aggregation="gcn",
                            gat_heads=sizes.gt_heads)
            .initialize_layers(qdims, "xavier", seed=0).set_optimizer(*ADAM))
    gt = train_path("gt", tgnn, device, sizes.epochs, {
        "bsr_attention_fwd": qn, "bsr_attention_bwd_row": qn,
        "bsr_attention_bwd_col": qn, "bsr_spmm": 2, "fused_adam": 6 * qn})
    gplan = gt["prog"].plan
    if gplan.layers[0].primitive != "cuda.feature_matmul_sparse":
        raise AssertionError("GT's layer 0 must bind cuda.feature_matmul_sparse")
    if any(l.agg_primitive != "cuda.spmm_attention" for l in gplan.layers):
        raise AssertionError("every GT layer must bind cuda.spmm_attention")
    attn_pair_err = attention_pair_unequal(gt["prog"], device)
    seg = tgnn.compile(engine="cuda", device=device, fused_optimizer=True,
                       fuse_attention=False, params=gt["weights"])
    if any(l.agg_primitive != "cuda.segment_softmax_aggregate"
           for l in seg.plan.layers):
        raise AssertionError("fuse_attention=False must bind the segment path")
    seg_loss = seg.train_epoch()["loss"]
    fused_loss = gt["summary"]["losses"][0]
    seg_rel = abs(seg_loss - fused_loss) / abs(fused_loss)
    print(f"[gt] segment path, one epoch: loss {seg_loss} against the fused "
          f"{fused_loss} (relative {seg_rel:.2e})")
    if not seg_rel <= 2e-4:
        raise AssertionError(f"segment epoch loss {seg_loss} vs fused {fused_loss}")
    gt["summary"]["segment_epoch"] = {"loss": seg_loss, "rel_diff": seg_rel}
    del gt["prog"], gt["ref"], seg
    phase_s["9"] = time.perf_counter() - t0

    # phase 10: LM serving at llama3.2-1B width, the flash kernel's main path
    t0 = time.perf_counter()
    lm = lm_serving_phase(sizes, device)
    lm_summary = lm["summary"]
    phase_s["10"] = time.perf_counter() - t0
    # phase 11: the flash kernel on phase 10's prefill inputs
    t0 = time.perf_counter()
    fa = flash_phase(lm, device, reps=10)
    phase_s["11"] = time.perf_counter() - t0
    del lm
    if device.type == "cuda":
        torch.cuda.empty_cache()

    attn_err = max(ak["err"]["edge"], attn_pair_err)
    nonfinite = max(edge["nonfinite"], fk["err"]["nonfinite"])
    errs = {"bsr_spmm": max(kern["max_abs_err"], fk["err"]["spmm"], pair_err,
                            qk["err"], nonfinite),
            "bsr_spmm_fused_epilogue": max(fk["err"]["fused"], edge["fused"], pair_err,
                                           nonfinite),
            "bsr_spmm_masked": max(fk["err"]["masked"], edge["masked"], pair_err,
                                   nonfinite),
            "fused_adam": fk["err"]["adam"],
            **{name: max(ak["err"][kind], attn_err)
               for kind, (name, _, _) in ATTENTION.items()}}
    serving_counts = {k: 0 for k in KERNELS}
    serving_counts["bsr_spmm"] = serve["launches"]
    by_path = {"serving": serving_counts,
               "train": train["summary"]["launches"],
               "quickstart": quick["summary"]["launches"],
               "gat": gat["summary"]["launches"],
               "gt": gt["summary"]["launches"],
               "lm_serving": lm_summary["launches"]}
    entries = kernel_entries(serving_entry, by_path, fk, ak, errs, dims,
                             train["summary"]["profile"],
                             gat["summary"]["profile"], flash_entry(fa))
    entries[0]["quickstart"] = qk["rows"]
    return {"kernels": entries, "layers": layers, "serve": serve,
            "sample_s": kern["sample_s"], "train": train["summary"],
            "quickstart": quick["summary"], "gat": gat["summary"],
            "gt": gt["summary"], "lm": lm_summary, "flash": fa, "phase_s": phase_s,
            "attention_hub": ak["hub"], "quickstart_spmm": qk["rows"],
            "kernel_rows": {str(k): v for k, v in fk["rows"].items()},
            "attention_rows": {str(k): v for k, v in ak["rows"].items()}}


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
            spilling = {k: int(a) + int(b) for k, a, b in re.findall(
                r"Function properties for (\S+)\n\s*\d+ bytes stack frame, "
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
                if int(a) + int(b)}
            print(f"[build] ptxas {name}: registers {regs[0]}-{regs[-1]}, "
                  f"spilled bytes {sum(spilling.values())}"
                  + (f" in {spilling}" if spilling else ""))

    clocks = {"query": CLOCKS, "start": card_line(CLOCKS)}
    print(f"[card] {CLOCKS}: {clocks['start']}")
    t_all = time.perf_counter()
    result = run(Sizes(), device)
    clocks["end"] = card_line(CLOCKS)
    print(f"[card] {CLOCKS} after the phases: {clocks['end']}")
    serve = result["serve"]
    print(f"[serve] {serve['requests']} requests, {serve['req_per_s']:.2f} req/s, "
          f"p50 {serve['p50_ms']:.2f} ms, p99 {serve['p99_ms']:.2f} ms, "
          f"warmup {serve['warmup_s']:.2f}s, sample one 256-seed batch "
          f"{result['sample_s']:.3f}s on {card}")
    for path in ("train", "quickstart", "gat", "gt"):
        r = result[path]
        print(f"[{path}] {len(r['losses'])} epochs, median epoch "
              f"{r['epoch_ms_median']:.1f} ms (torch reference "
              f"{r['ref_epoch_ms_median']:.1f} ms), loss {r['losses'][0]:.4f} -> "
              f"{r['losses'][-1]:.4f}, max rel diff {r['max_rel_diff']:.2e}, "
              f"peak {r['peak_mem_bytes'] / 2**30:.2f} GiB on {card}")
    lm = result["lm"]
    print(f"[lm] {lm['arch']}: {lm['requests']} requests in {lm['waves']} waves, "
          f"prefill {', '.join(f'{x:.1f}' for x in lm['prefill_ms'])} ms a wave "
          f"(torch {', '.join(f'{x:.1f}' for x in lm['ref_prefill_ms'])}), decode "
          f"{lm['decode_step_ms_median']:.2f} ms a step (torch "
          f"{lm['ref_decode_step_ms_median']:.2f}), {lm['tokens_per_s']:.1f} tokens/s, "
          f"peak {lm['peak_mem_bytes'] / 2**30:.2f} GiB on {card}")
    print(f"[done] phases 2-11 in {time.perf_counter() - t_all:.1f}s: "
          + ", ".join(f"{k} {v:.1f}s" for k, v in result["phase_s"].items()))
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump({"card": card, "clocks": clocks, "build_s": built, **result}, fh,
                  indent=1)
    print(card)
    print(json.dumps({"kernels": result["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
