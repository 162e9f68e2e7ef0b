#!/usr/bin/env python3
"""One sampled training step of ``chip_smoke.py``'s GT path, by operator.

    python3 tools/sampled_step_ops.py [--src DIR] [--scale S] [--device D]

The path is phase 14 (c): ``MiniBatchTrainer`` on the ``cuda`` engine,
GT [8710, 32, 70] with 4 heads on the corafull analog (``--scale`` 1.0),
fanouts (10, 5), the train mask cut to its first 1,024 nodes, one
1,024-seed batch (sampled with seed 17, as the phase's probe batch), fused
Adam 0.01. Its layer 0 binds ``gather.feature_matmul_sparse``: X·W over
the batch's padded COO feature operand.

On the batch, with the data on the card: the step's synchronised host
time (median of 5 after 2 more), then one step under ``torch.profiler``
(CPU and CUDA activity, after a warmup step): device ms and calls by
operator (each kernel counted under the operator that launched it), and
the longest device kernels by name. The step's result is dropped each
time, so every step starts from the same weights.

``--src`` names the ``src`` directory that ``repro_torch`` is imported
from (default: this checkout's), so the same script measures another tree
of the port. Prints the card's name and power limit, then one JSON line.
``--device cpu`` with a small ``--scale`` rehearses the script off the
card (host times and CPU operators only).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = 1024
TOP = 12


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("sampled_step_ops: needs an NVIDIA card (or --device cpu)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.graph.datasets import generate_dataset
    from repro_torch.kernels import build
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.training.optimizer import adam
    from repro_torch.training.trainer import MiniBatchTrainer

    if on_card:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout.strip()
        build.build(["bsr_spmm", "bsr_attention", "fused_adam"])
    else:
        card = "cpu"
    print(card)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    ds = generate_dataset("corafull", scale=args.scale, seed=0)
    mask = np.zeros_like(ds.train_mask)
    mask[np.flatnonzero(ds.train_mask)[:SEEDS]] = True
    cfg = GNNConfig(kind="GT", layer_dims=[ds.features.shape[1], 32, ds.n_classes],
                    aggregation="gcn", gat_heads=4)
    tr = MiniBatchTrainer(cfg, ds.graph, ds.features, ds.labels, mask,
                          adam(0.01, fused=True), fanouts=(10, 5),
                          batch_size=SEEDS, engine="cuda", seed=0, device=device)
    batch = tr.sampler.sample_batch(tr.train_ids[:SEEDS], tr.features,
                                    tr.labels_np, rng=np.random.default_rng(17))
    data = tr._batch_arrays(batch, train=True)

    def step():
        loss = tr._step(tr.params, tr.opt_state, data)[2]
        sync()
        return loss

    times = []
    for _ in range(7):
        sync()
        t0 = time.perf_counter()
        step()
        times.append((time.perf_counter() - t0) * 1e3)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with profile(activities=activities, schedule=sched) as prof:
        for _ in range(2):
            step()
            prof.step()
    events = [e for e in prof.key_averages() if not e.key.startswith("ProfilerStep")]
    ops = sorted((e for e in events if e.key.startswith("aten::")),
                 key=lambda e: (e.self_device_time_total, e.self_cpu_time_total),
                 reverse=True)
    kernels = sorted((e for e in events if e.device_type.name == "CUDA"),
                     key=lambda e: e.self_device_time_total, reverse=True)
    rows, cols, vals = batch.feat_coo
    result = {
        "src": os.path.abspath(args.src), "card": card,
        "layer0": tr.plan.layers[0].primitive,
        "feat_entries": int(rows.shape[0]),
        "feat_nonzeros": int(np.count_nonzero(vals)),
        "step_ms_median": float(np.median(times[2:])), "step_ms": times[2:],
        "device_busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
        "ops": [{"op": e.key, "device_ms": e.self_device_time_total / 1e3,
                 "cpu_ms": e.self_cpu_time_total / 1e3, "calls": e.count}
                for e in ops[:TOP]],
        "kernels": [{"kernel": e.key[:160], "device_ms": e.self_device_time_total / 1e3,
                     "launches": e.count} for e in kernels[:TOP]],
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
