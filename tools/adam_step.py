#!/usr/bin/env python3
"""One fused Adam step over each full-batch training path's parameter tree
on one NVIDIA card: its host time, its launches and its outputs.

    python3 tools/adam_step.py [--src DIR] [--reps N] [--save FILE]
    python3 tools/adam_step.py --compare FILE FILE

The trees are ``chip_smoke.py``'s four training paths at their full
widths, made by ``models/gnn.py:init_params`` from seed 0: GCN [128, 256,
256, 40] (ogbn-arxiv, 6 leaves), GCN [8710, 32, 70] (the quickstart on
corafull, 4), GAT [128, 750, 750, 40] with 3 heads (15) and GT [8710, 32,
70] with 4 heads (12). Gradients and Adam's moments are random from seed
1, on the card; the step is the third. For each tree, ``adam(0.01, 0.9,
0.999, fused=True).update``: the host clock from a synchronised card to
the update's end, synchronised, median, min and max over ``--reps`` calls
after 5 more, and the kernel's launches in one call.

``--src`` names the ``src`` directory that ``repro_torch`` is imported
from (default: this checkout's), so the same script measures another tree
of the port, such as its parent commit unpacked beside it; it uses only
``init_params``, ``GNNConfig``, ``adam``, ``AdamState`` and
``fused_adam.launches``. ``--save`` writes one step's outputs over the GCN
and GAT trees (``torch.save``, on the CPU); ``--compare`` says whether two
such files are bitwise equal, leaf by leaf, and exits 1 where they are
not. Prints the card's name and power limit, then one JSON line.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (path, arch, layer widths, heads)
TREES = [("train", "GCN", [128, 256, 256, 40], 4),
         ("quickstart", "GCN", [8710, 32, 70], 4),
         ("gat", "GAT", [128, 750, 750, 40], 3),
         ("gt", "GT", [8710, 32, 70], 4)]
SAVED = ("train", "gat")


def compare(a: str, b: str) -> int:
    x, y = torch.load(a), torch.load(b)
    out = {}
    for path in SAVED:
        pairs = list(zip(x[path], y[path]))
        same = len(x[path]) == len(y[path]) and all(
            u.shape == w.shape and torch.equal(u, w) for u, w in pairs)
        out[path] = {"tensors": len(pairs), "bitwise_equal": same,
                     "max_abs_diff": max(float((u - w).abs().max()) if u.numel() else 0.0
                                         for u, w in pairs)}
    print(json.dumps(out))
    return 0 if all(v["bitwise_equal"] for v in out.values()) else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--save")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    if not torch.cuda.is_available():
        print("adam_step: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels.fused_adam import fused_adam
    from repro_torch.models.gnn import GNNConfig, init_params
    from repro_torch.training.optimizer import AdamState, adam, tree_leaves, tree_map

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    gen = torch.Generator().manual_seed(1)
    opt = adam(0.01, 0.9, 0.999, fused=True)
    result, saved = {"src": os.path.abspath(args.src), "card": card}, {}
    for path, arch, dims, heads in TREES:
        params = init_params(GNNConfig(arch, dims, gat_heads=heads),
                             torch.Generator().manual_seed(0), device)
        rand = lambda p, s=1.0: (s * torch.randn(p.shape, generator=gen)).to(device)  # noqa: E731
        grads = tree_map(rand, params)
        state = AdamState(step=2, m=tree_map(lambda p: rand(p, 0.1), params),
                          v=tree_map(lambda p: 0.01 * torch.rand(
                              p.shape, generator=gen).to(device), params))
        times = []
        with torch.no_grad():
            for _ in range(args.reps + 5):
                torch.cuda.synchronize(device)
                before = fused_adam.launches
                t0 = time.perf_counter()
                new_params, new_state = opt.update(grads, state, params)
                torch.cuda.synchronize(device)
                times.append((time.perf_counter() - t0) * 1e3)
                launches = fused_adam.launches - before
        times = times[5:]
        leaves = tree_leaves(params)
        result[path] = {"leaves": len(leaves),
                        "params": int(sum(p.numel() for p in leaves)),
                        "launches_a_step": launches,
                        "update_host_ms_median": float(np.median(times)),
                        "update_host_ms_min": min(times),
                        "update_host_ms_max": max(times), "reps": args.reps}
        if path in SAVED:
            saved[path] = [t.cpu() for t in (*tree_leaves(new_params),
                                             *tree_leaves(new_state.m),
                                             *tree_leaves(new_state.v))]
        print(f"[{path}] {json.dumps(result[path])}")
    if args.save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save)), exist_ok=True)
        torch.save(saved, args.save)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
