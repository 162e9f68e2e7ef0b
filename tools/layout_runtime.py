#!/usr/bin/env python3
"""Phases 4, 6, 17 and 18 of ``chip_smoke.py`` alone: the layout stage, γ
and the runtime, with the identity-layout runs they are compared with.

    python3 tools/layout_runtime.py [--device D] [--scale S] [--quick-scale S]

Phase 4 (the arxiv analog's GCN [128, 256, 256, 40]) and phase 6 (the
quickstart, GCN [8710, 32, 70] on the corafull analog) run first, as in
``chip_smoke.py``, gates and all; then phase 17 (``plan_layout`` on both
graphs with a fresh cache, ``layout="auto"`` training against them, γ at
two shapes, the quickstart's epoch with layer 0 forced each way) and
phase 18 (the guarded GCN with a NaN epoch, a killed save and a bitwise
resume; sampled SAGE-mean interrupted and resumed). Any failed gate
raises. Prints the card's name and power limit and each phase's lines;
the details go to ``chiprun_out/layout_runtime.json``. ``--device cpu``
with small scales rehearses it off the card (no timing of the kernels).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--quick-scale", type=float, default=1.0)
    args = ap.parse_args()
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("layout_runtime: needs an NVIDIA card (or --device cpu)",
              file=sys.stderr)
        return 1
    sizes = dataclasses.replace(cs.Sizes(), scale=args.scale,
                                quick_scale=args.quick_scale)
    if on_card:
        print(cs.card_line())
        t0 = time.perf_counter()
        cs.build.build(cs.LIBRARIES)
        print(f"[build] {time.perf_counter() - t0:.1f}s")
    ds = cs.generate_dataset(sizes.dataset, scale=sizes.scale, seed=0)
    dims = [ds.features.shape[1], *sizes.train_hidden, ds.n_classes]
    n = len(dims) - 1
    gnn = (cs.GNNProgram.load(ds, arch="GCN", aggregation="gcn")
           .initialize_layers(dims, "xavier", seed=0).set_optimizer(*cs.ADAM))
    train_expect = {"bsr_spmm_fused_epilogue": n, "bsr_spmm_masked": n - 1,
                    "bsr_spmm": 1, "fused_adam": 1}
    train = cs.train_path("train", gnn, device, sizes.epochs, train_expect)
    del train["prog"], train["ref"]
    qds = cs.generate_dataset(sizes.quick_dataset, scale=sizes.quick_scale,
                              seed=0)
    qdims = [qds.features.shape[1], *sizes.quick_hidden, qds.n_classes]
    qn = len(qdims) - 1
    qgnn = (cs.GNNProgram.load(qds, arch="GCN", aggregation="gcn")
            .initialize_layers(qdims, "xavier", seed=0).set_optimizer(*cs.ADAM))
    quick_expect = {"bsr_spmm_fused_epilogue": qn, "bsr_spmm_masked": qn - 1,
                    "bsr_spmm": 3, "fused_adam": 1}
    quick = cs.train_path("quickstart", qgnn, device, sizes.epochs,
                          quick_expect)
    del quick["prog"], quick["ref"]
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with cs.layout_cache() as cache:
        lay = {"train": cs.plan_phase("layout-arxiv", ds.graph, dims[1],
                                      device, cache)}
        auto = {"train": cs.auto_path("train-auto", gnn, train, device,
                                      sizes.epochs, train_expect)}
        lay["quickstart"] = cs.plan_phase("layout-quickstart", qds.graph,
                                          qdims[1], device, cache)
        auto["quickstart"] = cs.auto_path("quickstart-auto", qgnn, quick,
                                          device, sizes.epochs, quick_expect)
    gamma = cs.gamma_phase(qgnn, quick, qds, device, sizes.epochs)
    t17 = time.perf_counter() - t0
    t0 = time.perf_counter()
    runtime = cs.runtime_phase(gnn, train, device, sizes.epochs, train_expect)
    resume = cs.sampled_resume(ds, sizes, device)
    t18 = time.perf_counter() - t0
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "layout_runtime.json"), "w") as fh:
        json.dump({"card": cs.card_line() if on_card else "cpu",
                   "train": train["summary"], "quick": quick["summary"],
                   "layout": lay, "auto": auto, "gamma": gamma,
                   "runtime": runtime, "resume": resume, "t17": t17,
                   "t18": t18}, fh, indent=1, default=str)
    print(f"[done] phase 17 {t17:.1f}s, phase 18 {t18:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
