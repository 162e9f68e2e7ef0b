#!/usr/bin/env python3
"""Chaos soak: randomized fault schedules against the port's runtime.

    python3 tools/chaos_soak.py [--schedules N] [--base-seed S] [--device D]
                                [--work-dir DIR]

The counterpart of ``benchmarks/chaos_soak.py``. Each schedule is one
seeded draw of (target, fault sites, steps) from
:class:`numpy.random.Generator`, in the JAX soak's order. Targets:

  full_batch   — guarded ``FullBatchTrainer`` + grad poison + checkpoint
                 writer kills
  mini_batch   — guarded ``MiniBatchTrainer`` + grad poison through the
                 sampled path
  distributed  — ROADMAP.md Queue 1, item 7: reported as skipped (the JAX
                 soak skips it below 2 devices too)
  serving      — ``GNNServingEngine`` under random submission bursts,
                 deadlines, and queue bounds (the degradation rungs)

Every trial asserts **end-state properties**, not step-by-step behaviour
(DESIGN.md §14): training either completes with finite committed params
and a finite final loss, or raises a *typed* error — it never silently
diverges; a checkpoint directory is always restorable to a consistent
step; a serving queue always drains with each request either answered
with well-formed, finite, correctly-shaped logits (labeled with which
degradation rung answered it) or explicitly rejected — never hung.

Default soak is ``N_SCHEDULES`` schedules on ``--device cuda``; prints a
``name,us_per_call,derived`` row per schedule. Any property violation
raises ``ChaosPropertyError`` naming the schedule seed, so a failure
reproduces with ``--schedules`` and the printed seed alone. Checkpoints
go to temporary directories under ``--work-dir`` (``chiprun_out/chaos_soak``
by default), removed after each trial.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.backends.registry import DIST_ITEM  # noqa: E402
from repro_torch.graph.datasets import generate_dataset  # noqa: E402
from repro_torch.models.gnn import GNNConfig, GNNModel, init_params  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    FaultInjector,
    FaultSpec,
    GuardPolicy,
    InjectedFault,
    restore_checkpoint,
)
from repro_torch.serving.gnn_engine import GNNRequest, GNNServingEngine  # noqa: E402
from repro_torch.training.optimizer import adam, tree_leaves  # noqa: E402
from repro_torch.training.trainer import FullBatchTrainer, MiniBatchTrainer  # noqa: E402

N_SCHEDULES = 24
_EPOCHS = 6
#: the CUDA sources the trials' kernels are built from, in parallel up front
_LIBRARIES = ["bsr_spmm", "bsr_spmm_fused", "bsr_spmm_masked", "bsr_attention"]


class ChaosPropertyError(AssertionError):
    def __init__(self, seed: int, target: str, prop: str, detail: str):
        super().__init__(
            f"schedule seed={seed} target={target}: property {prop!r} "
            f"violated: {detail}")
        self.seed = seed
        self.prop = prop


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.1f},{derived}"


def _finite_tree(tree) -> bool:
    return all(bool(torch.isfinite(l).all()) for l in tree_leaves(tree))


def _dataset(seed: int):
    return generate_dataset("corafull", scale=1.0, seed=seed, max_nodes=96)


def _config(ds, rng):
    kind = rng.choice(["GCN", "SAGE", "GAT"])
    return GNNConfig(kind=str(kind),
                     layer_dims=[ds.features.shape[1], 8, ds.n_classes],
                     aggregation="mean" if kind == "SAGE" else "sum",
                     gat_heads=2)


def _grad_faults(rng, n_steps, rank=None):
    """1-3 random grad-poison firings over the step range."""
    n = int(rng.integers(1, 4))
    steps = frozenset(int(s) for s in rng.integers(1, n_steps, size=n))
    mode = str(rng.choice(["nan", "inf"]))
    return FaultSpec(site="grad", steps=steps, mode=mode, rank=rank)


def _check(ok: bool, seed, target, prop, detail=""):
    if not ok:
        raise ChaosPropertyError(seed, target, prop, detail)


# ---------------------------------------------------------------------------
# per-target trials
# ---------------------------------------------------------------------------


def _trial_full_batch(seed: int, rng, device, work_dir: str) -> str:
    ds = _dataset(seed)
    cfg = _config(ds, rng)
    faults = [_grad_faults(rng, _EPOCHS)]
    if rng.random() < 0.5:  # half the schedules also kill a ckpt writer
        faults.append(FaultSpec(site="checkpoint_kill",
                                steps=frozenset(
                                    [int(rng.choice([2, 4, 6]))])))
    inj = FaultInjector(seed=seed, faults=faults)
    model = GNNModel(cfg, ds.graph, device=device)
    params = init_params(cfg, torch.Generator().manual_seed(seed), device)
    with tempfile.TemporaryDirectory(dir=work_dir) as ckpt:
        tr = FullBatchTrainer(model, adam(1e-2), ckpt_dir=ckpt,
                              ckpt_every=2, guard=GuardPolicy(),
                              injector=inj)
        outcome, res = "completed", None
        try:
            res = tr.fit(params, ds.features, ds.labels, ds.train_mask,
                         epochs=_EPOCHS)
        except InjectedFault:
            outcome = "writer_killed"  # typed raise, the legal exit
        if res is not None:
            _check(_finite_tree(res.final_params), seed, "full_batch",
                   "params_finite", "guard committed a non-finite update")
            _check(np.isfinite(res.losses[-1]), seed, "full_batch",
                   "loss_finite", f"final loss {res.losses[-1]}")
        # whatever the (possibly killed) writer left behind must restore
        # to a consistent step with a finite payload — never a torn write
        target = (params, tr.opt.init(params))
        (p2, _), step = restore_checkpoint(ckpt, target)
        _check(step is None or (0 < step <= _EPOCHS), seed, "full_batch",
               "ckpt_step_consistent", f"restored step {step}")
        if step is not None:
            _check(_finite_tree(p2), seed, "full_batch",
                   "ckpt_payload_finite", "restored params non-finite")
    skips = ((res.guard or {}).get("skipped", 0)
             if res is not None else "n/a")
    return f"outcome={outcome} guard_skips={skips}"


def _trial_mini_batch(seed: int, rng, device, work_dir: str) -> str:
    ds = _dataset(seed)
    cfg = _config(ds, rng)
    n_steps = _EPOCHS * 4  # ~batches per epoch x epochs
    inj = FaultInjector(seed=seed, faults=[_grad_faults(rng, n_steps)])
    tr = MiniBatchTrainer(cfg, ds.graph, ds.features, ds.labels,
                          ds.train_mask, adam(1e-2), fanouts=(3, 3),
                          batch_size=16, n_buckets=2, seed=seed,
                          guard=GuardPolicy(), injector=inj, device=device)
    res = tr.fit(epochs=3)
    _check(_finite_tree(res.final_params), seed, "mini_batch",
           "params_finite", "guard committed a non-finite update")
    _check(np.isfinite(res.losses[-1]), seed, "mini_batch",
           "loss_finite", f"final loss {res.losses[-1]}")
    skips = (res.guard or {}).get("skipped", 0)
    return f"guard_skips={skips}"


def _trial_distributed(seed: int, rng, device, work_dir: str) -> str:
    return f"skipped=not_ported ({DIST_ITEM})"


def _trial_serving(seed: int, rng, device, work_dir: str) -> str:
    ds = _dataset(seed)
    cfg = _config(ds, rng)
    tr = MiniBatchTrainer(cfg, ds.graph, ds.features, None, None, None,
                          fanouts=(3, 3), batch_size=16, n_buckets=2,
                          seed=seed, device=device)
    eng = GNNServingEngine(
        tr, wave_size=int(rng.integers(2, 6)),
        use_cache=bool(rng.random() < 0.7),
        max_queue=int(rng.integers(4, 12)),
        overload_threshold=int(rng.integers(2, 6)),
        default_deadline_s=(None if rng.random() < 0.5
                            else float(rng.uniform(0.0, 30.0))),
        seed=seed)
    n_req = int(rng.integers(8, 25))
    reqs = [GNNRequest(rid=i,
                       node_ids=rng.integers(0, ds.graph.n_rows,
                                             size=int(rng.integers(1, 5))))
            for i in range(n_req)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    n_served = 0
    for r in reqs:
        _check(r.done, seed, "serving", "no_hung_requests",
               f"rid={r.rid} not done after drain")
        if r.rejected:
            _check(r.logits is None, seed, "serving", "reject_is_labeled",
                   f"rid={r.rid} rejected but carries logits")
            continue
        n_served += 1
        _check(r.logits is not None and
               r.logits.shape == (r.node_ids.shape[0], eng.n_classes),
               seed, "serving", "logits_well_formed",
               f"rid={r.rid} shape {None if r.logits is None else r.logits.shape}")
        _check(bool(np.isfinite(r.logits).all()), seed, "serving",
               "logits_finite", f"rid={r.rid}")
        _check(r.degraded in (None, "stale", "fanout"), seed, "serving",
               "degradation_labeled", f"rid={r.rid} rung {r.degraded!r}")
    _check(len(eng.queue) == 0, seed, "serving", "queue_drained",
           f"{len(eng.queue)} left")
    return f"served={n_served}/{n_req}"


_TRIALS = {
    "full_batch": _trial_full_batch,
    "mini_batch": _trial_mini_batch,
    "distributed": _trial_distributed,
    "serving": _trial_serving,
}


def soak(n_schedules: int = N_SCHEDULES, base_seed: int = 0, device="cuda",
         work_dir: str = os.path.join(ROOT, "chiprun_out", "chaos_soak")):
    """Yield one CSV row per schedule; raises ChaosPropertyError on the
    first violated end-state property."""
    device = torch.device(device)
    os.makedirs(work_dir, exist_ok=True)
    targets = sorted(_TRIALS)
    for i in range(n_schedules):
        seed = base_seed + i
        rng = np.random.default_rng(seed)
        target = targets[i % len(targets)]  # round-robin, faults random
        t0 = time.perf_counter()
        detail = _TRIALS[target](seed, rng, device, work_dir)
        dt = time.perf_counter() - t0
        yield csv_row(f"chaos/{target}", dt * 1e6,
                      f"seed={seed} {detail}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--schedules", type=int, default=N_SCHEDULES)
    ap.add_argument("--base-seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--work-dir",
                    default=os.path.join(ROOT, "chiprun_out", "chaos_soak"))
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            print("chaos_soak: needs an NVIDIA card (or --device cpu)",
                  file=sys.stderr)
            return 1
        from repro_torch.kernels import build

        build.build(_LIBRARIES)
        print(f"# {torch.cuda.get_device_name(0)}")
    print("name,us_per_call,derived")
    for row in soak(args.schedules, args.base_seed, args.device,
                    args.work_dir):
        print(row)
    print(f"# chaos soak: {args.schedules} schedules, all properties held")
    return 0


if __name__ == "__main__":
    sys.exit(main())
