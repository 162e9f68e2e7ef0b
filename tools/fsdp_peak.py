"""Where an FSDP rank step's peak allocation goes on the card.

Four rank processes share one card at (data 2, model 2) and run
``chip_smoke.py`` phase 27 (b)'s step: starcoder2-3b at its published
widths, ``--layers`` of its layers, FSDP on, one 2 x 1,024 batch a data
rank, bfloat16, remat, fused AdamW. After one warm step each rank reads
its second step's peak allocation over what it held before, beside the
dry run's simulated peak of the same step (``launch/specs.py``,
``launch/step_cost.py``). Rank 0 records the allocator's history over that
step and prints the blocks alive at the peak, grouped by size and the
Python frames that allocated them. Then every rank runs the loss and its
gradients once more and prints the bytes still allocated after the
backward, after dropping the loss, and after a garbage collection (a
reference cycle shows as bytes only the collection frees).

    python3 tools/fsdp_peak.py [--layers 10]
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.sharding import ShardingRules, use_rules  # noqa: E402
from repro_torch.launch.mesh import RankPool, make_mesh  # noqa: E402
from repro_torch.launch.specs import build_cell  # noqa: E402
from repro_torch.launch.step_cost import reckon  # noqa: E402
from repro_torch.models.model_zoo import build_model, make_train_step  # noqa: E402
from repro_torch.training.optimizer import adamw, tree_leaves, tree_unflatten  # noqa: E402

CELL = dict(batch=4, seq_len=1024)


def _cfg(layers: int):
    return dataclasses.replace(get_config("starcoder2-3b"), n_layers=layers)


def _peak_blocks(snapshot: dict, device: int) -> tuple:
    """The allocator trace's highest sum of live blocks, and the blocks
    alive there grouped by (size, allocating frames), largest first."""
    live, cur, best, at = {}, 0, 0, {}
    for e in snapshot["device_traces"][device]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
            cur += e["size"]
            if cur > best:
                best, at = cur, dict(live)
        elif e["action"] == "free_requested" and e["addr"] in live:
            cur -= live.pop(e["addr"])["size"]
    groups = collections.Counter()
    for e in at.values():
        frames = [f"{os.path.basename(f['filename'])}:{f['line']}:{f['name']}"
                  for f in e.get("frames", []) if "/repro_torch/" in f["filename"]][:4]
        groups[(e["size"], " < ".join(frames))] += 1
    top = sorted(((size * n, size, n, where) for (size, where), n in groups.items()),
                 reverse=True)
    return best, top[:24]


def rank(r: int, layers: int) -> dict:
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = _cfg(layers)
    mesh = make_mesh(2, 2)
    cell = build_cell("starcoder2-3b", "train_4k", cfg=cfg, mesh=mesh, fsdp=True, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0), **CELL)
    params, state, batch = cell.args
    del cell
    model = build_model(cfg, inner="cuda", remat="layer")
    step = make_train_step(model, adamw(3e-4, fused=True))
    out = {}
    with use_rules(ShardingRules(mesh, cfg, fsdp=True)):
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if r == 0:
            torch.cuda.memory._record_memory_history(max_entries=400000)
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        out["peak"] = torch.cuda.max_memory_allocated() - before
        if r == 0:
            snapshot = torch.cuda.memory._snapshot()
            torch.cuda.memory._record_memory_history(enabled=None)
            out["trace_peak"], out["top"] = _peak_blocks(snapshot, dev.index)
            del snapshot
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        cast = [p.to(torch.bfloat16) for p in leaves]
        start = torch.cuda.memory_allocated()
        loss, metrics = model.loss(tree_unflatten(params, cast), batch)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        after_grad = torch.cuda.memory_allocated() - start
        del loss, metrics
        after_del = torch.cuda.memory_allocated() - start
        collected = gc.collect()
        out["after_backward"] = {"grad": after_grad, "del": after_del,
                                 "gc": torch.cuda.memory_allocated() - start,
                                 "objects_collected": collected}
        del grads, cast, leaves
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fsdp_peak: needs an NVIDIA card", file=sys.stderr)
        return 1
    meta = build_cell("starcoder2-3b", "train_4k", cfg=_cfg(args.layers), mesh=(2, 2), fsdp=True,
                      device="meta", **CELL)
    _, cost = reckon(meta.step, *meta.args)
    with RankPool(4, device="cuda") as pool:
        res = pool.run(rank, 4, (args.layers,))
    print(f"simulated peak {cost.peak}; measured {[r['peak'] for r in res]}; "
          f"rank 0's trace {res[0]['trace_peak']}")
    for total, size, n, where in res[0]["top"]:
        print(f"  {total:>14,} = {n:>3} x {size:>12,}  {where}")
    print("bytes over the start after the backward / dropping the loss / a collection: "
          + "; ".join(str(r["after_backward"]) for r in res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
