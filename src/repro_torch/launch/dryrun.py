"""Dry run of every (architecture × ``SHAPES``) cell for one H100, or for
one rank of a (data × model) mesh of H100s.

The single-card counterpart of ``repro/launch/dryrun.py``, which compiles
each cell's step on a fake 256- or 512-chip TPU mesh and records its
``memory_analysis()`` and loop-aware cost. Here each cell's step runs once
over value-less ``meta`` tensors (``launch/specs.py``) under
``launch/step_cost.py:StepCost``, on the path the card runs (flash
attention in prefill, one ``fused_adam`` call a training step), and the
record says:

- the bytes held before the step by kind (parameters, AdamW state, cache,
  inputs), the simulated peak over them, and whether the cell fits the
  card's 80 GB: a training cell with the fewest power-of-two
  ``microbatches`` that fit, a serving cell whole or else the largest
  batch of its length that fits; a cell whose persistent state alone
  exceeds 80 GB says so;
- the counted FLOPs (by dtype class), the model FLOPs and their ratio,
  the operators' bytes beside the least bytes the step must move, and
  the roofline terms (``launch/roofline.py``): ``dominant``,
  ``bound_time_s``, ``roofline_fraction``;
- the parameters initialised and ``count_params``' closed form (they part
  for deepseek-v3-671b: ROADMAP.md Queue 3, item 9), the kernels' calls,
  and the dry run's seconds.

With ``--mesh DxM`` each cell is one rank's of a ``D x M`` mesh
(``launch/specs.py``: the rank's shards, its data rank's rows): the fit is
the rank's on its card, the roofline the mesh's (``launch/roofline.py``),
with the collectives' bytes and counts by kind (``collective_counts``),
the bytes a rank sends for them by a ring (``collective_link_bytes``)
and their term over NVLink; a cell whose configuration the port has no
runtime for under the rules yet (SSM and xLSTM layers) is skipped with
``tensor_parallel.check_tp``'s reason: ``--all --mesh 1x8`` and ``--mesh
2x4`` reckon the dense family's 16 cells (FSDP where the JAX package's
rule turns it on), dbrx-132b's 3 and deepseek-v3-671b's 3, their experts
over ``(data, model)`` (at ``2x4`` the tokens' all-to-alls over ``data``
among the collectives; deepseek's latent all-gathered over ``model``),
and whisper-tiny's 3, and skip 15 (zamba2-7b's 4, xlstm-1.3b's 4 and the
7 cells no mesh runs). ``--mesh 1x1`` (the default) is the one-card run.

The JAX dry run's knobs: ``--remat {layer,none}``, ``--ssm-chunk N``
(the SSD and mLSTM chunk), ``--ep2d`` (2D expert parallelism forced on
a mesh), ``--microbatches N`` (a training cell at N microbatches instead
of the fewest that fit) and ``--moe-impl {,sorted,dense}``; each record
carries the knobs it ran with (``knobs``).

It needs no card, and gives the same numbers on any machine. Usage:

  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--out dryrun_results_torch.jsonl]
  python -m repro_torch.launch.dryrun --all --mesh 1x8
  python -m repro_torch.launch.dryrun --arch dbrx-132b --shape train_4k --mesh 2x4 --moe-impl dense

Records append as JSON lines (``launch/report.py`` formats them); the exit
code is 1 if any cell failed, as in the JAX package.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import cell_is_runnable
from repro_torch.launch.roofline import HBM_BYTES, analyze, mesh_desc
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.launch.specs import build_cell, mesh_rules
from repro_torch.launch.step_cost import reckon


def _reckoned(arch: str, shape: str, **kw) -> tuple:
    """The cell built with ``kw`` and its reckoned step: ``(cell, cost,
    total peak bytes)``; the step's outputs are dropped."""
    cell = build_cell(arch, shape, **kw)
    out, cost = reckon(cell.step, *cell.args, **cell.kwargs)
    del out
    return cell, cost, cell.persistent_bytes + cost.peak


def _fit_train(arch: str, shape: str, mesh: tuple = (1, 1), microbatches: int = 0,
               **knobs) -> tuple:
    """The fewest power-of-two microbatches whose peak fits (bisected over
    the exponents: the peak falls as the microbatch shrinks), and the cell
    at it; where none fits, the cell at one sequence a microbatch, or at
    one microbatch where the persistent state alone does not fit.
    ``microbatches`` given: the cell at that many, fitting or not."""
    if microbatches:
        cell, cost, total = _reckoned(arch, shape, mesh=mesh, microbatches=microbatches,
                                      **knobs)
        fit = {"fits": total <= HBM_BYTES, "peak_bytes": total, "microbatches": microbatches}
        if not fit["fits"]:
            fit["why"] = f"{microbatches} microbatches peak at {total} bytes"
        return cell, cost, fit
    batch = SHAPES[shape].global_batch // mesh[0]  # a data rank's
    cell, cost, total = _reckoned(arch, shape, mesh=mesh, **knobs)
    if cell.persistent_bytes > HBM_BYTES:
        return cell, cost, {"fits": False, "peak_bytes": total, "microbatches": 1,
                            "why": f"persistent state alone: {cell.persistent_bytes} bytes"}
    if total <= HBM_BYTES:
        return cell, cost, {"fits": True, "peak_bytes": total, "microbatches": 1}
    lo, hi = 1, batch.bit_length() - 1  # 2**lo .. 2**hi microbatches
    best = _reckoned(arch, shape, microbatches=2 ** hi, mesh=mesh, **knobs)
    if best[2] > HBM_BYTES:
        return best[0], best[1], {"fits": False, "peak_bytes": best[2], "microbatches": 2 ** hi,
                                  "why": f"one sequence a microbatch peaks at {best[2]} bytes"}
    while lo < hi:
        mid = (lo + hi) // 2
        run = _reckoned(arch, shape, microbatches=2 ** mid, mesh=mesh, **knobs)
        if run[2] <= HBM_BYTES:
            best, hi = run, mid
        else:
            lo = mid + 1
    cell, cost, total = best
    return cell, cost, {"fits": True, "peak_bytes": total, "microbatches": cell.microbatches}


def _fit_serving(arch: str, shape: str, mesh: tuple = (1, 1), microbatches: int = 0,
                 **knobs) -> tuple:
    """The cell whole, and where it does not fit, the largest batch of its
    length that does, in sequences a data rank (bisected; None where one
    sequence does not). ``microbatches`` has no meaning here."""
    n_data = mesh[0]
    cell, cost, total = _reckoned(arch, shape, mesh=mesh, **knobs)
    fit = {"fits": total <= HBM_BYTES, "peak_bytes": total}
    if fit["fits"]:
        return cell, cost, fit
    fit["why"] = (f"persistent state alone: {cell.persistent_bytes} bytes"
                  if cell.persistent_bytes > HBM_BYTES else f"the step peaks at {total} bytes")
    lo, hi, best = 1, cell.shp.global_batch // n_data - 1, None
    while lo <= hi:
        mid = (lo + hi) // 2
        _, _, peak = _reckoned(arch, shape, batch=mid * n_data, mesh=mesh, **knobs)
        if peak <= HBM_BYTES:
            best, lo = (mid, peak), mid + 1
        else:
            hi = mid - 1
    fit["largest_batch"] = best[0] * n_data if best else None
    fit["largest_batch_peak_bytes"] = best[1] if best else None
    return cell, cost, fit


def run_cell(arch: str, shape: str, verbose: bool = True, mesh: tuple = (1, 1),
             **knobs) -> dict:
    """One cell's record (on a mesh, one rank's step) at the dry run's
    ``knobs`` (``remat``, ``ssm_chunk``, ``expert_parallel_2d``,
    ``microbatches``, ``moe_impl``); raises ``NotImplementedError`` where
    ``tensor_parallel.check_tp`` refuses the cell on ``mesh``."""
    t0 = time.perf_counter()
    fitter = _fit_train if SHAPES[shape].kind == "train" else _fit_serving
    cell, cost, fit = fitter(arch, shape, mesh, **knobs)
    cfg = cell.cfg
    roof = analyze(cost, arch, shape, cfg, SHAPES[shape], cell.min_bytes, mesh=mesh)
    rec = {
        "status": "ok", "arch": arch, "shape": shape, "mesh": roof.mesh_desc,
        "remat": cell.knobs["remat"],
        "knobs": {**cell.knobs, "microbatches": cell.microbatches},
        "memory": {"persistent_bytes": dict(cell.persistent),
                   "persistent_total": cell.persistent_bytes,
                   "step_peak_bytes": cost.peak, **fit},
        "params_init": cell.n_params, "params_count": cfg.param_count(),
        "launches": dict(cost.launches),
        **roof.to_dict(),
        "dryrun_s": round(time.perf_counter() - t0, 2),
    }
    if roof.chips > 1:
        rec["mesh_shape"] = {"data": mesh[0], "model": mesh[1]}
        rec["collective_counts"] = cost.collective_counts
        rec["collective_link_bytes"] = roof.link_bytes
    if verbose:
        mem = rec["memory"]
        how = (f"microbatches={mem['microbatches']}" if "microbatches" in mem
               else f"largest batch={mem.get('largest_batch')}" if not mem["fits"] else "whole")
        print(f"[dryrun] {arch} × {shape} × {roof.mesh_desc}: {rec['dryrun_s']:.1f}s "
              f"flops={roof.hlo_flops:.3e} bytes={roof.hlo_bytes:.3e} "
              f"coll={roof.collective_bytes:.3e} "
              f"dominant={roof.dominant} bound={roof.bound_time:.4g}s "
              f"peak={_fmt_bytes(mem['peak_bytes'])} fits={mem['fits']} ({how})", flush=True)
    return rec


def _fmt_bytes(b):
    """Bytes in decimal units (80 GB = 80e9 bytes, as ``HBM_BYTES``)."""
    if b is None:
        return "?"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1000:
            return f"{b:.1f}{unit}"
        b /= 1000
    return f"{b:.1f}PB"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="dryrun_results_torch.jsonl")
    ap.add_argument("--mesh", default="1x1",
                    help="DxM: one rank of a data D x model M mesh (default 1x1, one card)")
    ap.add_argument("--remat", default="layer", choices=["layer", "none"])
    ap.add_argument("--ssm-chunk", type=int, default=0,
                    help="the SSD and mLSTM chunk length (0: the configuration's)")
    ap.add_argument("--ep2d", action="store_true",
                    help="2D expert parallelism (experts over data x model) on a mesh")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="a training cell's microbatches (0: the fewest that fit)")
    ap.add_argument("--moe-impl", default="", choices=["", "sorted", "dense"])
    args = ap.parse_args(argv)
    knobs = {"remat": args.remat, "ssm_chunk": args.ssm_chunk,
             "expert_parallel_2d": args.ep2d, "microbatches": args.microbatches,
             "moe_impl": args.moe_impl}
    try:
        mesh = tuple(int(v) for v in args.mesh.lower().split("x"))
    except ValueError:
        mesh = ()
    if len(mesh) != 2 or min(mesh) < 1:
        ap.error(f"--mesh takes DxM, e.g. 1x8; got {args.mesh!r}")
    where = mesh_desc(mesh)

    if args.all:
        cells = [(arch, shape) for arch in sorted(ARCHS) for shape in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    n_ok = n_skip = n_fail = 0
    with open(args.out, "a") as f:
        for arch, shape in cells:
            runnable, why = cell_is_runnable(arch, shape)
            if runnable and mesh != (1, 1):
                try:
                    mesh_rules(get_config(arch), SHAPES[shape], abstract_mesh(*mesh),
                               expert_parallel_2d=args.ep2d)
                except NotImplementedError as e:  # check_tp: not in this slice
                    runnable, why = False, str(e)
            if not runnable:
                rec = {"status": "skipped", "arch": arch, "shape": shape, "mesh": where,
                       "reason": why}
                print(f"[dryrun] SKIP {arch} × {shape}: {why}")
                n_skip += 1
            else:
                try:
                    rec = run_cell(arch, shape, mesh=mesh, **knobs)
                    n_ok += 1
                except Exception as e:  # a failure here is a bug in the port
                    traceback.print_exc()
                    rec = {"status": "fail", "arch": arch, "shape": shape, "mesh": where,
                           "error": f"{type(e).__name__}: {e}"}
                    n_fail += 1
            f.write(json.dumps(rec) + "\n")
            f.flush()
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_fail} FAILED")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
