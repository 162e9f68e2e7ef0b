"""Format the one-card dry run's JSON lines into a markdown table.

The counterpart of ``repro/launch/report.py``: ``fmt_table`` and
``pick_hillclimb_cells`` over ``launch/dryrun.py``'s records, with the
fit on one card beside the roofline terms. ``most_collective`` has
nothing to pick on one card: no cell moves a byte across a link.

  python -m repro_torch.launch.report dryrun_results_torch.jsonl [--pick]
"""
from __future__ import annotations

import argparse
import json


def _records(path: str) -> dict:
    """The last record of each cell (re-runs append)."""
    by_cell = {}
    with open(path) as fh:
        for line in fh:
            r = json.loads(line)
            by_cell[(r["arch"], r["shape"])] = r
    return by_cell


def _fit(mem: dict) -> str:
    if mem["fits"]:
        m = mem.get("microbatches")
        return "whole" if not m or m == 1 else f"{m} microbatches"
    if mem.get("largest_batch"):
        return f"batch ≤ {mem['largest_batch']}"
    return "no"


def fmt_table(path: str) -> str:
    lines = [
        "| arch | shape | dominant | t_compute (s) | t_memory (s) | "
        "t_collective (s) | MODEL_FLOPS | useful/counted | roofline frac | "
        "persistent | peak | fits one card |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape), r in sorted(_records(path).items()):
        if r["status"] == "skipped":
            lines.append(f"| {arch} | {shape} | — skipped: "
                         f"{r['reason'][:60]}… | | | | | | | | | |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {arch} | {shape} | FAILED | | | | | | | | | |")
            continue
        mem = r["memory"]
        lines.append(
            f"| {arch} | {shape} | **{r['dominant']}** "
            f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} "
            f"| {r['t_collective_s']:.3e} | {r['model_flops']:.2e} "
            f"| {r['useful_flops_ratio']:.2f} "
            f"| {r['roofline_fraction']:.3f} "
            f"| {mem['persistent_total'] / 1e9:.1f} GB | {mem['peak_bytes'] / 1e9:.1f} GB "
            f"| {_fit(mem)} |"
        )
    return "\n".join(lines)


def pick_hillclimb_cells(path: str) -> dict:
    cells = [r for r in _records(path).values() if r["status"] == "ok"]
    worst = min(cells, key=lambda r: r["roofline_fraction"])
    return {"worst_fraction": (worst["arch"], worst["shape"], worst["roofline_fraction"]),
            "most_collective": None,
            "why_no_collective": "one card: every cell's collective term is 0"}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--pick", action="store_true")
    a = ap.parse_args()
    print(fmt_table(a.path))
    if a.pick:
        print(json.dumps(pick_hillclimb_cells(a.path), indent=2))
