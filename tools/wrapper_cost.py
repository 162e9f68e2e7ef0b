#!/usr/bin/env python3
"""The host cost of one call of the flash and Adam kernels' wrappers on one
NVIDIA card.

    python3 tools/wrapper_cost.py [--src DIR] [--against DIR] [--reps N] [--turns K]

Each wrapper is called ``--reps`` times back to back (after 20 more) on
inputs small enough that the card keeps up with the host, and each call
is timed on the host clock without a synchronise: what a caller's thread
spends in the wrapper (checks, any operator dispatch, the ctypes launch).
Cases: ``flash_attention`` on q, k, v [1, 4, 128, 64] float32, causal;
``fused_adam_multi`` over 6 leaves (a GCN's count) and over 86
(xlstm-1.3b's: two launches) of 1,024 values each. Median, min and max in
microseconds, and the kernels' launches over the warm-up and timed calls.

``--src`` names the ``src`` directory that ``repro_torch`` is imported
from (default: this checkout's). ``--against`` names the ``src`` directory
of another tree of the port, such as its parent commit unpacked beside
it: that tree's two wrapper modules are loaded beside the first's, under
names of their own (they share its built libraries and plain versions, so
the other tree must not register the operators too), and each case is
timed ``--turns`` times in turns, A B B A ..., in this one process, so
that what differs between two processes on a shared host does not enter
the comparison. Prints the card's name and power limit, then one JSON
line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def per_call_us(fn, reps: int) -> list:
    for _ in range(20):
        fn()
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t) * 1e6)
    return out


def load_wrappers(src: str) -> tuple:
    """``src``'s ``kernels/flash_attention.py`` and ``kernels/fused_adam.py``
    as modules named apart from the imported ``repro_torch``."""
    mods = []
    for name in ("flash_attention", "fused_adam"):
        path = os.path.join(src, "repro_torch", "kernels", f"{name}.py")
        spec = importlib.util.spec_from_file_location(f"against_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods.append(mod)
    return tuple(mods)


def cases(fa, adam, q, k, v, leaves) -> dict:
    """name -> (the call, the function whose ``launches`` it counts)."""
    out = {"flash_attention": (lambda: fa.flash_attention(q, k, v, causal=True),
                               fa.flash_attention)}
    for n, ls in leaves.items():
        out[f"fused_adam_multi_{n}_leaves"] = (
            lambda ls=ls: adam.fused_adam_multi(*ls, 1e-3, weight_decay=0.01),
            adam.fused_adam)
    return out


def timed(torch, fn, kernel, reps: int) -> dict:
    torch.cuda.synchronize()
    kernel.launches = 0
    us = sorted(per_call_us(fn, reps))
    torch.cuda.synchronize()
    return {"median_us": us[len(us) // 2], "min_us": us[0], "max_us": us[-1],
            "launches": kernel.launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--against", default=None)
    ap.add_argument("--reps", type=int, default=2000)
    ap.add_argument("--turns", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    import repro_torch.kernels.flash_attention as fa
    import repro_torch.kernels.fused_adam as adam

    if not torch.cuda.is_available():
        print("wrapper_cost: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((1, 4, 128, 64), generator=gen, device=dev) for _ in range(3))
    leaves = {}
    for n in (6, 86):
        ls = [[torch.randn(1024, generator=gen, device=dev) for _ in range(n)]
              for _ in range(4)]
        ls[3] = [x.abs() for x in ls[3]]
        leaves[n] = ls
    mine = cases(fa, adam, q, k, v, leaves)
    out = {"src": os.path.abspath(args.src), "reps": args.reps}
    if args.against is None:
        for name, (fn, kernel) in mine.items():
            out[name] = timed(torch, fn, kernel, args.reps)
    else:
        other = cases(*load_wrappers(os.path.abspath(args.against)), q, k, v, leaves)
        out["against"] = os.path.abspath(args.against)
        out["turns"] = args.turns
        for name in mine:
            runs = {"src": [], "against": []}
            for t in range(args.turns):
                order = ("src", "against") if t % 2 == 0 else ("against", "src")
                for side in order:
                    fn, kernel = (mine if side == "src" else other)[name]
                    runs[side].append(timed(torch, fn, kernel, args.reps))
            out[name] = {side: {"median_us": [r["median_us"] for r in rs],
                                "launches": [r["launches"] for r in rs]}
                         for side, rs in runs.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
