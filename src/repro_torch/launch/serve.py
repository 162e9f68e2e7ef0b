"""GNN serving launcher: ``python -m repro_torch.launch.serve``.

Counterpart of ``repro/launch/serve.py``: builds a synthetic dataset
analog, trains ``--epochs`` mini-batch epochs with ``adam(0.01)`` over
the dataset's train mask (or, with ``--epochs 0``, loads an untrained
model: random weights from seed 0) and drives the online GNN serving
engine from a request loop — Poisson think time, seed-node queries drawn
80% from a hot set so the embedding cache has something to hit — then
prints p50/p99 latency, throughput and cache statistics.

The defaults are the port's serving configuration: the ogbn-arxiv analog
at full scale, GCN [128, 256, 256, 40] as in OGB's ogbn-arxiv GCN
baseline, fanouts (15, 10, 5), 256-seed batches, no training, on CUDA.
``--device cpu`` runs the plain PyTorch versions instead (use a small
``--scale`` there).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.graph.datasets import DATASET_SPECS, generate_dataset
from repro_torch.models.gnn import GNNConfig
from repro_torch.serving.gnn_engine import GNNRequest, GNNServingEngine
from repro_torch.training.optimizer import adam
from repro_torch.training.trainer import MiniBatchTrainer


def _percentile_ms(xs, q):
    return float(np.percentile(np.asarray(xs), q) * 1e3) if len(xs) else 0.0


def model_config(ds, arch: str, hidden: int, n_layers: int,
                 **config) -> GNNConfig:
    """``arch`` over ``ds`` with ``n_layers`` layers: [F, hidden, ...,
    n_classes]; ``config`` the rest of ``GNNConfig`` (``gat_heads=``)."""
    dims = [ds.features.shape[1]] + [hidden] * (n_layers - 1) + [ds.n_classes]
    return GNNConfig(kind=arch, layer_dims=dims, **config)


def build_engine(ds, *, arch: str, hidden: int, fanouts: Sequence[int],
                 batch_size: int, n_buckets: int, wave_size: int,
                 use_cache: bool, engine: str = "cuda", device=None,
                 seed: int = 0, **config) -> GNNServingEngine:
    """An infer-only trainer of ``model_config(ds, arch, hidden,
    len(fanouts), **config)``, untrained weights from ``seed``, wrapped in
    a serving engine."""
    trainer = MiniBatchTrainer(
        model_config(ds, arch, hidden, len(fanouts), **config), ds.graph,
        ds.features, None, None, None, fanouts=tuple(fanouts),
        batch_size=batch_size, n_buckets=n_buckets, engine=engine, seed=seed,
        infer_only=True, device=device)
    return GNNServingEngine(trainer, wave_size=wave_size,
                            use_cache=use_cache, seed=seed)


def drive(engine: GNNServingEngine, n_nodes: int, n_requests: int, *,
          query_size: int = 4, rate: float = 200.0, hot_frac: float = 0.05,
          seed: int = 1) -> tuple[list[GNNRequest], float]:
    """The request loop: bursts of up to ``wave_size`` arrivals with
    Poisson think time, 1..``query_size`` seed nodes each, 80% from a hot
    set of ``hot_frac`` of the nodes. Returns the answered requests in
    completion order and the wall time; the stream depends on ``seed``
    only, so two engines driven with one seed see the same requests."""
    rng = np.random.default_rng(seed)
    hot = rng.choice(n_nodes, size=max(1, int(n_nodes * hot_frac)),
                     replace=False)
    done: list[GNNRequest] = []
    t_start = time.perf_counter()
    rid = 0
    while len(done) < n_requests:
        n_arrivals = min(engine.wave_size,
                         n_requests - len(done) - len(engine.queue))
        for _ in range(max(n_arrivals, 1 if not engine.queue else 0)):
            k = int(rng.integers(1, query_size + 1))
            pool = hot if rng.random() < 0.8 else np.arange(n_nodes)
            ids = rng.choice(pool, size=min(k, pool.shape[0]), replace=False)
            engine.submit(GNNRequest(rid=rid, node_ids=ids))
            rid += 1
            time.sleep(min(rng.exponential(1.0 / rate), 0.05))
        done.extend(engine.run())
    return done, time.perf_counter() - t_start


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="ogbn-arxiv",
                    choices=sorted(DATASET_SPECS))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--arch", default="GCN",
                    choices=["GCN", "SAGE", "GIN", "GAT", "GT"])
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--fanouts", default="15,10,5",
                    help="comma-separated fanout per layer (sets the depth)")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--buckets", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=0,
                    help="mini-batch epochs to train first (0: serve an "
                         "untrained model)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--wave-size", type=int, default=8)
    ap.add_argument("--query-size", type=int, default=4,
                    help="max seed nodes per request")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="Poisson arrival rate (requests/s of think time)")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--hot-frac", type=float, default=0.05,
                    help="fraction of nodes 80%% of queries concentrate on")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    ds = generate_dataset(args.dataset, scale=args.scale, seed=0)
    fanouts = tuple(int(f) for f in args.fanouts.split(","))
    print(f"[serve] {ds.name}: {ds.graph.n_rows} nodes {ds.graph.nnz} edges "
          f"{ds.features.shape[1]} features, arch={args.arch} "
          f"fanouts={fanouts} device={args.device}")
    if args.epochs > 0:
        trainer = MiniBatchTrainer(
            model_config(ds, args.arch, args.hidden, len(fanouts)), ds.graph,
            ds.features, ds.labels, ds.train_mask,
            adam(0.01, fused=True), fanouts=fanouts,
            batch_size=args.batch_size, n_buckets=args.buckets, seed=0,
            device=args.device)
        for e in range(args.epochs):
            t0 = time.perf_counter()
            loss = trainer.train_epoch()
            print(f"[serve] train epoch {e}: loss {loss:.4f} "
                  f"({time.perf_counter() - t0:.2f}s)")
        engine = GNNServingEngine(trainer, wave_size=args.wave_size,
                                  use_cache=not args.no_cache, seed=0)
    else:
        engine = build_engine(
            ds, arch=args.arch, hidden=args.hidden, fanouts=fanouts,
            batch_size=args.batch_size, n_buckets=args.buckets,
            wave_size=args.wave_size, use_cache=not args.no_cache,
            device=args.device)
    t0 = time.perf_counter()
    n_warm = engine.warmup()
    print(f"[serve] warmup: {n_warm} shape signatures "
          f"({len(engine.sampler.buckets)} buckets) "
          f"in {time.perf_counter() - t0:.2f}s")

    done, wall = drive(engine, ds.graph.n_rows, args.requests,
                       query_size=args.query_size, rate=args.rate,
                       hot_frac=args.hot_frac)
    latencies = [r.latency_s for r in done]
    print(f"[serve] {len(done)} requests in {wall:.2f}s "
          f"({len(done) / wall:.1f} req/s)")
    print(f"[serve] latency p50 {_percentile_ms(latencies, 50):.2f}ms "
          f"p99 {_percentile_ms(latencies, 99):.2f}ms")
    stats = engine.stats()
    print(f"[serve] waves={stats['waves']} batches={stats['batches']} "
          f"coalesced={stats['coalesced']} "
          f"infer_traces={stats['infer_traces']}")
    if "cache" in stats:
        c = stats["cache"]
        print(f"[serve] cache: hits={c['hits']} misses={c['misses']} "
              f"entries={c['entries']} evictions={c['evictions']}")
    return stats


if __name__ == "__main__":
    main()
