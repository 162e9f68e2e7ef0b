"""Online GNN serving engine (DESIGN.md §12).

Training plans become a service: streams of seed-node queries are
coalesced into micro-batch *waves*, deduplicated across overlapping
request frontiers, padded into the ``NeighborSampler``'s existing shape
buckets — so after one warmup per bucket the infer path sees no new
shape signature — and executed through the ``MiniBatchTrainer``'s compiled
``SampledModelPlan``. Results come back as logits in **user node-id
space**: the engine feeds user ids through the trainer's PR-5
permutation boundary (``_to_exec`` in, request-order rows out), so a
reordered plan is invisible to callers.

Request path per wave::

    requests -> concat ids -> unique (coalesce) -> cache lookup (level L)
             -> misses: _to_exec -> split_request -> sample -> bucket pad
             -> device infer -> scatter rows back per request

Layered on top is a bounded multi-level **embedding cache** of
historical activations: level ``k`` holds the layer-``k`` output for a
node, level ``n_layers`` the logits. Entries are keyed by user node id
and scoped by a *fingerprint* — sha256 of the serving graph's structure
plus a params version — so a graph or parameter change invalidates the
whole cache wholesale (a historical activation is only valid against the
exact graph + params it was computed with). Hits serve straight from
host memory; misses compute, then populate.

Determinism: the engine owns its sampling rng, so two engines built with
the same seed over identical query streams produce identical logits (the
CUDA SpMM kernel uses no atomics, so this holds bitwise on the card).

A copy of ``repro/serving/gnn_engine.py`` adapted to the port: device
tensors come back to the host through ``.cpu().numpy()``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict, deque
from typing import Iterable, Optional

import numpy as np


class EmbeddingCache:
    """Bounded multi-level historical-activation cache.

    ``n_levels`` matches the model depth: level ``k`` (1-based) stores
    the activation of layer ``k``, level ``n_levels`` the output logits.
    Each level is an LRU of at most ``capacity`` vectors keyed by user
    node id. ``set_fingerprint`` with a changed value clears every level
    and bumps ``invalidations`` — there is no per-entry invalidation; the
    fingerprint scopes the whole cache generation.
    """

    def __init__(self, n_levels: int, capacity: int = 4096,
                 keep_stale: bool = False):
        if n_levels < 1 or capacity < 1:
            raise ValueError("n_levels and capacity must be >= 1")
        self.n_levels = int(n_levels)
        self.capacity = int(capacity)
        self.keep_stale = bool(keep_stale)
        self.fingerprint: Optional[str] = None
        self._levels: dict[int, OrderedDict] = {
            k: OrderedDict() for k in range(1, self.n_levels + 1)}
        # previous-generation level-L rows (graceful degradation rung 1,
        # DESIGN.md §13): invalidation moves logits here instead of
        # dropping them, so an overloaded engine can answer with a stale
        # row instead of computing or shedding
        self._stale: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.stale_hits = 0

    def __len__(self) -> int:
        return sum(len(d) for d in self._levels.values())

    def set_fingerprint(self, fp: str) -> None:
        if fp == self.fingerprint:
            return
        if self.fingerprint is not None:
            self.invalidations += 1
        self.fingerprint = fp
        if self.keep_stale:
            self._stale.update(self._levels[self.n_levels])
            while len(self._stale) > self.capacity:
                self._stale.popitem(last=False)
        for d in self._levels.values():
            d.clear()

    def get_stale(self, node_id: int) -> Optional[np.ndarray]:
        """A previous-generation logits row for ``node_id`` (or the
        current generation's, if cached) — the overload ladder's first
        rung. Returns None when the node was never computed."""
        vec = self._levels[self.n_levels].get(int(node_id))
        if vec is None:
            vec = self._stale.get(int(node_id))
        if vec is not None:
            self.stale_hits += 1
        return vec

    def _level(self, level: int) -> OrderedDict:
        if level not in self._levels:
            raise KeyError(
                f"cache level {level} outside [1, {self.n_levels}]")
        return self._levels[level]

    def get(self, level: int, node_id: int) -> Optional[np.ndarray]:
        d = self._level(level)
        vec = d.get(int(node_id))
        if vec is None:
            self.misses += 1
            return None
        d.move_to_end(int(node_id))
        self.hits += 1
        return vec

    def put(self, level: int, node_id: int, vec: np.ndarray) -> None:
        d = self._level(level)
        nid = int(node_id)
        if nid in d:
            d.move_to_end(nid)
        d[nid] = np.array(vec, dtype=np.float32, copy=True)
        while len(d) > self.capacity:
            d.popitem(last=False)
            self.evictions += 1

    def stats(self) -> dict:
        return {
            "hits": self.hits, "misses": self.misses,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
            "stale_hits": self.stale_hits,
            "stale_entries": len(self._stale),
            "entries": len(self), "capacity": self.capacity,
            "fingerprint": self.fingerprint,
        }


@dataclasses.dataclass
class GNNRequest:
    """One seed-node query: logits for ``node_ids`` (user id space).

    ``deadline_s`` is the caller's latency budget: a request still queued
    past its deadline is answered from stale cache if possible, otherwise
    explicitly rejected (``rejected=True``) — never served uselessly
    late and never left hanging. ``degraded`` records which rung of the
    overload ladder answered it (None = full-quality path): ``"stale"``
    (historical cache row) or ``"fanout"`` (reduced-fanout plan).
    """

    rid: int
    node_ids: np.ndarray
    logits: Optional[np.ndarray] = None
    done: bool = False
    t_submit: float = 0.0
    t_done: float = 0.0
    deadline_s: Optional[float] = None
    rejected: bool = False
    degraded: Optional[str] = None

    def __post_init__(self):
        self.node_ids = np.asarray(self.node_ids, dtype=np.int64).reshape(-1)

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit

    def expired(self, now: float) -> bool:
        return (self.deadline_s is not None
                and now - self.t_submit > self.deadline_s)


class GNNServingEngine:
    """Micro-batched online serving over a compiled ``SampledModelPlan``.

    ``trainer`` is a ``MiniBatchTrainer`` (trained, or infer-only with
    params loaded); the engine reuses its infer path, its sampler
    (so serve-time shapes land in the training buckets) and its
    permutation boundary. ``wave_size`` is the coalescing window: up to
    that many queued requests are merged into one wave and served
    together. ``cache_hidden=True`` additionally records every computed
    frontier node's hidden activations (levels ``1..L-1``) via the
    trainer's ``_infer_levels`` path — the historical-embedding feed
    ``embed`` serves from.
    """

    def __init__(
        self,
        trainer,
        *,
        wave_size: int = 8,
        use_cache: bool = True,
        cache_capacity: int = 4096,
        cache_hidden: bool = False,
        seed: int = 0,
        max_queue: Optional[int] = None,
        overload_threshold: Optional[int] = None,
        default_deadline_s: Optional[float] = None,
        degraded_fanouts: Optional[tuple] = None,
    ):
        if wave_size < 1:
            raise ValueError("wave_size must be >= 1")
        self.trainer = trainer
        self.sampler = trainer.sampler
        self.config = trainer.config
        self.n_classes = int(trainer.config.layer_dims[-1])
        self.wave_size = int(wave_size)
        self.cache_hidden = bool(cache_hidden and use_cache)
        self.cache = (EmbeddingCache(trainer.config.n_layers, cache_capacity,
                                     keep_stale=True)
                      if use_cache else None)
        # -- overload policy (DESIGN.md §13 degradation ladder) -----------
        # max_queue bounds admission (requests beyond it are shed with an
        # explicit rejection at submit time — last rung); a backlog past
        # overload_threshold flips waves into degraded mode: stale cache
        # rows first, the reduced-fanout plan second. default_deadline_s
        # stamps every request lacking its own deadline.
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.max_queue = max_queue
        self.overload_threshold = overload_threshold
        self.default_deadline_s = default_deadline_s
        self._deg_sampler = None
        if degraded_fanouts is not None:
            from repro_torch.graph.sampling import NeighborSampler

            s = trainer.sampler
            fo = tuple(int(f) for f in degraded_fanouts)
            if len(fo) != s.n_layers:
                raise ValueError(
                    f"degraded_fanouts needs {s.n_layers} entries, got {fo!r}")
            if any(a > b for a, b in zip(fo, s.fanouts)):
                raise ValueError(
                    f"degraded fanouts {fo} must not exceed the primary "
                    f"plan's {s.fanouts}")
            # same (weighted, exec-space) graph and tile as the primary
            # sampler, so the trainer's infer path runs the smaller
            # blocks directly — only the shapes (and cost) shrink
            self._deg_sampler = NeighborSampler(
                s.graph, fo, batch_size=s.batch_size, n_buckets=1,
                br=s.br, bc=s.bc, seed=seed + 1, emit_bsr=s.emit_bsr)
        # engine-owned sampling stream: identical engines serve identical
        # query streams identically (the trainer's rng is untouched)
        self._rng = np.random.default_rng(seed)
        self._infer_fn = (trainer._infer_levels if self.cache_hidden
                          else trainer._infer)
        # exec-id -> user-id map (perm[new] = old), for keying hidden
        # activations of frontier nodes back into user space
        lp = trainer.plan.layout
        self._perm = (np.asarray(lp.perm, dtype=np.int64)
                      if lp is not None and lp.permutes else None)
        self._params_version = 0
        if self.cache is not None:
            self.cache.set_fingerprint(self._fingerprint())
        self.queue: deque[GNNRequest] = deque()
        self.n_requests = 0
        self.n_waves = 0
        self.n_batches = 0
        self.n_coalesced = 0  # duplicate ids merged across a wave
        self.n_shed = 0  # rejected at admission (queue full)
        self.n_deadline_miss = 0  # expired in queue, no stale fallback
        self.n_stale = 0  # requests answered from previous-gen rows
        self.n_degraded = 0  # requests answered via reduced fanout
        self.degraded_waves = 0

    # -- cache generation ----------------------------------------------------

    def _fingerprint(self) -> str:
        """sha256(graph structure) + params version: the cache generation.

        Any structural graph change or params swap yields a new value —
        ``set_fingerprint`` then drops every cached activation wholesale.
        """
        g = self.sampler.graph
        h = hashlib.sha256()
        h.update(np.asarray([g.n_rows, g.n_cols, g.nnz],
                            dtype=np.int64).tobytes())
        h.update(np.asarray(g.indptr, dtype=np.int64).tobytes())
        h.update(np.asarray(g.indices, dtype=np.int64).tobytes())
        h.update(f"params_v{self._params_version}".encode())
        return h.hexdigest()

    def update_params(self, params) -> None:
        """Swap serving params (e.g. after a training refresh); bumps the
        fingerprint so every cached activation is invalidated."""
        self.trainer.params = params
        self._params_version += 1
        if self.cache is not None:
            self.cache.set_fingerprint(self._fingerprint())

    # -- lifecycle -----------------------------------------------------------

    def warmup(self) -> int:
        """Run the serve path once per sampler bucket (and per degraded
        bucket, when a reduced-fanout plan is configured); returns the
        number of new shape signatures seen. After this, waves present no
        new signature (``trainer.n_infer_traces`` stays flat — the
        serve-time bound the JAX package keeps on jit retraces)."""
        tr = self.trainer
        before = tr.n_infer_traces
        samplers = [self.sampler]
        if self._deg_sampler is not None:
            samplers.append(self._deg_sampler)
        for s in samplers:
            for spec in s.buckets:
                n = min(spec.seed_cap, s.graph.n_rows)
                batch = s.sample_batch(
                    np.arange(n, dtype=np.int64), tr.features, rng=self._rng)
                out = self._infer_fn(tr.params, tr._batch_arrays(batch))
                last = out[-1] if isinstance(out, tuple) else out
                last.cpu()  # block until the run finishes
        return tr.n_infer_traces - before

    def submit(self, req: GNNRequest) -> bool:
        """Admit ``req`` into the queue. Returns False — with the request
        marked ``rejected`` and ``done`` — when the queue is at
        ``max_queue``: explicit load shedding, the ladder's last rung, so
        a saturated engine answers "no" immediately instead of hanging."""
        if not req.t_submit:
            req.t_submit = time.perf_counter()
        if req.deadline_s is None:
            req.deadline_s = self.default_deadline_s
        self.n_requests += 1
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            req.rejected = True
            req.done = True
            req.t_done = time.perf_counter()
            self.n_shed += 1
            return False
        self.queue.append(req)
        return True

    def run(self) -> list[GNNRequest]:
        """Drain the queue in waves of up to ``wave_size`` requests.

        Requests already past their deadline are answered from stale
        cache rows when every row is available, otherwise rejected —
        either way they complete immediately and never occupy a wave.
        While the backlog exceeds ``overload_threshold`` the waves
        themselves run degraded (stale rows first, reduced fanout next).
        """
        done: list[GNNRequest] = []
        while self.queue:
            overloaded = (self.overload_threshold is not None
                          and len(self.queue) > self.overload_threshold)
            wave: list[GNNRequest] = []
            now = time.perf_counter()
            while self.queue and len(wave) < self.wave_size:
                r = self.queue.popleft()
                if r.expired(now) and not self._answer_stale(r, now):
                    r.rejected = True
                    r.done = True
                    r.t_done = now
                    self.n_deadline_miss += 1
                    done.append(r)
                    continue
                if r.done:  # answered entirely from stale rows
                    done.append(r)
                    continue
                wave.append(r)
            if wave:
                self._run_wave(wave, degraded=overloaded)
                done.extend(wave)
        return done

    def _answer_stale(self, req: GNNRequest, now: float) -> bool:
        """Serve ``req`` wholly from previous-generation cache rows if
        every id has one; the deadline path's only non-reject option."""
        if self.cache is None:
            return False
        rows = []
        for nid in req.node_ids:
            vec = self.cache.get_stale(nid)
            if vec is None:
                return False
            rows.append(vec)
        req.logits = (np.stack(rows, axis=0) if rows
                      else np.zeros((0, self.n_classes), np.float32))
        req.degraded = "stale"
        req.done = True
        req.t_done = now
        self.n_stale += 1
        return True

    def serve(self, node_ids: Iterable[int]) -> np.ndarray:
        """Synchronous single-query path: logits for ``node_ids``."""
        req = GNNRequest(rid=-1, node_ids=np.asarray(list(node_ids)))
        req.t_submit = time.perf_counter()
        self._run_wave([req])
        return req.logits

    # -- the wave ------------------------------------------------------------

    def _run_wave(self, wave: list[GNNRequest],
                  degraded: bool = False) -> None:
        tr = self.trainer
        L = self.config.n_layers
        all_ids = (np.concatenate([r.node_ids for r in wave])
                   if wave else np.zeros(0, np.int64))
        # coalesce: overlapping frontiers across the wave's requests are
        # computed once; unique also de-collides the sampler's relabel
        # table (a duplicated seed is illegal there)
        uniq, inv = np.unique(all_ids, return_inverse=True)
        self.n_coalesced += int(all_ids.size - uniq.size)
        rows = np.zeros((uniq.shape[0], self.n_classes), np.float32)
        # per-unique-row provenance: 0 fresh, 1 stale row, 2 reduced fanout
        src = np.zeros(uniq.shape[0], dtype=np.int8)

        need = np.ones(uniq.shape[0], dtype=bool)
        if self.cache is not None:
            for j, nid in enumerate(uniq):
                vec = self.cache.get(L, nid)
                if vec is not None:
                    rows[j] = vec
                    need[j] = False

        if degraded and self.cache is not None:
            # ladder rung 1: previous-generation rows for the misses
            for j in np.flatnonzero(need):
                vec = self.cache.get_stale(uniq[j])
                if vec is not None:
                    rows[j] = vec
                    need[j] = False
                    src[j] = 1

        # ladder rung 2: remaining misses through the reduced-fanout plan
        use_deg = degraded and self._deg_sampler is not None
        sampler = self._deg_sampler if use_deg else self.sampler
        miss_pos = np.flatnonzero(need)
        if miss_pos.size:
            exec_ids = tr._to_exec(uniq)  # validates the whole wave's range
            for pos in sampler.split_request(miss_pos):
                batch = sampler.sample_batch(
                    exec_ids[pos], tr.features, rng=self._rng)
                out = self._infer_fn(tr.params, tr._batch_arrays(batch))
                self.n_batches += 1
                logits = out[-1] if self.cache_hidden else out
                rows[pos] = logits[: pos.shape[0]].cpu().numpy()
                if use_deg:
                    src[pos] = 2
                elif self.cache is not None:
                    # degraded-fanout logits never enter the cache — they
                    # would pollute full-quality answers next wave
                    for j in pos:
                        self.cache.put(L, uniq[j], rows[j])
                    if self.cache_hidden:
                        self._store_hidden(batch, out)

        offset = 0
        now = time.perf_counter()
        for r in wave:
            k = r.node_ids.shape[0]
            take = inv[offset: offset + k]
            r.logits = rows[take]
            r.done = True
            r.t_done = now
            if (src[take] == 2).any():
                r.degraded = "fanout"
                self.n_degraded += 1
            elif (src[take] == 1).any():
                r.degraded = "stale"
                self.n_stale += 1
            offset += k
        self.n_waves += 1
        if degraded:
            self.degraded_waves += 1

    def _store_hidden(self, batch, levels) -> None:
        """Record the wave's computed hidden activations: ``levels[l]``
        rows are the level-(l+1) frontier, i.e. ``blocks[l].dst_nodes``
        in exec space — mapped back to user ids for the cache key."""
        for l in range(len(levels) - 1):  # hidden levels only; L was stored
            blk = batch.blocks[l]
            arr = levels[l].cpu().numpy()
            dst_exec = blk.dst_nodes
            user = (self._perm[dst_exec] if self._perm is not None
                    else dst_exec)
            for row, nid in zip(arr[: blk.n_dst], user):
                self.cache.put(l + 1, nid, row)

    # -- historical-embedding endpoint --------------------------------------

    def embed(self, node_ids: Iterable[int], level: int) -> np.ndarray:
        """Layer-``level`` embeddings for ``node_ids`` (user id space),
        served from the historical cache; misses are computed by running
        the nodes through the serve path (which populates every level
        they appear in). Requires ``cache_hidden=True``."""
        if not self.cache_hidden:
            raise RuntimeError("embed() requires cache_hidden=True")
        ids = np.asarray(list(node_ids), dtype=np.int64).reshape(-1)
        missing = [nid for nid in ids
                   if self.cache._level(level).get(int(nid)) is None]
        if missing:
            self.serve(np.asarray(missing))
        out = [self.cache.get(level, nid) for nid in ids]
        still = [int(ids[i]) for i, v in enumerate(out) if v is None]
        if still:
            raise RuntimeError(
                f"level-{level} activations unavailable for {still[:8]} "
                f"(evicted during the same wave? raise cache_capacity)")
        return np.stack(out, axis=0)

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        d = {
            "requests": self.n_requests, "waves": self.n_waves,
            "batches": self.n_batches, "coalesced": self.n_coalesced,
            "infer_traces": self.trainer.n_infer_traces,
            "n_buckets": len(self.sampler.buckets),
            "shed": self.n_shed, "deadline_miss": self.n_deadline_miss,
            "stale_served": self.n_stale, "degraded": self.n_degraded,
            "degraded_waves": self.degraded_waves,
        }
        if self.cache is not None:
            d["cache"] = self.cache.stats()
        return d
