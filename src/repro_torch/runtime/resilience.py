"""Resilience layer: fault injection, guarded steps, retries, RNG capture,
and the distributed orchestrator.

Counterpart of ``repro/runtime/resilience.py`` (DESIGN.md §13):

* :class:`FaultInjector` — a seeded, deterministic fault source: NaN/inf
  gradients, a checkpoint writer killed mid-write, failing host
  callbacks, fire identically across runs for a fixed seed.
* :func:`guarded_update` — the on-device half of a guarded optimizer
  step: one non-finite count over the candidate params and the loss, and
  a ``torch.where`` that commits ``old + scale·(new-old)`` only when the
  step is finite. A NaN step never touches params or optimizer state.
* :class:`GuardPolicy` / :class:`GuardRunner` — the host half: an
  escalating ladder over consecutive bad steps (skip → LR backoff →
  rollback to the last checkpoint).
* :class:`RetryPolicy` — bounded exponential backoff with deterministic
  jitter for host-side callbacks (the streamed strips' fetch in
  ``runtime/streaming.py``, whose failures raise
  :class:`StreamFetchError` and :class:`StripChecksumError`).
* :class:`ResilientDistributedTrainer` — the orchestrator that acts on
  the ranks' heartbeat monitors (``runtime/failure.py``): a DEAD rank
  triggers checkpoint-restore onto fewer ranks (``runtime/elastic.py``),
  a STRAGGLER the degree-rebalancing re-partition (§IV-E1).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.runtime.checkpoint import _flatten_with_paths, _unflatten


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------


class InjectedFault(RuntimeError):
    """Raised by a fault-injection site (simulates a crash/kill there)."""


class StreamFetchError(RuntimeError):
    """A host-side strip fetch failed (after any retries).

    Carries the strip index, shard id and operand name, so the failure
    surfaces from the strip stream (``runtime/streaming.py``) with enough
    context to find the bad shard.
    """

    def __init__(self, strip: int, shard: int, name: str,
                 cause: BaseException, attempts: int = 1):
        self.strip = int(strip)
        self.shard = int(shard)
        self.name = str(name)
        self.cause = cause
        self.attempts = int(attempts)
        super().__init__(
            f"host prefetch of strip {strip} (operand {name!r}, shard "
            f"{shard}) failed after {attempts} attempt(s): "
            f"{type(cause).__name__}: {cause}")


class StripChecksumError(RuntimeError):
    """A fetched strip's payload does not match its build-time checksum.

    Raised *inside* the retried read (DESIGN.md §14), so a transient
    corruption — a bad DMA, a flipped bit in transit — retries under the
    strips' :class:`RetryPolicy` like any other host fault; persistent
    corruption exhausts the budget and surfaces as a
    :class:`StreamFetchError` wrapping this error.
    """

    def __init__(self, strip: int, name: str, expected: int, got: int):
        self.strip = int(strip)
        self.name = str(name)
        self.expected = int(expected)
        self.got = int(got)
        super().__init__(
            f"strip {strip} of operand {name!r} failed checksum "
            f"verification: crc32 {got:#010x} != expected {expected:#010x} "
            f"(silent host-memory corruption?)")


def _site_digest(site: str) -> int:
    # stable across processes (unlike hash(), which PYTHONHASHSEED salts)
    return int.from_bytes(hashlib.sha256(site.encode()).digest()[:8], "little")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injectable fault.

    ``steps`` fires at exactly those step indices; ``prob`` fires a
    deterministic per-(seed, site, step, rank) Bernoulli instead. With
    ``persistent=True`` the fault latches: once fired it keeps firing
    (a dead rank stays dead). ``count`` bounds total fires per key —
    the shape of a *transient* fault (e.g. a prefetch that fails twice
    and then succeeds, exercising the retry path).
    """

    site: str
    steps: Optional[frozenset] = None
    prob: float = 0.0
    rank: Optional[int] = None
    factor: float = 8.0  # slowdown multiplier for "rank_slow"
    mode: str = "nan"  # "nan" | "inf" for gradient corruption
    persistent: bool = False
    count: Optional[int] = None

    def __post_init__(self):
        if self.steps is not None:
            object.__setattr__(self, "steps", frozenset(int(s) for s in self.steps))


class FaultInjector:
    """Seeded, deterministic fault source shared by every runtime layer.

    Sites in use: ``grad`` (non-finite gradients), ``rank_dead``,
    ``rank_slow``, ``prefetch`` (host callback failure), and
    ``checkpoint_kill`` (writer killed between payload write and rename).
    """

    def __init__(self, seed: int = 0, faults: Iterable[FaultSpec] = ()):
        self.seed = int(seed)
        self._specs: dict[str, list[FaultSpec]] = {}
        for spec in faults:
            self._specs.setdefault(spec.site, []).append(spec)
        self._latched: set[tuple] = set()
        self._fire_counts: dict[tuple, int] = {}
        self.fired: dict[str, int] = {}

    def add(self, spec: FaultSpec) -> None:
        self._specs.setdefault(spec.site, []).append(spec)

    def clear(self, site: str) -> None:
        """Drop a site's specs and latches (the fault has been repaired)."""
        self._specs.pop(site, None)
        self._latched = {k for k in self._latched if k[0] != site}
        self._fire_counts = {k: v for k, v in self._fire_counts.items()
                             if k[0] != site}

    def specs(self, site: str) -> list[FaultSpec]:
        return list(self._specs.get(site, ()))

    def _bernoulli(self, site: str, step: int, rank: Optional[int],
                   prob: float) -> bool:
        if prob <= 0.0:
            return False
        # SeedSequence entropy must be non-negative; 2**31-1 tags "no rank"
        key = [self.seed, _site_digest(site) % (2**31), int(step),
               2**31 - 1 if rank is None else int(rank)]
        return float(np.random.default_rng(key).random()) < prob

    def fires(self, site: str, step: Optional[int] = None,
              rank: Optional[int] = None) -> bool:
        """Deterministic: does ``site`` fire at (step, rank)?"""
        step = 0 if step is None else int(step)
        for spec in self._specs.get(site, ()):
            if spec.rank is not None and rank is not None and spec.rank != rank:
                continue
            key = (site, spec.rank if spec.rank is not None else rank)
            if spec.persistent and key in self._latched:
                self._count(site)
                return True
            hit = (step in spec.steps if spec.steps is not None
                   else self._bernoulli(site, step, rank, spec.prob))
            if hit and spec.count is not None:
                ckey = (site, rank, "n")
                n = self._fire_counts.get(ckey, 0)
                if n >= spec.count:
                    hit = False
                else:
                    self._fire_counts[ckey] = n + 1
            if hit:
                if spec.persistent:
                    self._latched.add(key)
                self._count(site)
                return True
        return False

    def _count(self, site: str) -> None:
        self.fired[site] = self.fired.get(site, 0) + 1

    # -- site-specific helpers ----------------------------------------------

    def grad_poison(self, step: int) -> float:
        """0.0 on clean steps; NaN/inf on a fired ``grad`` step, which the
        guarded step adds to every gradient leaf (a clean step adds
        nothing, so clean numerics are bitwise unchanged)."""
        for spec in self._specs.get("grad", ()):
            hit = (step in spec.steps if spec.steps is not None
                   else self._bernoulli("grad", step, None, spec.prob))
            if hit:
                self._count("grad")
                return float("inf") if spec.mode == "inf" else float("nan")
        return 0.0

    def dead_ranks(self, step: int, n_ranks: int) -> set[int]:
        return {r for r in range(n_ranks)
                if self.fires("rank_dead", step, rank=r)}

    def slow_factor(self, step: int, rank: int) -> float:
        for spec in self._specs.get("rank_slow", ()):
            if spec.rank is not None and spec.rank != rank:
                continue
            hit = (step in spec.steps if spec.steps is not None
                   else self._bernoulli("rank_slow", step, rank, spec.prob))
            if spec.persistent and ("rank_slow", rank) in self._latched:
                hit = True
            if hit:
                if spec.persistent:
                    self._latched.add(("rank_slow", rank))
                self._count("rank_slow")
                return float(spec.factor)
        return 1.0

    def maybe_kill(self, site: str, step: Optional[int] = None) -> None:
        """Raise :class:`InjectedFault` if ``site`` fires — the simulated
        SIGKILL used at the checkpoint-writer site."""
        if self.fires(site, step):
            raise InjectedFault(f"injected fault at site {site!r}"
                                + (f" step {step}" if step is not None else ""))

    def callback_hook(self, site: str) -> Callable[[Any], None]:
        """A host-callback fault hook: ``hook(key)`` raises on fired
        attempts. Attempt numbering is per-``key`` (e.g. per strip), so a
        ``count``-bounded spec fails the first N attempts at that key and
        then lets the retry succeed."""

        def hook(key):
            attempt_key = (site, key, "n")
            for spec in self._specs.get(site, ()):
                n = self._fire_counts.get(attempt_key, 0)
                if spec.count is not None and n >= spec.count:
                    continue
                hit = (n in spec.steps if spec.steps is not None
                       else spec.prob >= 1.0
                       or self._bernoulli(site, n, None, spec.prob))
                self._fire_counts[attempt_key] = n + 1
                if hit:
                    self._count(site)
                    raise InjectedFault(
                        f"injected {site!r} failure (key={key!r}, attempt {n})")
                return
        return hook


# ---------------------------------------------------------------------------
# retry policy: bounded exponential backoff + deterministic jitter
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retries a host-side callable with bounded exponential backoff.

    Delays are ``min(base·2^attempt, max) · (1 + jitter·u)`` where ``u``
    is a deterministic uniform in [0, 1) derived from (seed, key,
    attempt) — two processes replaying the same faults back off
    identically, so a recovery trace reproduces.
    """

    max_retries: int = 3
    base_delay_s: float = 0.005
    max_delay_s: float = 0.25
    jitter: float = 0.25
    seed: int = 0

    def delay(self, key: Any, attempt: int) -> float:
        d = min(self.base_delay_s * (2.0 ** attempt), self.max_delay_s)
        digest = _site_digest(f"{self.seed}/{key!r}/{attempt}")
        u = (digest % (2**24)) / float(2**24)
        return d * (1.0 + self.jitter * u)

    def call(self, fn: Callable[[], Any], key: Any = None,
             on_retry: Optional[Callable[[int, BaseException], None]] = None):
        """Run ``fn``; on exception retry up to ``max_retries`` times with
        backoff. Re-raises the last exception when the budget is spent."""
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            try:
                return fn()
            except BaseException as e:  # noqa: BLE001 — host-side boundary
                last = e
                if attempt >= self.max_retries:
                    break
                if on_retry is not None:
                    on_retry(attempt, e)
                time.sleep(self.delay(key, attempt))
        assert last is not None
        raise last


# ---------------------------------------------------------------------------
# guarded steps: one non-finite count + escalation ladder
# ---------------------------------------------------------------------------


def _leaves(tree) -> list:
    return [leaf for _, leaf in _flatten_with_paths(tree)]


def _tensor_leaves(tree) -> list:
    return [leaf for leaf in _leaves(tree) if isinstance(leaf, torch.Tensor)]


def nonfinite_count(*trees) -> torch.Tensor:
    """Count of non-finite elements across trees, a 0-d int32 tensor on the
    leaves' device: nothing is read back until the caller reads it."""
    total = None
    for leaf in (t for tree in trees for t in _tensor_leaves(tree)):
        if leaf.is_floating_point():
            bad = (~torch.isfinite(leaf)).sum(dtype=torch.int32)
            total = bad if total is None else total + bad
    return torch.zeros((), dtype=torch.int32) if total is None else total


def guarded_update(old_params, old_opt_state, new_params, new_opt_state,
                   loss, scale, extra_bad=0):
    """Commit a candidate optimizer step only if it is finite.

    Returns ``(params, opt_state, loss, ok)``, ``ok`` a 0-d bool tensor.
    When the candidate params or the loss hold any non-finite value (or
    ``extra_bad > 0``, e.g. the backward's own grad census) the old params
    and state are kept bit for bit. ``scale`` (the guard ladder's
    LR-backoff knob) commits ``old + scale·(new - old)``. Tensors are
    selected with ``torch.where`` on their device. A host leaf of the
    state (the optimizer's step count, which the port keeps on the host)
    is selected on the host, which reads ``ok`` once: the read the JAX
    package's ``bool(ok)`` pays too, and the one a guarded step pays."""
    # extra_bad is added as it comes (a count on the device, or a host int):
    # copying a host value to the card would wait for the whole step
    ok = (nonfinite_count(new_params, loss) + extra_bad) == 0

    def sel_param(old, new):
        step = old + (scale * (new - old)).to(old.dtype)
        return torch.where(ok, step, old)

    params = _unflatten(old_params, [
        sel_param(a, b) for a, b in zip(_leaves(old_params), _leaves(new_params))])
    old_s, new_s = _leaves(old_opt_state), _leaves(new_opt_state)
    state = [torch.where(ok, b, a) if isinstance(a, torch.Tensor) else b
             for a, b in zip(old_s, new_s)]
    # host leaves last, so the read of ok comes after every launch above
    if any(not isinstance(a, torch.Tensor) and a != b
           for a, b in zip(old_s, new_s)) and not bool(ok):
        state = [b if isinstance(a, torch.Tensor) else a
                 for a, b in zip(old_s, state)]
    return params, _unflatten(old_opt_state, state), loss, ok


@dataclasses.dataclass(frozen=True)
class GuardPolicy:
    """Escalation ladder over *consecutive* guarded-step failures.

    rung 0 — every bad step is skipped on device (guarded_update);
    rung 1 — after ``backoff_after`` consecutive bad steps the commit
             scale is multiplied by ``backoff_factor`` per further bad
             step (floored at ``min_scale``);
    rung 2 — after ``rollback_after`` consecutive bad steps the runner
             invokes its restore hook (last checkpoint, incl. RNG state)
             and resets the ladder.
    A good step resets the ladder and restores ``scale = 1.0``.
    """

    backoff_after: int = 1
    backoff_factor: float = 0.5
    min_scale: float = 1.0 / 16.0
    rollback_after: int = 4


class GuardRunner:
    """Host-side executor of a :class:`GuardPolicy` ladder."""

    def __init__(self, policy: Optional[GuardPolicy] = None,
                 restore_fn: Optional[Callable[[], None]] = None):
        self.policy = policy or GuardPolicy()
        self.restore_fn = restore_fn
        self.scale = 1.0
        self.consecutive_bad = 0
        self.n_skipped = 0
        self.n_backoffs = 0
        self.n_rollbacks = 0
        self.events: list[dict] = []

    def after_step(self, ok: bool, step: Optional[int] = None) -> str:
        """Advance the ladder; returns the action taken
        (``"none" | "skip" | "backoff" | "rollback"``)."""
        p = self.policy
        if ok:
            self.consecutive_bad = 0
            self.scale = 1.0
            return "none"
        self.consecutive_bad += 1
        self.n_skipped += 1
        if self.consecutive_bad >= p.rollback_after:
            if self.restore_fn is not None:
                self.restore_fn()
            self.n_rollbacks += 1
            self.consecutive_bad = 0
            self.scale = 1.0
            self.events.append({"step": step, "action": "rollback"})
            return "rollback"
        if self.consecutive_bad > p.backoff_after:
            self.scale = max(self.scale * p.backoff_factor, p.min_scale)
            self.n_backoffs += 1
            self.events.append({"step": step, "action": "backoff",
                                "scale": self.scale})
            return "backoff"
        self.events.append({"step": step, "action": "skip"})
        return "skip"

    def stats(self) -> dict:
        return {"skipped": self.n_skipped, "backoffs": self.n_backoffs,
                "rollbacks": self.n_rollbacks, "scale": self.scale,
                "consecutive_bad": self.consecutive_bad}


# ---------------------------------------------------------------------------
# RNG-state capture (the checkpoint's determinism contract)
# ---------------------------------------------------------------------------


def pack_rng_state(gen: np.random.Generator) -> np.ndarray:
    """Serialize a numpy Generator's full bit-generator state to a uint8
    array — a checkpointable leaf (variable length is fine; restore
    matches by tree path, not shape)."""
    blob = json.dumps(gen.bit_generator.state).encode()
    return np.frombuffer(blob, dtype=np.uint8).copy()


def unpack_rng_state(gen: np.random.Generator, blob: np.ndarray) -> None:
    gen.bit_generator.state = json.loads(bytes(np.asarray(blob, np.uint8)))


# ---------------------------------------------------------------------------
# virtual clock — drives a heartbeat monitor deterministically in-process
# ---------------------------------------------------------------------------


class VirtualClock:
    """A manually-advanced monotonic clock: a monitor reads it, the trainer
    advances it by each step's measured (or injected) duration, so tests
    never sleep."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        self._now += float(dt)
        return self._now


# ---------------------------------------------------------------------------
# resilient distributed training orchestrator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RecoveryEvent:
    step: int
    action: str  # "rescale" | "rebalance" | "rollback"
    detail: dict
    recovery_s: float


def _to_host(tree):
    """A tree of tensors as numpy (host counts stay ints): what crosses
    between the rank processes and the parent."""
    from repro_torch.runtime.checkpoint import _flatten_with_paths

    leaves = [leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else leaf
              for _, leaf in _flatten_with_paths(tree)]
    return _unflatten(tree, leaves)


def _to_device(tree, device):
    from repro_torch.runtime.checkpoint import _flatten_with_paths

    leaves = [torch.from_numpy(np.array(leaf)).to(device)
              if isinstance(leaf, np.ndarray) else leaf
              for _, leaf in _flatten_with_paths(tree)]
    return _unflatten(tree, leaves)


def _state_digest(tree) -> str:
    """sha256 over a state's leaves (tensors, arrays, counts), in order."""
    from repro_torch.runtime.checkpoint import _flatten_with_paths, _to_numpy

    h = hashlib.sha256()
    for _, leaf in _flatten_with_paths(tree):
        h.update(np.ascontiguousarray(_to_numpy(leaf)).tobytes())
    return h.hexdigest()


def _segment_rank(rank: int, spec: dict) -> dict:
    """One rank of one segment (``ResilientDistributedTrainer._segment``):
    its slices loaded, the trainer bound from the carried state, the
    monitor fresh on the carried clock; epochs until the monitor
    recommends an action (every rank's monitor holds the same beats, so
    every rank stops at the same step) or ``spec["end"]`` is reached.
    Rank 0 saves the checkpoints (a barrier after each) and hands back
    the state, the guard runner and the injector; where the epochs ran
    out, every rank probes the loss and gradients at the final params."""
    import pickle

    import torch.distributed as tdist

    from repro_torch.launch.mesh import rank_device
    from repro_torch.runtime.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.runtime.failure import Action, HeartbeatMonitor
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.trainer import DistributedGNNTrainer

    device = rank_device(rank, spec["device"])
    with open(spec["files"][rank], "rb") as fh:
        dist, plan = pickle.load(fh)
    opt = spec["opt"]()
    clock = VirtualClock(spec["clock"])
    n = dist.n_ranks
    monitor = HeartbeatMonitor(n, dead_timeout=spec["dead_timeout"],
                               straggler_factor=spec["straggler_factor"],
                               window=spec["window"], clock=clock)
    tr = DistributedGNNTrainer(
        dist, spec["config"], opt, plan=plan,
        params=_to_device(spec["params"], device), device=device,
        guard=spec["guard"], injector=spec["injector"], monitor=monitor,
        clock=clock)
    tr.opt_state = _to_device(spec["opt_state"], device)
    tr._step_idx = spec["step"]
    ckpt_dir, every = spec["ckpt_dir"], spec["ckpt_every"]

    def _rollback():  # guard rung 2: back to the last checkpoint
        (tr.params, tr.opt_state), _ = restore_checkpoint(
            ckpt_dir, (tr.params, tr.opt_state))

    tr.set_rollback(_rollback)
    start_digest = _state_digest((tr.params, tr.opt_state)) if rank == 0 else None
    ready_at = time.time()
    losses, epoch_ms, action, states = [], [], Action.NONE, None
    while tr._step_idx < spec["end"]:
        t0 = time.perf_counter()
        losses.append(tr.train_epoch())
        epoch_ms.append((time.perf_counter() - t0) * 1e3)
        action = monitor.recommend()
        if action is not Action.NONE:
            states = {r: s.value for r, s in monitor.classify().items()}
            break
        if tr._step_idx % every == 0:
            if rank == 0:
                save_checkpoint(ckpt_dir, tr._step_idx, (tr.params, tr.opt_state),
                                injector=tr.injector)
            tdist.barrier()  # no rank rolls back to a half-written step
    out = {"rank": rank, "losses": losses, "epoch_ms": epoch_ms,
           "action": action.value, "states": states, "step": tr._step_idx,
           "clock": clock.now(), "ready_at": ready_at}
    if action is Action.NONE:
        loss, grads = tr.loss_and_grads()
        out["probe"] = {"loss": float(loss),
                        "grads": [g.cpu().numpy() for g in tree_leaves(grads)]}
    if rank == 0:
        if tr.guard is not None:
            tr.guard.restore_fn = None  # a closure over this process's trainer
        out.update(params=_to_host(tr.params), opt_state=_to_host(tr.opt_state),
                   guard=tr.guard, injector=tr.injector, start_digest=start_digest,
                   end_digest=_state_digest((tr.params, tr.opt_state)))
    return out


class ResilientDistributedTrainer:
    """Distributed training that survives dead and straggling ranks.

    Counterpart of the JAX package's orchestrator: the control plane
    around ``DistributedGNNTrainer`` — per-step heartbeats (on a
    :class:`VirtualClock` advanced by the measured step time, with
    injector-dictated suppression and slowdown), guarded steps, periodic
    checkpoints, and the heartbeat→action table:

    ========== =====================================================
    DEAD       checkpoint-restore onto fewer ranks
               (``elastic.rescale``: re-partition, re-lower, resume)
    STRAGGLER  degree-rebalancing re-partition (paper §IV-E1 Phase
               III, Σdeg balancing) at the same rank count; params
               are replicated and healthy so state carries over
    ========== =====================================================

    The JAX package drives one controller over a mesh; the port's ranks
    are processes (``launch/mesh.py:run_ranks``), so this orchestrator
    lives in the parent and runs the group a *segment* at a time: one
    group of its ``RankPool``'s first ``n_ranks`` processes
    (``launch/mesh.py``) that trains until the ranks' monitors
    recommend an action (every rank's monitor holds the same beats, so
    all stop at the same step) or the epochs run out. Rank 0 saves the
    checkpoints every ``ckpt_every`` steps, in the JAX package's format,
    and hands back the parameters, optimizer state, guard runner and
    injector as host values. A DEAD rank leads to ``elastic.rescale``
    from the latest checkpoint onto n − |dead| ranks in a new group of
    the pool's first n − |dead| processes; a
    STRAGGLER to ``hierarchical_partition(..., force_phase=
    "greedy_degree")`` at the same n with the carried state, bitwise. The
    injected death stays simulated, as in the JAX package: the "dead"
    rank's process runs on and stops heartbeating. The guard ladder's
    counters carry across rebuilds (one ``GuardRunner`` travels with the
    state).

    ``opt`` is a picklable callable that builds the optimizer (each rank
    builds its own: ``functools.partial(adam, 1e-2)``); ``params`` the
    starting weights (a tree of tensors or arrays, e.g. ``params_from_jax``'s),
    else ``seed``'s ``init_params``. ``device`` is where the ranks run
    (CUDA unless the caller asks for the CPU); the parent's state and
    host work stay on the CPU. Each segment's graph slices go to files
    in a temporary directory the parent removes. ``partition`` (the
    ``hierarchical_partition(graph, n_ranks, seed=partition_seed)`` a
    caller already has) skips the first partition. ``pool`` (a
    ``RankPool`` of at least ``n_ranks`` members on ``device``) runs the
    segments where the caller keeps one; else the trainer spawns its own
    when it is built. ``close`` (or leaving a ``with`` statement) stops
    the trainer's own pool and removes its files; a caller's pool stays
    open.
    """

    #: what each rank runs for a segment (``pool.run(segment_rank, n,
    #: (spec,))``); a subclass may wrap it, to count or record what a
    #: segment launches on its ranks
    segment_rank = staticmethod(_segment_rank)

    def __init__(self, graph, features, labels, train_mask, config, opt,
                 n_ranks: int, *, ckpt_dir: str, ckpt_every: int = 2,
                 guard: Optional[GuardPolicy] = None,
                 injector: Optional[FaultInjector] = None,
                 dead_timeout: float = 0.5, straggler_factor: float = 3.0,
                 window: int = 8, seed: int = 0, br: int = 8, bc: int = 32,
                 partition_seed: int = 0, params=None, device=None,
                 timeout_s: float = 300.0, partition=None, pool=None):
        from repro_torch import resolve_device
        from repro_torch.launch.mesh import RankPool
        from repro_torch.models.gnn import init_params

        self.graph = graph
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.train_mask = np.asarray(train_mask)
        self.config = config
        self.opt = opt
        self.n_ranks = int(n_ranks)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = int(ckpt_every)
        # one runner for the whole run: ladder state and skip/backoff/
        # rollback counters survive rebuilds (rescale/rebalance)
        self.guard = GuardRunner(guard or GuardPolicy())
        self.injector = injector
        self.dead_timeout = float(dead_timeout)
        self.straggler_factor = float(straggler_factor)
        self.window = int(window)
        self.br, self.bc = int(br), int(bc)
        self.partition_seed = int(partition_seed)
        self.device = resolve_device(device)
        self.timeout_s = float(timeout_s)

        self.clock = VirtualClock()
        self.step_idx = 0
        self.events: list[RecoveryEvent] = []
        #: one record a segment: ranks, steps, spawn and epoch times
        self.segments: list[dict] = []
        self.builds: list[dict] = []
        cpu = torch.device("cpu")
        if params is None:
            params = init_params(config, torch.Generator().manual_seed(seed), cpu)
        self.params = _to_device(_to_host(params), cpu)
        self.opt_state = opt().init(self.params)
        self.probe = None  # (loss, grads) at the current params, once taken
        self._work = None
        # the pool's members reach their device while the host partitions
        self._own_pool = pool is None
        self.pool = pool if pool is not None else RankPool(
            self.n_ranks, device=self.device, timeout_s=self.timeout_s)
        try:
            self._build(self.n_ranks, partition=partition)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        """Stop the trainer's own pool (a caller's stays open) and remove
        the segments' files."""
        if self._own_pool:
            self.pool.close()
        self._drop_work()

    def __enter__(self) -> "ResilientDistributedTrainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- (re)construction ---------------------------------------------------

    def _agg(self) -> str:
        from repro_torch.core.lowering import effective_aggregation
        return effective_aggregation(self.config)

    def _build(self, n_ranks: int, force_phase: Optional[str] = None,
               partition=None) -> None:
        """Partition (unless given), build and lower for ``n_ranks`` ranks,
        and write each rank's slices for the next segment."""
        import pickle
        import tempfile

        from repro_torch.core.halo import build_distributed_graph
        from repro_torch.core.lowering import lower_distributed
        from repro_torch.core.partitioner import hierarchical_partition

        times = {"ranks": int(n_ranks)}
        t0 = time.perf_counter()
        if partition is None:
            partition = hierarchical_partition(self.graph, n_ranks,
                                               seed=self.partition_seed,
                                               force_phase=force_phase)
        times["partition_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dist = build_distributed_graph(
            self.graph, self.features, self.labels, self.train_mask, partition,
            br=self.br, bc=self.bc, aggregation=self._agg())
        times["build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan = lower_distributed(self.config, dist)
        times["lower_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._drop_work()
        self._work = tempfile.mkdtemp(prefix="repro_torch_resilient_")
        self._files = []
        for r in range(n_ranks):
            self._files.append(os.path.join(self._work, f"rank{r}.pkl"))
            with open(self._files[-1], "wb") as fh:
                pickle.dump((dist.rank_slice(r, bulk=plan.overlap is None),
                             plan.rank_slice(r)), fh, protocol=5)
        times["write_s"] = time.perf_counter() - t0
        #: the host's seconds for each (re)build: partition, distributed
        #: graph, lowering, the ranks' files
        self.builds.append(times)
        self.partition = partition
        self.n_ranks = int(n_ranks)

    def _drop_work(self) -> None:
        import shutil

        if self._work is not None:
            shutil.rmtree(self._work, ignore_errors=True)
            self._work = None

    # -- checkpoint plumbing ------------------------------------------------

    def _state(self) -> tuple:
        return (self.params, self.opt_state)

    def save(self) -> str:
        from repro_torch.runtime.checkpoint import save_checkpoint
        return save_checkpoint(self.ckpt_dir, self.step_idx, self._state(),
                               injector=self.injector)

    # -- a segment ------------------------------------------------------------

    def _segment(self, end: int) -> dict:
        spec = {"files": self._files, "config": self.config, "opt": self.opt,
                "params": _to_host(self.params),
                "opt_state": _to_host(self.opt_state), "guard": self.guard,
                "injector": self.injector, "clock": self.clock.now(),
                "step": self.step_idx, "end": int(end),
                "dead_timeout": self.dead_timeout,
                "straggler_factor": self.straggler_factor, "window": self.window,
                "ckpt_dir": self.ckpt_dir, "ckpt_every": self.ckpt_every,
                "device": self.device}
        t0 = time.time()
        ranks = self.pool.run(self.segment_rank, self.n_ranks, (spec,))
        r0 = ranks[0]
        for r in ranks[1:]:
            if (r["action"], r["step"], r["losses"]) != (r0["action"], r0["step"],
                                                         r0["losses"]):
                raise RuntimeError(
                    f"rank {r['rank']} parted from rank 0: action {r['action']!r} "
                    f"at step {r['step']} against {r0['action']!r} at {r0['step']}")
        cpu = torch.device("cpu")
        self.params = _to_device(r0["params"], cpu)
        self.opt_state = _to_device(r0["opt_state"], cpu)
        self.guard, self.injector = r0["guard"], r0["injector"]
        self.clock = VirtualClock(r0["clock"])
        self.step_idx = r0["step"]
        self.probe = (r0["probe"]["loss"], r0["probe"]["grads"]) if "probe" in r0 else None
        self.segments.append({
            "ranks": self.n_ranks, "steps": len(r0["losses"]),
            "start_s": max(r["ready_at"] for r in ranks) - t0,
            "ready_at": max(r["ready_at"] for r in ranks),
            "epoch_ms": r0["epoch_ms"], "action": r0["action"],
            "start_digest": r0["start_digest"], "end_digest": r0["end_digest"]})
        return r0

    # -- recovery actions ---------------------------------------------------

    def _rescale(self, dead) -> RecoveryEvent:
        """DEAD rank(s): restore the latest checkpoint onto fewer ranks
        (re-partition + re-lower + resume) — ``elastic.rescale``."""
        from repro_torch.runtime.elastic import rescale

        t0 = time.perf_counter()
        new_ranks = max(self.n_ranks - len(dead), 1)
        state, plan = rescale(self.ckpt_dir, self.graph, new_ranks,
                              self._state(), old_ranks=self.n_ranks,
                              partition_seed=self.partition_seed)
        self.params, self.opt_state = state
        self.probe = None
        self._build(new_ranks, partition=plan.partition)
        if self.injector is not None:
            self.injector.clear("rank_dead")  # the dead hardware is gone
        ev = RecoveryEvent(
            step=self.step_idx, action="rescale",
            detail={"dead": sorted(int(d) for d in dead),
                    "old_ranks": plan.old_ranks, "new_ranks": plan.new_ranks,
                    "restored_step": plan.restored_step},
            recovery_s=time.perf_counter() - t0)
        self.events.append(ev)
        return ev

    def _rebalance(self) -> RecoveryEvent:
        """STRAGGLER: re-partition with Phase III degree balancing (the
        paper's remedy — rebalance Σdeg(v), Eq. 9) at the same rank
        count. The replicated params and optimizer state carry over."""
        t0 = time.perf_counter()
        self._build(self.n_ranks, force_phase="greedy_degree")
        if self.injector is not None:
            self.injector.clear("rank_slow")  # load has been rebalanced
        ev = RecoveryEvent(
            step=self.step_idx, action="rebalance",
            detail={"ranks": self.n_ranks,
                    "load_imbalance": float(self.partition.load_imbalance)},
            recovery_s=time.perf_counter() - t0)
        self.events.append(ev)
        return ev

    # -- the training loop --------------------------------------------------

    def fit(self, epochs: int) -> dict:
        """Train ``epochs`` epochs in all, segment by segment, recovering
        between segments. An event's ``recovery_s`` runs from the action's
        decision to the next segment's ranks bound and ready (the host's
        restore, partition, build and lowering, then the new group);
        ``detail["host_s"]`` is the host's part alone. An action at the
        last epoch has no next segment: its ``recovery_s`` is the host's
        part."""
        losses: list[float] = []
        end = self.step_idx + int(epochs)
        self.save()  # step-0 anchor so the first recovery has a target
        pending = None  # (event, decided at) until the next segment is up
        while self.step_idx < end:
            seg = self._segment(end)
            losses += seg["losses"]
            if pending is not None:
                ev, t = pending
                ev.recovery_s = self.segments[-1]["ready_at"] - t
                pending = None
            t = time.time()
            if seg["action"] == "restart_from_checkpoint":
                dead = [int(r) for r, s in seg["states"].items() if s == "dead"]
                pending = (self._rescale(dead), t)
            elif seg["action"] == "rebalance":
                pending = (self._rebalance(), t)
            if pending is not None:
                pending[0].detail["host_s"] = pending[0].recovery_s
        return {"losses": losses, "events": self.events,
                "guard": self.guard.stats(), "final_ranks": self.n_ranks,
                "segments": self.segments, "builds": self.builds}

    def loss_and_grads(self):
        """Global loss and gradients (numpy leaves, ``tree_leaves`` order)
        at the current params on the current ranks: the last segment's
        probe where it was taken at these params, else a segment of no
        epochs that probes."""
        if self.probe is None:
            self._segment(self.step_idx)
        return self.probe
