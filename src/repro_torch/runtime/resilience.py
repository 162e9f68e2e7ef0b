"""Resilience layer, the single-device half: fault injection, guarded
steps, retries, RNG capture.

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
  jitter for host-side callbacks.

The distributed orchestrator (heartbeats, elastic rescale, streamed
shards and their errors) waits for ROADMAP.md Queue 1, item 7.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
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
