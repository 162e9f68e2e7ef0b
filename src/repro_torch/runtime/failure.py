"""Fault-tolerance control plane: heartbeats, straggler detection, restart
policy. Counterpart of ``repro/runtime/failure.py`` (pure Python, copied).

On a real cluster this runs on the coordinator; here it is a host-side
module driven by injected timestamps (``runtime.resilience.VirtualClock``),
so the policy logic is exercised without hardware. In the port's
distributed runtime each rank process keeps its own monitor, fed the same
step time on every rank (``DistributedGNNTrainer``), so the ranks classify
alike and reach the same action at the same step.

Straggler mitigation follows the paper's diagnosis (§IV-E1: "straggler
partitions" from degree imbalance): when a rank is persistently slow the
recommended action is *re-partitioning with Phase III degree balancing*,
not just retrying — computational load, Σdeg(v), is the quantity to
rebalance (Eq. 9).
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Optional


class RankState(enum.Enum):
    HEALTHY = "healthy"
    STRAGGLER = "straggler"
    DEAD = "dead"


class Action(enum.Enum):
    NONE = "none"
    REBALANCE = "rebalance"  # re-run partitioner Phase III on observed loads
    RESTART_FROM_CHECKPOINT = "restart_from_checkpoint"


@dataclasses.dataclass
class RankHealth:
    last_heartbeat: float
    step_times: list = dataclasses.field(default_factory=list)
    state: RankState = RankState.HEALTHY


class HeartbeatMonitor:
    """Tracks per-rank heartbeats + step durations; classifies health.

    * DEAD: no heartbeat for ``dead_timeout`` seconds -> restart from the
      latest checkpoint on a (possibly smaller — elastic) mesh.
    * STRAGGLER: median step time of the rank exceeds
      ``straggler_factor`` × fleet median over a sliding window ->
      recommend degree-rebalancing re-partition.
    """

    def __init__(self, n_ranks: int, dead_timeout: float = 60.0,
                 straggler_factor: float = 1.5, window: int = 16,
                 clock=time.monotonic):
        self.n_ranks = n_ranks
        self.dead_timeout = dead_timeout
        self.straggler_factor = straggler_factor
        self.window = window
        self._clock = clock
        now = clock()
        self.ranks = {r: RankHealth(last_heartbeat=now) for r in range(n_ranks)}

    def heartbeat(self, rank: int, step_time: Optional[float] = None):
        h = self.ranks[rank]
        h.last_heartbeat = self._clock()
        if step_time is not None:
            h.step_times.append(step_time)
            if len(h.step_times) > self.window:
                h.step_times.pop(0)

    def _median(self, xs):
        xs = sorted(xs)
        return xs[len(xs) // 2] if xs else None

    def classify(self) -> dict[int, RankState]:
        now = self._clock()
        fleet = [t for h in self.ranks.values() for t in h.step_times]
        fleet_med = self._median(fleet)
        out = {}
        for r, h in self.ranks.items():
            if now - h.last_heartbeat > self.dead_timeout:
                h.state = RankState.DEAD
            elif (
                fleet_med is not None
                and len(h.step_times) >= max(self.window // 2, 2)
                and self._median(h.step_times) > self.straggler_factor * fleet_med
            ):
                h.state = RankState.STRAGGLER
            else:
                h.state = RankState.HEALTHY
            out[r] = h.state
        return out

    def recommend(self) -> Action:
        states = self.classify().values()
        if any(s is RankState.DEAD for s in states):
            return Action.RESTART_FROM_CHECKPOINT
        if any(s is RankState.STRAGGLER for s in states):
            return Action.REBALANCE
        return Action.NONE
