"""The single-device runtime: checkpoint/restart and the resilience layer
(fault injection, guarded steps, retries). Counterpart of
``repro/runtime/checkpoint.py`` and of ``repro/runtime/resilience.py``'s
device half; the distributed runtime (heartbeats, elastic rescale,
streamed shards) is ROADMAP.md Queue 1, item 7."""
from repro_torch.runtime.checkpoint import (
    latest_step,
    list_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.runtime.resilience import (
    FaultInjector,
    FaultSpec,
    GuardPolicy,
    GuardRunner,
    InjectedFault,
    RetryPolicy,
    VirtualClock,
    guarded_update,
    nonfinite_count,
    pack_rng_state,
    unpack_rng_state,
)

__all__ = [
    "FaultInjector", "FaultSpec", "GuardPolicy", "GuardRunner",
    "InjectedFault", "RetryPolicy", "VirtualClock", "guarded_update",
    "latest_step", "list_checkpoints", "nonfinite_count", "pack_rng_state",
    "restore_checkpoint", "save_checkpoint", "unpack_rng_state",
]
