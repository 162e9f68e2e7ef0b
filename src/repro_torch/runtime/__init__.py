"""The runtime: checkpoint/restart, the resilience layer (fault injection,
guarded steps, retries, the distributed orchestrator), the heartbeat
monitor, elastic rescale and host-streamed strips. Counterpart of
``repro/runtime/``. The names of ``runtime.streaming`` load with it."""
from repro_torch.runtime.checkpoint import (
    latest_step,
    list_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.runtime.elastic import ElasticPlan, rescale
from repro_torch.runtime.failure import Action, HeartbeatMonitor, RankState
from repro_torch.runtime.resilience import (
    FaultInjector,
    FaultSpec,
    GuardPolicy,
    GuardRunner,
    InjectedFault,
    RecoveryEvent,
    ResilientDistributedTrainer,
    RetryPolicy,
    StreamFetchError,
    StripChecksumError,
    VirtualClock,
    guarded_update,
    nonfinite_count,
    pack_rng_state,
    unpack_rng_state,
)
from repro_torch.runtime.streaming import (
    HostStrips,
    StreamedOperand,
    build_streamed_operand,
    streamed_spmm,
)

__all__ = [
    "Action", "ElasticPlan", "FaultInjector", "FaultSpec", "GuardPolicy",
    "GuardRunner", "HeartbeatMonitor", "HostStrips", "InjectedFault",
    "RankState", "RecoveryEvent", "ResilientDistributedTrainer",
    "RetryPolicy", "StreamFetchError", "StreamedOperand",
    "StripChecksumError", "VirtualClock", "build_streamed_operand",
    "guarded_update", "latest_step", "list_checkpoints", "nonfinite_count",
    "pack_rng_state", "rescale", "restore_checkpoint", "save_checkpoint",
    "streamed_spmm", "unpack_rng_state",
]
