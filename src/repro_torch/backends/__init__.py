"""Backend primitive registry (DESIGN.md §2-3).

Importing this package registers ``cuda`` (the Hopper kernels), ``torch``
(their plain PyTorch versions), ``gather`` (edge-list baseline) and
``distributed`` (the halo-exchange compositions, requested by name from
``lower_distributed``).
"""
from repro_torch.backends.registry import (
    DIST_OP_VOCABULARY,
    OP_VOCABULARY,
    Backend,
    apply_epilogue,
    compose_epilogue,
    get_backend,
    register_backend,
    select_backend,
)
from repro_torch.backends.cuda import CudaBackend
from repro_torch.backends.gather import GatherBackend
from repro_torch.backends.reference import TorchBackend
from repro_torch.backends.distributed import DistributedBackend

register_backend(CudaBackend())
register_backend(TorchBackend())
register_backend(GatherBackend())
register_backend(DistributedBackend())

__all__ = [
    "DIST_OP_VOCABULARY",
    "OP_VOCABULARY",
    "Backend",
    "CudaBackend",
    "DistributedBackend",
    "GatherBackend",
    "TorchBackend",
    "apply_epilogue",
    "compose_epilogue",
    "get_backend",
    "register_backend",
    "select_backend",
]
