"""Backend primitive registry (DESIGN.md §2-3).

Importing this package registers ``cuda`` (the Hopper kernels), ``torch``
(their plain PyTorch versions) and ``gather`` (edge-list baseline).
"""
from repro_torch.backends.registry import (
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

register_backend(CudaBackend())
register_backend(TorchBackend())
register_backend(GatherBackend())

__all__ = [
    "OP_VOCABULARY",
    "Backend",
    "CudaBackend",
    "GatherBackend",
    "TorchBackend",
    "apply_epilogue",
    "compose_epilogue",
    "get_backend",
    "register_backend",
    "select_backend",
]
