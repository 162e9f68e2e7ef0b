"""CUDA backend — counterpart of ``repro/backends/pallas.py``.

Names the Hopper kernels as the executor of a plan's sparse primitives:
the sampled path runs ``kernels/ops.py:bsr_spmm_pair`` with ``inner="cuda"``
(``kernels/csrc/bsr_spmm.cu`` for CUDA tensors, its plain version for CPU
tensors). Full-batch operands come with the full-batch slice.
"""
from __future__ import annotations

from repro_torch.backends.registry import Backend


class CudaBackend(Backend):
    name = "cuda"
