"""Plain PyTorch backend ``torch`` — counterpart of ``repro/backends/xla.py``.

The same BSR operands as the ``cuda`` backend, executed by the plain
versions in ``kernels/ref.py`` on whatever device the tensors live on,
under the same autograd Functions: the reference a ``cuda`` plan is
compared with on the card.
"""
from __future__ import annotations

from repro_torch.backends.cuda import CudaBackend


class TorchBackend(CudaBackend):
    name = "torch"
    inner = "torch"
