"""CUDA backend — counterpart of ``repro/backends/pallas.py``.

BSR operands (CSR -> BSR once, ``kernels/ops.py:BSRDevice``) consumed by
the Hopper kernels: ``spmm`` runs ``kernels/csrc/bsr_spmm.cu``, and the
native ``spmm_fused_epilogue`` runs ``bsr_spmm_fused.cu`` forward and
``bsr_spmm_masked.cu`` (or ``bsr_spmm.cu``) on Aᵀ backward, all three over
each operand's nonzero columns, built once when the op is bound
(``spmm_transposed_vjp``, which ``feature_matmul_sparse`` binds over X
and Xᵀ, and ``spmm_fused_epilogue``); ``sparse_mha`` runs
``bsr_attention.cu`` (the forward and the row pass over A's nonzero
columns, the column pass over Aᵀ's, both built when the op is bound). The kernel wrappers run their plain versions for CPU tensors, so
the same plans run in the CPU tests. The sampled path runs
``kernels/ops.py:bsr_spmm_pair`` with ``inner="cuda"``, which builds
each batch layer's columns where its product runs.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.backends.registry import Backend
from repro_torch.graph.csr import CSRGraph, csr_to_bsr
from repro_torch.kernels import ops as kops


class CudaBackend(Backend):
    name = "cuda"
    inner = "cuda"  # the executor of kernels/ops.py this backend binds

    def build_spmm_operand(self, csr: CSRGraph, br: int = 8,
                           bc: Optional[int] = None, device=None):
        return kops.BSRDevice.from_bsr(csr_to_bsr(csr, br=br, bc=bc), device)

    def operand_bytes(self, operand) -> int:
        return operand.nbytes

    def spmm(self, operand, x: torch.Tensor) -> torch.Tensor:
        return operand.matmul(x, self.inner)

    def spmm_transposed_vjp(self, fwd_operand, bwd_operand):
        """The shared composition, with both operands' nonzero columns
        built here, once, for the ``cuda`` executor (the ``torch`` one
        reads none): no step pays for the build, and the operands'
        ``nbytes`` count it."""
        if self.inner == "cuda":
            fwd_operand.nonzero_columns()
            bwd_operand.nonzero_columns()
        return super().spmm_transposed_vjp(fwd_operand, bwd_operand)

    def spmm_fused_epilogue(self, fwd_operand, bwd_operand):
        """The native fused kernel: the epilogue applied where each row's
        sum finishes; the backward folds the ReLU mask into the transposed
        SpMM (``kernels/ops.py:bsr_spmm_fused_pair``)."""
        return kops.build_fused_epilogue(fwd_operand, bwd_operand, self.inner)

    def sparse_mha(self, fwd_operand, bwd_operand):
        """The fused attention kernels: edge softmax and aggregation in one
        pass, the recompute VJP from the saved (max, denominator) row
        statistics (``kernels/ops.py:sparse_mha_pair``)."""
        return kops.build_sparse_mha(fwd_operand, bwd_operand, self.inner)
