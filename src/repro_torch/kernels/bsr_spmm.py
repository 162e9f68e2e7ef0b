"""Block-sparse-row SpMM: Y = A·X over a flattened BSR stream.

The port of ``repro/kernels/bsr_spmm.py:bsr_spmm`` (the Pallas TPU kernel,
``pallas_call`` at :105). For CUDA tensors the wrapper launches the
hand-written Hopper kernel ``kernels/csrc/bsr_spmm.cu`` (one CTA per
(block-row, feature tile), no atomics, bitwise repeatable); for CPU
tensors it runs the plain version ``kernels/ref.py:bsr_spmm_ref``. There
is no fallback between the two: a CUDA call that cannot launch raises.
The source's header says what bounds the kernel; PERF.md has its times.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.ref import bsr_spmm_ref

#: (br, bc) tiles instantiated by ``csrc/bsr_spmm.cu``
TILES = ((8, 8), (8, 16), (8, 32), (8, 64), (8, 128), (16, 16), (16, 32),
         (16, 64))


@functools.cache
def _entry():
    from repro_torch.kernels.build import load_library

    fn = load_library("bsr_spmm").bsr_spmm_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(block_rows, block_cols, blocks, x, n_rows_padded):
    if blocks.dim() != 3 or x.dim() != 2:
        raise ValueError(f"blocks must be [n_blocks, br, bc] and x [n_cols, F], "
                         f"got {tuple(blocks.shape)} and {tuple(x.shape)}")
    n_blocks, br, bc = blocks.shape
    if block_rows.shape != (n_blocks,) or block_cols.shape != (n_blocks,):
        raise ValueError(f"block_rows/block_cols must be [{n_blocks}], got "
                         f"{tuple(block_rows.shape)}/{tuple(block_cols.shape)}")
    if x.shape[0] % bc != 0:
        raise ValueError("x rows must be padded to the block-column size")
    if n_rows_padded < 0 or n_rows_padded % br != 0:
        raise ValueError(f"n_rows_padded={n_rows_padded} must be a multiple "
                         f"of br={br}")


def bsr_spmm(
    block_rows: torch.Tensor,  # [n_blocks] int32 (sorted)
    block_cols: torch.Tensor,  # [n_blocks] int32
    blocks: torch.Tensor,  # [n_blocks, BR, BC] float32
    x: torch.Tensor,  # [n_cols_padded, F] float32, any F
    n_rows_padded: int,
) -> torch.Tensor:
    """Y = A @ X with A in flattened BSR. Output is float32 [n_rows_padded, F].

    Block indices must lie inside the padded operand, rows sorted and each
    row's block-columns increasing, zero padding blocks trailing
    (``csr_to_bsr`` and the sampler guarantee it); the kernel does not
    re-check them on the device. ``bsr_spmm.launches`` counts kernel
    launches (CPU calls do not count).
    """
    _check(block_rows, block_cols, blocks, x, n_rows_padded)
    if x.device.type == "cpu":
        return bsr_spmm_ref(block_rows, block_cols, blocks, x, n_rows_padded)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_spmm runs on cuda or cpu tensors, got {x.device}")
    for name, t, dtype in (("block_rows", block_rows, torch.int32),
                           ("block_cols", block_cols, torch.int32),
                           ("blocks", blocks, torch.float32),
                           ("x", x, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_blocks, br, bc = blocks.shape
    if (br, bc) not in TILES:
        raise ValueError(f"tile ({br}, {bc}) is not built; tiles: {TILES}")
    f = x.shape[1]
    y = torch.empty((n_rows_padded, f), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry()(block_rows.data_ptr(), block_cols.data_ptr(),
                       blocks.data_ptr(), x.data_ptr(), y.data_ptr(),
                       n_blocks, n_rows_padded // br, f, br, bc, stream)
    if err != 0:
        raise RuntimeError(f"bsr_spmm kernel launch failed: cudaError {err}")
    bsr_spmm.launches += 1
    return y


bsr_spmm.launches = 0
