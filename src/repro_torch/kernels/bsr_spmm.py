"""Block-sparse-row SpMM family: Y = act(A·(M ⊙ X) + α·self + bias) over a
flattened BSR stream.

The port of ``repro/kernels/bsr_spmm.py``'s three Pallas TPU kernels:

* ``bsr_spmm`` (``pallas_call`` at :105): Y = A·X;
* ``bsr_spmm_fused_epilogue`` (:245): the epilogue α·self + bias and an
  optional ReLU (with its 0/1 mask) applied where the row's sum finishes;
* ``bsr_spmm_masked`` (:312): Y = A·(mask ⊙ X), the ReLU epilogue's VJP.

For CUDA tensors each wrapper launches its hand-written Hopper kernel
(``kernels/csrc/bsr_spmm*.cu``: one CTA per (block-row, feature tile), no
atomics, bitwise repeatable); for CPU tensors it runs the plain version in
``kernels/ref.py``. There is no fallback between the two: a CUDA call that
cannot launch raises. ``bsr_common.cuh`` says what bounds the kernels;
PERF.md has their times. Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.ref import (
    bsr_spmm_fused_ref,
    bsr_spmm_masked_ref,
    bsr_spmm_ref,
)

#: (br, bc) tiles instantiated by ``csrc/bsr_common.cuh:BSR_FOR_EACH_TILE``
TILES = ((8, 8), (8, 16), (8, 32), (8, 64), (8, 128), (16, 16), (16, 32),
         (16, 64))

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _entry(name: str, symbol: str, argtypes: tuple):
    from repro_torch.kernels.build import load_library

    fn = getattr(load_library(name), symbol)
    fn.argtypes = list(argtypes)
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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the BSR kernels run on cuda or cpu tensors, got "
                         f"{x.device}")


def _check_launch(**tensors):
    """What the CUDA kernels take: every operand on x's card, int32
    indices, float32 values, contiguous; and a built tile."""
    device = tensors["x"].device
    for name, t in tensors.items():
        if t is None:
            continue
        dtype = torch.int32 if name in ("block_rows", "block_cols") else torch.float32
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    br, bc = tensors["blocks"].shape[1:]
    if (br, bc) not in TILES:
        raise ValueError(f"tile ({br}, {bc}) is not built; tiles: {TILES}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


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
    re-check them on the device. CPU calls run the plain version and do
    not count as launches.
    """
    _check(block_rows, block_cols, blocks, x, n_rows_padded)
    if x.device.type == "cpu":
        return bsr_spmm_ref(block_rows, block_cols, blocks, x, n_rows_padded)
    _check_launch(block_rows=block_rows, block_cols=block_cols,
                  blocks=blocks, x=x)
    n_blocks, br, bc = blocks.shape
    f = x.shape[1]
    y = torch.empty((n_rows_padded, f), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    fn = _entry("bsr_spmm", "bsr_spmm_f32", (_P,) * 5 + (_I,) * 5 + (_P,))
    with torch.cuda.device(x.device):
        err = fn(block_rows.data_ptr(), block_cols.data_ptr(),
                 blocks.data_ptr(), x.data_ptr(), y.data_ptr(), n_blocks,
                 n_rows_padded // br, f, br, bc, _stream(x.device))
    _raise_on(err, "bsr_spmm")
    bsr_spmm.launches += 1
    return y


def bsr_spmm_fused_epilogue(
    block_rows: torch.Tensor,
    block_cols: torch.Tensor,
    blocks: torch.Tensor,
    x: torch.Tensor,  # [n_cols_padded, F] float32
    n_rows_padded: int,
    self_term: Optional[torch.Tensor] = None,  # [n_rows_padded, F]
    bias: Optional[torch.Tensor] = None,  # [F] (or [1, F])
    alpha=None,  # 1-element float32 tensor (a float on the CPU)
    activation: str = "none",  # "none" | "relu"
):
    """Y = act(A @ X + alpha * self_term + bias), the epilogue fused into
    the SpMM. Returns ``(y, mask)``: ``mask`` is the float32 0/1 sign of
    the pre-activation with ``activation="relu"``, else ``None``.

    The spec is static by the presence of ``self_term`` / ``bias`` and the
    activation, as in the Pallas kernel; ``self_term`` requires ``alpha``
    (1.0 for a plain add), which the kernel reads on the device, so a
    parameter α costs no host sync.
    """
    _check(block_rows, block_cols, blocks, x, n_rows_padded)
    if activation not in ("none", "relu"):
        raise ValueError(f"unsupported fused activation {activation!r}")
    f = x.shape[1]
    if self_term is not None:
        if alpha is None:
            raise ValueError("self_term requires alpha (use 1.0 for plain add)")
        if tuple(self_term.shape) != (n_rows_padded, f):
            raise ValueError(f"self_term must be [{n_rows_padded}, {f}], got "
                             f"{tuple(self_term.shape)}")
    if bias is not None and bias.numel() != f:
        raise ValueError(f"bias must hold {f} values, got {tuple(bias.shape)}")
    relu = activation == "relu"
    if x.device.type == "cpu":
        return bsr_spmm_fused_ref(block_rows, block_cols, blocks, x,
                                  n_rows_padded, self_term, bias, alpha,
                                  activation)
    if self_term is not None and not (isinstance(alpha, torch.Tensor)
                                      and alpha.numel() == 1):
        raise ValueError("alpha must be a 1-element tensor on the card")
    _check_launch(block_rows=block_rows, block_cols=block_cols,
                  blocks=blocks, x=x, self_term=self_term, bias=bias,
                  alpha=alpha if self_term is not None else None)
    n_blocks, br, bc = blocks.shape
    y = torch.empty((n_rows_padded, f), dtype=torch.float32, device=x.device)
    mask = torch.empty_like(y) if relu else None
    if y.numel() == 0:
        return y, mask
    fn = _entry("bsr_spmm_fused", "bsr_spmm_fused_f32",
                (_P,) * 9 + (_I,) * 8 + (_P,))
    with torch.cuda.device(x.device):
        err = fn(block_rows.data_ptr(), block_cols.data_ptr(),
                 blocks.data_ptr(), x.data_ptr(), _ptr(self_term),
                 _ptr(bias), _ptr(alpha if self_term is not None else None),
                 y.data_ptr(), _ptr(mask), n_blocks, n_rows_padded // br, f,
                 br, bc, int(self_term is not None), int(bias is not None),
                 int(relu), _stream(x.device))
    _raise_on(err, "bsr_spmm_fused_epilogue")
    bsr_spmm_fused_epilogue.launches += 1
    return y, mask


def bsr_spmm_masked(
    block_rows: torch.Tensor,
    block_cols: torch.Tensor,
    blocks: torch.Tensor,
    x: torch.Tensor,  # [n_cols_padded, F] — the incoming cotangent dY
    mask: torch.Tensor,  # shaped like x — the saved activation mask
    n_rows_padded: int,
) -> torch.Tensor:
    """Y = A @ (mask ⊙ X), the mask applied to X as it is loaded: the
    fused-epilogue VJP through a ReLU (A is the transposed operand)."""
    _check(block_rows, block_cols, blocks, x, n_rows_padded)
    if mask.shape != x.shape:
        raise ValueError(f"mask shape {tuple(mask.shape)} != x shape "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return bsr_spmm_masked_ref(block_rows, block_cols, blocks, x, mask,
                                   n_rows_padded)
    _check_launch(block_rows=block_rows, block_cols=block_cols,
                  blocks=blocks, x=x, mask=mask)
    n_blocks, br, bc = blocks.shape
    f = x.shape[1]
    y = torch.empty((n_rows_padded, f), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    fn = _entry("bsr_spmm_masked", "bsr_spmm_masked_f32",
                (_P,) * 6 + (_I,) * 5 + (_P,))
    with torch.cuda.device(x.device):
        err = fn(block_rows.data_ptr(), block_cols.data_ptr(),
                 blocks.data_ptr(), x.data_ptr(), mask.data_ptr(),
                 y.data_ptr(), n_blocks, n_rows_padded // br, f, br, bc,
                 _stream(x.device))
    _raise_on(err, "bsr_spmm_masked")
    bsr_spmm_masked.launches += 1
    return y


bsr_spmm.launches = 0
bsr_spmm_fused_epilogue.launches = 0
bsr_spmm_masked.launches = 0
