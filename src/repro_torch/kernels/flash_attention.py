"""Flash (tiled, online-softmax) attention: softmax(q·kᵀ·scale)·v without
the (Tq, Tk) score matrix ever reaching device memory.

The port of ``repro/kernels/flash_attention.py:flash_attention`` (the
Pallas TPU kernel, ``pallas_call`` at :106), the LM substrate's prefill
attention. For CUDA tensors the wrapper launches the hand-written Hopper
kernel ``kernels/csrc/flash_attention.cu`` (one CTA per (batch·head,
64-row query tile), float32 accumulation on the CUDA cores, any Tq and
Tk, nothing padded in memory); for CPU tensors it runs the plain version
``kernels/ref.py:flash_attention_ref``. No fallback: a CUDA call that
cannot launch raises. The causal mask is aligned top-left, as the Pallas
kernel aligns it. ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.ref import flash_attention_ref

#: head widths the kernel is instantiated for (one template each)
HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _entry():
    from repro_torch.kernels.build import load_library

    fn = load_library("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_int,
                                                  ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [B, H, T, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, tq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k and v must be [{b}, Hkv, Tk, {d}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    hkv, tk = k.shape[1], k.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"{hkv} KV heads do not divide {h} query heads")
    if tq == 0 or tk == 0:
        raise ValueError("attention needs at least one query and one key")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")


def flash_attention(
    q: torch.Tensor,  # [B, H, Tq, D]
    k: torch.Tensor,  # [B, Hkv, Tk, D]
    v: torch.Tensor,  # [B, Hkv, Tk, D]
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v in float32, returned in q's dtype as [B, H, Tq,
    D]; ``causal`` masks key ``col > row`` (top-left); ``sm_scale``
    defaults to ``1/sqrt(D)``. Query head h reads KV head ``h // (H //
    Hkv)``.

    The inputs are float32 or bfloat16 (all alike) and D one of
    ``HEAD_DIMS`` on every device, as the kernel takes them. On the card
    the last axis is contiguous; the other strides are read as they are,
    so a ``transpose(1, 2)`` view of [B, T, H, D] needs no copy.
    The result is a [B, H, Tq, D] view of a [B, Tq, H, D] tensor, so
    ``transpose(1, 2)`` of it is contiguous. CPU calls run the plain
    version and do not count as launches."""
    _check(q, k, v)
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / float(d) ** 0.5
    if d not in HEAD_DIMS:
        raise ValueError(f"head width D={d} is not built; widths: {HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, sm_scale=scale)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous, stride "
                             f"{t.stride(3)}")
    if b * h > 65535:
        raise ValueError(f"B·H = {b * h} exceeds the grid's 65535")
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    with torch.cuda.device(q.device):
        err = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, h, hkv, tq, tk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            scale, int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
