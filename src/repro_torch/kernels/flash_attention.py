"""Flash (tiled, online-softmax) attention: softmax(q·kᵀ·scale)·v without
the (Tq, Tk) score matrix ever reaching device memory.

The port of ``repro/kernels/flash_attention.py:flash_attention`` (the
Pallas TPU kernel, ``pallas_call`` at :106), the LM substrate's prefill
attention. For CUDA tensors the wrapper launches the hand-written Hopper
kernel ``kernels/csrc/flash_attention.cu`` (128 query rows a CTA, 64 at
D = 112, 128 and 256, shared by up to ``HEADS_PER_CTA`` heads of one KV group; 8x8 register
tiles fed by float4 shared-memory reads; K/V tiles loaded by ``cp.async``
where q, k and v are float32 with 16-byte aligned rows, else by the
kernel's synchronous path; float32 accumulation on the CUDA cores, any
Tq and Tk, nothing padded in memory); for CPU tensors it runs the plain
version ``kernels/ref.py:flash_attention_ref``. No fallback: a CUDA call
that cannot launch raises. The causal mask is aligned top-left, as the
Pallas kernel aligns it. ``flash_attention.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.ref import flash_attention_ref

#: head widths the kernel is instantiated for (one template each)
HEAD_DIMS = (8, 16, 32, 64, 112, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the most query heads of one KV group a CTA serves: each K/V tile it
#: loads then serves that many heads (on an H100, 4 heads a CTA ran 5-6%
#: faster than 1 with the group's CTAs neighbours in the grid; PERF.md)
HEADS_PER_CTA = 4


@functools.cache
def _entry():
    from repro_torch.kernels.build import load_library

    fn = load_library("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
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


def _heads_per_cta(group: int) -> int:
    """The query heads of one KV group a CTA serves: the largest power of
    two up to ``HEADS_PER_CTA`` that divides the group."""
    hp = 1
    while hp * 2 <= HEADS_PER_CTA and group % (hp * 2) == 0:
        hp *= 2
    return hp


def _rows_aligned(t: torch.Tensor) -> bool:
    """Does every (b, h, t) row of ``t`` start on 16 bytes (float4)?"""
    elem = t.element_size()
    return (t.data_ptr() % 16 == 0
            and all((st * elem) % 16 == 0 for st in t.stride()[:3]))


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
    so a ``transpose(1, 2)`` view of [B, T, H, D] needs no copy. Float32
    inputs whose rows all start on 16 bytes load their tiles by
    ``cp.async``; the others (bfloat16, or a misaligned view) by the
    kernel's synchronous path, with the same result.
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
    async_ok = q.dtype == torch.float32 and all(map(_rows_aligned, (q, k, v)))
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    with torch.cuda.device(q.device):
        err = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, h, hkv, tq, tk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            scale, int(causal), _heads_per_cta(h // hkv), int(async_ok),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
