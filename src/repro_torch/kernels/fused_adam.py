"""Fused AdamW update: one elementwise pass that reads (p, g, m, v) and
writes (p, m, v), instead of the ~10 separate elementwise ops an unfused
Adam runs.

The port of ``repro/kernels/fused_adam.py:fused_adam`` (the Pallas TPU
kernel, ``pallas_call`` at :86). For CUDA tensors the wrapper launches the
hand-written Hopper kernel ``kernels/csrc/fused_adam.cu`` (a grid-stride
loop, any length, nothing padded); for CPU tensors it runs the plain
version ``kernels/ref.py:fused_adam_ref``. No fallback: a CUDA call that
cannot launch raises. The bias correction is folded into ``lr_t`` by the
caller, a host float, so a step reads nothing back from the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.ref import fused_adam_ref


@functools.cache
def _entry():
    from repro_torch.kernels.build import load_library

    fn = load_library("fused_adam").fused_adam_f32
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                   + [ctypes.c_float] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def fused_adam(
    p: torch.Tensor,
    g: torch.Tensor,
    m: torch.Tensor,
    v: torch.Tensor,
    lr_t: float,  # bias correction pre-folded
    *,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
):
    """One AdamW step on one leaf; returns new ``(p, m, v)`` (the inputs
    are not modified). ``fused_adam.launches`` counts kernel launches (CPU
    calls run the plain version and do not count)."""
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError(f"p, g, m, v shapes differ: {tuple(p.shape)}, "
                         f"{tuple(g.shape)}, {tuple(m.shape)}, {tuple(v.shape)}")
    if p.device.type == "cpu":
        return fused_adam_ref(p, g, m, v, lr_t, beta1, beta2, eps,
                              weight_decay)
    if p.device.type != "cuda":
        raise ValueError(f"fused_adam runs on cuda or cpu tensors, got {p.device}")
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    p_new, m_new, v_new = (torch.empty_like(p), torch.empty_like(m),
                           torch.empty_like(v))
    if p.numel() == 0:
        return p_new, m_new, v_new
    with torch.cuda.device(p.device):
        err = _entry()(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                       p_new.data_ptr(), m_new.data_ptr(), v_new.data_ptr(),
                       p.numel(), lr_t, beta1, 1.0 - beta1, beta2,
                       1.0 - beta2, eps, weight_decay,
                       torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_adam kernel launch failed: cudaError {err}")
    fused_adam.launches += 1
    return p_new, m_new, v_new


fused_adam.launches = 0
