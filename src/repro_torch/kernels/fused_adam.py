"""Fused AdamW update: one elementwise pass that reads (p, g, m, v) and
writes (p, m, v), instead of the ~10 separate elementwise ops an unfused
Adam runs, and one launch for all of a step's leaves.

The port of ``repro/kernels/fused_adam.py:fused_adam`` (the Pallas TPU
kernel, ``pallas_call`` at :86, one call a leaf). ``fused_adam_multi``
takes a step's leaves as lists; for CUDA tensors it launches the
hand-written Hopper kernel ``kernels/csrc/fused_adam.cu`` once for every
``CAPACITY`` leaves (a table of their pointers passed by value; the work
is their concatenated 16-byte chunks, float4 accesses where a leaf's
pointers allow), and for CPU tensors it runs the plain version
``kernels/ref.py:fused_adam_ref`` leaf by leaf. ``fused_adam`` is its
one-leaf call. No fallback: a CUDA call that cannot launch raises. The
bias correction is folded into ``lr_t`` by the caller, a host float, so a
step reads nothing back from the card. Each output is a tensor of its own
(contiguous, its leaf's shape); the inputs are not modified.

The call is also the operator ``torch.ops.repro_torch.fused_adam``
(``torch.library.custom_op``), whose shape-only version
(``register_fake``) serves ``meta`` and fake tensors. The wrapper takes
it only where ``kernels/build.py:via_operator`` says (no values, or a
dispatch mode watching): a step over value-less tensors
(``launch/step_cost.py``) sees one operator, and ``fused_adam_cost``
gives its bytes and launches, while a plain call launches the kernel
without the operator's dispatch.
"""
from __future__ import annotations

import array
import ctypes
import functools
from typing import NamedTuple, Sequence

import torch
from torch import Tensor

from repro_torch.kernels.build import via_operator
from repro_torch.kernels.ref import fused_adam_ref

#: leaves one launch carries: ``kCapacity`` in ``csrc/fused_adam.cu``
#: (checked against the library when it loads)
CAPACITY = 48
#: floats in one 16-byte chunk, the kernel's unit of work
CHUNK = 4


class Table(NamedTuple):
    """One launch's leaves: their indices in the step's list, the first
    chunk of each in the launch's chunk space followed by the total
    (``len(leaves) + 1`` entries), and whether each takes float4
    accesses."""

    leaves: list
    starts: list
    vec: list


def pack_tables(sizes: Sequence[int], aligned: Sequence[bool],
                capacity: int = CAPACITY) -> list:
    """The launches of one step over leaves of ``sizes`` values: the
    nonempty leaves in order, ``capacity`` to a table, each rounded up to
    whole chunks of ``CHUNK`` values. A leaf is ``vec`` where ``aligned``
    says all seven of its pointers are 16-byte aligned: its whole chunks
    take float4 accesses and its last partial chunk scalar ones; any other
    leaf takes scalar accesses throughout. Empty leaves take no slot."""
    nonempty = [i for i, n in enumerate(sizes) if n > 0]
    tables = []
    for s in range(0, len(nonempty), capacity):
        leaves = nonempty[s:s + capacity]
        starts = [0]
        for i in leaves:
            starts.append(starts[-1] + -(-sizes[i] // CHUNK))
        tables.append(Table(leaves, starts, [bool(aligned[i]) for i in leaves]))
    return tables


def aligned16(ptrs: Sequence[int]) -> bool:
    """Do all of a leaf's seven pointers (``data_ptr()``) start on a
    16-byte boundary?"""
    a, b, c, d, e, f, g = ptrs
    return not (a | b | c | d | e | f | g) & 15


def fused_adam_cost(sizes: Sequence[int]) -> dict:
    """The bytes, operations and launches of one step over leaves of
    ``sizes`` float32 values: p, g, m and v read once and p, m and v
    written once (28 bytes a value), against ~15 elementwise operations a
    value, in one launch for every ``CAPACITY`` nonempty leaves (as
    ``pack_tables`` packs them)."""
    n = sum(sizes)
    return {"bytes": 28 * n, "flop": 15.0 * n,
            "launches": len(pack_tables(sizes, [True] * len(sizes)))}


@functools.cache
def _entry():
    from repro_torch.kernels.build import load_library

    lib = load_library("fused_adam")
    if lib.fused_adam_capacity() != CAPACITY:
        raise RuntimeError(f"fused_adam.cu carries {lib.fused_adam_capacity()} "
                           f"leaves a launch, the wrapper packs {CAPACITY}")
    fn = lib.fused_adam_f32
    # the four arrays are host buffers (``array.array``), passed by address
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_float] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(ps, gs, ms, vs) -> torch.device:
    """The lists' device, after checking what the kernel takes: equal
    lengths, each leaf's four shapes equal, every tensor float32,
    contiguous and on one device (cpu or cuda; meta for their shapes)."""
    if not (len(ps) == len(gs) == len(ms) == len(vs)):
        raise ValueError(f"ps, gs, ms, vs lengths differ: {len(ps)}, {len(gs)}, "
                         f"{len(ms)}, {len(vs)}")
    for i, (p, g, m, v) in enumerate(zip(ps, gs, ms, vs)):
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"leaf {i}: p, g, m, v shapes differ: "
                             f"{tuple(p.shape)}, {tuple(g.shape)}, "
                             f"{tuple(m.shape)}, {tuple(v.shape)}")
    every = [*ps, *gs, *ms, *vs]
    devices = {t.device for t in every}
    if len(devices) > 1:
        raise ValueError(f"fused_adam takes tensors on one device, got {devices}")
    dtypes = {t.dtype for t in every}
    if dtypes != {torch.float32}:
        raise TypeError(f"fused_adam takes float32 tensors, got {dtypes}")
    if not all(t.is_contiguous() for t in every):
        raise ValueError("fused_adam takes contiguous tensors")
    (device,) = devices
    if device.type not in ("cpu", "cuda", "meta"):
        raise ValueError("fused_adam runs on cuda or cpu tensors (meta for their "
                         f"shapes), got {device}")
    return device


def fused_adam_multi(
    ps: Sequence[torch.Tensor],
    gs: Sequence[torch.Tensor],
    ms: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    lr_t: float,  # bias correction pre-folded
    *,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
):
    """One AdamW step on every leaf ``(ps[i], gs[i], ms[i], vs[i])``;
    returns the lists ``(ps', ms', vs')``. On the card one launch for every
    ``CAPACITY`` nonempty leaves, each counted in ``fused_adam.launches``
    (CPU calls run the plain version and count nothing; ``meta`` calls
    give the outputs' shapes)."""
    device = _check(ps, gs, ms, vs)
    if via_operator(ps[0]):
        n = len(ps)
        out = torch.ops.repro_torch.fused_adam(list(ps), list(gs), list(ms), list(vs),
                                               lr_t, beta1, beta2, eps, weight_decay)
        return out[:n], out[n:2 * n], out[2 * n:]
    return _adam_call(device, ps, gs, ms, vs, lr_t, beta1, beta2, eps, weight_decay)


def _adam_call(device, ps, gs, ms, vs, lr_t, beta1, beta2, eps, weight_decay):
    """The checked call: the plain version leaf by leaf for CPU tensors,
    else the kernel's launches; returns ``(ps', ms', vs')``."""
    if device.type == "cpu":
        out = [fused_adam_ref(p, g, m, v, lr_t, beta1, beta2, eps, weight_decay)
               for p, g, m, v in zip(ps, gs, ms, vs)]
        return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]
    p_new = [torch.empty_like(p) for p in ps]
    m_new = [torch.empty_like(m) for m in ms]
    v_new = [torch.empty_like(v) for v in vs]
    ptrs = [[x.data_ptr() for x in leaf]
            for leaf in zip(ps, gs, ms, vs, p_new, m_new, v_new)]
    sizes = [p.numel() for p in ps]
    tables = pack_tables(sizes, [aligned16(q) for q in ptrs])
    if not tables:
        return p_new, m_new, v_new
    fn = _entry()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for t in tables:
            host = (array.array("Q", [q for i in t.leaves for q in ptrs[i]]),
                    array.array("q", [sizes[i] for i in t.leaves]),
                    array.array("q", t.starts), array.array("B", t.vec))
            err = fn(len(t.leaves), *(a.buffer_info()[0] for a in host), lr_t,
                     beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps, weight_decay,
                     stream)
            if err != 0:
                raise RuntimeError(f"fused_adam kernel launch failed: cudaError {err}")
            fused_adam.launches += 1
    return p_new, m_new, v_new


@torch.library.custom_op("repro_torch::fused_adam", mutates_args=())
def _adam_op(ps: list[Tensor], gs: list[Tensor], ms: list[Tensor], vs: list[Tensor],
             lr_t: float, beta1: float, beta2: float, eps: float,
             weight_decay: float) -> list[Tensor]:
    """``_adam_call`` as an operator: ``ps' + ms' + vs'`` as one list."""
    p_new, m_new, v_new = _adam_call(ps[0].device, ps, gs, ms, vs, lr_t, beta1, beta2,
                                     eps, weight_decay)
    return p_new + m_new + v_new


@_adam_op.register_fake
def _adam_shapes(ps, gs, ms, vs, lr_t, beta1, beta2, eps, weight_decay):
    """The outputs without values: each leaf's p, m and v like its own."""
    return [torch.empty_like(t) for t in (*ps, *ms, *vs)]


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
    are not modified). ``fused_adam.launches`` counts the kernel's
    launches, from here and from ``fused_adam_multi``."""
    (p_new,), (m_new,), (v_new,) = fused_adam_multi(
        [p], [g], [m], [v], lr_t, beta1=beta1, beta2=beta2, eps=eps,
        weight_decay=weight_decay)
    return p_new, m_new, v_new


fused_adam.launches = 0
