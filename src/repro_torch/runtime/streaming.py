"""Host-resident BSR operands, streamed to the card one strip ahead.

Counterpart of ``repro/runtime/streaming.py`` (DESIGN.md §11): when a
graph's BSR operands exceed the device-memory budget, the operands stay
on the host and a prefetcher streams fixed-size *strips* of the block
stream to the device, one step ahead of the strip being consumed.

The host half is a copy. ``HostStrips`` cuts a
:class:`~repro_torch.graph.csr.BSRMatrix`'s flat block stream into ``S``
equal-shaped strips of at most ``budget_bytes / 2`` each, padded with
explicit zero blocks at block-row 0, byte for byte as the JAX package
cuts them (``rows``, ``cols``, ``blocks``, ``checksums``), and
``device_nbytes()`` / ``total_nbytes()`` keep its reckoning.

The card half is a translation. The card's SpMM kernels read an
operand's nonzero columns (``kernels/bsr_spmm.py:NonzeroColumns``), not
its blocks, so each strip also gets its own column stream, built once on
the host when the strips are built (empty block-rows dropped: a strip
adds nothing to rows it does not touch) and packed into one buffer; the
first pass on a card pins that buffer and allocates two device buffers,
each the size of the largest strip's stream. A pass over the strips
issues strip s + 1's host-to-device copy on a side CUDA stream before it
launches strip s's kernel (``bsr_spmm_accumulate``, y += A_s·X), as the
JAX package fetches s + 1 before it computes with s: the depth-1
prefetch of ``OverlapPlan.prefetch_depth``. CUDA events make the kernel
wait for its strip's copy and a buffer's next copy wait for the kernel
that read it. A strip boundary can cut a block-row in two, which is why
the kernel adds into the caller's y instead of storing; strips run in
order on one stream, so the sum is the same run to run, with no atomics.
On CPU tensors each strip runs the plain version over its blocks
(``bsr_spmm_accum_ref``); on the card no strip reaches the plain
version.

Each fetch's host half runs before its copy is issued, as the JAX
package's callback does: the ``fault_hook``, the ``RetryPolicy``, the
checksum check (``StripChecksumError``) and the wrap into
``StreamFetchError`` with the strip, shard, operand name and attempts.
With ``verify_fetch`` the strips record two crc32s a strip at build time:
the JAX package's over (rows, cols, blocks), which a CPU fetch checks
(the plain version reads the blocks), and one over the packed column
stream, which a card fetch checks in pinned memory, the bytes the copy
reads. Unlike the JAX package's scan, whose last step refetches the
last strip (its clamped index), the port does not refetch: a pass makes
one fetch a strip, so a ``fault_hook`` that fires on the last strip
fires once a pass fewer than in the JAX package.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core.aggregate import Aggregation, _weighted_graph
from repro_torch.graph.csr import BSRMatrix, CSRGraph, csr_to_bsr, permute_graph
from repro_torch.kernels.bsr_spmm import (
    NonzeroColumns,
    bsr_spmm_accumulate,
    nonzero_columns,
)
from repro_torch.kernels.ref import bsr_spmm_accum_ref
from repro_torch.runtime.resilience import (
    RetryPolicy,
    StreamFetchError,
    StripChecksumError,
)

#: byte alignment of each array in a packed column stream (the kernels
#: load items and values as 16-byte vectors)
_ALIGN = 16


def _strip_checksum(rows: np.ndarray, cols: np.ndarray,
                    blocks: np.ndarray) -> int:
    """crc32 chained over one strip's three arrays (host-side, cheap
    relative to the host→device copy the fetch feeds)."""
    c = zlib.crc32(np.ascontiguousarray(rows).tobytes())
    c = zlib.crc32(np.ascontiguousarray(cols).tobytes(), c)
    return zlib.crc32(np.ascontiguousarray(blocks).tobytes(), c)


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


@dataclasses.dataclass(frozen=True)
class StripColumns:
    """Where one strip's column stream lies in the packed buffer: byte
    offsets of its items, splits, x_rows and values from the strip's
    start, their counts, and the strip's bytes."""

    offset: int        # the strip's first byte in the packed buffer
    nbytes: int
    n_items: int
    n_split: int
    n_cols: int
    n_slots: int
    sections: tuple    # byte offsets of items, splits, x_rows, values

    def unpack(self, buf: torch.Tensor, br: int,
               n_block_rows: int) -> NonzeroColumns:
        """The strip's ``NonzeroColumns`` as views of ``buf`` (a uint8
        tensor holding the strip's bytes from 0)."""
        def part(i, dtype, shape):
            n = int(np.prod(shape)) * 4
            start = self.sections[i]
            return buf[start:start + n].view(dtype).view(shape)

        return NonzeroColumns(
            items=part(0, torch.int32, (self.n_items, 4)),
            splits=part(1, torch.int32, (self.n_split, 3)),
            x_rows=part(2, torch.int32, (self.n_cols,)),
            values=part(3, torch.float32, (self.n_cols, br)),
            n_block_rows=n_block_rows, n_slots=self.n_slots)


def _strip_columns(rows, cols, blocks, n_rows_padded: int):
    """One strip's column stream on the host (``nonzero_columns`` with CPU
    torch ops), its empty items dropped, packed: (bytes, counts)."""
    nzc = nonzero_columns(torch.from_numpy(rows), torch.from_numpy(cols),
                          torch.from_numpy(blocks), n_rows_padded)
    items = nzc.items[nzc.items[:, 2] > nzc.items[:, 1]]
    arrays = [items.numpy(), nzc.splits.numpy(), nzc.x_rows.numpy(),
              nzc.values.numpy()]
    sections, at = [], 0
    for a in arrays:
        sections.append(at)
        at = _aligned(at + a.nbytes)
    packed = np.zeros(at, dtype=np.uint8)
    for a, s in zip(arrays, sections):
        packed[s:s + a.nbytes] = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
    counts = (items.shape[0], nzc.splits.shape[0], nzc.x_rows.shape[0],
              nzc.n_slots, tuple(sections))
    return packed, counts


class _CardStage:
    """One ``HostStrips``' card side: the pinned column streams, two device
    buffers the size of the largest strip's, the side stream the copies
    run on and the events that order copies and kernels."""

    def __init__(self, strips: "HostStrips", device: torch.device):
        self.device = device
        if not strips.packed.is_pinned():
            strips.packed = strips.packed.pin_memory()
        self.pinned = strips.packed
        size = max(c.nbytes for c in strips.columns)
        self.bufs = [torch.empty(max(size, _ALIGN), dtype=torch.uint8, device=device)
                     for _ in range(2)]
        self.side = torch.cuda.Stream(device)
        self.copied = [torch.cuda.Event() for _ in range(2)]
        self.consumed: list = [None, None]

    def copy(self, strips: "HostStrips", s: int, timeline) -> None:
        """Issue strip ``s``'s copy into buffer s % 2 on the side stream,
        after the kernel that last read that buffer."""
        b, c = s % 2, strips.columns[s]
        if self.consumed[b] is not None:
            self.side.wait_event(self.consumed[b])
        with torch.cuda.stream(self.side):
            t0 = _timing_event(self.side, timeline)
            self.bufs[b][:c.nbytes].copy_(self.pinned[c.offset:c.offset + c.nbytes],
                                          non_blocking=True)
            t1 = _timing_event(self.side, timeline)
            self.copied[b].record(self.side)
        if timeline is not None:
            timeline.append({"strip": s, "copy": (t0, t1), "bytes": c.nbytes})

    def launch(self, strips: "HostStrips", s: int, x: torch.Tensor,
               y: torch.Tensor, timeline) -> None:
        """Strip ``s``'s kernel on the current stream once its copy is in."""
        b, c = s % 2, strips.columns[s]
        main = torch.cuda.current_stream(self.device)
        main.wait_event(self.copied[b])
        nzc = c.unpack(self.bufs[b], strips.br, strips.n_rows_padded // strips.br)
        t0 = _timing_event(main, timeline)
        bsr_spmm_accumulate(nzc, x, y)
        t1 = _timing_event(main, timeline)
        if self.consumed[b] is None:
            self.consumed[b] = torch.cuda.Event()
        self.consumed[b].record(main)
        if timeline is not None:
            next(e for e in reversed(timeline) if e["strip"] == s)["kernel"] = (t0, t1)


def _timing_event(stream, timeline):
    if timeline is None:
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record(stream)
    return e


# eq=False: hashed by identity, as the JAX package's (a static operand there)
@dataclasses.dataclass(eq=False)
class HostStrips:
    """A BSR block stream cut into equal-shaped host-resident strips, with
    each strip's column stream for the card."""

    rows: np.ndarray  # [S, Bmax] int32 block-row ids
    cols: np.ndarray  # [S, Bmax] int32 block-col ids
    blocks: np.ndarray  # [S, Bmax, br, bc] float32
    n_rows: int  # logical (unpadded) output rows
    n_cols: int  # logical (unpadded) input rows
    n_rows_padded: int
    n_cols_padded: int
    n_blocks: int  # real blocks across all strips (excl. strip padding)
    # -- resilience (DESIGN.md §13) ------------------------------------
    # host-side failures carry the strip index / shard id / operand name,
    # and transient failures are retried under ``retry`` first
    shard_id: int = 0
    name: str = ""
    retry: Optional[RetryPolicy] = None
    fault_hook: Optional[callable] = None  # test/bench injection point
    # opt-in silent-corruption guard (DESIGN.md §14): per-strip crc32
    # recorded at build time and re-verified inside every retried fetch;
    # None = fetches unverified (the default)
    checksums: Optional[np.ndarray] = None  # [S] uint32, over (rows, cols, blocks)
    # -- the card's column streams -------------------------------------
    #: every strip's packed column stream, one uint8 tensor (pinned at the
    #: first pass on a card)
    packed: Optional[torch.Tensor] = None
    columns: tuple = ()  # [S] StripColumns
    column_checksums: Optional[np.ndarray] = None  # [S] uint32, over ``packed``
    #: when a list, a card pass appends each strip's timing events to it
    #: ({"strip", "copy": (start, end), "kernel": (start, end), "bytes"})
    timeline: Optional[list] = None
    _stages: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_strips(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def blocks_per_strip(self) -> int:
        return int(self.blocks.shape[1])

    @property
    def br(self) -> int:
        return int(self.blocks.shape[2])

    def strip_nbytes(self) -> int:
        """Device footprint of ONE strip (the prefetcher holds two), as the
        JAX package reckons it: the strip's blocks and indices."""
        return int(self.rows[0].nbytes + self.cols[0].nbytes
                   + self.blocks[0].nbytes)

    def device_nbytes(self) -> int:
        """Peak device residency: consumed strip + in-flight strip."""
        return 2 * self.strip_nbytes()

    def total_nbytes(self) -> int:
        """Host footprint — what a fully-resident operand would pin."""
        return int(self.rows.nbytes + self.cols.nbytes + self.blocks.nbytes)

    def card_nbytes(self) -> int:
        """What the card holds of this operand: its two strip buffers,
        each the largest strip's column stream."""
        return 2 * max(c.nbytes for c in self.columns)

    def pinned_nbytes(self) -> int:
        """The column streams of every strip, pinned on the host."""
        return int(self.packed.numel())

    @classmethod
    def from_bsr(cls, bsr: BSRMatrix, budget_bytes: int, *,
                 shard_id: int = 0, name: str = "",
                 retry: Optional[RetryPolicy] = None,
                 fault_hook=None, verify_fetch: bool = False) -> "HostStrips":
        """Cut ``bsr`` so that two device-resident strips fit the budget."""
        block_nbytes = bsr.br * bsr.bc * 4 + 8  # tile + its two indices
        per_strip = max(1, int(budget_bytes // (2 * block_nbytes)))
        n_strips = max(1, -(-bsr.n_blocks // per_strip))
        per_strip = -(-bsr.n_blocks // n_strips)  # rebalance evenly
        pad = n_strips * per_strip - bsr.n_blocks
        # padding blocks scatter zeros into block-row 0: a no-op
        rows = np.concatenate(
            [bsr.block_rows.astype(np.int32),
             np.zeros(pad, np.int32)]).reshape(n_strips, per_strip)
        colsv = np.concatenate(
            [bsr.block_cols.astype(np.int32),
             np.zeros(pad, np.int32)]).reshape(n_strips, per_strip)
        blocks = np.concatenate(
            [bsr.blocks.astype(np.float32),
             np.zeros((pad, bsr.br, bsr.bc), np.float32)]).reshape(
                 n_strips, per_strip, bsr.br, bsr.bc)
        rows = np.ascontiguousarray(rows)
        colsv = np.ascontiguousarray(colsv)
        blocks = np.ascontiguousarray(blocks)
        packs, columns, at = [], [], 0
        for s in range(n_strips):
            packed, (n_items, n_split, n_cols, n_slots, sections) = _strip_columns(
                rows[s], colsv[s], blocks[s], bsr.padded_rows)
            columns.append(StripColumns(
                offset=at, nbytes=packed.nbytes, n_items=n_items, n_split=n_split,
                n_cols=n_cols, n_slots=n_slots, sections=sections))
            packs.append(packed)
            at += packed.nbytes
        packed = torch.from_numpy(np.concatenate(packs))
        checksums = column_checksums = None
        if verify_fetch:
            checksums = np.asarray(
                [_strip_checksum(rows[s], colsv[s], blocks[s])
                 for s in range(n_strips)], dtype=np.uint32)
            column_checksums = np.asarray(
                [zlib.crc32(packs[s]) for s in range(n_strips)], dtype=np.uint32)
        return cls(rows=rows, cols=colsv, blocks=blocks,
                   n_rows=bsr.n_rows, n_cols=bsr.n_cols,
                   n_rows_padded=bsr.padded_rows,
                   n_cols_padded=bsr.padded_cols,
                   n_blocks=bsr.n_blocks,
                   shard_id=int(shard_id), name=str(name),
                   retry=retry, fault_hook=fault_hook,
                   checksums=checksums, packed=packed, columns=tuple(columns),
                   column_checksums=column_checksums)

    # -- the fetch's host half ------------------------------------------

    def _verify(self, i: int, card: bool) -> None:
        if card:
            c = self.columns[i]
            got = zlib.crc32(self.packed[c.offset:c.offset + c.nbytes].numpy())
            want = int(self.column_checksums[i])
        else:
            got = _strip_checksum(self.rows[i], self.cols[i], self.blocks[i])
            want = int(self.checksums[i])
        if got != want:
            raise StripChecksumError(strip=i, name=self.name, expected=want, got=got)

    def fetch(self, i: int, card: bool) -> None:
        """The host half of strip ``i``'s fetch, before its copy (``card``)
        or its plain product is issued: the fault hook (an injected host
        fault, standing in for a pinned-memory or remote-shard read), the
        checksum where the strips carry them (of what the copy reads on
        the card, of the blocks off it), retried under ``retry``; once
        the budget is spent, the failure is raised as a
        :class:`StreamFetchError` naming the strip, shard and operand."""
        def read():
            if self.fault_hook is not None:
                self.fault_hook(i)  # may raise (injected host fault)
            if self.checksums is not None:
                # verified inside the retried read: transient corruption
                # retries like any host fault, persistent corruption
                # exhausts the budget and names the strip
                self._verify(i, card)

        attempts = [0]

        def counted():
            attempts[0] += 1
            return read()

        try:
            if self.retry is not None:
                return self.retry.call(counted, key=(self.name, self.shard_id, i))
            return counted()
        except StreamFetchError:
            raise
        except BaseException as e:
            raise StreamFetchError(
                strip=i, shard=self.shard_id, name=self.name,
                cause=e, attempts=attempts[0]) from e

    # -- a pass -----------------------------------------------------------

    def _stage(self, device: torch.device) -> _CardStage:
        key = (device.type, device.index)
        if key not in self._stages:
            self._stages[key] = _CardStage(self, device)
        return self._stages[key]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x`` accumulated strip by strip with the depth-1 prefetch;
        float32 [n_rows, F]."""
        f = x.shape[-1]
        x_p = torch.zeros((self.n_cols_padded, f), dtype=torch.float32,
                          device=x.device)
        x_p[: x.shape[0]] = x
        y = torch.zeros((self.n_rows_padded, f), dtype=torch.float32,
                        device=x.device)
        card = x.device.type == "cuda"
        if card:
            device = x.device if x.device.index is not None else torch.device(
                "cuda", torch.cuda.current_device())
            stage, timeline = self._stage(device), self.timeline
            self.fetch(0, card)
            stage.copy(self, 0, timeline)
        else:
            self.fetch(0, card)
        for s in range(self.n_strips):
            if s + 1 < self.n_strips:
                # fetch s+1 BEFORE computing with s: on the card its copy
                # runs on the side stream while strip s's kernel runs
                self.fetch(s + 1, card)
                if card:
                    stage.copy(self, s + 1, timeline)
            if card:
                stage.launch(self, s, x_p, y, timeline)
            else:
                y = bsr_spmm_accum_ref(
                    y, torch.from_numpy(self.rows[s]), torch.from_numpy(self.cols[s]),
                    torch.from_numpy(self.blocks[s]), x_p, self.n_rows_padded)
        return y[: self.n_rows]


class _StreamedSpMM(torch.autograd.Function):
    """``y = A @ x`` over ``fwd``'s strips; the backward streams ``bwd``
    (Aᵀ) the same way. Linear in x: no residuals (the JAX package's
    ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x, fwd: HostStrips, bwd: HostStrips):
        ctx.bwd = bwd
        return fwd.apply(x).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        return ctx.bwd.apply(dy).to(dy.dtype), None, None


def streamed_spmm(fwd: HostStrips, bwd: HostStrips, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` with ``A`` (and ``A^T`` for the gradient) streamed
    from the host.

    ``fwd`` holds ``A`` strips (``[n_rows, n_cols]``), ``bwd`` the
    pre-transposed ``A^T`` strips (``[n_cols, n_rows]``). At most two
    strips of either operand are on the device at any point: on the card,
    two strips' column streams.
    """
    return _StreamedSpMM.apply(x, fwd, bwd)


@dataclasses.dataclass(eq=False)
class StreamedOperand:
    """Per-shard host-resident forward/backward streams for one graph.

    ``order`` is the shard-contiguous node permutation applied when the
    operand was built: position ``p`` of the streamed space holds original
    node ``order[p]``; callers permute features/labels/masks by ``order``
    once and train entirely in streamed space.
    """

    fwd: HostStrips
    bwd: HostStrips
    order: np.ndarray  # [n] old node id at each streamed position
    shard_offsets: np.ndarray  # [k+1] streamed-row extent of each shard
    aggregation: str

    @property
    def n_nodes(self) -> int:
        return int(self.order.shape[0])

    def aggregate(self, u: torch.Tensor) -> torch.Tensor:
        return streamed_spmm(self.fwd, self.bwd, u)

    def device_nbytes(self) -> int:
        """Peak operand residency: the forward stream is fully consumed
        before the backward stream starts, so the phases don't overlap and
        the peak is the larger pair of strips, not the sum."""
        return max(self.fwd.device_nbytes(), self.bwd.device_nbytes())

    def total_nbytes(self) -> int:
        return self.fwd.total_nbytes() + self.bwd.total_nbytes()

    def card_nbytes(self) -> int:
        """What the card holds of both operands: each keeps its own two
        strip buffers of column streams."""
        return self.fwd.card_nbytes() + self.bwd.card_nbytes()

    def pinned_nbytes(self) -> int:
        return self.fwd.pinned_nbytes() + self.bwd.pinned_nbytes()


def build_streamed_operand(
    graph: CSRGraph,
    aggregation: Aggregation = "sum",
    k_shards: int = 4,
    budget_bytes: int = 1 << 20,
    br: int = 8,
    bc: int = 32,
    retry: Optional[RetryPolicy] = None,
    shard_id: int = 0,
    verify_fetch: bool = False,
    assignment: Optional[np.ndarray] = None,
) -> StreamedOperand:
    """Partition ``graph`` into ``k_shards`` host shards and build streams.

    Nodes are reordered shard-contiguously (each shard owns a contiguous
    block-row range of the streamed operand), the aggregation-weighted
    adjacency and its transpose are converted to BSR, and each block stream
    is cut so two in-flight strips fit ``budget_bytes``. ``assignment``
    (the ``k_shards``-way ``hierarchical_partition(graph, k_shards)``'s
    assignment, where the caller has it) skips the partition.
    """
    from repro_torch.core.partitioner import hierarchical_partition

    part = (hierarchical_partition(graph, k_shards).assignment
            if assignment is None else np.asarray(assignment))
    order = np.argsort(part, kind="stable").astype(np.int64)
    inv_perm = np.empty_like(order)
    inv_perm[order] = np.arange(order.shape[0], dtype=np.int64)

    weighted = _weighted_graph(permute_graph(graph, inv_perm), aggregation)
    fwd_bsr = csr_to_bsr(weighted, br=br, bc=bc)
    bwd_bsr = csr_to_bsr(weighted.transpose(), br=br, bc=bc)

    counts = np.bincount(part, minlength=k_shards)
    shard_offsets = np.concatenate(
        [[0], np.cumsum(counts)]).astype(np.int64)
    return StreamedOperand(
        fwd=HostStrips.from_bsr(fwd_bsr, budget_bytes, name="fwd",
                                shard_id=shard_id, retry=retry,
                                verify_fetch=verify_fetch),
        bwd=HostStrips.from_bsr(bwd_bsr, budget_bytes, name="bwd",
                                shard_id=shard_id, retry=retry,
                                verify_fetch=verify_fetch),
        order=order, shard_offsets=shard_offsets,
        aggregation=str(aggregation))
