"""Distributed GNN runtime — the port of ``repro/core/halo.py``, the
analog of the paper's MPI backend (§IV-E2).

The host half is a copy of the JAX package's (the port imports nothing
of it): ``DistributedGraph``, ``stack_bsr_matrices``,
``build_distributed_graph`` and ``_split_pair`` run the same numpy calls,
so both packages build the same arrays, byte for byte, from the same
graph and partition. Each rank's feature buffer is ``[local | ghost]``:
local slots ``[0, n_local)`` followed by ghosts, so one BSR over the
concatenated buffer aggregates both (the paper's G2L layout).

The in-step half runs in each rank process of a ``torch.distributed``
group (``launch/mesh.py``) where the JAX package runs ``ppermute`` rounds
inside ``shard_map``. ``HaloSchedule`` holds one rank's rows of the
schedule on its device. For each live ring shift s, rank r sends the rows
``send_idx[s-1]`` (-1 padded, a ``max_send``-row payload, zeros where -1)
to rank (r + s) % P and receives from (r − s) % P into the ghost slots
``recv_slot[s-1]`` — JAX's ``_halo_exchange_impl``. The transport is
gloo's point-to-point (``batch_isend_irecv``): gloo sends CPU tensors
only, so on the card a payload is gathered there, copied once into a
pinned host buffer (the copy waited for before the send is posted),
sent, and the received rows copied back and scattered into the ghost
slots. ``begin`` posts the sends and receives and returns; ``finish``
waits for them, so work launched between the two (the interior SpMM of
the split-phase compositions, ``backends/distributed.py``) runs while
the rows are on the wire. Every rank posts the same live shifts in the
same order, with the shift as the tag. ``halo_exchange`` is the
differentiable exchange: its backward is ``halo_exchange_transpose``, the
reverse schedule (ghost gradients go back along −s and are scatter-added
into their owners' rows in shift order, so the result is deterministic).
``GhostBufferRing`` rotates the pinned staging buffers between layers.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.core.partitioner import PartitionResult, build_local_views
from repro_torch.graph.csr import CSRGraph, csr_from_edges, csr_to_bsr


def _ceil_to(x: int, m: int) -> int:
    return max(-(-x // m) * m, m)


@dataclasses.dataclass
class DistributedGraph:
    """Host-built SPMD plan: stacked per-rank BSR + halo schedules.

    When built with ``split_phase=True`` (the default) the forward operand
    is additionally split per rank into an *interior* operand — block-rows
    whose columns are all local, runnable while the halo exchange is still
    in flight — and a *boundary* operand — block-rows that may read ghost
    columns — each with its transpose for the overlapped backward
    (DESIGN.md §11). Both split streams cover every local block-row with
    explicit zero blocks (the Pallas kernel's row-coverage contract), so
    ``y = y_interior + y_boundary`` stitches rows back exactly.
    """

    n_ranks: int
    n_local: int  # padded, uniform across ranks, multiple of 128
    n_ghost: int  # padded, uniform, multiple of 128
    max_send: int
    # stacked fwd BSR of local graphs: rows=[local], cols=[local|ghost]
    fwd: dict  # rows/cols/first [P, B], blocks [P, B, br, bc]
    bwd: dict  # BSR of transpose: rows=[local|ghost], cols=[local]
    send_idx: np.ndarray  # [P, P-1, max_send] local idx to send at shift s (-1 pad)
    recv_slot: np.ndarray  # [P, P-1, max_send] ghost slot (0-based in ghost region)
    features: np.ndarray  # [P, n_local, F]
    labels: np.ndarray  # [P, n_local]
    mask: np.ndarray  # [P, n_local] bool (False on padding)
    br: int
    bc: int
    # per-rank unpadded node counts — the lowering pass's per-rank Alg-1
    # statistics are computed over these rows only (padding is all-zero)
    n_valid: Optional[np.ndarray] = None  # [P] int32
    # stacked local edge lists (src indexes [local|ghost] slots, dst local
    # rows; -1 padded) — the segment path for GAT edge-softmax / max agg
    edge_src: Optional[np.ndarray] = None  # [P, max_edges] int32
    edge_dst: Optional[np.ndarray] = None  # [P, max_edges] int32
    aggregation: str = "sum"  # weighting applied to the local adjacencies
    # within-rank node order the local views were built with ("none" |
    # "degree" | "rcm") — recorded so lower_distributed's LayoutPlan can
    # say what layout the stacked operands carry
    reorder: str = "none"
    # -- split-phase operands (None when built with split_phase=False) -----
    # interior: rows=[local], cols=[local] only; boundary: rows=[local],
    # cols=[local|ghost]. Each stream covers all local block-rows.
    fwd_interior: Optional[dict] = None
    bwd_interior: Optional[dict] = None  # transpose: [local] x [local]
    fwd_boundary: Optional[dict] = None
    bwd_boundary: Optional[dict] = None  # transpose: [local|ghost] x [local]
    n_interior: Optional[np.ndarray] = None  # [P] leading interior local slots
    interior_blocks: Optional[np.ndarray] = None  # [P] per-rank stream length
    boundary_blocks: Optional[np.ndarray] = None  # [P]
    # ring shifts with at least one live (send_idx >= 0) entry on any rank;
    # a ppermute is collective, so the set is any-over-ranks (host-computed)
    live_shifts: Optional[tuple] = None
    # the one rank whose arrays this graph holds, at index 0 of every
    # stacked array (``rank_slice``); None: every rank's, stacked
    rank: Optional[int] = None

    def __post_init__(self):
        split = [self.fwd_interior, self.bwd_interior,
                 self.fwd_boundary, self.bwd_boundary]
        if any(s is not None for s in split):
            if any(s is None for s in split):
                raise ValueError(
                    "split-phase operands must be constructed together "
                    "(fwd/bwd x interior/boundary)")
            nrb = self.n_local // self.br
            ncb_local = self.n_local // self.bc
            if int(self.fwd_interior["cols"].max(initial=0)) >= ncb_local:
                raise ValueError(
                    "interior operand references a ghost column: "
                    f"max block-col {int(self.fwd_interior['cols'].max())} "
                    f">= {ncb_local}")
            if int(self.fwd_interior["rows"].max(initial=0)) >= nrb:
                raise ValueError("interior operand row outside local region")
            if int(self.fwd_boundary["rows"].max(initial=0)) >= nrb:
                raise ValueError("boundary operand row outside local region")
            if (self.n_interior is not None and self.n_valid is not None
                    and bool((np.asarray(self.n_interior)
                              > np.asarray(self.n_valid)).any())):
                raise ValueError("n_interior exceeds per-rank valid rows")
        if self.live_shifts is not None:
            bad = [s for s in self.live_shifts
                   if not 1 <= int(s) < max(self.n_ranks, 2)]
            if bad:
                raise ValueError(f"live shifts {bad} outside [1, P)")

    def rank_slice(self, rank: int, bulk: bool = True) -> "DistributedGraph":
        """The arrays of ``rank`` alone: each stacked array cut to
        ``[rank:rank + 1]``, the fleet-wide fields (sizes, tile, live
        shifts) kept, ``rank`` set. What one rank process reads; a rank's
        slice of the arxiv analog at ``br=8, bc=32`` holds a few hundred
        MB where the whole graph holds four times that. ``bulk=False``
        leaves out the bulk ``fwd`` / ``bwd`` pair (``None``), which a
        split-phase plan does not read."""
        if self.rank is not None:
            raise ValueError(f"already the slice of rank {self.rank}")
        if not 0 <= rank < self.n_ranks:
            raise ValueError(f"rank {rank} outside [0, {self.n_ranks})")
        cut = slice(rank, rank + 1)

        def one(a):
            if a is None:
                return None
            if isinstance(a, dict):
                return {k: np.ascontiguousarray(v[cut]) for k, v in a.items()}
            return np.ascontiguousarray(np.asarray(a)[cut])

        names = ("send_idx", "recv_slot", "features", "labels", "mask",
                 "n_valid", "edge_src", "edge_dst", "fwd_interior",
                 "bwd_interior", "fwd_boundary", "bwd_boundary",
                 "n_interior", "interior_blocks", "boundary_blocks")
        kw = {name: one(getattr(self, name)) for name in names}
        kw["fwd"] = one(self.fwd) if bulk else None
        kw["bwd"] = one(self.bwd) if bulk else None
        return dataclasses.replace(self, rank=rank, **kw)


def stack_bsr_matrices(bsrs, br: int, bc: int) -> dict:
    """Stack per-rank BSR matrices on a leading rank axis, padded to the
    fleet-max block count (zero blocks accumulate 0 into the last row)."""
    P = len(bsrs)
    n_blocks = max(b.n_blocks for b in bsrs)
    rows = np.zeros((P, n_blocks), dtype=np.int32)
    cols = np.zeros((P, n_blocks), dtype=np.int32)
    first = np.zeros((P, n_blocks), dtype=np.int32)
    blocks = np.zeros((P, n_blocks, br, bc), dtype=np.float32)
    for p, b in enumerate(bsrs):
        k = b.n_blocks
        rows[p, :k] = b.block_rows
        cols[p, :k] = b.block_cols
        first[p, :k] = b.first_in_row
        blocks[p, :k] = b.blocks
        if k < n_blocks:  # zero-block padding accumulates 0 into last row
            rows[p, k:] = b.block_rows[-1] if k else 0
            cols[p, k:] = 0
    return {"rows": rows, "cols": cols, "first": first, "blocks": blocks}


def build_distributed_graph(
    graph: CSRGraph,
    features: np.ndarray,
    labels: np.ndarray,
    train_mask: np.ndarray,
    partition: PartitionResult,
    br: int = 8,
    bc: int = 128,
    aggregation: str = "sum",
    reorder: str = "none",
    split_phase: bool = True,
) -> DistributedGraph:
    """Build the SPMD plan. ``aggregation`` weights the *global* adjacency
    (``"sum"`` keeps it raw — pass pre-weighted graphs that way) before the
    per-rank views are cut, so degree normalisation sees global degrees.
    ``reorder`` renumbers each rank's local block (degree / RCM on the
    rank's induced subgraph) before the per-rank BSR is materialised —
    denser local blocks, no semantic change (the halo schedule and the
    feature/label/mask stacking all follow the permuted ``global_ids``).

    ``split_phase`` additionally splits each rank's forward operand by
    block-row into interior (all columns local) / boundary (may read ghost
    columns) streams, with transposes, and computes the live ring-shift set
    — the operands of the overlapped runtime (DESIGN.md §11). The bulk
    ``fwd``/``bwd`` pair is always built; ``split_phase=False`` is the
    fallback that skips the extra streams."""
    if aggregation != "sum":
        from repro_torch.core.aggregate import _weighted_graph

        graph = _weighted_graph(graph, aggregation)
    P = partition.k
    views = build_local_views(graph, partition.assignment, P, reorder=reorder)
    n_local = _ceil_to(max(v.n_local for v in views), bc)
    n_ghost = _ceil_to(max(max(v.n_ghost for v in views), 1), bc)

    f_dim = features.shape[1]
    feats = np.zeros((P, n_local, f_dim), dtype=np.float32)
    labs = np.zeros((P, n_local), dtype=np.int32)
    mask = np.zeros((P, n_local), dtype=bool)

    # -- halo schedule: for ring shift s, rank r sends to (r+s)%P ----------
    # pair_nodes[(o, r)] = ordered list of global ids owner o sends to r
    pair_nodes: dict[tuple[int, int], list[int]] = {}
    for v in views:
        for slot, (gid, owner) in enumerate(
            zip(v.global_ids[v.n_local:], v.ghost_owner)
        ):
            pair_nodes.setdefault((int(owner), v.rank), []).append(int(gid))
    max_send = max((len(v) for v in pair_nodes.values()), default=1)
    send_idx = np.full((P, P - 1, max_send), -1, dtype=np.int32)
    recv_slot = np.full((P, P - 1, max_send), -1, dtype=np.int32)

    g2l_local = []  # global -> local index among owned nodes, per rank
    for v in views:
        g2l_local.append({int(g): i for i, g in enumerate(v.global_ids[: v.n_local])})
    ghost_slot_of = []  # global -> slot within ghost region, per rank
    for v in views:
        ghost_slot_of.append(
            {int(g): i for i, g in enumerate(v.global_ids[v.n_local:])}
        )

    for (o, r), nodes in pair_nodes.items():
        s = (r - o) % P
        assert s != 0
        for j, gid in enumerate(nodes):
            send_idx[o, s - 1, j] = g2l_local[o][gid]
            recv_slot[r, s - 1, j] = ghost_slot_of[r][gid]

    # -- per-rank local BSR (padded coords) + local COO edge lists ---------
    fwd_stack, bwd_stack = [], []
    int_fwd, int_bwd, bnd_fwd, bnd_bwd = [], [], [], []
    edge_lists: list[tuple[np.ndarray, np.ndarray]] = []
    for v in views:
        # remap ghost columns from (v.n_local + j) to (n_local + j)
        src, dst = v.local_graph.edge_list()
        src = src.astype(np.int64)
        dst = dst.astype(np.int64)
        ghost_sel = src >= v.n_local
        src[ghost_sel] = src[ghost_sel] - v.n_local + n_local
        lg = csr_from_edges(
            src=src, dst=dst, n_rows=n_local, n_cols=n_local + n_ghost,
            data=v.local_graph.data, dedupe=False,
        )
        fwd_stack.append(csr_to_bsr(lg, br=br, bc=bc))
        bwd_stack.append(csr_to_bsr(lg.transpose(), br=br, bc=bc))
        edge_lists.append((src.astype(np.int32), dst.astype(np.int32)))
        feats[v.rank, : v.n_local] = features[v.global_ids[: v.n_local]]
        labs[v.rank, : v.n_local] = labels[v.global_ids[: v.n_local]]
        mask[v.rank, : v.n_local] = train_mask[v.global_ids[: v.n_local]]

        if split_phase:
            # block-row granularity split: a block-row is boundary iff any
            # of its edges reads a ghost column. The [interior | boundary]
            # node order of build_local_views confines mixing to at most
            # the one block-row straddling the segment boundary.
            nrb = n_local // br
            boundary_row = np.zeros(nrb, dtype=bool)
            boundary_row[(dst[ghost_sel] // br)] = True
            eb = boundary_row[dst // br]
            ipair, bpair = _split_pair(
                src, dst, np.asarray(v.local_graph.data), eb,
                n_local, n_ghost, br, bc)
            int_fwd.append(ipair[0])
            int_bwd.append(ipair[1])
            bnd_fwd.append(bpair[0])
            bnd_bwd.append(bpair[1])

    max_edges = max(max(len(s) for s, _ in edge_lists), 1)
    edge_src = np.full((P, max_edges), -1, dtype=np.int32)
    edge_dst = np.full((P, max_edges), -1, dtype=np.int32)
    for p, (s, d) in enumerate(edge_lists):
        edge_src[p, : len(s)] = s
        edge_dst[p, : len(d)] = d

    live_shifts = tuple(
        int(s) for s in range(1, P) if bool((send_idx[:, s - 1] >= 0).any()))

    split_kw = {}
    if split_phase:
        split_kw = dict(
            fwd_interior=stack_bsr_matrices(int_fwd, br, bc),
            bwd_interior=stack_bsr_matrices(int_bwd, br, bc),
            fwd_boundary=stack_bsr_matrices(bnd_fwd, br, bc),
            bwd_boundary=stack_bsr_matrices(bnd_bwd, br, bc),
            n_interior=np.asarray([v.n_interior for v in views],
                                  dtype=np.int32),
            interior_blocks=np.asarray([b.n_blocks for b in int_fwd],
                                       dtype=np.int64),
            boundary_blocks=np.asarray([b.n_blocks for b in bnd_fwd],
                                       dtype=np.int64),
        )

    return DistributedGraph(
        n_ranks=P, n_local=n_local, n_ghost=n_ghost, max_send=max_send,
        fwd=stack_bsr_matrices(fwd_stack, br, bc),
        bwd=stack_bsr_matrices(bwd_stack, br, bc),
        send_idx=send_idx, recv_slot=recv_slot,
        features=feats, labels=labs, mask=mask, br=br, bc=bc,
        n_valid=np.asarray([v.n_local for v in views], dtype=np.int32),
        edge_src=edge_src, edge_dst=edge_dst, aggregation=aggregation,
        reorder=reorder, live_shifts=live_shifts, **split_kw,
    )


def _empty_csr(n_rows: int, n_cols: int) -> CSRGraph:
    return CSRGraph(
        indptr=np.zeros(n_rows + 1, dtype=np.int64),
        indices=np.zeros(0, dtype=np.int32),
        data=np.zeros(0, dtype=np.float32),
        n_rows=n_rows, n_cols=n_cols,
    )


def _split_pair(src, dst, data, boundary_edge, n_local, n_ghost, br, bc):
    """Cut one rank's edge set into interior / boundary CSR→BSR pairs.

    Both streams span all ``n_local`` rows — ``csr_to_bsr`` inserts an
    explicit zero block for every uncovered block-row (the kernel's
    row-coverage contract), so the two partial SpMMs add back to the bulk
    result row-exactly. The interior operand's column space is local-only
    (``n_cols = n_local``): its SpMM consumes no ghost slot and therefore
    never waits on the halo exchange."""
    def one(sel, n_cols):
        if sel.any():
            csr = csr_from_edges(
                src=src[sel], dst=dst[sel], n_rows=n_local, n_cols=n_cols,
                data=data[sel], dedupe=False)
        else:
            csr = _empty_csr(n_local, n_cols)
        return (csr_to_bsr(csr, br=br, bc=bc),
                csr_to_bsr(csr.transpose(), br=br, bc=bc))

    return one(~boundary_edge, n_local), one(boundary_edge, n_local + n_ghost)




# ---------------------------------------------------------------------------
# In-step primitives: one rank's exchange over torch.distributed
# ---------------------------------------------------------------------------


class GhostBufferRing:
    """Double-buffered host staging for the per-layer exchanges.

    Consecutive layers draw distinct slots of an ``n_slots``-deep pool
    (``acquire``; ``schedule()`` exposes the rotation for plan dumps and
    tests, as in the JAX package). Each slot owns a (send, receive) pair
    of host buffers, pinned when the rank runs on the card: the payload
    is copied into the send buffer before the sends are posted, and gloo
    writes the received rows into the receive buffer, whose copy back to
    the card runs asynchronously. So a slot's receive buffer is reused
    only after that copy has finished (``staging`` waits for the event
    ``released`` recorded), and adjacent layers never wait on each other's
    copy.
    """

    def __init__(self, n_slots: int = 2):
        if n_slots < 2:
            raise ValueError("double buffering needs at least 2 slots")
        self.n_slots = int(n_slots)
        self._schedule: list[int] = []
        self._buffers: dict[int, tuple] = {}
        self._copied: dict[int, torch.cuda.Event] = {}

    def acquire(self, layer: int) -> int:
        slot = int(layer) % self.n_slots
        if self._schedule and self._schedule[-1] == slot:
            raise ValueError(
                f"slot {slot} acquired twice in a row — adjacent layers "
                f"must rotate ghost buffers")
        self._schedule.append(slot)
        return slot

    def schedule(self) -> tuple:
        return tuple(self._schedule)

    def staging(self, slot: int, shape: tuple, pin: bool) -> tuple:
        """Slot ``slot``'s (send, receive) float32 host buffers viewed as
        ``shape``, grown when too small; waits for the last copy out of
        its receive buffer."""
        n = int(np.prod(shape))
        bufs = self._buffers.get(slot)
        if bufs is None or bufs[0].numel() < n:
            bufs = tuple(torch.empty(n, dtype=torch.float32, pin_memory=pin)
                         for _ in range(2))
            self._buffers[slot] = bufs
        copied = self._copied.pop(slot, None)
        if copied is not None:
            copied.synchronize()
        return bufs[0][:n].view(shape), bufs[1][:n].view(shape)

    def released(self, slot: int, event: torch.cuda.Event) -> None:
        """Record the event after which slot's receive buffer is free."""
        self._copied[slot] = event


def _ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


@dataclasses.dataclass
class _Transfer:
    """An exchange in flight: its posted works and where its rows land."""

    works: list
    recv: Optional[torch.Tensor]  # [n_shifts, max_send, F] host (or cpu)
    f: int
    slot: int
    reverse: bool
    record: Optional[dict]  # timing record, when the schedule keeps them
    t_posted: float


class HaloSchedule:
    """One rank's rows of a ``DistributedGraph``'s halo schedule, as index
    tensors on the rank's device, and the exchange over the default
    ``torch.distributed`` group (``launch/mesh.py``).

    ``send_idx`` / ``recv_slot`` are the rank's ``[P-1, max_send]`` rows;
    ``shifts`` the live ring shifts (``None``: all P−1). Only the valid
    (≥ 0) positions are gathered and scattered, but every payload holds
    ``max_send`` rows, zeros at the -1 positions, as the JAX package's,
    so a sender and its receiver always agree on the message's size, even
    under a corrupted schedule (which ``debug_halo_check`` then catches).

    ``timings``: set to a list to have each exchange append its record
    (``layer``, direction, width, bytes a rank sends, and the host ms of
    the pack and copy out, the wire, the copy in): the copy in is then
    synchronised, so leave it ``None`` outside measurements.
    """

    def __init__(self, send_idx: np.ndarray, recv_slot: np.ndarray,
                 n_local: int, n_ghost: int, shifts=None, *, device,
                 ring: Optional[GhostBufferRing] = None):
        send_idx = np.asarray(send_idx)
        recv_slot = np.asarray(recv_slot)
        self.rank = tdist.get_rank()
        self.n_ranks = tdist.get_world_size()
        if send_idx.shape[0] != self.n_ranks - 1 or recv_slot.shape != send_idx.shape:
            raise ValueError(
                f"send_idx {send_idx.shape} / recv_slot {recv_slot.shape} are "
                f"not one rank's [P-1={self.n_ranks - 1}, max_send] rows")
        self.n_local, self.n_ghost = int(n_local), int(n_ghost)
        self.max_send = int(send_idx.shape[1])
        self.shifts = (tuple(range(1, self.n_ranks)) if shifts is None
                       else tuple(int(s) for s in shifts))
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(self.device)

        self._send, self._recv = [], []
        for s in self.shifts:
            pos = np.flatnonzero(send_idx[s - 1] >= 0)
            self._send.append((t(pos), t(send_idx[s - 1][pos])))
            pos = np.flatnonzero(recv_slot[s - 1] >= 0)
            self._recv.append((t(pos), t(recv_slot[s - 1][pos])))
        self.ring = ring if ring is not None else GhostBufferRing()
        self.timings: Optional[list] = None

    @classmethod
    def of(cls, dist: DistributedGraph, *, device,
           ring: Optional[GhostBufferRing] = None,
           shifts="live") -> "HaloSchedule":
        """The calling rank's schedule from a ``DistributedGraph`` (every
        rank's, or this rank's ``rank_slice``); ``shifts="live"`` takes
        the graph's live shifts."""
        rank = tdist.get_rank()
        if dist.rank is not None and dist.rank != rank:
            raise ValueError(f"rank {rank} was given the slice of rank {dist.rank}")
        i = 0 if dist.rank is not None else rank
        if shifts == "live":
            shifts = dist.live_shifts
        return cls(dist.send_idx[i], dist.recv_slot[i], dist.n_local,
                   dist.n_ghost, shifts, device=device, ring=ring)

    # -- the two directions -------------------------------------------------

    def _payload(self, x: torch.Tensor, pairs) -> torch.Tensor:
        """[n_shifts, max_send, F]: each shift's rows gathered from x,
        zeros at the -1 positions."""
        payload = x.new_zeros((len(self.shifts), self.max_send, x.shape[1]))
        for k, (pos, rows) in enumerate(pairs):
            payload[k].index_copy_(0, pos, x.index_select(0, rows))
        return payload

    def begin(self, x: torch.Tensor, slot: int = 0,
              layer: Optional[int] = None) -> _Transfer:
        """Post the forward exchange of ``x [n_local, F]`` and return at
        once: ``finish`` gives the ghost rows."""
        return self._post(self._payload(x, self._send), slot, False, layer)

    def begin_transpose(self, g: torch.Tensor, slot: int = 0,
                        layer: Optional[int] = None) -> _Transfer:
        """Post the reverse exchange of ghost-slot values ``g [n_ghost,
        F]`` (the transpose): ``finish`` gives their sums in the owners'
        rows."""
        return self._post(self._payload(g, self._recv), slot, True, layer)

    def _post(self, payload: torch.Tensor, slot: int, reverse: bool,
              layer: Optional[int]) -> _Transfer:
        t0 = time.perf_counter()
        f = int(payload.shape[-1])
        record = None
        if self.timings is not None:
            record = {"layer": layer, "dir": "bwd" if reverse else "fwd",
                      "f": f, "bytes": int(payload.numel()) * 4}
        if not self.shifts:
            return _Transfer([], None, f, slot, reverse, record, t0)
        send, recv = self.ring.staging(slot, tuple(payload.shape), self.on_card)
        send.copy_(payload, non_blocking=self.on_card)
        if self.on_card:
            # gloo reads the host buffer from its own thread: the copy
            # must have landed before the send is posted
            torch.cuda.current_stream(self.device).synchronize()
        r, p = self.rank, self.n_ranks
        ops = []
        for k, s in enumerate(self.shifts):
            to, frm = ((r - s) % p, (r + s) % p) if reverse else ((r + s) % p, (r - s) % p)
            ops.append(tdist.P2POp(tdist.isend, send[k], to, tag=s))
            ops.append(tdist.P2POp(tdist.irecv, recv[k], frm, tag=s))
        works = tdist.batch_isend_irecv(ops)
        if record is not None:
            record["pack_ms"] = _ms(t0)
        return _Transfer(works, recv, f, slot, reverse, record, time.perf_counter())

    def received(self, tr: _Transfer, probe=None) -> Optional[torch.Tensor]:
        """Wait for ``tr``'s rows and return them on the device, [n_shifts,
        max_send, F] (None where no shift is live). ``probe``, a (start,
        end) pair of CUDA events around work launched while the rows were
        in flight, is read the moment the wire has finished: the record
        then says whether that work had started on the card by then."""
        for w in tr.works:
            w.wait()
        rec = tr.record
        if rec is not None:
            rec["wire_ms"] = _ms(tr.t_posted)
            if probe is not None:
                rec["probe_started_in_wire"] = bool(probe[0].query())
                rec["probe_done_in_wire"] = bool(probe[1].query())
        if tr.recv is None:
            return None
        if not self.on_card:
            return tr.recv
        rows = tr.recv.to(self.device, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(self.device))
        self.ring.released(tr.slot, copied)
        return rows

    def finish(self, tr: _Transfer, probe=None) -> torch.Tensor:
        """Wait for ``tr`` and scatter-add its rows, shift by shift: the
        ghost rows ``[n_ghost, F]`` of a forward exchange, the owners'
        ``[n_local, F]`` sums of a reverse one."""
        t0 = time.perf_counter()
        rows = self.received(tr, probe)
        t1 = time.perf_counter()
        n = self.n_local if tr.reverse else self.n_ghost
        out = torch.zeros((n, tr.f), dtype=torch.float32, device=self.device)
        if rows is not None:
            pairs = self._send if tr.reverse else self._recv
            for k, (pos, dest) in enumerate(pairs):
                out.index_add_(0, dest, rows[k].index_select(0, pos))
        if tr.record is not None:
            if self.on_card:
                torch.cuda.current_stream(self.device).synchronize()
            tr.record["copy_in_ms"] = _ms(t1)
            tr.record["finish_ms"] = _ms(t0)
            self.timings.append(tr.record)
        return out


class _HaloExchange(torch.autograd.Function):
    """The exchange, whose backward is the reverse exchange (the custom
    VJP of ``repro/core/halo.py:_halo_exchange_vjp``)."""

    @staticmethod
    def forward(ctx, x, sched, slot, layer):
        ctx.sched, ctx.slot, ctx.layer = sched, slot, layer
        return sched.finish(sched.begin(x.detach().float(), slot, layer))

    @staticmethod
    def backward(ctx, g):
        s = ctx.sched
        dx = s.finish(s.begin_transpose(g.float().contiguous(), ctx.slot, ctx.layer))
        return dx, None, None, None


def halo_exchange(x_local: torch.Tensor, sched: HaloSchedule, slot: int = 0,
                  layer: Optional[int] = None) -> torch.Tensor:
    """Ghost-feature exchange: ``[n_local, F]`` in, ``[n_ghost, F]`` out.
    Differentiable: the backward runs ``halo_exchange_transpose``, so
    ghost gradients return to their owners without autograd re-deriving
    the exchange."""
    return _HaloExchange.apply(x_local, sched, slot, layer)


def halo_exchange_transpose(ghost: torch.Tensor, sched: HaloSchedule,
                            slot: int = 0) -> torch.Tensor:
    """The linear transpose of the exchange: ghost-slot values
    ``[n_ghost, F]`` go back to their owning ranks and are summed into
    their rows, ``[n_local, F]``, in shift order."""
    return sched.finish(sched.begin_transpose(ghost.float().contiguous(), slot))


def halo_exchange_debug(x_local: torch.Tensor, sched: HaloSchedule) -> tuple:
    """The exchange plus a transit checksum (DESIGN.md §14): returns
    ``(ghost, shipped, received)``, the two 0-d tensors the position- and
    shift-weighted sums of the valid payload rows shipped and of the rows
    received into valid ghost slots, each summed over the group. The
    weighting catches payload corruption, a send/receive schedule desync
    and row swaps; misrouting among valid ghost slots is left to the
    verifier's ``halo.slot_unique`` / ``halo.schedule_paired``."""
    x = x_local.detach().float()
    payload = sched._payload(x, sched._send)
    w = ((torch.arange(sched.max_send, dtype=torch.float32, device=x.device) + 1.0)[None]
         * torch.tensor(sched.shifts, dtype=torch.float32,
                        device=x.device).reshape(-1, 1))
    shipped = (payload.sum(dim=-1) * w).sum()
    tr = sched._post(payload, 0, False, None)
    rows = sched.received(tr)
    received = x.new_zeros(())
    ghost = x.new_zeros((sched.n_ghost, x.shape[1]))
    if rows is not None:
        kept = torch.zeros_like(rows)
        for k, (pos, slots) in enumerate(sched._recv):
            kept[k].index_copy_(0, pos, rows[k].index_select(0, pos))
            ghost.index_add_(0, slots, rows[k].index_select(0, pos))
        received = (kept.sum(dim=-1) * w).sum()
    sums = torch.stack([shipped, received]).double()
    tdist.all_reduce(sums)
    return ghost, sums[0], sums[1]
