"""Port parity, the distributed host layer: the partitioner and the
``DistributedGraph`` builder (``repro_torch/core/{partitioner,halo}.py``,
copies of the JAX package's) give byte-identical arrays from the same
graph and seed; ``lower_distributed`` gives the same plan as the JAX
package's; the verifier's ``split.*`` / ``halo.*`` checks name the same
mutations as the JAX verifier and stay silent on sound plans.

Everything here runs in one process; the exchange and the trainer, which
need a process group, are in ``test_torch_distributed_train.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import halo as jhalo  # noqa: E402
from repro.core import lowering as jlow  # noqa: E402
from repro.core import partitioner as jpart  # noqa: E402
from repro.core import verify as jverify  # noqa: E402
from repro.graph import csr as jcsr  # noqa: E402
from repro.graph import datasets as jds  # noqa: E402
from repro.models.gnn import GNNConfig as JConfig  # noqa: E402
from repro_torch.core import halo as thalo  # noqa: E402
from repro_torch.core import lowering as tlow  # noqa: E402
from repro_torch.core import partitioner as tpart  # noqa: E402
from repro_torch.core import verify as tverify  # noqa: E402
from repro_torch.graph import csr as tcsr  # noqa: E402
from repro_torch.graph import datasets as tds  # noqa: E402
from repro_torch.models.gnn import GNNConfig  # noqa: E402

torch.set_num_threads(1)


def _same(a, b, what=""):
    """Byte-identical: same dtype, same shape, same bytes."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _same_csr(a, b, what=""):
    for f in ("indptr", "indices", "data"):
        _same(getattr(a, f), getattr(b, f), f"{what}.{f}")
    assert (a.n_rows, a.n_cols) == (b.n_rows, b.n_cols), what


def _components_edges():
    """Three components (a ring, a star, a path) and two isolated nodes."""
    src, dst = [], []
    for i in range(20):  # ring 0..19
        src += [i, (i + 1) % 20]
        dst += [(i + 1) % 20, i]
    for leaf in range(21, 33):  # star around 20
        src += [20, leaf]
        dst += [leaf, 20]
    for i in range(33, 44):  # path 33..44
        src += [i, i + 1]
        dst += [i + 1, i]
    return np.asarray(src), np.asarray(dst), 47


def _graphs(name):
    """The same graph in both packages (features, labels and mask too)."""
    if name == "components":
        src, dst, n = _components_edges()
        r = np.random.default_rng(7)
        x = (r.random((n, 12)) < 0.3).astype(np.float32) * r.standard_normal((n, 12)).astype(np.float32)
        y = r.integers(0, 3, n).astype(np.int32)
        m = r.random(n) < 0.5
        return (jcsr.csr_from_edges(src, dst, n), tcsr.csr_from_edges(src, dst, n),
                x, y, m)
    j = jds.generate_dataset(name, scale=0.004, seed=0)
    t = tds.generate_dataset(name, scale=0.004, seed=0)
    _same_csr(j.graph, t.graph, name)
    return j.graph, t.graph, t.features, t.labels, t.train_mask


@pytest.fixture(scope="module")
def graphs():
    return {name: _graphs(name) for name in ("corafull", "flickr", "components")}


PHASES = (None, "metis_kway", "recursive_bisection", "component_packing",
          "greedy_degree")


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", ["corafull", "flickr", "components"])
def test_partition_identical(graphs, name, k, phase):
    jg, tg = graphs[name][:2]
    j = jpart.hierarchical_partition(jg, k, seed=1, force_phase=phase)
    t = tpart.hierarchical_partition(tg, k, seed=1, force_phase=phase)
    _same(j.assignment, t.assignment, "assignment")
    assert (j.k, j.phase, j.edge_cut) == (t.k, t.phase, t.edge_cut)
    assert (j.vertex_imbalance, j.load_imbalance) == (t.vertex_imbalance,
                                                      t.load_imbalance)
    _same(j.partition_sizes(), t.partition_sizes())


@pytest.mark.parametrize("name", ["corafull", "components"])
def test_components_and_vertex_count_baseline_identical(graphs, name):
    jg, tg = graphs[name][:2]
    _same(jpart.connected_components(jg), tpart.connected_components(tg))
    _same(jpart.greedy_vertex_count(jg, 3), tpart.greedy_vertex_count(tg, 3))


@pytest.mark.parametrize("reorder", ["none", "degree"])
def test_local_views_identical(graphs, reorder):
    jg, tg = graphs["flickr"][:2]
    part = tpart.hierarchical_partition(tg, 4).assignment
    jv = jpart.build_local_views(jg, part, 4, reorder=reorder)
    tv = tpart.build_local_views(tg, part, 4, reorder=reorder)
    for a, b in zip(jv, tv):
        assert (a.rank, a.n_local, a.n_ghost, a.n_interior) == (
            b.rank, b.n_local, b.n_ghost, b.n_interior)
        _same(a.global_ids, b.global_ids)
        _same(a.ghost_owner, b.ghost_owner)
        _same_csr(a.local_graph, b.local_graph)


def _same_dist(j, t):
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if isinstance(a, dict):
            assert set(a) == set(b), f.name
            for k in a:
                _same(a[k], b[k], f"{f.name}[{k}]")
        elif isinstance(a, np.ndarray):
            _same(a, b, f.name)
        else:
            assert a == b, f.name
    assert t.rank is None


def _build(pkg_halo, g, x, y, m, part, **kw):
    return pkg_halo.build_distributed_graph(g, x, y, m, part, br=8, bc=32, **kw)


@pytest.mark.parametrize("reorder", ["none", "degree"])
@pytest.mark.parametrize("split_phase", [True, False])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", ["corafull", "flickr", "components"])
def test_distributed_graph_identical(graphs, name, k, split_phase, reorder):
    jg, tg, x, y, m = graphs[name]
    tp = tpart.hierarchical_partition(tg, k)
    jp = jpart.hierarchical_partition(jg, k)
    kw = dict(aggregation="gcn", reorder=reorder, split_phase=split_phase)
    j = _build(jhalo, jg, x, y, m, jp, **kw)
    t = _build(thalo, tg, x, y, m, tp, **kw)
    _same_dist(j, t)
    assert (t.fwd_interior is not None) == split_phase


def test_rank_slice_holds_one_rank(graphs):
    jg, tg, x, y, m = graphs["flickr"]
    d = _build(thalo, tg, x, y, m, tpart.hierarchical_partition(tg, 4),
               aggregation="gcn")
    s = d.rank_slice(2, bulk=False)
    assert s.rank == 2 and s.fwd is None and s.bwd is None
    _same(s.send_idx[0], d.send_idx[2])
    _same(s.fwd_boundary["blocks"][0], d.fwd_boundary["blocks"][2])
    assert (s.n_local, s.n_ghost, s.live_shifts) == (d.n_local, d.n_ghost,
                                                     d.live_shifts)
    with pytest.raises(ValueError, match="already"):
        s.rank_slice(0)
    with pytest.raises(ValueError, match="every rank"):
        tlow.lower_distributed(GNNConfig("GCN", [x.shape[1], 8, 3]), s)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

CASES = [("GCN", "gcn"), ("SAGE", "mean"), ("GIN", "sum"), ("GAT", "sum"),
         ("GT", "sum"), ("SAGE", "max")]


def _dist_pair(graphs, name, kind, agg, k=4):
    jg, tg, x, y, m = graphs[name]
    tp = tpart.hierarchical_partition(tg, k)
    eff = tlow.effective_aggregation(GNNConfig(kind, [x.shape[1], 8, 3],
                                               aggregation=agg))
    return (_build(jhalo, jg, x, y, m, jpart.hierarchical_partition(jg, k),
                   aggregation=eff),
            _build(thalo, tg, x, y, m, tp, aggregation=eff))


def _layer_view(l):
    return (l.index, l.op_kind, l.d_in, l.d_out, l.feature_path,
            l.primitive, l.agg_primitive, l.note, l.decision.mode,
            l.decision.sparsity, l.epilogue is None or l.epilogue.formula,
            l.attention is None or (l.attention.heads, l.attention.head_dim,
                                    l.attention.fused))


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("kind,agg", CASES)
@pytest.mark.parametrize("name", ["corafull", "flickr"])
def test_lower_distributed_same_plan(graphs, name, kind, agg, overlap):
    jd, td = _dist_pair(graphs, name, kind, agg)
    f = td.features.shape[-1]
    jcfg = JConfig(kind=kind, layer_dims=[f, 16, 5], aggregation=agg,
                   gat_heads=2)
    tcfg = GNNConfig(kind=kind, layer_dims=[f, 16, 5], aggregation=agg,
                     gat_heads=2)
    jp = jlow.lower_distributed(jcfg, jd, overlap=overlap, validate="full")
    tp = tlow.lower_distributed(tcfg, td, overlap=overlap, validate="full")
    assert [_layer_view(l) for l in jp.layers] == [_layer_view(l) for l in tp.layers]
    assert (jp.backend, jp.arch, jp.aggregation, jp.n_ranks, jp.gamma,
            jp.feature_sparsity, jp.feat_f_pad) == (
        tp.backend, tp.arch, tp.aggregation, tp.n_ranks, tp.gamma,
        tp.feature_sparsity, tp.feat_f_pad)
    _same(jp.per_rank_sparsity, tp.per_rank_sparsity)
    assert (jp.overlap is None) == (tp.overlap is None)
    if tp.overlap is not None:
        assert dataclasses.asdict(jp.overlap) == dataclasses.asdict(tp.overlap)
    for key in ("feat_fwd", "feat_bwd"):
        a, b = getattr(jp, key), getattr(tp, key)
        assert (a is None) == (b is None)
        for k in a or {}:
            _same(a[k], b[k], f"{key}[{k}]")
    assert tp.inner == "torch"  # no card here
    # the plan dump: the JAX package's, with the port's executor name
    assert tp.describe() == jp.describe().replace(f"inner={jp.inner}",
                                                  "inner=torch")


def test_lower_distributed_flags_and_slices(graphs):
    jd, td = _dist_pair(graphs, "corafull", "GCN", "gcn")
    f = td.features.shape[-1]
    for kw in (dict(fuse_epilogue=False), dict(use_sparse_input=False)):
        jp = jlow.lower_distributed(JConfig("GCN", [f, 16, 5]), jd, **kw)
        tp = tlow.lower_distributed(GNNConfig("GCN", [f, 16, 5]), td, **kw)
        assert [_layer_view(l) for l in jp.layers] == [_layer_view(l) for l in tp.layers]
    tp = tlow.lower_distributed(GNNConfig("GCN", [f, 16, 5]), td)
    assert tp.layers[0].primitive == "distributed.dist_feature_matmul_sparse"
    s = tp.rank_slice(1)
    assert s.rank == 1 and s.feat_fwd["blocks"].shape[0] == 1
    _same(s.feat_bwd["rows"][0], tp.feat_bwd["rows"][1])
    with pytest.raises(ValueError, match="weighted"):
        tlow.lower_distributed(GNNConfig("SAGE", [f, 16, 5],
                                         aggregation="mean"), td)


# ---------------------------------------------------------------------------
# the verifier's split.* and halo.* checks
# ---------------------------------------------------------------------------


def _verify_pair(rng_seed=0):
    """A random 64-node graph in both packages, partitioned in 4, with its
    plans lowered unchecked (``tests/test_verify.py:_dist_pair``)."""
    r = np.random.default_rng(rng_seed)
    e = r.integers(0, 64, size=(300, 2))
    x = r.standard_normal((64, 16)).astype(np.float32)
    out = []
    for csr, part, halo, low, cfg in (
            (jcsr, jpart, jhalo, jlow, JConfig),
            (tcsr, tpart, thalo, tlow, GNNConfig)):
        g = csr.csr_from_edges(e[:, 0], e[:, 1], n_rows=64, n_cols=64)
        d = halo.build_distributed_graph(
            g, x, np.zeros(64, np.int32), np.ones(64, bool),
            part.hierarchical_partition(g, 4), br=8, bc=8,
            aggregation="gcn", split_phase=True)
        plan = low.lower_distributed(
            cfg(kind="GCN", layer_dims=[16, 8, 4], aggregation="sum"), d,
            gamma=0.5, validate="off")
        out.append((plan, d))
    return out


def _names(violations):
    return {v.invariant for v in violations}


def _mutate_interior_ghost(d):
    cols = d.fwd_interior["cols"].copy()
    cols[0, -1] = d.n_local // d.bc  # the first ghost block-col
    d.fwd_interior = {**d.fwd_interior, "cols": cols}  # skips __post_init__


def _mutate_reconstruction(d):
    blocks = np.asarray(d.fwd_boundary["blocks"]).copy()
    nz = np.flatnonzero(np.abs(blocks[0]).sum(axis=(1, 2)) > 0)
    assert nz.size, "fixture needs a nonzero boundary block"
    blocks[0, nz[0]] = 0.0
    d.fwd_boundary = {**d.fwd_boundary, "blocks": blocks}


def _mutate_live_shifts(d):
    assert d.live_shifts
    d.live_shifts = tuple(d.live_shifts[:-1])


def _mutate_schedule(d):
    send = np.asarray(d.send_idx).copy()
    row = send[0, d.live_shifts[0] - 1]
    assert (row >= 0).any(), "fixture needs a live send on rank 0"
    row[np.flatnonzero(row >= 0)[0]] = -1  # a sender drops a row silently
    d.send_idx = send


def _mutate_slot_collision(d):
    recv = np.asarray(d.recv_slot).copy()
    for p in range(d.n_ranks):
        flat = recv[p].ravel()
        slots = np.flatnonzero(flat >= 0)
        if slots.size >= 2:
            flat[slots[1]] = flat[slots[0]]  # two senders, one ghost slot
            recv[p] = flat.reshape(recv[p].shape)
            break
    else:
        raise AssertionError("fixture needs a rank receiving >= 2 rows")
    d.recv_slot = recv


MUTATIONS = {
    "interior_reads_ghost": (_mutate_interior_ghost, {"split.interior_no_ghost"}),
    "reconstruction": (_mutate_reconstruction, {"split.reconstruction"}),
    "live_shifts": (_mutate_live_shifts, {"split.live_shifts"}),
    "schedule_desync": (_mutate_schedule, {"halo.schedule_paired"}),
    "slot_collision": (_mutate_slot_collision,
                       {"halo.slot_unique", "halo.schedule_paired"}),
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_distributed_mutation_flagged_as_jax_flags_it(mutation):
    mutate, want = MUTATIONS[mutation]
    (jp, jd), (tp, td) = _verify_pair()
    for d in (jd, td):
        mutate(d)
    got_j = _names(jverify.verify_plan(jp, mode="full", dist=jd))
    got_t = _names(tverify.verify_plan(tp, mode="full", dist=td))
    assert want & got_t, (mutation, got_t)
    assert got_t == got_j, (mutation, got_t, got_j)
    with pytest.raises(tverify.PlanVerificationError):
        tverify.check_plan(tp, mode="full", dist=td)


@pytest.mark.parametrize("mode", ["fast", "full"])
def test_distributed_no_false_positives(mode):
    (jp, jd), (tp, td) = _verify_pair()
    assert jverify.verify_plan(jp, mode=mode, dist=jd) == []
    assert tverify.verify_plan(tp, mode=mode, dist=td) == []
    with pytest.raises(ValueError, match="every rank"):
        tverify.verify_plan(tp, mode=mode, dist=td.rank_slice(0))


def test_distributed_catalog_matches_jax():
    keys = [k for k in jverify.INVARIANT_CATALOG
            if k.startswith(("split.", "halo."))]
    assert len(keys) == 5
    for k in keys:
        assert tverify.INVARIANT_CATALOG[k] == jverify.INVARIANT_CATALOG[k]


@pytest.mark.parametrize("kind,agg", CASES)
def test_distributed_plans_verify_clean(graphs, kind, agg):
    """Zero violations in full mode on every plan the training test
    lowers, with overlap on and off."""
    _, td = _dist_pair(graphs, "corafull", kind, agg)
    cfg = GNNConfig(kind=kind, layer_dims=[td.features.shape[-1], 16, 5],
                    aggregation=agg, gat_heads=2)
    for overlap in (True, False):
        plan = tlow.lower_distributed(cfg, td, overlap=overlap, validate="off")
        assert tverify.verify_plan(plan, mode="full", dist=td) == []
