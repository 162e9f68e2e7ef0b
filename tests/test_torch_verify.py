"""Port parity, the plan-contract verifier (``repro_torch/core/verify.py``
against ``repro/core/verify.py``, DESIGN.md §14).

* **Shared mutations** — each JAX mutation whose data the port carries
  (everything but ``last_in_row``, and the distributed split and halo
  ones, which ``test_torch_distributed.py`` mirrors) goes, as the same
  seeded corruption, into a JAX plan (``xla``)
  and the port's plan (``torch`` and ``cuda``, built from byte-identical
  operands); both verifiers must name the same invariant.
* **Column-stream mutations** — the ``nzc.*`` checks that take the place
  of the row flags for the Hopper kernels: each invariant has a mutation
  that it alone flags, on a random graph's rows and on a star graph's
  hub row, which the stream cuts into segments.
* **Zero false positives** over every plan family the port lowers.
* **API**, the host copies full mode makes, the CSR guards, and the
  chaos soak (``tools/chaos_soak.py``) on the CPU.

JAX is reached only through a fixture, so the card-marked tests (the
mutations on card-resident operands) collect where JAX is absent.
"""
import dataclasses
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import verify as verify_mod  # noqa: E402
from repro_torch.core.dsl import GNNProgram  # noqa: E402
from repro_torch.core.lowering import lower, lower_sampled  # noqa: E402
from repro_torch.core.verify import (  # noqa: E402
    INVARIANT_CATALOG,
    PlanVerificationError,
    PlanViolation,
    check_plan,
    verify_plan,
)
from repro_torch.graph.csr import (  # noqa: E402
    CSRGraph,
    csr_from_edges,
    permute_graph,
)
from repro_torch.graph.datasets import generate_dataset  # noqa: E402
from repro_torch.models.gnn import GNNConfig  # noqa: E402
from repro_torch.training.trainer import MiniBatchTrainer  # noqa: E402

pytestmark = pytest.mark.verify
torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side, imported in a fixture so the card-marked
    tests collect where JAX is absent."""
    pytest.importorskip("jax")
    from repro.core.lowering import lower as jlower
    from repro.core.lowering import lower_sampled as jlower_sampled
    from repro.core.verify import verify_plan as jverify
    from repro.graph.csr import csr_from_edges as jcsr_from_edges
    from repro.models.gnn import GNNConfig as JConfig

    return types.SimpleNamespace(lower=jlower, lower_sampled=jlower_sampled,
                                 verify=jverify, csr_from_edges=jcsr_from_edges,
                                 Config=JConfig)


def _edges(seed=0, n=64, n_edges=300):
    e = np.random.default_rng(seed).integers(0, n, size=(n_edges, 2))
    return e[:, 0], e[:, 1], n


def _star(n=1200, hub=1100, seed=0):
    """A hub row reading ``hub`` columns, past ``SPLIT_COLUMNS``: its
    block-row is cut into segments."""
    r = np.random.default_rng(seed)
    src = np.concatenate([np.arange(1, hub + 1), r.integers(0, n, 2 * n),
                          np.arange(n)])
    dst = np.concatenate([np.zeros(hub, np.int64), r.integers(0, n, 2 * n),
                          np.arange(n)])
    return src, dst, n


def _features(n, f=16, seed=1):
    return np.random.default_rng(seed).standard_normal((n, f)).astype(np.float32)


def _gcn(f=16, kind="GCN"):
    return GNNConfig(kind=kind, layer_dims=[f, 8, 4], aggregation="sum",
                     gat_heads=2)


def _port(src, dst, n, engine="cuda", **kw):
    g = csr_from_edges(src, dst, n_rows=n, n_cols=n)
    kw.setdefault("validate", "off")  # mutations go in after lowering
    kw.setdefault("br", 8)
    kw.setdefault("bc", 8)
    cfg = kw.pop("cfg", _gcn())
    return lower(cfg, g, _features(n), gamma=0.5, engine=engine,
                 device="cpu", **kw), g


def _jax(jx, src, dst, n, **kw):
    g = jx.csr_from_edges(src, dst, n_rows=n, n_cols=n)
    kw.setdefault("validate", "off")
    kw.setdefault("br", 8)
    kw.setdefault("bc", 8)
    cfg = kw.pop("cfg", None) or jx.Config(kind="GCN", layer_dims=[16, 8, 4],
                                           aggregation="sum")
    return jx.lower(cfg, g, _features(n), gamma=0.5, engine="xla", **kw), g


def _invariants(violations):
    return {v.invariant for v in violations}


def _assert_flagged(violations, invariant):
    hit = [v for v in violations if v.invariant == invariant]
    assert hit, (f"expected a {invariant!r} violation, got "
                 f"{[str(v) for v in violations]}")
    for v in hit:  # structured diagnostics: layer + operand + detail
        assert v.invariant in INVARIANT_CATALOG
        assert v.operand and v.detail
    return hit


def _mutate(plan, which="fwd", **arrays):
    """``plan`` with its forward (or backward) operand's fields replaced,
    numpy arrays becoming tensors in the port's plan."""
    name = f"{which}_operand"
    dev = getattr(plan.graph_op, name)
    kw = {k: (torch.from_numpy(np.ascontiguousarray(v))
              if isinstance(v, np.ndarray) and isinstance(dev.block_rows,
                                                          torch.Tensor) else v)
          for k, v in arrays.items()}
    gop = dataclasses.replace(plan.graph_op,
                              **{name: dataclasses.replace(dev, **kw)})
    return dataclasses.replace(plan, graph_op=gop)


def _host(plan, field):
    a = getattr(plan.graph_op.fwd_operand, field)
    return (a.cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a)).copy()


# ---------------------------------------------------------------------------
# shared mutations: the same corruption, the same invariant in both packages
# ---------------------------------------------------------------------------


def _unsorted_cols(rows, cols):
    row = next(r for r in np.unique(rows) if (rows == r).sum() >= 2)
    i, j = np.flatnonzero(rows == row)[:2]
    cols[i], cols[j] = cols[j], cols[i]
    return {"block_cols": cols}


def _col_out_of_range(rows, cols):
    cols[0] = 10_000
    return {"block_cols": cols}


def _int64_rows(rows, cols):
    return {"block_rows": rows.astype(np.int64)}


def _uncovered_row(rows, cols):
    rows[rows == rows.max()] = max(int(rows.max()) - 1, 0)
    return {"block_rows": rows}


INDEX_MUTATIONS = {
    "bsr.cols_sorted": _unsorted_cols,
    "bsr.cols_in_range": _col_out_of_range,
    "bsr.index_dtype": _int64_rows,
    "bsr.row_coverage": _uncovered_row,
}


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("invariant", sorted(INDEX_MUTATIONS))
def test_shared_index_mutation(jx, engine, invariant):
    src, dst, n = _edges()
    jp, jg = _jax(jx, src, dst, n)
    tp, tg = _port(src, dst, n, engine)
    for field in ("block_rows", "block_cols", "blocks"):
        np.testing.assert_array_equal(_host(jp, field), _host(tp, field))
    mutate = INDEX_MUTATIONS[invariant]
    jbad = _mutate(jp, **mutate(_host(jp, "block_rows"), _host(jp, "block_cols")))
    tbad = _mutate(tp, **mutate(_host(tp, "block_rows"), _host(tp, "block_cols")))
    _assert_flagged(jx.verify(jbad, mode="full", graph=jg), invariant)
    _assert_flagged(verify_plan(tbad, mode="full", graph=tg), invariant)


def _nan_block(blocks):
    blocks[0, 0, 0] = np.nan
    return blocks


VALUE_MUTATIONS = {
    "bsr.finite": _nan_block,
    "binding.operand_dtype": lambda b: b.astype(np.float64),
}


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("invariant", sorted(VALUE_MUTATIONS))
def test_shared_value_mutation(jx, engine, invariant):
    src, dst, n = _edges()
    jp, jg = _jax(jx, src, dst, n)
    tp, tg = _port(src, dst, n, engine)
    mutate = VALUE_MUTATIONS[invariant]
    jbad = _mutate(jp, blocks=mutate(_host(jp, "blocks")))
    tbad = _mutate(tp, blocks=mutate(_host(tp, "blocks")))
    _assert_flagged(jx.verify(jbad, mode="full", graph=jg), invariant)
    _assert_flagged(verify_plan(tbad, mode="full", graph=tg), invariant)


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_shared_operand_on_wrong_graph(jx, engine):
    """Operands built on the permuted graph, checked against the
    un-permuted one: totals agree, per-row sums do not."""
    src, dst, n = _edges()
    jp, jg = _jax(jx, src, dst, n, layout="rcm", br=None, bc=None)
    tp, tg = _port(src, dst, n, engine, layout="rcm", br=None, bc=None)
    _assert_flagged(jx.verify(jp, mode="full", graph=jg), "layout.operand_rows")
    _assert_flagged(verify_plan(tp, mode="full", graph=tg), "layout.operand_rows")


def _swap_perm(perm):
    perm[0], perm[1] = perm[1], perm[0]
    return perm


def _dup_perm(perm):
    perm[0] = perm[1]
    return perm


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("invariant,mutate", [("perm.inverse", _swap_perm),
                                              ("perm.bijection", _dup_perm)])
def test_shared_perm_mutation(jx, engine, invariant, mutate):
    src, dst, n = _edges()
    plans = (_jax(jx, src, dst, n, layout="rcm")[0],
             _port(src, dst, n, engine, layout="rcm")[0])
    assert np.array_equal(plans[0].layout.perm, plans[1].layout.perm)
    for plan, verify in zip(plans, (jx.verify, verify_plan)):
        perm = mutate(np.asarray(plan.layout.perm).copy())
        bad = dataclasses.replace(
            plan, layout=dataclasses.replace(plan.layout, perm=perm))
        _assert_flagged(verify(bad, mode="fast"), invariant)


def _tile(plan, jplan):
    return {"layout": dataclasses.replace(plan.layout, br=16, bc=16)}


def _epilogue_on_gat(plan, gcn):
    return {"layers": [dataclasses.replace(l, epilogue=gcn.layers[0].epilogue)
                       for l in plan.layers]}


def _attention_on_gcn(plan, gat):
    return {"layers": [dataclasses.replace(l, attention=gat.layers[0].attention)
                       for l in plan.layers]}


def _dim_chain(plan, _):
    layers = list(plan.layers)
    layers[0] = dataclasses.replace(layers[0], d_out=layers[0].d_out + 1)
    return {"layers": layers}


def _foreign_primitive(plan, _):
    layers = list(plan.layers)
    layers[0] = dataclasses.replace(layers[0], primitive="cublas.sgemm")
    return {"layers": layers}


#: invariant -> (the plan's arch, the donor plan's arch, the mutation)
BINDING_MUTATIONS = {
    "layout.tile_match": ("GCN", "GCN", _tile),
    "binding.epilogue_arch": ("GAT", "GCN", _epilogue_on_gat),
    "binding.attention_arch": ("GCN", "GAT", _attention_on_gcn),
    "binding.dim_chain": ("GCN", "GCN", _dim_chain),
    "binding.primitive": ("GCN", "GCN", _foreign_primitive),
}


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("invariant", sorted(BINDING_MUTATIONS))
def test_shared_binding_mutation(jx, engine, invariant):
    kind, donor, mutate = BINDING_MUTATIONS[invariant]
    src, dst, n = _edges()

    def jcfg(k):
        return jx.Config(kind=k, layer_dims=[16, 8, 4], aggregation="sum",
                         gat_heads=2)

    jp, jg = _jax(jx, src, dst, n, cfg=jcfg(kind))
    jd, _ = _jax(jx, src, dst, n, cfg=jcfg(donor))
    tp, tg = _port(src, dst, n, engine, cfg=_gcn(kind=kind))
    td, _ = _port(src, dst, n, engine, cfg=_gcn(kind=donor))
    for plan, d, g, verify in ((jp, jd, jg, jx.verify),
                               (tp, td, tg, verify_plan)):
        bad = dataclasses.replace(plan, **mutate(plan, d))
        _assert_flagged(verify(bad, mode="full", graph=g), invariant)


def _sampled_pair(jx, engine="cuda", kind="GCN"):
    src, dst, n = _edges()
    x = _features(n)
    kw = dict(fanouts=(3, 3), batch_size=16, n_buckets=2, gamma=0.5,
              validate="off")
    jp = jx.lower_sampled(
        jx.Config(kind=kind, layer_dims=[16, 8, 4], aggregation="sum"),
        jx.csr_from_edges(src, dst, n_rows=n, n_cols=n), x, engine="xla", **kw)
    tp = lower_sampled(_gcn(kind=kind), csr_from_edges(src, dst, n_rows=n,
                                                       n_cols=n),
                       x, engine=engine, **kw)
    return jp, tp


def _shrink_last_bucket(sampler):
    b = sampler.buckets[-1]
    caps = list(b.node_caps)
    caps[0] = caps[0] - sampler.br  # still aligned, but below bucket[0]'s
    sampler.buckets = (*sampler.buckets[:-1],
                       dataclasses.replace(b, node_caps=tuple(caps)))


def _misalign_first_bucket(sampler):
    b = sampler.buckets[0]
    caps = list(b.node_caps)
    caps[1] = caps[1] + 1  # breaks lcm(br, bc) alignment
    sampler.buckets = (dataclasses.replace(b, node_caps=tuple(caps)),
                       *sampler.buckets[1:])


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("invariant,mutate", [
    ("sampled.caps_monotone", _shrink_last_bucket),
    ("sampled.caps_aligned", _misalign_first_bucket)])
def test_shared_bucket_cap_mutation(jx, engine, invariant, mutate):
    for plan, verify in zip(_sampled_pair(jx, engine), (jx.verify, verify_plan)):
        mutate(plan.sampler)
        _assert_flagged(verify(plan, mode="fast"), invariant)


def _break_frontier(batch):
    blk = batch.blocks[0]
    src = blk.src_nodes.copy()
    src[0], src[1] = src[1], src[0]  # break [:n_dst] == dst_nodes
    batch.blocks[0] = dataclasses.replace(blk, src_nodes=src)


def _double_first_flag(batch):
    d = batch.blocks[0].fwd_bsr
    rows = d["rows"]
    row = next(r for r in np.unique(rows) if (rows == r).sum() >= 2)
    d["first"] = d["first"].copy()
    d["first"][np.flatnonzero(rows == row)[1]] = 1  # two accumulator resets


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("invariants,mutate", [
    ({"sampled.relabel_bijective", "sampled.frontier_chain"}, _break_frontier),
    ({"bsr.first_in_row"}, _double_first_flag)])
def test_shared_template_batch_mutation(jx, engine, invariants, mutate):
    """Full mode's template batch catches a relabel table that breaks the
    src-prefix contract and a doubled ``first`` flag in a batch operand
    (the sampler's dicts carry ``first``), through a patched sampler."""
    for plan, verify in zip(_sampled_pair(jx, engine), (jx.verify, verify_plan)):
        sampler = plan.sampler
        orig = sampler.sample_batch

        def corrupted(seeds, features=None, labels=None, rng=None):
            batch = orig(seeds, features, labels, rng)
            mutate(batch)
            return batch

        sampler.sample_batch = corrupted
        try:
            got = _invariants(verify(plan, mode="full"))
        finally:
            sampler.sample_batch = orig
        assert invariants & got, got


# ---------------------------------------------------------------------------
# the column stream: each nzc.* invariant has a mutation only it flags
# ---------------------------------------------------------------------------


def _nzc_plan(graph: str):
    src, dst, n = _star() if graph == "star" else _edges()
    plan, g = _port(src, dst, n, "cuda")
    nzc = plan.graph_op.fwd_operand.nzc
    assert nzc is not None
    if graph == "star":  # the hub's block-row is cut into segments
        assert nzc.splits.shape[0] == 1 and int(nzc.splits[0, 0]) == 0
    return plan, g, nzc


def _target_items(nzc, graph):
    """Item indices of the mutated row: the hub row's segments (in
    segment order) on the star, else the first row with 2+ columns."""
    items = nzc.items.numpy()
    if graph == "star":
        idx = np.flatnonzero(items[:, 0] == 0)
        return idx[np.argsort(items[idx, 1])]
    span = items[:, 2] - items[:, 1]
    return np.flatnonzero((span >= 2) & (items[:, 1] > 0))[:1]


def _drop_item(nzc, idx):
    keep = np.setdiff1d(np.arange(nzc.items.shape[0]), idx[-1:])
    return {"items": nzc.items[torch.from_numpy(keep)].contiguous()}


def _double_item(nzc, idx):
    return {"items": torch.cat([nzc.items, nzc.items[idx[-1]][None]])}


def _overlap_spans(nzc, idx):
    items = nzc.items.clone()
    items[idx[-1], 1] -= 1  # starts inside the previous span
    return {"items": items}


def _wrong_slot(nzc, idx):
    items = nzc.items.clone()
    if len(idx) >= 2:  # the hub row's segments swap their slots
        items[idx[0], 3], items[idx[1], 3] = (int(items[idx[1], 3]),
                                              int(items[idx[0], 3]))
    else:  # an unsplit row writes a partial-sum slot
        items[idx[0], 3] = 0
    return {"items": items}


def _drop_splits_row(nzc, idx):
    return {"splits": nzc.splits[1:].contiguous()}


def _int64_items(nzc, idx):
    return {"items": nzc.items.long()}


def _x_row_past_end(nzc, idx):
    x_rows = nzc.x_rows.clone()
    x_rows[int(nzc.items[idx[-1], 2]) - 1] = 10_000  # a row's last column
    return {"x_rows": x_rows}


NZC_MUTATIONS = {
    "dropped item": ("nzc.row_coverage", _drop_item),
    "doubled item": ("nzc.row_coverage", _double_item),
    "overlapping spans": ("nzc.row_coverage", _overlap_spans),
    "wrong slot": ("nzc.segments", _wrong_slot),
    "int64 items": ("nzc.index_dtype", _int64_items),
    "x_rows past the end": ("nzc.x_rows", _x_row_past_end),
}


@pytest.mark.parametrize("graph", ["random", "star"])
@pytest.mark.parametrize("mutation", sorted(NZC_MUTATIONS))
def test_nzc_mutation_flagged_by_its_invariant_alone(graph, mutation):
    invariant, mutate = NZC_MUTATIONS[mutation]
    plan, g, nzc = _nzc_plan(graph)
    bad = _mutate(plan, nzc=dataclasses.replace(
        nzc, **mutate(nzc, _target_items(nzc, graph))))
    got = verify_plan(bad, mode="fast", graph=g)
    _assert_flagged(got, invariant)
    assert _invariants(got) == {invariant}, [str(v) for v in got]
    assert verify_plan(plan, mode="full", graph=g) == []


def test_nzc_missing_splits_row_on_the_hub():
    plan, g, nzc = _nzc_plan("star")
    bad = _mutate(plan, nzc=dataclasses.replace(nzc, **_drop_splits_row(nzc, None)))
    got = verify_plan(bad, mode="fast", graph=g)
    assert _invariants(got) == {"nzc.segments"}, [str(v) for v in got]


@pytest.mark.parametrize("graph", ["random", "star"])
def test_nzc_stale_stream_after_replace(graph):
    """``dataclasses.replace(dev, blocks=...)`` keeps the old ``nzc``: the
    kernels would read a stream that is no longer the operand's. Only
    full mode, which rebuilds the stream from the blocks, can see it."""
    plan, g, nzc = _nzc_plan(graph)
    dev = plan.graph_op.fwd_operand
    col = int(nzc.x_rows[int(nzc.items[_target_items(nzc, graph)[0], 1])])
    blocks = dev.blocks.clone()
    held = (dev.block_rows == 0) if graph == "star" else slice(None)
    b = blocks[held]
    b[dev.block_cols[held] == col // dev.bc, :, col % dev.bc] = 0.0
    blocks[held] = b
    bad = _mutate(plan, blocks=blocks)
    assert bad.graph_op.fwd_operand.nzc is nzc  # the hazard itself
    assert verify_plan(bad, mode="fast", graph=g) == []
    got = verify_plan(bad, mode="full")  # no graph: the mass check is off
    assert _invariants(got) == {"nzc.stream_match"}, [str(v) for v in got]
    _assert_flagged(verify_plan(bad, mode="full", graph=g), "nzc.stream_match")


def test_sampled_template_streams_skip_the_padding_tail():
    """The template batch's streams are built as the trainer builds them,
    on the plan's device (the trainer's, which it passes to
    ``lower_sampled``); the sampler's zero padding tail gives no column,
    so the padded and the unpadded stream agree."""
    ds = generate_dataset("corafull", scale=1.0, seed=0, max_nodes=96)
    tr = MiniBatchTrainer(_gcn(ds.features.shape[1]), ds.graph, ds.features,
                          None, None, None, fanouts=(3, 3), batch_size=16,
                          engine="cuda", device="cpu")
    assert tr.plan.device == torch.device("cpu")
    calls = []
    orig = verify_mod._check_batch_stream

    def spy(v, operand, d, n_rows, n_cols, br, device, layer):
        calls.append((operand, verify_mod._real_blocks(d), d["rows"].shape[0],
                      device))
        return orig(v, operand, d, n_rows, n_cols, br, device, layer)

    verify_mod._check_batch_stream = spy
    try:
        assert verify_plan(tr.plan, mode="full") == []
    finally:
        verify_mod._check_batch_stream = orig
    assert len(calls) == 4  # A and Aᵀ of both layers
    assert any(real < total for _, real, total, _ in calls)  # padding present
    assert {d for *_, d in calls} == {torch.device("cpu")}


# ---------------------------------------------------------------------------
# zero false positives over every plan family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("arch", ["GCN", "SAGE", "GIN", "GAT", "GT"])
@pytest.mark.parametrize("name", ["corafull", "ppi"])
def test_no_false_positives_full_batch(name, arch, engine):
    ds = generate_dataset(name, scale=1.0, seed=0, max_nodes=96)
    f = ds.features.shape[1]
    cfg = GNNConfig(kind=arch, layer_dims=[f, 8, int(ds.n_classes)],
                    aggregation="mean" if arch == "SAGE" else "sum",
                    gat_heads=2)
    plan = lower(cfg, ds.graph, ds.features, gamma=0.5, engine=engine,
                 device="cpu", validate="full")
    assert verify_plan(plan, mode="full", graph=ds.graph) == []
    assert (plan.graph_op.fwd_operand.nzc is not None) == (engine == "cuda")


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("arch,agg", [("GCN", "sum"), ("GAT", "sum"),
                                      ("SAGE", "max")])
def test_no_false_positives_sampled(arch, agg, engine):
    ds = generate_dataset("corafull", scale=1.0, seed=0, max_nodes=96)
    f = ds.features.shape[1]
    cfg = GNNConfig(kind=arch, layer_dims=[f, 8, int(ds.n_classes)],
                    aggregation=agg, gat_heads=2)
    plan = lower_sampled(cfg, ds.graph, ds.features, fanouts=(3, 3),
                         batch_size=16, n_buckets=2, gamma=0.5, engine=engine,
                         validate="full")
    assert verify_plan(plan, mode="full") == []


@pytest.mark.parametrize("layout", ["degree", "rcm", "auto"])
def test_no_false_positives_reordered_layouts(layout, tmp_path, monkeypatch):
    monkeypatch.setenv("MORPHLING_LAYOUT_CACHE", str(tmp_path / "cache.json"))
    src, dst, n = _edges()
    g = csr_from_edges(src, dst, n_rows=n, n_cols=n)
    plan = lower(_gcn(), g, _features(n), gamma=0.5, engine="cuda",
                 device="cpu", layout=layout, validate="full")
    g_exec = (permute_graph(g, np.asarray(plan.layout.inv_perm))
              if plan.layout.permutes else g)
    assert verify_plan(plan, mode="full", graph=g_exec) == []


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_no_false_positives_star(engine):
    src, dst, n = _star()
    plan, g = _port(src, dst, n, engine, validate="full")
    assert verify_plan(plan, mode="full", graph=g) == []
    sampled = lower_sampled(_gcn(), g, _features(n), fanouts=(1200, 4),
                            batch_size=8, gamma=0.5, engine=engine,
                            validate="full")
    assert verify_plan(sampled, mode="full") == []


# ---------------------------------------------------------------------------
# API: the raising entry point, the mode knob, the host copies
# ---------------------------------------------------------------------------


def test_check_plan_raises_with_named_layer_and_invariant():
    plan, g = _port(*_edges())
    layers = list(plan.layers)
    layers[0] = dataclasses.replace(layers[0], d_out=999)
    bad = dataclasses.replace(plan, layers=layers)
    with pytest.raises(PlanVerificationError) as ei:
        check_plan(bad, mode="fast")
    assert "binding.dim_chain" in str(ei.value)
    assert "layer 0" in str(ei.value)
    assert ei.value.violations[0].layer == 0


def test_lowerings_reject_bad_mode_before_building(monkeypatch):
    import repro_torch.core.lowering as lowering

    def no_build(*a, **kw):
        raise AssertionError("an operand was built")

    monkeypatch.setattr(lowering, "make_fused_aggregate", no_build)
    monkeypatch.setattr(lowering, "NeighborSampler", no_build)
    src, dst, n = _edges()
    g = csr_from_edges(src, dst, n_rows=n, n_cols=n)
    with pytest.raises(ValueError, match="validate"):
        lower(_gcn(), g, _features(n), device="cpu", validate="paranoid")
    with pytest.raises(ValueError, match="validate"):
        lower_sampled(_gcn(), g, _features(n), fanouts=(3, 3),
                      validate="paranoid")


def test_validate_off_skips_everything():
    plan, g = _port(*_edges())
    cols = _host(plan, "block_cols")
    cols[0] = 10_000
    bad = _mutate(plan, block_cols=cols)
    assert verify_plan(bad, mode="off") == []
    check_plan(bad, mode="off")
    with pytest.raises(PlanVerificationError, match="bsr.cols_in_range"):
        check_plan(bad, mode="fast")


def test_violation_str_names_everything():
    v = PlanViolation(layer=2, operand="graph_op.fwd",
                      invariant="bsr.cols_sorted", detail="x")
    assert "layer 2" in str(v) and "bsr.cols_sorted" in str(v)
    assert str(PlanViolation(-1, "layout", "perm.inverse", "y")).startswith(
        "[perm.inverse] plan / layout")


def test_compile_passes_validate_on():
    ds = generate_dataset("corafull", scale=1.0, seed=0, max_nodes=96)
    gnn = GNNProgram.load(ds).initialize_layers([16])
    for mode in ("off", "fast", "full"):
        prog = gnn.compile(device="cpu", validate=mode)
        assert verify_plan(prog.plan, mode="full", graph=ds.graph) == []
    with pytest.raises(ValueError, match="validate"):
        gnn.compile(device="cpu", validate="paranoid")


def test_distributed_checks_name_item_7():
    """The distributed checks (``split.*``, ``halo.*``) are ported with
    item 7's core (their mutations and false-positive sweep are in
    ``test_torch_distributed.py``); a single-device plan ignores
    ``dist``; what item 7 still leaves (tensor-parallel sharding, a
    transport other than gloo) is named by ``DIST_ITEM``."""
    from repro_torch.backends.registry import DIST_ITEM

    plan, _ = _port(*_edges())
    assert verify_plan(plan, mode="full", dist=object()) == []
    assert {"split.interior_no_ghost", "split.reconstruction",
            "split.live_shifts", "halo.schedule_paired",
            "halo.slot_unique"} <= set(INVARIANT_CATALOG)
    assert "bsr.last_in_row" not in INVARIANT_CATALOG
    assert "item 7, parts 4 and 5" in DIST_ITEM


def test_host_copies(monkeypatch):
    """Fast mode copies each operand's index arrays to the host in one
    copy and reads no value; full mode's value checks are reductions on
    the operand's device: no block value crosses, only counts, maxima
    and block-row sums."""
    plan, g = _port(*_star())
    reads = []
    orig = verify_mod._np

    def spy(a):
        if isinstance(a, torch.Tensor):
            reads.append((a.dtype, a.numel()))
        return orig(a)

    monkeypatch.setattr(verify_mod, "_np", spy)
    assert verify_plan(plan, mode="fast", graph=g) == []
    assert len(reads) == 2  # one copy per operand: A and Aᵀ
    assert all(dt == torch.int32 for dt, _ in reads)
    reads.clear()
    assert verify_plan(plan, mode="full", graph=g) == []
    n_blocks = plan.graph_op.fwd_operand.blocks.shape[0]
    n_rows = -(-g.n_rows // plan.layout.br)
    floats = [n for dt, n in reads if dt.is_floating_point]
    assert floats and max(floats) <= n_rows < n_blocks


# ---------------------------------------------------------------------------
# CSR structural validation (repro_torch/graph/csr.py:validate_structure)
# ---------------------------------------------------------------------------


def test_csr_validates_unsorted_columns():
    with pytest.raises(ValueError, match="unsorted"):
        CSRGraph(indptr=np.array([0, 2]), indices=np.array([3, 1]),
                 data=np.ones(2, np.float32), n_rows=1, n_cols=4)


def test_csr_validates_duplicate_columns():
    with pytest.raises(ValueError, match="duplicate"):
        CSRGraph(indptr=np.array([0, 2]), indices=np.array([1, 1]),
                 data=np.ones(2, np.float32), n_rows=1, n_cols=4)


def test_csr_validates_out_of_range_columns():
    with pytest.raises(ValueError, match="valid range"):
        CSRGraph(indptr=np.array([0, 1]), indices=np.array([7]),
                 data=np.ones(1, np.float32), n_rows=1, n_cols=4)


def test_csr_validates_nonmonotone_indptr():
    with pytest.raises(ValueError, match="indptr"):
        CSRGraph(indptr=np.array([0, 2, 1, 3]),
                 indices=np.array([0, 1, 2]),
                 data=np.ones(3, np.float32), n_rows=3, n_cols=4)


def test_csr_escape_hatch_accepts_malformed():
    g = CSRGraph(indptr=np.array([0, 2]), indices=np.array([3, 1]),
                 data=np.ones(2, np.float32), n_rows=1, n_cols=4,
                 validate=False)
    assert g.nnz == 2  # accepted, caller owns the consequences


def test_csr_validates_trailing_empty_rows():
    g = CSRGraph(indptr=np.array([0, 2, 4, 4]),
                 indices=np.array([5, 9, 2, 3]),
                 data=np.ones(4, np.float32), n_rows=3, n_cols=10)
    assert g.nnz == 4


def test_csr_validates_interior_and_trailing_empty_rows():
    g = CSRGraph(indptr=np.array([0, 2, 2, 3, 3, 3]),
                 indices=np.array([1, 4, 0]),
                 data=np.ones(3, np.float32), n_rows=5, n_cols=5)
    assert g.degrees().tolist() == [2, 0, 1, 0, 0]


def test_csr_trailing_empty_rows_still_catch_bad_columns():
    with pytest.raises(ValueError, match="duplicate"):
        CSRGraph(indptr=np.array([0, 2, 2]), indices=np.array([3, 3]),
                 data=np.ones(2, np.float32), n_rows=2, n_cols=4)


def test_csr_validates_empty_graph():
    g = CSRGraph(indptr=np.zeros(4, np.int64), indices=np.zeros(0, np.int64),
                 data=np.zeros(0, np.float32), n_rows=3, n_cols=3)
    assert g.nnz == 0


def test_csr_builders_stay_valid():
    src, dst, n = _edges()
    g = csr_from_edges(src, dst, n_rows=n, n_cols=n)
    g.validate_structure()  # csr_from_edges output is well-formed
    g.transpose().validate_structure()


# ---------------------------------------------------------------------------
# the chaos soak, on the CPU
# ---------------------------------------------------------------------------


def test_chaos_soak_one_schedule_per_target(tmp_path, capsys):
    sys.path.insert(0, REPO)
    try:
        from tools import chaos_soak
    finally:
        sys.path.remove(REPO)
    assert chaos_soak.main(["--schedules", "4", "--device", "cpu",
                            "--work-dir", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [l.split(",", 2) for l in lines[1:-1]]
    assert lines[0] == "name,us_per_call,derived"
    assert [r[0] for r in rows] == ["chaos/distributed", "chaos/full_batch",
                                    "chaos/mini_batch", "chaos/serving"]
    assert "ranks=4" in rows[0][2]  # 4 gloo rank processes on the CPU
    assert "all properties held" in lines[-1]
    assert os.listdir(tmp_path) == []  # checkpoints removed after each trial


# ---------------------------------------------------------------------------
# the card: the same mutations on card-resident operands
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("graph", ["random", "star"])
def test_card_mutations_flagged(graph):
    """On the card: the plan's operands and streams are card-resident; the
    unsorted block column, the NaN block, a dropped item, the stale stream
    and the over-heavy block-row are each flagged by name through
    ``check_plan``, and the clean plan passes full mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    src, dst, n = _star() if graph == "star" else _edges()
    g = csr_from_edges(src, dst, n_rows=n, n_cols=n)
    plan = lower(_gcn(), g, _features(n), gamma=0.5, engine="cuda",
                 device="cuda", br=8, bc=8, validate="full")
    dev = plan.graph_op.fwd_operand
    assert dev.blocks.is_cuda and dev.nzc.items.is_cuda
    rows, cols = _host(plan, "block_rows"), _host(plan, "block_cols")
    blocks = dev.blocks.clone()
    blocks[0, 0, 0] = float("nan")
    heavy = dev.blocks.clone()
    heavy[int(np.flatnonzero(rows == rows.max())[0])] *= 2.0
    idx = _target_items(types.SimpleNamespace(items=dev.nzc.items.cpu()), graph)
    for invariant, bad in (
            ("bsr.cols_sorted", _mutate(plan, **{
                k: torch.from_numpy(v).cuda()
                for k, v in _unsorted_cols(rows, cols.copy()).items()})),
            ("bsr.finite", _mutate(plan, blocks=blocks)),
            ("nzc.row_coverage", _mutate(plan, nzc=dataclasses.replace(
                dev.nzc, items=dev.nzc.items[torch.from_numpy(np.setdiff1d(
                    np.arange(dev.nzc.items.shape[0]), idx[-1:])).cuda()]))),
            ("nzc.stream_match", _mutate(plan, blocks=heavy)),
            ("layout.operand_rows", _mutate(plan, blocks=heavy))):
        with pytest.raises(PlanVerificationError) as ei:
            check_plan(bad, mode="full", graph=g)
        _assert_flagged(ei.value.violations, invariant)
