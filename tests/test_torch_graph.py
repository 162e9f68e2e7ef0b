"""Port parity, graph layer: the port's copied CSR/BSR builders, dataset
generator and neighbour sampler produce byte-identical arrays to
``repro.graph`` from the same inputs and seeds."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graph import csr as jcsr  # noqa: E402
from repro.graph import datasets as jds  # noqa: E402
from repro.graph import sampling as jsmp  # noqa: E402
from repro_torch.graph import csr as tcsr  # noqa: E402
from repro_torch.graph import datasets as tds  # noqa: E402
from repro_torch.graph import sampling as tsmp  # noqa: E402

torch.set_num_threads(1)


def _same(a, b, what=""):
    """Byte-identical: same dtype, same shape, same bytes."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _same_csr(a, b):
    for f in ("indptr", "indices", "data"):
        _same(getattr(a, f), getattr(b, f), f)
    assert (a.n_rows, a.n_cols) == (b.n_rows, b.n_cols)


def _same_bsr(a, b):
    for f in ("block_rows", "block_cols", "first_in_row", "last_in_row",
              "blocks"):
        _same(getattr(a, f), getattr(b, f), f)
    assert (a.n_rows, a.n_cols, a.br, a.bc) == (b.n_rows, b.n_cols, b.br, b.bc)


def _edges(seed, n=60, e=300, n_cols=None):
    r = np.random.default_rng(seed)
    return r.integers(0, n_cols or n, e), r.integers(0, n, e)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dedupe", [True, False])
def test_csr_builders_and_normalisations_identical(seed, dedupe):
    src, dst = _edges(seed)
    j = jcsr.csr_from_edges(src, dst, 60, dedupe=dedupe)
    t = tcsr.csr_from_edges(src, dst, 60, dedupe=dedupe)
    _same_csr(j, t)
    _same_csr(j.transpose(), t.transpose())
    _same_csr(j.sym_normalized(), t.sym_normalized())
    _same_csr(j.row_normalized(), t.row_normalized())


@pytest.mark.parametrize("br,bc", [(8, 8), (8, 16), (16, 32), (8, None)])
@pytest.mark.parametrize("seed", [0, 3])
def test_csr_to_bsr_identical(seed, br, bc):
    # 70 columns against 60 rows: rectangular, with empty block-rows
    src, dst = _edges(seed, n=60, e=120, n_cols=70)
    j = jcsr.csr_to_bsr(jcsr.csr_from_edges(src, dst, 60, n_cols=70), br=br, bc=bc)
    t = tcsr.csr_to_bsr(tcsr.csr_from_edges(src, dst, 60, n_cols=70), br=br, bc=bc)
    _same_bsr(j, t)


@pytest.mark.parametrize("mode", ["degree", "rcm"])
def test_reorder_identical(mode):
    src, dst = _edges(5)
    j_g, j_p, j_i = jcsr.reorder_graph(jcsr.csr_from_edges(src, dst, 60), mode)
    t_g, t_p, t_i = tcsr.reorder_graph(tcsr.csr_from_edges(src, dst, 60), mode)
    _same_csr(j_g, t_g)
    _same(j_p, t_p)
    _same(j_i, t_i)


@pytest.mark.parametrize("name,scale", [("corafull", 0.005), ("nell", 0.002),
                                        ("ogbn-arxiv", 0.0005),
                                        ("ppi", 0.002)])
def test_generate_dataset_identical(name, scale):
    j = jds.generate_dataset(name, scale=scale, seed=7)
    t = tds.generate_dataset(name, scale=scale, seed=7)
    _same_csr(j.graph, t.graph)
    for f in ("features", "labels", "train_mask", "val_mask", "test_mask"):
        _same(getattr(j, f), getattr(t, f), f)
    assert dataclasses.asdict(j.spec) == dataclasses.asdict(t.spec)


def _specs(buckets):
    """Bucket specs as plain tuples (the two packages' classes differ)."""
    return tuple(dataclasses.astuple(b) for b in buckets)


def _same_batch(a, b):
    assert _specs([a.bucket]) == _specs([b.bucket])
    _same(a.seeds, b.seeds)
    for va, vb in zip(a.valid, b.valid):
        _same(va, vb)
    _same(a.x, b.x)
    _same(a.labels, b.labels)
    assert (a.feat_coo is None) == (b.feat_coo is None)
    if a.feat_coo is not None:
        for ca, cb in zip(a.feat_coo, b.feat_coo):
            _same(ca, cb)
    for ba, bb in zip(a.blocks, b.blocks):
        for f in ("dst_nodes", "src_nodes", "edge_src", "edge_dst", "edge_w"):
            _same(getattr(ba, f), getattr(bb, f), f)
        _same_csr(ba.csr, bb.csr)
        for side in ("fwd_bsr", "bwd_bsr"):
            for k in ("rows", "cols", "first", "blocks"):
                _same(getattr(ba, side)[k], getattr(bb, side)[k], f"{side}.{k}")


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("br,bc", [(8, 8), (8, 16)])
def test_sampler_batches_identical(seed, br, bc):
    ds = jds.generate_dataset("corafull", scale=0.01, seed=seed)
    feats = ds.features
    j_g = ds.graph.sym_normalized()
    t_g = tcsr.CSRGraph(ds.graph.indptr, ds.graph.indices, ds.graph.data,
                        ds.graph.n_rows, ds.graph.n_cols).sym_normalized()
    kw = dict(n_buckets=2, br=br, bc=bc, seed=seed)
    js = jsmp.NeighborSampler(j_g, (4, 3), 16, **kw)
    ts = tsmp.NeighborSampler(t_g, (4, 3), 16, **kw)
    assert _specs(js.buckets) == _specs(ts.buckets)
    js.set_feature_caps([500, 900])
    ts.set_feature_caps([500, 900])
    ids = np.arange(ds.graph.n_rows)
    for jb, tb in zip(js.epoch_batches(ids, feats, ds.labels),
                      ts.epoch_batches(ids, feats, ds.labels)):
        _same_batch(jb, tb)
    # an explicit rng and a request smaller than the largest bucket
    _same_batch(js.sample_batch(ids[:5], feats, rng=np.random.default_rng(3)),
                ts.sample_batch(ids[:5], feats, rng=np.random.default_rng(3)))


def test_bucket_specs_identical_at_serving_shape():
    """The bucket caps of the port's serving configuration (fanouts
    (15, 10, 5), 256 seeds, 2 buckets, 8x8 tiles) at ogbn-arxiv's size.
    The caps read only the graph's node and nonzero counts."""
    g = types.SimpleNamespace(n_rows=169_343, nnz=1_335_586)
    t = tsmp.make_bucket_specs(g, (15, 10, 5), 256, 2, 8, 8)
    assert _specs(t) == _specs(jsmp.make_bucket_specs(g, (15, 10, 5), 256, 2, 8, 8))
    assert t[-1].node_caps == (169_344, 16_904, 1_544, 264)
    assert t[-1].fwd_block_caps[0] == 255_553
    assert t[-1].bwd_block_caps[0] == 274_608
