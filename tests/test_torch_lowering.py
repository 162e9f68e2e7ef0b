"""Port parity, lowering: ``repro_torch.core.lowering.lower_sampled`` makes the
same plan as the JAX package's — the same ``describe()`` dump with the
backend names mapped (``pallas`` -> ``cuda``, ``xla`` -> ``torch``) — for the
archs, the attention archs (fused and segment) and ``max`` on a
sparse-feature (nell) and a dense-feature (ogbn-arxiv) dataset; the
Alg-1 arithmetic agrees."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.lowering import lower_sampled as jax_lower_sampled  # noqa: E402
from repro.core.sparsity import (  # noqa: E402
    decide_execution_path_from_stats as jax_decide,
    estimate_activation_sparsity as jax_estimate,
)
from repro.graph.datasets import generate_dataset  # noqa: E402
from repro.models.gnn import GNNConfig as JaxConfig  # noqa: E402
from repro_torch.backends import OP_VOCABULARY, select_backend  # noqa: E402
from repro_torch.core.lowering import lower_sampled  # noqa: E402
from repro_torch.core.sparsity import (  # noqa: E402
    decide_execution_path_from_stats,
    estimate_activation_sparsity,
)
from repro_torch.models.gnn import GNNConfig  # noqa: E402

torch.set_num_threads(1)

NAMES = {"pallas": "cuda", "xla": "torch", "gather": "gather"}

ARCHS = [("GCN", "gcn"), ("SAGE", "mean"), ("SAGE", "sum"), ("GIN", "sum")]


def _dataset(regime):
    if regime == "sparse":
        return generate_dataset("nell", scale=0.002, seed=0)  # 99% zeros
    return generate_dataset("ogbn-arxiv", scale=0.001, seed=0)  # dense


def _plans(kind, agg, regime, engine, heads=4, **kw):
    ds = _dataset(regime)
    dims = [ds.features.shape[1], 16, ds.n_classes]
    cfg = dict(kind=kind, layer_dims=dims, aggregation=agg, gat_heads=heads)
    jp = jax_lower_sampled(
        JaxConfig(**cfg), ds.graph, ds.features, fanouts=(4, 3),
        batch_size=16, engine=engine, **kw)
    tp = lower_sampled(
        GNNConfig(**cfg), ds.graph, ds.features, fanouts=(4, 3),
        batch_size=16, engine=NAMES[engine], **kw)
    return jp, tp


def _mapped(describe: str) -> str:
    for jax_name, port_name in NAMES.items():
        describe = describe.replace(jax_name, port_name)
    return describe


@pytest.mark.parametrize("kind,agg", ARCHS)
@pytest.mark.parametrize("regime", ["sparse", "dense"])
@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_sampled_plan_matches_jax(kind, agg, regime, engine):
    jp, tp = _plans(kind, agg, regime, engine)
    assert tp.describe() == _mapped(jp.describe())
    assert [l.feature_path for l in tp.layers] == [l.feature_path for l in jp.layers]
    assert tp.layers[0].feature_path == ("sparse" if regime == "sparse" else "dense")
    assert tp.sampler.emit_bsr == jp.sampler.emit_bsr


@pytest.mark.parametrize("kw", [dict(layout="degree"), dict(fuse_epilogue=False),
                                dict(use_sparse_input=False),
                                dict(infer_only=True)])
def test_sampled_plan_options_match_jax(kw):
    jp, tp = _plans("GIN", "sum", "sparse", "pallas", **kw)
    assert tp.describe() == _mapped(jp.describe())
    if "layout" in kw:
        np.testing.assert_array_equal(tp.layout.perm, jp.layout.perm)
        np.testing.assert_array_equal(tp.layout.inv_perm, jp.layout.inv_perm)


@pytest.mark.parametrize("kind,agg", [("GAT", "gcn"), ("GT", "gcn"),
                                      ("SAGE", "max")])
@pytest.mark.parametrize("regime", ["sparse", "dense"])
@pytest.mark.parametrize("engine", ["pallas", "xla", "gather"])
@pytest.mark.parametrize("fuse_attention", [True, False])
def test_sampled_attention_and_max_plans_match_jax(kind, agg, regime, engine,
                                                   fuse_attention):
    jp, tp = _plans(kind, agg, regime, engine, heads=3,
                    fuse_attention=fuse_attention)
    assert tp.describe() == _mapped(jp.describe())
    assert tp.sampler.emit_bsr == jp.sampler.emit_bsr
    for jl, tl in zip(jp.layers, tp.layers):
        assert (tl.attention is None) == (jl.attention is None)
        if tl.attention is not None:
            assert (tl.attention.heads, tl.attention.head_dim, tl.attention.fused,
                    tl.attention.vjp) == (jl.attention.heads, jl.attention.head_dim,
                                          jl.attention.fused, jl.attention.vjp)


def test_gather_engine_plan_matches_jax():
    jp, tp = _plans("GCN", "gcn", "dense", "gather")
    assert tp.describe() == _mapped(jp.describe())
    assert not tp.sampler.emit_bsr


@pytest.mark.parametrize("s,n,f,h,gamma", [(0.99, 100, 500, 16, 0.2),
                                           (0.5, 40, 8, 32, 0.2),
                                           (0.85, 10, 10, 10, 0.1)])
def test_alg1_decision_matches_jax(s, n, f, h, gamma):
    j = jax_decide(s, n, f, h, gamma=gamma)
    t = decide_execution_path_from_stats(s, n, f, h, gamma=gamma)
    assert (t.mode, t.sparsity, t.gamma, t.threshold, t.t_dense, t.t_sparse) == \
        (j.mode, j.sparsity, j.gamma, j.threshold, j.t_dense, j.t_sparse)


def test_activation_sparsity_keys_on_the_ports_relu():
    assert estimate_activation_sparsity(torch.relu) == jax_estimate(jax.nn.relu)
    assert estimate_activation_sparsity(torch.tanh) == jax_estimate(jax.nn.tanh)
    assert estimate_activation_sparsity(jax.nn.relu) == 0.0  # not the port's


def test_later_slices_raise_not_implemented():
    """Attention and ``max`` on the sampled path, once a later slice, now
    bind: GAT / GT the fused ``spmm_attention`` over the per-batch BSR
    pair (an ``AttentionPlan`` per layer, the recompute VJP) or, with
    ``fuse_attention=False``, the segment path over the edge lists; SAGE
    with ``max`` ``gather.segment_max`` over the edge lists."""
    ds = _dataset("dense")
    dims = [ds.features.shape[1], 16, ds.n_classes]
    for kind in ("GAT", "GT"):
        cfg = GNNConfig(kind=kind, layer_dims=dims, gat_heads=4)
        for fused, prim in ((True, "cuda.spmm_attention"),
                            (False, "cuda.segment_softmax_aggregate")):
            plan = lower_sampled(cfg, ds.graph, ds.features, fanouts=(4, 3),
                                 fuse_attention=fused)
            assert plan.sampler.emit_bsr is fused
            assert [l.agg_primitive for l in plan.layers] == [prim, prim]
            assert [(l.attention.heads, l.attention.head_dim, l.attention.fused,
                     l.attention.vjp) for l in plan.layers] == [
                (4, 4, fused, "recompute(m,l)" if fused else "autodiff"),
                (4, max(ds.n_classes // 4, 1), fused,
                 "recompute(m,l)" if fused else "autodiff")]
            assert all(l.epilogue is None for l in plan.layers)
    plan = lower_sampled(GNNConfig(kind="SAGE", layer_dims=dims,
                                   aggregation="max"),
                         ds.graph, ds.features, fanouts=(4, 3))
    assert not plan.sampler.emit_bsr
    assert all(l.agg_primitive == "gather.segment_max" and l.attention is None
               and l.epilogue is None for l in plan.layers)


def test_registry_names_and_default_backend():
    assert "spmm" in OP_VOCABULARY and len(OP_VOCABULARY) == 8
    assert select_backend(None).name == "cuda"
    assert select_backend("torch").name == "torch"
    with pytest.raises(KeyError, match="unknown backend"):
        select_backend("pallas")
