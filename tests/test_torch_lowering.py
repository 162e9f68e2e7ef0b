"""Port parity, lowering: ``repro_torch.core.lowering.lower_sampled`` makes the
same plan as the JAX package's — the same ``describe()`` dump with the
backend names mapped (``pallas`` -> ``cuda``, ``xla`` -> ``torch``) — for the
matmul archs on a sparse-feature (nell) and a dense-feature (ogbn-arxiv)
dataset; the Alg-1 arithmetic agrees; archs of later slices raise."""
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


def _plans(kind, agg, regime, engine, **kw):
    ds = _dataset(regime)
    dims = [ds.features.shape[1], 16, ds.n_classes]
    jp = jax_lower_sampled(
        JaxConfig(kind=kind, layer_dims=dims, aggregation=agg), ds.graph,
        ds.features, fanouts=(4, 3), batch_size=16, engine=engine, **kw)
    tp = lower_sampled(
        GNNConfig(kind=kind, layer_dims=dims, aggregation=agg), ds.graph,
        ds.features, fanouts=(4, 3), batch_size=16, engine=NAMES[engine], **kw)
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
    ds = _dataset("dense")
    dims = [ds.features.shape[1], 16, ds.n_classes]
    for cfg in (GNNConfig(kind="GAT", layer_dims=dims),
                GNNConfig(kind="GT", layer_dims=dims),
                GNNConfig(kind="SAGE", layer_dims=dims, aggregation="max")):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md Queue 1, item 11"):
            lower_sampled(cfg, ds.graph, ds.features, fanouts=(4, 3))


def test_registry_names_and_default_backend():
    assert "spmm" in OP_VOCABULARY and len(OP_VOCABULARY) == 8
    assert select_backend(None).name == "cuda"
    assert select_backend("torch").name == "torch"
    with pytest.raises(KeyError, match="unknown backend"):
        select_backend("pallas")
