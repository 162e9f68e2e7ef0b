"""Port parity, the slice as a whole: the serving path (sampler -> lowering ->
trainer -> engine) of ``repro_torch`` against the JAX package's on the
48-node fixture of ``tests/test_serving.py``.

The JAX engine runs ``engine="pallas"`` (the Pallas kernel in interpret
mode); the port's runs its default ``cuda`` backend on ``device="cpu"``,
where the kernel wrapper takes its plain version. Both get the same
weights (``params_from_jax``) and the same request stream; logits agree
within 1e-4 (float32, different summation orders) and the engines' counters
agree exactly. Also: the shape-signature bound, the no-card error, and that
the port imports without JAX or ``repro``."""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graph.csr import csr_from_edges as jax_csr_from_edges  # noqa: E402
from repro.models.gnn import GNNConfig as JaxConfig  # noqa: E402
from repro.models.gnn import init_params as jax_init_params  # noqa: E402
from repro.serving.gnn_engine import GNNRequest as JaxRequest  # noqa: E402
from repro.serving.gnn_engine import GNNServingEngine as JaxEngine  # noqa: E402
from repro.training.trainer import MiniBatchTrainer as JaxTrainer  # noqa: E402
from repro_torch.graph.csr import csr_from_edges  # noqa: E402
from repro_torch.models.gnn import GNNConfig, params_from_jax  # noqa: E402
from repro_torch.serving.gnn_engine import GNNRequest, GNNServingEngine  # noqa: E402
from repro_torch.training.trainer import MiniBatchTrainer  # noqa: E402

pytestmark = pytest.mark.serving
torch.set_num_threads(1)

N, F, C = 48, 12, 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(sparse_features=False):
    rng = np.random.default_rng(0)
    src = np.concatenate([rng.integers(0, N, 300), np.arange(N)])
    dst = np.concatenate([rng.integers(0, N, 300), np.arange(N)])
    x = rng.random((N, F)).astype(np.float32)
    if sparse_features:
        x[rng.random((N, F)) < 0.95] = 0.0
    return src, dst, x


def _pair(kind, *, agg="gcn", layout=None, sparse_features=False,
          fanouts=(4, 3), batch_size=8, n_buckets=2):
    """(JAX trainer on pallas-interpret, port trainer on cpu) with the
    same graph, features and weights."""
    src, dst, x = _inputs(sparse_features)
    kw = dict(fanouts=fanouts, batch_size=batch_size, n_buckets=n_buckets,
              seed=0, layout=layout, infer_only=True)
    dims = [F, 8, C]
    jtr = JaxTrainer(JaxConfig(kind=kind, layer_dims=dims, aggregation=agg),
                     jax_csr_from_edges(src, dst, N), x, None, None, None,
                     engine="pallas", **kw)
    jtr.params = jax_init_params(jtr.config, jax.random.PRNGKey(42))
    ttr = MiniBatchTrainer(GNNConfig(kind=kind, layer_dims=dims, aggregation=agg),
                           csr_from_edges(src, dst, N), x, None, None, None,
                           device="cpu", **kw)
    ttr.params = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jtr.params), device="cpu")
    return jtr, ttr


def _serve_stream(engine, request_cls, n_requests=10, seed=9):
    q = np.random.default_rng(seed)
    out = []
    for rid in range(n_requests):
        ids = q.choice(N, size=int(q.integers(1, 5)), replace=False)
        engine.submit(request_cls(rid=rid, node_ids=ids))
        if rid % 3 == 2:
            out.extend(engine.run())
    out.extend(engine.run())
    return out


def _stats(engine):
    s = engine.stats()
    return (s["waves"], s["batches"], s["coalesced"], s["cache"]["hits"],
            s["cache"]["misses"])


@pytest.mark.parametrize("kind,agg,layout,sparse", [
    ("GCN", "gcn", None, False),
    ("SAGE", "mean", None, False),
    ("GIN", "sum", None, False),
    ("GCN", "gcn", "degree", False),
    ("GIN", "sum", None, True),
])
def test_serving_logits_and_stats_match_jax(kind, agg, layout, sparse):
    jtr, ttr = _pair(kind, agg=agg, layout=layout, sparse_features=sparse)
    assert ttr.plan.describe() == jtr.plan.describe().replace("pallas", "cuda")
    assert ttr.plan.layers[0].feature_path == ("sparse" if sparse else "dense")
    je = JaxEngine(jtr, wave_size=3, use_cache=True, seed=5)
    te = GNNServingEngine(ttr, wave_size=3, use_cache=True, seed=5)
    jdone = _serve_stream(je, JaxRequest)
    tdone = _serve_stream(te, GNNRequest)
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for jr, tr in zip(jdone, tdone):
        assert tr.logits.shape == jr.logits.shape and tr.logits.dtype == np.float32
        np.testing.assert_allclose(tr.logits, jr.logits, atol=1e-4, rtol=1e-4)
    assert _stats(te) == _stats(je)
    # the trainer's direct path agrees too (fixed rng: same sample)
    ids = np.asarray([3, 17, 41, 0, 3])
    np.testing.assert_allclose(ttr.infer_logits(ids), jtr.infer_logits(ids),
                               atol=1e-4, rtol=1e-4)


def test_hidden_levels_match_jax():
    jtr, ttr = _pair("SAGE", agg="mean")
    je = JaxEngine(jtr, use_cache=True, cache_hidden=True, seed=0)
    te = GNNServingEngine(ttr, use_cache=True, cache_hidden=True, seed=0)
    ids = np.asarray([8, 15, 3])
    np.testing.assert_allclose(te.serve(ids), je.serve(ids), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(te.embed(ids, level=1), je.embed(ids, level=1),
                               atol=1e-4, rtol=1e-4)


def test_shape_signatures_bounded_by_buckets_and_zero_after_warmup():
    src, dst, x = _inputs()
    tr = MiniBatchTrainer(GNNConfig(kind="GCN", layer_dims=[F, 8, C]),
                          csr_from_edges(src, dst, N), x, None, None, None,
                          fanouts=(4, 3), batch_size=8, n_buckets=2,
                          infer_only=True, device="cpu")
    engine = GNNServingEngine(tr, wave_size=4, use_cache=False, seed=0)
    assert engine.warmup() == tr.n_infer_traces
    traces = tr.n_infer_traces
    assert 1 <= traces <= tr.plan.n_buckets
    done = _serve_stream(engine, GNNRequest, n_requests=40, seed=2)
    assert len(done) == 40 and all(np.isfinite(r.logits).all() for r in done)
    assert tr.n_infer_traces == traces


def test_no_card_raises_unless_cpu_requested(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, dst, x = _inputs()
    g = csr_from_edges(src, dst, N)
    cfg = GNNConfig(kind="GCN", layer_dims=[F, 8, C])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MiniBatchTrainer(cfg, g, x, None, None, None, fanouts=(4, 3),
                         batch_size=8, infer_only=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MiniBatchTrainer(cfg, g, x, None, None, None, fanouts=(4, 3),
                         batch_size=8, infer_only=True, device="cuda")
    tr = MiniBatchTrainer(cfg, g, x, None, None, None, fanouts=(4, 3),
                          batch_size=8, infer_only=True, device="cpu")
    assert tr.infer_logits([1, 2]).shape == (2, C)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        MiniBatchTrainer(cfg, g, x, None, None, object(), fanouts=(4, 3),
                         device="cpu")


def test_port_imports_without_jax_or_repro():
    """Every module of the port, and the chip smoke script, import in a
    process where ``jax`` and ``repro`` cannot be imported."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None  # any import of them now raises
        import repro_torch
        mods = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for m in mods:
            importlib.import_module(m)
        import chip_smoke
        print(" ".join(mods))
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), REPO]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.strip().splitlines()[-1].split())
    assert len(mods) >= 25
    assert {"repro_torch.core.dsl", "repro_torch.training.optimizer",
            "repro_torch.kernels.fused_adam", "repro_torch.kernels.ops",
            "repro_torch.core.aggregate", "repro_torch.core.lowering",
            "repro_torch.kernels.bsr_attention"} <= mods
