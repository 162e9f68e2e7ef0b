"""Port parity, the slice as a whole: the serving path (sampler -> lowering ->
trainer -> engine) of ``repro_torch`` against the JAX package's on the
48-node fixture of ``tests/test_serving.py``.

The JAX engine runs ``engine="pallas"`` (the Pallas kernel in interpret
mode); the port's runs its default ``cuda`` backend on ``device="cpu"``,
where the kernel wrapper takes its plain version. Both get the same
weights (``params_from_jax``) and the same request stream; logits agree
within 1e-4 (float32, different summation orders) and the engines' counters
agree exactly, for the matmul archs, GAT, GT and SAGE-max. Also: GAT
through the reduced-fanout plan, the launcher training then serving on
the CPU, the shape-signature bound, the no-card error, and that the port
imports without JAX or ``repro``."""
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
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.gnn import GNNConfig, params_from_jax  # noqa: E402
from repro_torch.serving.gnn_engine import GNNRequest, GNNServingEngine  # noqa: E402
from repro_torch.training.optimizer import adam  # noqa: E402
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
    same graph, features and weights; GAT and GT with 2 heads."""
    src, dst, x = _inputs(sparse_features)
    kw = dict(fanouts=fanouts, batch_size=batch_size, n_buckets=n_buckets,
              seed=0, layout=layout, infer_only=True)
    cfg = dict(kind=kind, layer_dims=[F, 8, C], aggregation=agg, gat_heads=2)
    jtr = JaxTrainer(JaxConfig(**cfg), jax_csr_from_edges(src, dst, N), x,
                     None, None, None, engine="pallas", **kw)
    jtr.params = jax_init_params(jtr.config, jax.random.PRNGKey(42))
    ttr = MiniBatchTrainer(GNNConfig(**cfg), csr_from_edges(src, dst, N), x,
                           None, None, None, device="cpu", **kw)
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
    ("GAT", "gcn", None, False),
    ("GT", "gcn", None, True),
    ("SAGE", "max", None, False),
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


def test_gat_serves_through_the_reduced_fanout_plan():
    """An overloaded engine answers GAT waves from the reduced-fanout
    sampler, as the JAX engine does: same requests, same degraded marks
    and counters, logits within 1e-4."""
    jtr, ttr = _pair("GAT")
    engines = [cls(tr, wave_size=2, use_cache=False, seed=3,
                   overload_threshold=2, degraded_fanouts=(2, 1))
               for cls, tr in ((JaxEngine, jtr), (GNNServingEngine, ttr))]
    done = []
    for eng, req in zip(engines, (JaxRequest, GNNRequest)):
        eng.warmup()
        for i in range(6):
            eng.submit(req(rid=i, node_ids=np.asarray([i % N, (i * 7) % N])))
        done.append(eng.run())
    jdone, tdone = done
    marks = [r.degraded for r in tdone]
    assert marks == [r.degraded for r in jdone]
    assert "fanout" in marks and marks[-1] is None
    for jr, tr in zip(jdone, tdone):
        np.testing.assert_allclose(tr.logits, jr.logits, atol=1e-4, rtol=1e-4)
    js, ts = (e.stats() for e in engines)
    assert ts["degraded"] == js["degraded"] and ts["degraded_waves"] >= 1
    assert ts["degraded_waves"] == js["degraded_waves"]


def test_launcher_trains_gat_then_serves_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch GAT --epochs 1`` at a
    tiny scale on the CPU: one epoch of training, then the request loop."""
    stats = launch_serve.main([
        "--device", "cpu", "--dataset", "corafull", "--scale", "0.01",
        "--hidden", "16", "--fanouts", "4,3", "--batch-size", "32",
        "--arch", "GAT", "--epochs", "1", "--requests", "12"])
    out = capsys.readouterr().out
    assert "train epoch 0: loss" in out
    assert stats["requests"] >= 12 and stats["infer_traces"] >= 1


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
    # an optimizer is accepted now: the trainer trains on the CPU
    tr = MiniBatchTrainer(cfg, g, x, np.zeros(N, np.int32), np.ones(N, bool),
                          adam(0.01), fanouts=(4, 3), batch_size=8,
                          device="cpu")
    assert not tr.infer_only and np.isfinite(tr.train_epoch())


def test_port_imports_without_jax_or_repro():
    """Every module of the port, the chip smoke script (with the chaos
    soak) and the port's example import in a process where ``jax`` and
    ``repro`` cannot be imported."""
    code = textwrap.dedent("""
        import importlib, importlib.util, pkgutil, sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None  # any import of them now raises
        import repro_torch
        mods = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for m in mods:
            importlib.import_module(m)
        import chip_smoke
        import tools.chaos_soak
        spec = importlib.util.spec_from_file_location(
            "host_streamed_demo_torch", "examples/host_streamed_demo_torch.py")
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
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
            "repro_torch.core.verify",
            "repro_torch.kernels.bsr_attention",
            "repro_torch.kernels.flash_attention", "repro_torch.configs.base",
            "repro_torch.configs.llama3p2_1b", "repro_torch.models.layers",
            "repro_torch.models.attention", "repro_torch.models.transformer",
            "repro_torch.models.moe", "repro_torch.configs.dbrx_132b",
            "repro_torch.models.ssm", "repro_torch.models.xlstm",
            "repro_torch.configs.zamba2_7b", "repro_torch.configs.xlstm_1p3b",
            "repro_torch.configs.deepseek_v3_671b",
            "repro_torch.models.model_zoo", "repro_torch.serving.engine",
            "repro_torch.training.grad", "repro_torch.training.schedule",
            "repro_torch.launch.train", "repro_torch.core.partitioner",
            "repro_torch.core.halo", "repro_torch.core.pipeline",
            "repro_torch.backends.distributed",
            "repro_torch.launch.mesh", "repro_torch.runtime.streaming",
            "repro_torch.runtime.failure", "repro_torch.runtime.elastic",
            "repro_torch.runtime.resilience"} <= mods
