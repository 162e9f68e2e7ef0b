"""Port parity, the layout stage and γ (``repro_torch/core/layout.py``,
``core/sparsity.py:calibrate_gamma``) against the JAX package's
``repro/core/layout.py`` and ``core/sparsity.py``.

The ``torch`` backend's cost model is the JAX ``xla`` backend's, so its
plans equal JAX's exactly; its timed plans run on the CPU here. The
``cuda`` backend's grid keeps one ``bc`` per ``br`` and its cost model
scores the nonzero-column stream, which does not depend on ``bc``
(checked tensor for tensor). Training at ``layout="auto"`` holds the
JAX package's losses within 1e-4 (float32 sums in other orders). Every
test writes its cache under ``tmp_path``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import layout as layout_mod  # noqa: E402
from repro_torch.core.dsl import GNNProgram  # noqa: E402
from repro_torch.core.layout import (  # noqa: E402
    TILE_CANDIDATES,
    _candidate_grid,
    _model_scores,
    cached_layout,
    column_stream,
    graph_fingerprint,
    plan_layout,
)
from repro_torch.core.lowering import lower  # noqa: E402
from repro_torch.core.sparsity import (  # noqa: E402
    calibrate_gamma,
    decide_execution_path_from_stats,
    measure_gamma,
)
from repro_torch.graph.csr import bsr_block_count, csr_from_edges, csr_to_bsr  # noqa: E402
from repro_torch.graph.datasets import generate_dataset  # noqa: E402
from repro_torch.kernels.bsr_spmm import BUILT_BR, nonzero_columns  # noqa: E402
from repro_torch.models.gnn import GNNConfig  # noqa: E402

torch.set_num_threads(1)

#: (name, scale) of the generated graphs the cost-model plans are compared
#: on: small uniform ones, and the power-law analogs where degree or rcm
#: wins the order
DATASETS = [("nell", 0.004), ("stargraph", 0.02), ("corafull", 0.01)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side, imported in a fixture so the card-marked
    test collects where JAX is absent."""
    pytest.importorskip("jax")
    import types

    import jax

    from repro.core import layout as jlayout
    from repro.core import sparsity as jsparsity
    from repro.core.dsl import GNNProgram as JaxProgram
    from repro.graph.csr import csr_from_edges as jax_csr_from_edges
    from repro.graph.datasets import generate_dataset as jax_generate

    return types.SimpleNamespace(jax=jax, layout=jlayout, sparsity=jsparsity,
                                 Program=JaxProgram, generate=jax_generate,
                                 csr_from_edges=jax_csr_from_edges)


def _edges(seed, n, e):
    r = np.random.default_rng(seed)
    return (np.concatenate([r.integers(0, n, e), np.arange(n)]),
            np.concatenate([r.integers(0, n, e), np.arange(n)]))


def _graph(seed=0, n=48, e=260):
    return csr_from_edges(*_edges(seed, n, e), n)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("case", [("random", 0, 48), ("random", 1, 100),
                                  ("random", 2, 300), *DATASETS],
                         ids=lambda c: "-".join(map(str, c)))
def test_cost_model_plans_match_jax(jx, tmp_path, case, fused):
    """``backend="torch"`` is the JAX ``xla`` cost model: the same order,
    tile, block count and padding waste."""
    name, a, *b = case
    if name == "random":
        b, = b
        src, dst = _edges(a, b, 5 * b)
        g, jg = csr_from_edges(src, dst, b), jx.csr_from_edges(src, dst, b)
    else:
        g = generate_dataset(name, scale=a, seed=0).graph
        jg = jx.generate(name, scale=a, seed=0).graph
    for f in (16, 200):
        tp = plan_layout(g, f, backend="torch", fused=fused, measure=False,
                         cache_path=str(tmp_path / "t.json"))
        jp = jx.layout.plan_layout(jg, f, backend="xla", fused=fused,
                                   measure=False,
                                   cache_path=str(tmp_path / "j.json"))
        assert (tp.order, tp.br, tp.bc, tp.bf) == (jp.order, jp.br, jp.bc, jp.bf)
        assert tp.n_blocks == jp.n_blocks
        assert tp.padding_waste == jp.padding_waste
        assert tp.source == jp.source == "cost-model"
        if tp.permutes:
            np.testing.assert_array_equal(tp.perm, jp.perm)


def test_a_skewed_graph_permutes(tmp_path):
    """On the power-law analogs the order rule picks degree or rcm."""
    orders = {plan_layout(generate_dataset(n, scale=s, seed=0).graph, 16,
                          backend="cuda", measure=False,
                          cache_path=str(tmp_path / "c.json")).order
              for n, s in DATASETS[:2]}
    assert orders & {"degree", "rcm"}


def test_fingerprint_keys_by_port_backend_heads_and_attention(jx):
    src, dst = _edges(0, 48, 260)
    g, jg = csr_from_edges(src, dst, 48), jx.csr_from_edges(src, dst, 48)
    keys = {graph_fingerprint(g, 16, be, True) for be in ("cuda", "torch")}
    assert len(keys) == 2
    # the JAX package's keys use its own backend names: never shadowed
    assert keys.isdisjoint({jx.layout.graph_fingerprint(jg, 16, be, True)
                            for be in ("pallas", "xla")})
    # the same backend name hashes the same condition the same way
    assert graph_fingerprint(g, 16, "xla", True) == \
        jx.layout.graph_fingerprint(jg, 16, "xla", True)
    base = graph_fingerprint(g, 16, "cuda", False)
    assert base != graph_fingerprint(g, 16, "cuda", False, attention=True,
                                     n_heads=4)
    assert graph_fingerprint(g, 16, "cuda", False, attention=True, n_heads=4) \
        != graph_fingerprint(g, 16, "cuda", False, attention=True, n_heads=2)
    assert base != graph_fingerprint(g, 32, "cuda", False)


def test_cache_hit_never_remeasures(tmp_path):
    """The ``torch`` backend, timed on the CPU."""
    g = _graph()
    cache = str(tmp_path / "layouts.json")
    first = plan_layout(g, 16, backend="torch", cache_path=cache, device="cpu")
    measured = layout_mod.measure_calls()
    assert first.source == "measured"
    second = plan_layout(g, 16, backend="torch", cache_path=cache, device="cpu")
    assert layout_mod.measure_calls() == measured  # no re-measure
    assert second.source == "cache"
    assert (second.order, second.br, second.bc, second.bf) == \
        (first.order, first.br, first.bc, first.bf)
    third = plan_layout(g, 32, backend="torch", cache_path=cache, device="cpu")
    assert third.source == "measured"
    assert layout_mod.measure_calls() > measured


def test_cost_model_fallback_is_deterministic(tmp_path):
    """``cuda`` on the CPU cannot time its kernels: the cost model, twice
    the same."""
    g = _graph()
    a, b = (plan_layout(g, 16, backend="cuda", device="cpu",
                        cache_path=str(tmp_path / f"{n}.json")) for n in "ab")
    assert a.source == b.source == "cost-model"
    assert (a.order, a.br, a.bc, a.bf) == (b.order, b.br, b.bc, b.bf)


def test_cached_layout_is_lookup_only(tmp_path):
    g = _graph()
    cache = str(tmp_path / "layouts.json")
    assert cached_layout(g, 16, cache_path=cache) is None  # miss: no tuning
    plan_layout(g, 16, backend="torch", cache_path=cache, measure=False)
    calls = layout_mod.measure_calls()
    hit = cached_layout(g, 16, cache_path=cache)
    assert hit is not None and hit.source == "cache"
    assert layout_mod.measure_calls() == calls


def test_cost_model_entry_is_upgraded_once_timing_is_available(tmp_path):
    g = _graph()
    cache = str(tmp_path / "layouts.json")
    modelled = plan_layout(g, 16, backend="torch", cache_path=cache,
                           measure=False)
    assert modelled.source == "cost-model"
    assert plan_layout(g, 16, backend="torch", cache_path=cache,
                       measure=False).source == "cache"
    upgraded = plan_layout(g, 16, backend="torch", cache_path=cache,
                           device="cpu")
    assert upgraded.source == "measured"
    assert plan_layout(g, 16, backend="torch", cache_path=cache,
                       device="cpu").source == "cache"


def test_cuda_grid_has_one_bc_per_br():
    g = generate_dataset("corafull", scale=0.01, seed=0).graph
    grid = _candidate_grid(g, 40, None, True, "cuda")
    assert sorted(br for br, _, _ in grid) == sorted({br for br, _ in TILE_CANDIDATES})
    assert all(bf == 0 for _, _, bf in grid)
    for br, bc, _ in grid:
        stored = {c: bsr_block_count(g, br, c) * br * c
                  for b, c in TILE_CANDIDATES if b == br}
        assert stored[bc] == min(stored.values())
    # the block backends keep every tile (and bf where the lane matters)
    assert len(_candidate_grid(g, 200, None, True, "torch")) == 2 * len(TILE_CANDIDATES)


@pytest.mark.parametrize("br", BUILT_BR)
def test_nonzero_columns_do_not_depend_on_bc(br):
    """The fact the ``cuda`` grid's collapse rests on: every ``bc`` of one
    ``br`` gives the same column stream, tensor for tensor."""
    g = generate_dataset("stargraph", scale=0.02, seed=0).graph.sym_normalized()
    built = []
    for bc in (8, 16, 32, 64, 128):
        bsr = csr_to_bsr(g, br=br, bc=bc)
        built.append(nonzero_columns(
            torch.from_numpy(bsr.block_rows), torch.from_numpy(bsr.block_cols),
            torch.from_numpy(bsr.blocks), bsr.padded_rows))
    for other in built[1:]:
        for name in ("items", "splits", "x_rows", "values"):
            torch.testing.assert_close(getattr(other, name),
                                       getattr(built[0], name), rtol=0, atol=0)
        assert (other.n_block_rows, other.n_slots) == \
            (built[0].n_block_rows, built[0].n_slots)


@pytest.mark.parametrize("br", BUILT_BR)
def test_cuda_cost_score_is_the_column_stream(br):
    g = generate_dataset("nell", scale=0.004, seed=0).graph.sym_normalized()
    bsr = csr_to_bsr(g, br=br, bc=32)
    nzc = nonzero_columns(
        torch.from_numpy(bsr.block_rows), torch.from_numpy(bsr.block_cols),
        torch.from_numpy(bsr.blocks), bsr.padded_rows)
    n_cols, n_items = column_stream(g, br)
    assert n_cols == nzc.x_rows.shape[0]
    assert n_items == nzc.items.shape[0]
    f = 24
    score, = _model_scores(g, f, [(br, 32, 0)], "cuda")
    assert score == n_cols * 2.0 * br * f + layout_mod.ITEM_OVERHEAD * n_items


@pytest.mark.parametrize("engine", ["cuda", "torch"])
@pytest.mark.parametrize("arch", ["GCN", "GAT"])
def test_lower_auto_trains_like_jax(jx, monkeypatch, tmp_path, engine, arch):
    """``compile(layout="auto")`` on the port against the JAX package's on
    ``xla``, from the same weights: the same node order (both choose it by
    block count), losses within 1e-4 over 5 epochs; the second lowering
    hits the cache."""
    monkeypatch.setenv("MORPHLING_LAYOUT_CACHE", str(tmp_path / "layouts.json"))
    ds = generate_dataset("nell", scale=0.004, seed=0)
    jds = jx.generate("nell", scale=0.004, seed=0)
    dims = [ds.features.shape[1], 16, ds.n_classes]
    heads = dict(gat_heads=2) if arch == "GAT" else {}
    jprog = (jx.Program.load(jds, arch=arch, **heads)
             .initialize_layers(dims, seed=0)
             .set_optimizer("adam", 0.01, 0.9, 0.999)
             .compile(engine="xla", layout="auto"))
    gnn = (GNNProgram.load(ds, arch=arch, **heads).initialize_layers(dims, seed=0)
           .set_optimizer("adam", 0.01, 0.9, 0.999))
    weights = jx.jax.tree_util.tree_map(np.asarray, jprog.params)
    prog = gnn.compile(engine=engine, device="cpu", layout="auto",
                       params=weights)
    lp, jlp = prog.plan.layout, jprog.plan.layout
    assert lp.order == jlp.order != "none"
    assert lp.source == ("measured" if engine == "torch" else "cost-model")
    np.testing.assert_array_equal(lp.perm, jlp.perm)
    jl = [jprog.train_epoch()["loss"] for _ in range(5)]
    tl = [prog.train_epoch()["loss"] for _ in range(5)]
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    again = gnn.compile(engine=engine, device="cpu", layout="auto",
                        params=weights)
    assert again.plan.layout.source == "cache"


def test_lower_auto_conflicts_with_an_explicit_tile(tmp_path, monkeypatch):
    monkeypatch.setenv("MORPHLING_LAYOUT_CACHE", str(tmp_path / "layouts.json"))
    g = _graph()
    x = np.random.default_rng(0).standard_normal((48, 8)).astype(np.float32)
    cfg = GNNConfig(kind="GCN", layer_dims=[8, 12, 4])
    with pytest.raises(ValueError, match="conflict"):
        lower(cfg, g, x, layout="auto", br=8, device="cpu")
    plan = lower(cfg, g, x, layout="auto", device="cpu")
    assert plan.layout.source == "cost-model"  # cuda on the CPU


def test_calibrate_gamma_in_range():
    gamma = calibrate_gamma(n=128, f=128, h=16, engine="cuda", device="cpu")
    assert 1e-4 <= gamma <= 1.0
    m = measure_gamma(n=64, f=96, h=8, sparsity=0.9, engine="torch",
                      device="cpu")
    assert (m.n, m.f, m.h) == (64, 96, 8) and m.t_dense > 0 and m.t_sparse > 0
    x = np.zeros((40, 50), np.float32)
    x[::3, ::7] = 1.0
    given = measure_gamma(h=4, x=x, device="cpu")
    assert (given.n, given.f, given.nnz) == (40, 50, int(np.count_nonzero(x)))
    assert given.gamma == float(np.clip(given.eta_sparse / given.eta_dense,
                                        1e-4, 1.0))


@pytest.mark.parametrize("gamma", [0.05, 0.2, 0.6])
def test_decisions_and_predicted_speedup_match_jax(jx, gamma):
    for s in (0.5, 0.8, 0.9, 0.95, 0.99):
        t = decide_execution_path_from_stats(s, 19793, 8710, 32, gamma=gamma)
        j = jx.sparsity.decide_execution_path_from_stats(s, 19793, 8710, 32,
                                                         gamma=gamma)
        assert t.mode == j.mode and t.threshold == j.threshold
        assert t.predicted_speedup == j.predicted_speedup


@pytest.mark.cuda
def test_cuda_autotuner_times_the_kernels(tmp_path):
    """On the card: ``cuda`` times its two candidates (one a block
    height), the winner is one of them, and a second plan is a cache hit
    that measures nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = generate_dataset("ogbn-arxiv", scale=0.02, seed=0).graph
    cache = str(tmp_path / "layouts.json")
    plan = plan_layout(g, 64, backend="cuda", cache_path=cache, device="cuda")
    calls = layout_mod.measure_calls()
    assert plan.source == "measured" and calls >= 2
    assert (plan.br, plan.bc, 0) in _candidate_grid(
        g if plan.reordered_graph is None else plan.reordered_graph, 64,
        None, True, "cuda")
    again = plan_layout(g, 64, backend="cuda", cache_path=cache, device="cuda")
    assert again.source == "cache" and layout_mod.measure_calls() == calls
    gamma = calibrate_gamma(engine="cuda", device="cuda")
    assert 1e-4 <= gamma <= 1.0
