"""Port parity, sampled training: ``repro_torch``'s ``lower_sampled`` and
``MiniBatchTrainer`` against the JAX package's, for GCN, SAGE-mean, GIN,
GAT, GT and SAGE-max, with the sparse and the dense layer-0 regime.

The JAX trainer runs ``engine="pallas"`` (interpret mode) where one step
is compared and ``engine="xla"`` over whole epochs, as the JAX suite runs
it; the port runs its ``cuda`` backend on ``device="cpu"``, where each
kernel wrapper takes its plain version. Both get the same graph, features
and weights (``params_from_jax``); their samplers are byte-identical and
draw in the same order, so they see the same batches. Tolerances: one
step's loss and gradients 1e-4 (the JAX suite's), a 3-epoch Adam loss
trace 1e-3 relative, plans exactly.

The JAX trainer's SAGE-max gradient of ``w_neigh`` is NaN: a padded row
that no edge reaches holds ``segment_max``'s -inf, and its zero cotangent
times -inf is NaN in dW. The port zeroes those rows inside the
aggregation (``trainer.py:_make_agg``), so its reference there is the JAX
trainer with the same rows zeroed.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.lowering import lower, lower_sampled  # noqa: E402
from repro_torch.graph.csr import csr_from_edges  # noqa: E402
from repro_torch.graph.datasets import generate_dataset  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.bsr_attention import (  # noqa: E402
    bsr_attention_bwd_col,
    bsr_attention_bwd_row,
    bsr_attention_fwd,
)
from repro_torch.kernels.bsr_spmm import bsr_spmm  # noqa: E402
from repro_torch.kernels.fused_adam import fused_adam  # noqa: E402
from repro_torch.models.gnn import GNNConfig, GNNModel, params_from_jax  # noqa: E402
from repro_torch.training.optimizer import adam, tree_leaves  # noqa: E402
from repro_torch.training.trainer import MiniBatchTrainer, value_and_grad  # noqa: E402

pytestmark = pytest.mark.sampling
torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
N, F, H, C = 48, 32, 12, 5
#: (kind, aggregation): every arch, and SAGE with max
CASES = [("GCN", "gcn"), ("SAGE", "mean"), ("GIN", "sum"), ("GAT", "sum"),
         ("GT", "sum"), ("SAGE", "max")]
KERNELS = (bsr_spmm, bsr_attention_fwd, bsr_attention_bwd_row,
           bsr_attention_bwd_col, fused_adam)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side, imported in a fixture so the card-marked
    test collects where JAX is absent."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.graph.csr import csr_from_edges as jax_csr_from_edges
    from repro.models.gnn import GNNConfig as JaxConfig
    from repro.models.gnn import GNNModel as JaxModel
    from repro.models.gnn import init_params as jax_init_params
    from repro.training.optimizer import adam as jax_adam
    from repro.training.trainer import MiniBatchTrainer as JaxTrainer

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, csr_from_edges=jax_csr_from_edges, Config=JaxConfig,
        Model=JaxModel, init_params=jax_init_params, adam=jax_adam,
        Trainer=JaxTrainer)


def _inputs(regime, seed=0):
    """The 48-node fixture of ``tests/test_minibatch_parity.py``: random
    edges plus self loops, features 95% zeros (Alg 1 binds the sparse
    layer-0 path) or dense, labels and a train mask."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, N, 220), np.arange(N)])
    dst = np.concatenate([rng.integers(0, N, 220), np.arange(N)])
    x = rng.standard_normal((N, F)).astype(np.float32)
    if regime == "sparse":
        x[rng.random((N, F)) < 0.95] = 0.0
    labels = rng.integers(0, C, N).astype(np.int32)
    mask = rng.random(N) < 0.6
    return src, dst, x, labels, mask


def _configs(jx, kind, agg):
    kw = dict(kind=kind, layer_dims=[F, H, C], aggregation=agg, gat_heads=2)
    return jx.Config(**kw), GNNConfig(**kw)


def _port_params(jx, jtr):
    return params_from_jax(jx.jax.tree_util.tree_map(np.asarray, jtr.params),
                           device="cpu")


def _pair(jx, kind, agg, regime, engine="pallas", **kw):
    """(JAX trainer, port trainer) on one graph, with the JAX trainer's
    weights in both and Adam(0.01) in both."""
    src, dst, x, labels, mask = _inputs(regime)
    jcfg, tcfg = _configs(jx, kind, agg)
    kw = dict(dict(fanouts=(3, 4), batch_size=8, n_buckets=2, seed=0), **kw)
    jtr = jx.Trainer(jcfg, jx.csr_from_edges(src, dst, N), x, labels, mask,
                     jx.adam(0.01), engine=engine, interpret=True, **kw)
    jtr.params = jx.init_params(jcfg, jx.jax.random.PRNGKey(1))
    ttr = MiniBatchTrainer(tcfg, csr_from_edges(src, dst, N), x, labels, mask,
                           adam(0.01), engine={"pallas": "cuda",
                                               "xla": "torch"}[engine],
                           device="cpu", **kw)
    ttr.params = _port_params(jx, jtr)
    return jtr, ttr, mask


def _zero_empty_max_rows(jx, jtr):
    """Zero the JAX trainer's max-aggregation rows that no edge reaches
    (-inf), as the port does, so its ``w_neigh`` gradient is finite."""
    make_agg = jtr._make_agg

    def patched(blk, n_out):
        agg = make_agg(blk, n_out)
        return lambda u: (lambda y: jx.jnp.where(jx.jnp.isfinite(y), y, 0.0))(agg(u))

    jtr._make_agg = patched


def _assert_trees_close(got, want):
    got, want = tree_leaves(got), [np.asarray(w) for w in want]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.detach().numpy(), b, **TOL)


@pytest.mark.parametrize("kind,agg", CASES)
@pytest.mark.parametrize("regime", ["sparse", "dense"])
def test_loss_and_grads_match_jax(jx, kind, agg, regime):
    jtr, ttr, mask = _pair(jx, kind, agg, regime)
    assert ttr.plan.describe() == jtr.plan.describe().replace("pallas", "cuda")
    assert ttr.plan.layers[0].feature_path == regime
    seeds = np.flatnonzero(mask)[:8]
    if agg == "max":
        # the JAX trainer's own gradient is NaN in w_neigh (module docstring)
        _, raw = jtr.loss_and_grads(seeds)
        finite = {k: bool(np.isfinite(np.asarray(v)).all())
                  for layer in raw["layers"] for k, v in layer.items()}
        assert not finite["w_neigh"] and finite["w_self"] and finite["b"]
        jtr, ttr, _ = _pair(jx, kind, agg, regime)
        _zero_empty_max_rows(jx, jtr)
    jl, jg = jtr.loss_and_grads(seeds)
    tl, tg = ttr.loss_and_grads(seeds)
    assert abs(float(tl) - float(jl)) < 1e-4
    _assert_trees_close(tg, jx.jax.tree_util.tree_leaves(jg))


@pytest.mark.parametrize("kind,agg", [("GCN", "gcn"), ("GAT", "sum"), ("SAGE", "max")])
@pytest.mark.parametrize("layout", ["degree", "rcm"])
@pytest.mark.parametrize("regime", ["sparse", "dense"])
def test_reordered_layout_matches_jax(jx, kind, agg, layout, regime):
    """Sampled training on a reordered graph (``layout=``: the plan's
    permutation between user ids and execution order): the plans equal,
    one step's loss and gradients and the inference logits of unsorted,
    repeated user ids within 1e-4 of the JAX trainer's."""
    jtr, ttr, mask = _pair(jx, kind, agg, regime, layout=layout)
    assert ttr.plan.describe() == jtr.plan.describe().replace("pallas", "cuda")
    assert ttr.plan.layout.order == jtr.plan.layout.order == layout
    if agg == "max":
        _zero_empty_max_rows(jx, jtr)
    seeds = np.flatnonzero(mask)[:8]
    jl, jg = jtr.loss_and_grads(seeds)
    tl, tg = ttr.loss_and_grads(seeds)
    assert abs(float(tl) - float(jl)) < 1e-4
    _assert_trees_close(tg, jx.jax.tree_util.tree_leaves(jg))
    ids = np.array([40, 3, 17, 3, 0, 29])
    np.testing.assert_allclose(ttr.infer_logits(ids), np.asarray(jtr.infer_logits(ids)),
                               **TOL)


@pytest.mark.parametrize("kind,agg", CASES)
@pytest.mark.parametrize("regime", ["sparse", "dense"])
def test_full_fanout_matches_full_batch(jx, kind, agg, regime):
    """Fanout >= the largest in-degree and one batch of every train seed:
    the sampled program equals the port's own full-batch program and the
    JAX package's full-batch gradient, at 1e-4."""
    src, dst, x, labels, mask = _inputs(regime)
    jcfg, tcfg = _configs(jx, kind, agg)
    g = csr_from_edges(src, dst, N)
    max_indeg = int(np.diff(g.indptr).max())
    n_train = int(mask.sum())
    plan = lower_sampled(tcfg, g, x, fanouts=(max_indeg, max_indeg),
                         batch_size=n_train, n_buckets=1)
    tr = MiniBatchTrainer(tcfg, None, x, labels, mask, adam(0.01), plan=plan,
                          device="cpu")
    params = tr.params
    loss_mb, grads_mb = tr.loss_and_grads()
    model = GNNModel(tcfg, g, plan=lower(tcfg, g, x, device="cpu"))
    loss_fb, grads_fb = value_and_grad(
        model.loss_fn, params, torch.from_numpy(x), torch.from_numpy(labels),
        torch.from_numpy(mask))
    assert abs(float(loss_mb) - float(loss_fb)) < 1e-4
    _assert_trees_close(grads_mb, [g.numpy() for g in tree_leaves(grads_fb)])
    jg = jx.jax.grad(jx.Model(jcfg, jx.csr_from_edges(src, dst, N)).loss_fn)(
        jx.jax.tree_util.tree_map(lambda t: jx.jnp.asarray(t.numpy()), params),
        jx.jnp.asarray(x), jx.jnp.asarray(labels), jx.jnp.asarray(mask))
    _assert_trees_close(grads_mb, jx.jax.tree_util.tree_leaves(jg))


@pytest.mark.parametrize("kind", ["GAT", "GT"])
@pytest.mark.parametrize("fanouts", [(3, 4), (N, N)], ids=["sampled", "full"])
def test_fused_attention_matches_segment_path(kind, fanouts):
    """The fused attention over each batch's BSR pair against the segment
    path over its edge lists: the same batches (BSR emission draws no
    random numbers), loss and gradients within 1e-4."""
    src, dst, x, labels, mask = _inputs("dense")
    g = csr_from_edges(src, dst, N)
    cfg = GNNConfig(kind=kind, layer_dims=[F, H, C], aggregation="gcn",
                    gat_heads=2)
    results = {}
    for fused in (True, False):
        plan = lower_sampled(cfg, g, x, fanouts=fanouts, batch_size=24,
                             n_buckets=1, seed=0, fuse_attention=fused)
        assert plan.sampler.emit_bsr is fused
        want = "cuda.spmm_attention" if fused else "cuda.segment_softmax_aggregate"
        assert {l.agg_primitive for l in plan.layers} == {want}
        assert all(l.attention.fused is fused for l in plan.layers)
        tr = MiniBatchTrainer(cfg, None, x, labels, mask, adam(0.01),
                              plan=plan, device="cpu")
        assert tr._fuse_attention is fused
        results[fused] = tr.loss_and_grads(np.flatnonzero(mask)[:24])
    (lf, gf), (ls, gs) = results[True], results[False]
    assert abs(float(lf) - float(ls)) < 1e-4
    _assert_trees_close(gf, [t.numpy() for t in tree_leaves(gs)])


@pytest.mark.parametrize("kind,agg", [("SAGE", "mean"), ("GAT", "sum"),
                                      ("SAGE", "max")])
def test_three_epoch_adam_trace_matches_jax(jx, kind, agg):
    """Three epochs of Adam(0.01) over the same batches from the same
    weights: every epoch's mean loss within 1e-3 relative."""
    jtr, ttr, _ = _pair(jx, kind, agg, "dense", engine="xla")
    if agg == "max":
        _zero_empty_max_rows(jx, jtr)
    jl = [jtr.train_epoch() for _ in range(3)]
    res = ttr.fit(3)
    assert len(res.losses) == 3 and len(res.epoch_times) == 3
    np.testing.assert_allclose(res.losses, jl, rtol=1e-3)
    assert ttr.opt_state.step == int(jtr.opt_state.step) > 3  # several batches an epoch


def test_n_traces_bounded_by_buckets_and_input_paths():
    """The step sees at most one shape signature per bucket and input
    path: dense plans at most ``n_buckets``, sparse plans at most twice
    that (a batch over the COO cap drops ``feat``)."""
    for name, scale, regime in (("ogbn-arxiv", 0.0005, "dense"),
                                ("corafull", 0.008, "sparse")):
        ds = generate_dataset(name, scale=scale, seed=0)
        cfg = GNNConfig(kind="GCN",
                        layer_dims=[ds.features.shape[1], 8, ds.n_classes])
        tr = MiniBatchTrainer(cfg, ds.graph, ds.features, ds.labels,
                              ds.train_mask, adam(0.01), fanouts=(3, 3),
                              batch_size=16, n_buckets=2, device="cpu")
        assert tr.plan.layers[0].feature_path == regime
        assert len(tr.train_ids) > 16 and len(tr.train_ids) % 16 != 0
        for _ in range(3):
            tr.train_epoch()
        variants = 2 if regime == "sparse" else 1
        assert 1 <= tr.n_traces <= tr.plan.n_buckets * variants
        if regime == "dense":
            assert tr.n_feature_overflows == 0
        assert tr.n_infer_traces == 0


def test_fit_loss_falls():
    ds = generate_dataset("corafull", scale=0.008, seed=0)
    cfg = GNNConfig(kind="SAGE",
                    layer_dims=[ds.features.shape[1], 16, ds.n_classes],
                    aggregation="mean")
    tr = MiniBatchTrainer(cfg, ds.graph, ds.features, ds.labels,
                          ds.train_mask, adam(0.01, fused=True),
                          fanouts=(5, 5), batch_size=32, device="cpu")
    res = tr.fit(4)
    assert np.isfinite(res.losses).all() and res.losses[-1] < res.losses[0]
    assert tr.fit(4).losses == []  # ``epochs`` counts every epoch so far
    assert tr.plan.layers[0].primitive == "gather.feature_matmul_sparse"
    assert 0.0 <= tr.evaluate(ds.val_mask) <= 1.0


@pytest.mark.parametrize("kind,agg,builds", [
    ("SAGE", "mean", (2, 4)), ("GAT", "sum", (2, 4)), ("SAGE", "max", (0, 0))])
def test_inference_copies_and_builds_only_the_forward_operand(
        monkeypatch, kind, agg, builds):
    """Inference copies A alone and builds its nonzero columns once per
    layer; a training step copies Aᵀ and the labels too and builds Aᵀ's
    columns in the backward. Without Aᵀ the backward raises. ``max``
    rides the edge lists and builds none."""
    src, dst, x, labels, mask = _inputs("dense")
    cfg = GNNConfig(kind=kind, layer_dims=[F, H, C], aggregation=agg,
                    gat_heads=2)
    tr = MiniBatchTrainer(cfg, csr_from_edges(src, dst, N), x, labels, mask,
                          adam(0.01), fanouts=(3, 4), batch_size=8,
                          device="cpu")
    built = []
    build = kops.nonzero_columns
    monkeypatch.setattr(kops, "nonzero_columns",
                        lambda *a: built.append(a[-1]) or build(*a))
    batch = tr.sampler.sample_batch(np.flatnonzero(mask)[:8], tr.features,
                                    tr.labels_np)
    infer = tr._batch_arrays(batch)
    train = tr._batch_arrays(batch, train=True)
    assert "labels" not in infer and "labels" in train
    if tr._agg_mode == "bsr":
        assert all(set(b) == {"fwd"} for b in infer["blocks"])
        assert all(set(b) == {"fwd", "bwd"} for b in train["blocks"])
    tr._infer(tr.params, infer)
    assert len(built) == builds[0]
    value_and_grad(tr._loss, tr.params, train)
    assert len(built) == builds[0] + builds[1]
    if tr._agg_mode == "bsr":
        with pytest.raises(RuntimeError, match="transposed operand"):
            value_and_grad(tr._loss, tr.params, {**train, "blocks": infer["blocks"]})


def test_runtime_arguments_raise_naming_item_6(tmp_path):
    """Item 6 is ported: ``ckpt_dir``, ``guard`` and ``injector`` are
    taken (an injected inf step is skipped, an epoch checkpointed and
    restored); an infer-only trainer still refuses to train."""
    from repro_torch.runtime import FaultInjector, FaultSpec, GuardPolicy

    src, dst, x, labels, mask = _inputs("dense")
    cfg = GNNConfig(kind="GCN", layer_dims=[F, H, C])
    inj = FaultInjector(seed=0, faults=[FaultSpec(site="grad", steps=(0,),
                                                  mode="inf")])
    tr = MiniBatchTrainer(cfg, csr_from_edges(src, dst, N), x, labels, mask,
                          adam(0.01), fanouts=(3, 4), device="cpu",
                          ckpt_dir=str(tmp_path), ckpt_every=1,
                          guard=GuardPolicy(), injector=inj)
    res = tr.fit(1)
    assert res.guard["skipped"] == 1 and np.isfinite(res.losses).all()
    assert tr.restore() == 1
    tr = MiniBatchTrainer(cfg, csr_from_edges(src, dst, N), x, None, None,
                          None, fanouts=(3, 4), device="cpu")
    for call in (tr.train_epoch, tr.loss_and_grads):
        with pytest.raises(RuntimeError, match="infer-only"):
            call()


@pytest.mark.cuda
def test_cuda_sampled_training_matches_torch_with_exact_launches():
    """On the card: one sampled step of SAGE-mean and of GAT (3 heads) on
    the arxiv analog at small scale, ``cuda`` against ``torch`` from one
    set of weights on the same batch: loss and gradients within 1e-4 a
    leaf's scale, and the launches the operands imply — SpMM once per
    forward and once per backward layer, attention 3 / 3 / 3 — plus each
    call's second pass where its operand splits a row; then one fused Adam
    launch for a step of ``train_epoch``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    ds = generate_dataset("ogbn-arxiv", scale=0.02, seed=0)
    for kind, agg, want in (("SAGE", "mean", (6, 0, 0, 0)),
                            ("GAT", "sum", (0, 3, 3, 3))):
        cfg = GNNConfig(kind=kind, layer_dims=[ds.features.shape[1], 64, 64,
                                               ds.n_classes],
                        aggregation=agg, gat_heads=3)
        trs = {eng: MiniBatchTrainer(cfg, ds.graph, ds.features, ds.labels,
                                     ds.train_mask, adam(0.01, fused=True),
                                     fanouts=(15, 10, 5), batch_size=128,
                                     engine=eng, device="cuda")
               for eng in ("cuda", "torch")}
        trs["torch"].params = {"layers": [{k: v.clone() for k, v in layer.items()}
                                          for layer in trs["cuda"].params["layers"]]}
        seeds = np.flatnonzero(ds.train_mask)[:128]
        for k in KERNELS:
            k.launches = 0
        loss, grads = trs["cuda"].loss_and_grads(seeds)
        assert tuple(k.launches for k in KERNELS[:4]) == want, kind
        ref_loss, ref_grads = trs["torch"].loss_and_grads(seeds)
        assert abs(float(loss) - float(ref_loss)) <= 1e-4
        for a, b in zip(tree_leaves(grads), tree_leaves(ref_grads)):
            assert float((a - b).norm()) <= 1e-4 * max(float(b.norm()), 1e-6)
        fused_adam.launches = 0
        trs["cuda"].train_epoch()
        steps = -(-len(trs["cuda"].train_ids) // 128)
        assert fused_adam.launches == steps
