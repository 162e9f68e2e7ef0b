"""Port parity, the full-batch training slice as a whole (paper Listing 1):
``repro_torch``'s ``lower`` makes the JAX package's plans; one training
step's loss and gradients agree with the JAX package's Pallas path
(interpret mode) from the same weights; a 10-epoch trace of a
quickstart-shaped program tracks the JAX package's ``xla`` trace; the
runtime's arguments, ``layout="auto"`` and ``validate="full"`` are
taken.

The port runs its default ``cuda`` backend on ``device="cpu"``, where each
kernel wrapper takes its plain version. Tolerances: plans exactly; loss
and gradients 1e-4 (the JAX suite's fused-epilogue tolerance, float32 sums
in different orders); the 10-epoch trace 1e-3 relative (differences of
1e-7 compound through ten Adam steps)."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.dsl import GNNProgram  # noqa: E402
from repro_torch.core.lowering import lower, lower_sampled  # noqa: E402
from repro_torch.graph.csr import csr_from_edges  # noqa: E402
from repro_torch.graph.datasets import generate_dataset  # noqa: E402
from repro_torch.kernels.bsr_spmm import (  # noqa: E402
    bsr_spmm,
    bsr_spmm_fused_epilogue,
    bsr_spmm_masked,
)
from repro_torch.kernels.fused_adam import fused_adam  # noqa: E402
from repro_torch.models.gnn import (  # noqa: E402
    GNNConfig,
    GNNModel,
    init_params,
    params_from_jax,
)
from repro_torch.training.optimizer import adam, tree_leaves  # noqa: E402
from repro_torch.training.trainer import (  # noqa: E402
    FullBatchTrainer,
    MiniBatchTrainer,
    value_and_grad,
)

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
NAMES = {"pallas": "cuda", "xla": "torch", "gather": "gather"}
ARCHS = [("GCN", "gcn"), ("SAGE", "mean"), ("GIN", "sum")]
KERNELS = (bsr_spmm_fused_epilogue, bsr_spmm_masked, bsr_spmm, fused_adam)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side, imported in a fixture so the card-marked
    test collects where JAX is absent."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core.dsl import GNNProgram as JaxProgram
    from repro.core.lowering import lower as jax_lower
    from repro.graph.csr import csr_from_edges as jax_csr_from_edges
    from repro.graph.datasets import generate_dataset as jax_generate
    from repro.models.gnn import GNNConfig as JaxConfig
    from repro.models.gnn import GNNModel as JaxModel

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, Program=JaxProgram, lower=jax_lower,
        csr_from_edges=jax_csr_from_edges, generate=jax_generate,
        Config=JaxConfig, Model=JaxModel)


def _mapped(describe: str) -> str:
    for jax_name, port_name in NAMES.items():
        describe = describe.replace(jax_name, port_name)
    return describe


def _inputs(regime, n=64, f=48, seed=0):
    """A 64-node graph with self loops; features 95% zeros (Alg 1 binds the
    sparse layer-0 path) or dense; labels and a train mask."""
    r = np.random.default_rng(seed)
    src = np.concatenate([r.integers(0, n, 4 * n), np.arange(n)])
    dst = np.concatenate([r.integers(0, n, 4 * n), np.arange(n)])
    x = r.standard_normal((n, f)).astype(np.float32)
    if regime == "sparse":
        x[r.random((n, f)) < 0.95] = 0.0
    labels = r.integers(0, 5, n).astype(np.int32)
    mask = r.random(n) < 0.7
    return src, dst, x, labels, mask


@pytest.mark.parametrize("kind,agg", ARCHS)
@pytest.mark.parametrize("regime", ["sparse", "dense"])
@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_plan_matches_jax(jx, kind, agg, regime, engine):
    src, dst, x, _, _ = _inputs(regime)
    dims = [x.shape[1], 16, 5]
    jp = jx.lower(jx.Config(kind=kind, layer_dims=dims, aggregation=agg),
                  jx.csr_from_edges(src, dst, 64), x, engine=engine,
                  interpret=True)
    tp = lower(GNNConfig(kind=kind, layer_dims=dims, aggregation=agg),
               csr_from_edges(src, dst, 64), x, engine=NAMES[engine],
               device="cpu")
    assert tp.describe() == _mapped(jp.describe())
    assert tp.feature_sparsity == jp.feature_sparsity
    for t, j in zip(tp.layers, jp.layers):
        assert t.decision.__dict__ == {k: getattr(j.decision, k)
                                       for k in t.decision.__dict__}
        assert t.epilogue.__dict__ == j.epilogue.__dict__
        assert (t.feature_path, t.primitive, t.agg_primitive) == (
            j.feature_path, _mapped(j.primitive), _mapped(j.agg_primitive))
    assert tp.layers[0].feature_path == ("sparse" if regime == "sparse" else "dense")
    assert (tp.layout.br, tp.layout.bc, tp.layout.n_blocks) == (
        jp.layout.br, jp.layout.bc, jp.layout.n_blocks)


@pytest.mark.parametrize("kw", [dict(layout="degree"), dict(layout="rcm"),
                                dict(fuse_epilogue=False), dict(use_fused=False),
                                dict(br=16, bc=32)])
def test_plan_options_match_jax(jx, kw):
    src, dst, x, _, _ = _inputs("sparse")
    dims = [x.shape[1], 16, 5]
    jp = jx.lower(jx.Config(kind="GIN", layer_dims=dims), jx.csr_from_edges(
        src, dst, 64), x, engine="pallas", interpret=True, **kw)
    tp = lower(GNNConfig(kind="GIN", layer_dims=dims), csr_from_edges(
        src, dst, 64), x, engine="cuda", device="cpu", **kw)
    assert tp.describe() == _mapped(jp.describe())
    if "layout" in kw:
        np.testing.assert_array_equal(tp.layout.perm, jp.layout.perm)
        np.testing.assert_array_equal(tp.layout.inv_perm, jp.layout.inv_perm)


def _one_step(jx, kind, agg, regime, **kw):
    src, dst, x, labels, mask = _inputs(regime, seed=len(kind))
    dims = [x.shape[1], 16, 5]
    jcfg = jx.Config(kind=kind, layer_dims=dims, aggregation=agg)
    jg = jx.csr_from_edges(src, dst, 64)
    jplan = jx.lower(jcfg, jg, x, engine="pallas", interpret=True, **kw)
    jmodel = jx.Model(jcfg, jg, plan=jplan)
    jparams = jmodel.init(jx.jax.random.PRNGKey(3))
    jnp = jx.jnp
    jloss, jgrads = jx.jax.value_and_grad(jmodel.loss_fn)(
        jparams, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(mask))

    cfg = GNNConfig(kind=kind, layer_dims=dims, aggregation=agg)
    plan = lower(cfg, csr_from_edges(src, dst, 64), x, engine="cuda",
                 device="cpu", **kw)
    model = GNNModel(cfg, None, plan=plan)
    params = params_from_jax(jx.jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    loss, grads = value_and_grad(model.loss_fn, params, torch.from_numpy(x),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(mask))
    assert abs(float(loss) - float(jloss)) < 1e-4
    for a, b in zip(tree_leaves(grads), jx.jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    return plan


@pytest.mark.parametrize("kind,agg", ARCHS)
@pytest.mark.parametrize("regime", ["sparse", "dense"])
def test_one_step_loss_and_grads_match_jax_pallas(jx, kind, agg, regime):
    plan = _one_step(jx, kind, agg, regime)
    assert all(l.agg_primitive == "cuda.spmm_fused_epilogue" for l in plan.layers)


def test_one_step_on_a_reordered_plan_matches_jax(jx):
    """The permutation contract: features in through perm, logits back
    through inv_perm, so loss and gradients are those of the JAX plan."""
    plan = _one_step(jx, "SAGE", "mean", "dense", layout="degree")
    assert plan.layout.permutes


def test_quickstart_trace_matches_jax_xla(jx):
    """Listing 1 as ``examples/quickstart.py`` runs it, at a CPU size: the
    corafull analog (95% zeros: sparse layer 0), GCN [F, 32, 70], Adam
    (0.01, 0.9, 0.999), 10 epochs; the port with its fused Adam."""
    ds = generate_dataset("corafull", scale=0.005, seed=0)
    jds = jx.generate("corafull", scale=0.005, seed=0)
    dims = [ds.features.shape[1], 32, ds.n_classes]
    jprog = (jx.Program.load(jds, arch="GCN").initialize_layers(dims, seed=0)
             .set_optimizer("adam", 0.01, 0.9, 0.999).compile(engine="xla"))
    prog = (GNNProgram.load(ds, arch="GCN").initialize_layers(dims, seed=0)
            .set_optimizer("adam", 0.01, 0.9, 0.999)
            .compile(engine="cuda", device="cpu", fused_optimizer=True,
                     params=jx.jax.tree_util.tree_map(np.asarray, jprog.params)))
    assert prog.plan.layers[0].primitive == "cuda.feature_matmul_sparse"
    jl = [jprog.train_epoch()["loss"] for _ in range(10)]
    tl = [prog.train_epoch()["loss"] for _ in range(10)]
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert np.isfinite(tl).all() and tl[-1] < tl[0]
    assert abs(prog.accuracy() - jprog.accuracy()) < 1e-6


def test_full_batch_trainer_fits_and_matches_the_program():
    ds = generate_dataset("corafull", scale=0.005, seed=1)
    dims = [ds.features.shape[1], 16, ds.n_classes]
    prog = (GNNProgram.load(ds, arch="SAGE", aggregation="mean")
            .initialize_layers(dims, seed=2).compile(device="cpu"))
    params = prog.params
    trainer = FullBatchTrainer(prog.model, adam(0.01, 0.9, 0.999))
    res = trainer.fit(params, ds.features, ds.labels, ds.train_mask, epochs=4)
    losses = [prog.train_epoch()["loss"] for _ in range(4)]
    np.testing.assert_allclose(res.losses, losses, rtol=1e-6)
    assert len(res.epoch_times) == 4 and res.losses[-1] < res.losses[0]


def test_unported_parts_raise_naming_roadmap(tmp_path, monkeypatch):
    """Items 5, 6 and 8 are ported: the trainers take the runtime's
    arguments, and ``lower`` takes ``layout="auto"`` and verifies that
    plan in full mode."""
    from repro_torch.runtime import FaultInjector, FaultSpec, GuardPolicy

    monkeypatch.setenv("MORPHLING_LAYOUT_CACHE", str(tmp_path / "layouts.json"))
    src, dst, x, labels, mask = _inputs("dense")
    g = csr_from_edges(src, dst, 64)
    dims = [x.shape[1], 16, 5]
    model = GNNModel(GNNConfig(kind="GCN", layer_dims=dims), g, device="cpu")
    inj = FaultInjector(seed=0, faults=[FaultSpec(site="grad", steps=(1,))])
    res = FullBatchTrainer(model, adam(), ckpt_dir=str(tmp_path / "full"),
                           ckpt_every=2, guard=GuardPolicy(),
                           injector=inj).fit(
        init_params(model.config, torch.Generator().manual_seed(0), "cpu"),
        x, labels, mask, epochs=2)
    assert res.guard["skipped"] == 1 and res.restored_from is None
    plan = lower(GNNConfig(kind="GCN", layer_dims=dims), g, x, layout="auto",
                 device="cpu", validate="full")
    assert plan.layout.source == "cost-model"  # the kernels need the card
    tr = MiniBatchTrainer(GNNConfig(kind="GCN", layer_dims=dims), g, x,
                          labels, mask, adam(), fanouts=(4, 3), device="cpu",
                          ckpt_dir=str(tmp_path / "mini"), ckpt_every=1,
                          guard=GuardPolicy(), injector=FaultInjector(seed=0))
    assert tr.fit(1).guard["skipped"] == 0 and tr.save() is not None
    # attention and max, once item 11, bind on both paths now
    for cfg, prim in ((GNNConfig(kind="GAT", layer_dims=dims),
                       "cuda.spmm_attention"),
                      (GNNConfig(kind="SAGE", layer_dims=dims,
                                 aggregation="max"), "gather.segment_max")):
        for plan in (lower(cfg, g, x, device="cpu"),
                     lower_sampled(cfg, g, x, fanouts=(4, 3))):
            assert {l.agg_primitive for l in plan.layers} == {prim}


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = generate_dataset("corafull", scale=0.005, seed=0)
    gnn = GNNProgram.load(ds).initialize_layers([32], seed=0)
    cfg = GNNConfig(kind="GCN", layer_dims=[4, 2])
    for call in (gnn.compile, lambda: init_params(cfg, torch.Generator()),
                 lambda: params_from_jax({"layers": [{"b": np.zeros(2)}]})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    prog = gnn.compile(device="cpu")
    assert prog.x.device.type == "cpu"
    before = [k.launches for k in KERNELS]
    prog.train_epoch()
    assert [k.launches for k in KERNELS] == before  # CPU tensors launch nothing


def _program(kind, ds, dims, engine, device, params=None):
    return (GNNProgram.load(ds, arch=kind).initialize_layers(dims, seed=0)
            .set_optimizer("adam", 0.01, 0.9, 0.999)
            .compile(engine=engine, device=device, fused_optimizer=engine == "cuda",
                     params=params))


@pytest.mark.cuda
def test_cuda_training_matches_torch_reference_with_exact_launches():
    """On the card: the arxiv-shaped GCN [F, 64, 64, C] (dense features)
    and the quickstart-shaped GCN [F, 32, C] (sparse layer 0) at small
    scale, 3 epochs of ``cuda`` against ``torch`` from one set of weights:
    losses within 1e-3 relative, and per epoch exactly fused 3 / masked 2 /
    bsr_spmm 1 / Adam 1, and 2 / 1 / 3 / 1 (one Adam launch a step, over
    all of its leaves)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cases = [("ogbn-arxiv", 0.01, [64, 64], (3, 2, 1, 1)),
             ("corafull", 0.05, [32], (2, 1, 3, 1))]
    for name, scale, hidden, want in cases:
        ds = generate_dataset(name, scale=scale, seed=0)
        dims = [ds.features.shape[1], *hidden, ds.n_classes]
        prog = _program("GCN", ds, dims, "cuda", "cuda")
        ref = _program("GCN", ds, dims, "torch", "cuda", params={"layers": [
            {k: v.cpu().numpy() for k, v in layer.items()}
            for layer in prog.params["layers"]]})
        for epoch in range(3):
            for k in KERNELS:
                k.launches = 0
            loss = prog.train_epoch()["loss"]
            assert tuple(k.launches for k in KERNELS) == want, name
            ref_loss = ref.train_epoch()["loss"]
            assert np.isfinite(loss) and abs(loss - ref_loss) <= 1e-3 * abs(ref_loss)
