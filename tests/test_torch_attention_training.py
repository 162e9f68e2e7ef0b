"""Port parity, attention and ``max`` on the full-batch training path: the
port's ``lower`` makes the JAX package's plans for GAT, GT and SAGE-max on
every backend, with the fused attention and without; one training step's
loss and gradients agree with the JAX package's Pallas path (interpret
mode) from the same weights; a 5-epoch GAT trace of the fused program
tracks the segment program; GT's residual leaf gets its gradient.

The port runs its default ``cuda`` backend on ``device="cpu"``, where each
kernel wrapper takes its plain version. Tolerances: plans exactly; loss
and gradients 1e-4 (the JAX suite's attention tolerance); fused against
segment 2e-4 relative over 5 epochs (the JAX suite's own for the same
check: two softmax formulations, differences compounded by Adam)."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.dsl import GNNProgram  # noqa: E402
from repro_torch.core.lowering import lower  # noqa: E402
from repro_torch.graph.csr import csr_from_edges  # noqa: E402
from repro_torch.graph.datasets import generate_dataset  # noqa: E402
from repro_torch.kernels.bsr_attention import (  # noqa: E402
    bsr_attention_bwd_col,
    bsr_attention_bwd_row,
    bsr_attention_fwd,
)
from repro_torch.kernels.bsr_spmm import bsr_spmm  # noqa: E402
from repro_torch.kernels.fused_adam import fused_adam  # noqa: E402
from repro_torch.models.gnn import (  # noqa: E402
    GNNConfig,
    GNNModel,
    init_params,
    params_from_jax,
)
from repro_torch.training.optimizer import tree_leaves  # noqa: E402
from repro_torch.training.trainer import value_and_grad  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
NAMES = {"pallas": "cuda", "xla": "torch", "gather": "gather"}
#: (kind, aggregation): the attention archs and SAGE with max
SPECS = [("GAT", "gcn"), ("GT", "gcn"), ("SAGE", "max")]
KERNELS = (bsr_attention_fwd, bsr_attention_bwd_row, bsr_attention_bwd_col,
           bsr_spmm, fused_adam)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side, imported in a fixture so the card-marked
    test collects where JAX is absent."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core.lowering import lower as jax_lower
    from repro.graph.csr import csr_from_edges as jax_csr_from_edges
    from repro.models.gnn import GNNConfig as JaxConfig
    from repro.models.gnn import GNNModel as JaxModel

    return types.SimpleNamespace(jax=jax, jnp=jnp, lower=jax_lower,
                                 csr_from_edges=jax_csr_from_edges,
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


@pytest.mark.parametrize("kind,agg", SPECS)
@pytest.mark.parametrize("engine", ["pallas", "xla", "gather"])
@pytest.mark.parametrize("fuse_attention", [True, False])
def test_plan_matches_jax(jx, kind, agg, engine, fuse_attention):
    src, dst, x, _, _ = _inputs("sparse")
    dims = [x.shape[1], 16, 5]
    jp = jx.lower(jx.Config(kind=kind, layer_dims=dims, aggregation=agg,
                            gat_heads=4),
                  jx.csr_from_edges(src, dst, 64), x, engine=engine,
                  interpret=True, fuse_attention=fuse_attention)
    tp = lower(GNNConfig(kind=kind, layer_dims=dims, aggregation=agg,
                         gat_heads=4),
               csr_from_edges(src, dst, 64), x, engine=NAMES[engine],
               fuse_attention=fuse_attention, device="cpu")
    assert tp.describe() == _mapped(jp.describe())
    for t, j in zip(tp.layers, jp.layers):
        assert (t.feature_path, t.primitive, t.agg_primitive) == (
            j.feature_path, _mapped(j.primitive), _mapped(j.agg_primitive))
        assert (t.attention is None) == (j.attention is None)
        if t.attention is not None:
            assert t.attention.__dict__ == j.attention.__dict__
        assert t.epilogue is None and j.epilogue is None
    fused = fuse_attention and engine != "gather" and kind != "SAGE"
    assert (tp.graph_op.aggregate_attention is not None) == fused


def _one_step(jx, kind, agg, regime, heads=4):
    src, dst, x, labels, mask = _inputs(regime, seed=len(kind))
    dims = [x.shape[1], 16, 5]
    jcfg = jx.Config(kind=kind, layer_dims=dims, aggregation=agg,
                     gat_heads=heads)
    jg = jx.csr_from_edges(src, dst, 64)
    jmodel = jx.Model(jcfg, jg, plan=jx.lower(jcfg, jg, x, engine="pallas",
                                              interpret=True))
    jparams = jmodel.init(jx.jax.random.PRNGKey(3))
    jnp = jx.jnp
    jloss, jgrads = jx.jax.value_and_grad(jmodel.loss_fn)(
        jparams, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(mask))

    cfg = GNNConfig(kind=kind, layer_dims=dims, aggregation=agg,
                    gat_heads=heads)
    plan = lower(cfg, csr_from_edges(src, dst, 64), x, engine="cuda",
                 device="cpu")
    model = GNNModel(cfg, None, plan=plan)
    params = params_from_jax(jx.jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    loss, grads = value_and_grad(model.loss_fn, params, torch.from_numpy(x),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(mask))
    assert abs(float(loss) - float(jloss)) < 1e-4
    jleaves = jx.jax.tree_util.tree_leaves(jgrads)
    assert len(tree_leaves(grads)) == len(jleaves)
    for a, b in zip(tree_leaves(grads), jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    return plan, grads


@pytest.mark.parametrize("kind,agg,regime", [
    ("GAT", "gcn", "dense"), ("GT", "gcn", "sparse"), ("SAGE", "max", "dense")])
def test_one_step_loss_and_grads_match_jax_pallas(jx, kind, agg, regime):
    """GT on the sparse regime: its layer 0 runs the Alg-1 sparse X·W
    feeding attention; SAGE-max aggregates on the segment path."""
    plan, grads = _one_step(jx, kind, agg, regime)
    want = "gather.segment_max" if agg == "max" else "cuda.spmm_attention"
    assert all(l.agg_primitive == want for l in plan.layers)
    assert plan.layers[0].feature_path == ("sparse" if regime == "sparse"
                                           else "dense")
    if kind == "GT":
        # the residual branch is trained: every layer's w_res gets gradient
        for layer in grads["layers"]:
            assert float(layer["w_res"].abs().sum()) > 0.0


def test_gt_leaves_match_jax_names_and_shapes(jx):
    """GAT / GT parameters: the JAX package's leaf names and shapes, so
    ``params_from_jax`` carries weights across; heads divide d_out."""
    dims = [12, 30, 7]
    for kind in ("GAT", "GT"):
        jp = jx.Model(jx.Config(kind=kind, layer_dims=dims, gat_heads=4),
                      jx.csr_from_edges(np.arange(4), np.arange(4), 4)).init(
            jx.jax.random.PRNGKey(0))
        tp = init_params(GNNConfig(kind=kind, layer_dims=dims, gat_heads=4),
                         torch.Generator().manual_seed(0), device="cpu")
        for j, t in zip(jp["layers"], tp["layers"]):
            assert {k: tuple(v.shape) for k, v in t.items()} == \
                {k: tuple(np.shape(v)) for k, v in j.items()}


def _gat_program(ds, dims, **kw):
    return (GNNProgram.load(ds, arch="GAT", gat_heads=3)
            .initialize_layers(dims, seed=0)
            .set_optimizer("adam", 0.01, 0.9, 0.999)
            .compile(engine="cuda", device="cpu", fused_optimizer=True, **kw))


def test_fused_gat_trace_tracks_the_segment_path():
    """Listing 1 with GAT at a CPU size: 5 epochs of the fused program
    against ``fuse_attention=False`` (the segment path) from the same
    seed: losses within 2e-4 relative, falling."""
    ds = generate_dataset("corafull", scale=0.005, seed=0)
    dims = [ds.features.shape[1], 24, ds.n_classes]
    fused, seg = _gat_program(ds, dims), _gat_program(ds, dims,
                                                      fuse_attention=False)
    assert all(l.agg_primitive == "cuda.spmm_attention"
               for l in fused.plan.layers)
    assert all(l.agg_primitive == "cuda.segment_softmax_aggregate"
               for l in seg.plan.layers)
    fl = [fused.train_epoch()["loss"] for _ in range(5)]
    sl = [seg.train_epoch()["loss"] for _ in range(5)]
    np.testing.assert_allclose(fl, sl, rtol=2e-4)
    assert np.isfinite(fl).all() and fl[-1] < fl[0]


@pytest.mark.cuda
def test_cuda_attention_training_matches_torch_with_exact_launches():
    """On the card: GAT [F, 48, 48, C] with 3 heads on the arxiv analog
    and GT [F, 32, C] with 4 heads on the quickstart (sparse layer 0) at
    small scale, 3 epochs of ``cuda`` against ``torch`` from one set of
    weights: losses within 1e-3 relative, and per epoch exactly the
    attention kernels once per layer each, ``bsr_spmm`` 0 and 2, Adam 1
    (one launch a step over its 15 and 12 leaves)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cases = [("GAT", "ogbn-arxiv", 0.01, [48, 48], 3, (3, 3, 3, 0, 1)),
             ("GT", "corafull", 0.05, [32], 4, (2, 2, 2, 2, 1))]
    for kind, name, scale, hidden, heads, want in cases:
        ds = generate_dataset(name, scale=scale, seed=0)
        dims = [ds.features.shape[1], *hidden, ds.n_classes]
        gnn = (GNNProgram.load(ds, arch=kind, gat_heads=heads)
               .initialize_layers(dims, seed=0)
               .set_optimizer("adam", 0.01, 0.9, 0.999))
        prog = gnn.compile(engine="cuda", device="cuda", fused_optimizer=True)
        ref = gnn.compile(engine="torch", device="cuda", params={"layers": [
            {k: v.cpu().numpy() for k, v in layer.items()}
            for layer in prog.params["layers"]]})
        for _ in range(3):
            for k in KERNELS:
                k.launches = 0
            loss = prog.train_epoch()["loss"]
            assert tuple(k.launches for k in KERNELS) == want, kind
            ref_loss = ref.train_epoch()["loss"]
            assert np.isfinite(loss) and abs(loss - ref_loss) <= 1e-3 * abs(ref_loss)
