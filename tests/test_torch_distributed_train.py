"""Port parity, distributed training: the halo exchange over
``torch.distributed`` and ``DistributedGNNTrainer`` on 4 gloo rank
processes on the CPU (``launch/mesh.py:run_ranks``), against the JAX
package's schedules and its single-device model.

One spawn runs every exchange check and every training case (the
cases of ``tests/test_distributed.py:33-86``: GCN, SAGE-mean, GIN and
GAT on the corafull analog, where Alg-1 binds the sparse input path, GCN
on the flickr analog, where it binds the dense one, SAGE-max, the
bulk-synchronous ``overlap=False`` plan, and the guarded step); a second
spawn checks that a failing rank fails the call. The JAX package is
reached only through a fixture, so the card-marked test (the kernels on
one rank's interior and boundary streams) collects where JAX is absent.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.halo import build_distributed_graph  # noqa: E402
from repro_torch.core.lowering import (  # noqa: E402
    effective_aggregation,
    lower_distributed,
)
from repro_torch.core.partitioner import hierarchical_partition  # noqa: E402
from repro_torch.graph.datasets import generate_dataset  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models.gnn import GNNConfig  # noqa: E402

torch.set_num_threads(1)

P = 4
EPOCHS = 3
#: (name, kind, aggregation, dataset, lower_distributed kwargs, guarded)
CASES = [
    ("GCN/corafull", "GCN", "gcn", "corafull", {}, False),
    ("SAGE/corafull", "SAGE", "mean", "corafull", {}, False),
    ("GIN/corafull", "GIN", "sum", "corafull", {}, False),
    ("GAT/corafull", "GAT", "sum", "corafull", {}, False),
    ("GCN/flickr", "GCN", "gcn", "flickr", {}, False),
    ("SAGE-max/corafull", "SAGE", "max", "corafull", {}, False),
    ("GCN/corafull/bulk", "GCN", "gcn", "corafull", {"overlap": False}, False),
    ("GCN/corafull/guarded", "GCN", "gcn", "corafull", {}, True),
]


def _config(kind, agg, f, c):
    return dict(kind=kind, layer_dims=[f, 16, c], aggregation=agg, gat_heads=4)


# ---------------------------------------------------------------------------
# what each rank runs (module-level functions: pickled by import path)
# ---------------------------------------------------------------------------


def _exchange_checks(rank, dist, bad_dist, g_np, x_np):
    from repro_torch.backends.distributed import debug_halo_check
    from repro_torch.core.halo import (
        HaloSchedule,
        halo_exchange,
        halo_exchange_transpose,
    )

    live = HaloSchedule.of(dist, device="cpu")
    full = HaloSchedule.of(dist, device="cpu", shifts=None)
    x = torch.from_numpy(x_np[rank]).requires_grad_(True)
    g = torch.from_numpy(g_np[rank])
    ghost = halo_exchange(x, live)
    (ghost * g).sum().backward()  # the VJP: the reverse exchange of g
    out = {"ghost_live": ghost.detach().numpy(),
           "ghost_full": halo_exchange(x.detach(), full).numpy(),
           "transpose": halo_exchange_transpose(g, live).numpy(),
           "vjp": x.grad.numpy()}
    debug_halo_check(dist, device="cpu")
    debug_halo_check(dist, x_np[rank], device="cpu")
    try:
        debug_halo_check(bad_dist, x_np[rank], device="cpu")
        out["bad_raised"] = ""
    except RuntimeError as e:
        out["bad_raised"] = str(e)
    return out


def _train_case(rank, dist, plan, params_np, cfg_args, guarded):
    from repro_torch.models.gnn import params_from_jax
    from repro_torch.runtime.resilience import GuardPolicy
    from repro_torch.training.optimizer import adam, tree_leaves
    from repro_torch.training.trainer import DistributedGNNTrainer

    tr = DistributedGNNTrainer(
        dist.rank_slice(rank), GNNConfig(**cfg_args), adam(0.01),
        plan=plan.rank_slice(rank), params=params_from_jax(params_np, "cpu"),
        device="cpu", guard=GuardPolicy() if guarded else None)
    loss, grads = tr.loss_and_grads()
    out = {"loss": float(loss),
           "grads": [g.numpy().copy() for g in tree_leaves(grads)],
           "losses": [], "params": []}
    for _ in range(EPOCHS):
        out["losses"].append(tr.train_epoch())
        out["params"].append([p.numpy().copy() for p in tree_leaves(tr.params)])
    return out


def _rank_body(rank, exchange_args, cases):
    return {"exchange": _exchange_checks(rank, *exchange_args),
            "train": {name: _train_case(rank, *args) for name, args in cases}}


def _failing_body(rank):
    if rank == 2:
        raise ValueError("rank two gives up")
    return rank


# ---------------------------------------------------------------------------
# the parent: JAX references, one spawn, the gates
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_ref():
    import jax
    import jax.numpy as jnp

    from repro.core import halo as jhalo
    from repro.core import partitioner as jpart
    from repro.core.lowering import lower as jlower
    from repro.graph import datasets as jds
    from repro.models.gnn import GNNConfig as JConfig
    from repro.models.gnn import GNNModel, init_params
    from repro.training.optimizer import adam
    from repro.training.trainer import FullBatchTrainer

    data = {name: jds.generate_dataset(name, scale=0.004, seed=0)
            for name in ("corafull", "flickr")}
    out = {"cases": {}}
    done = {}
    for name, kind, agg, dsname, _, _ in CASES:
        ds = data[dsname]
        key = (kind, agg, dsname)
        if key not in done:
            cfg = JConfig(**_config(kind, agg, ds.features.shape[1],
                                    ds.n_classes))
            model = GNNModel(cfg, ds.graph, plan=jlower(
                cfg, ds.graph, ds.features, engine="xla"))
            params = init_params(cfg, jax.random.PRNGKey(3))
            loss, grads = jax.jit(jax.value_and_grad(model.loss_fn))(
                params, jnp.asarray(ds.features), jnp.asarray(ds.labels),
                jnp.asarray(ds.train_mask))
            losses = FullBatchTrainer(model, adam(0.01)).fit(
                params, ds.features, ds.labels, ds.train_mask,
                epochs=EPOCHS).losses
            done[key] = {
                "params": jax.tree_util.tree_map(np.asarray, params),
                "loss": float(loss),
                "grads": [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)],
                "losses": [float(v) for v in losses]}
        out["cases"][name] = done[key]
    # the exchange's reference: JAX's own schedule on the flickr analog
    ds = data["flickr"]
    part = jpart.hierarchical_partition(ds.graph, P)
    out["dist"] = jhalo.build_distributed_graph(
        ds.graph, ds.features, ds.labels, ds.train_mask, part, br=8, bc=32,
        aggregation="gcn")
    return out


@pytest.fixture(scope="module")
def run(jax_ref):
    """The port's graphs and plans, built in the parent, then one spawn
    of 4 ranks running every check."""
    data = {name: generate_dataset(name, scale=0.004, seed=0)
            for name in ("corafull", "flickr")}
    parts = {name: hierarchical_partition(ds.graph, P)
             for name, ds in data.items()}
    cases, plans = [], {}
    for name, kind, agg, dsname, kw, guarded in CASES:
        ds = data[dsname]
        cfg_args = _config(kind, agg, ds.features.shape[1], ds.n_classes)
        cfg = GNNConfig(**cfg_args)
        dist = build_distributed_graph(
            ds.graph, ds.features, ds.labels, ds.train_mask, parts[dsname],
            br=8, bc=32, aggregation=effective_aggregation(cfg))
        plan = lower_distributed(cfg, dist, validate="full", **kw)
        plans[name] = plan
        cases.append((name, (dist, plan, jax_ref["cases"][name]["params"],
                             cfg_args, guarded)))
    ds = data["flickr"]
    dist = build_distributed_graph(ds.graph, ds.features, ds.labels,
                                   ds.train_mask, parts["flickr"], br=8,
                                   bc=32, aggregation="gcn")
    bad_recv = dist.recv_slot.copy()
    s = dist.live_shifts[-1]
    p = next(p for p in range(P) if (bad_recv[p, s - 1] >= 0).any())
    bad_recv[p, s - 1, np.flatnonzero(bad_recv[p, s - 1] >= 0)[-1]] = -1
    import dataclasses

    bad = dataclasses.replace(dist, recv_slot=bad_recv)  # a receiver drops a row
    r = np.random.default_rng(0)
    g = r.standard_normal((P, dist.n_ghost, 7)).astype(np.float32)
    x = r.standard_normal((P, dist.n_local, 7)).astype(np.float32)
    res = run_ranks(_rank_body, P, ((dist, bad, g, x), cases), device="cpu",
                    timeout_s=240)
    return {"res": res, "plans": plans, "dist": dist, "g": g, "x": x}


def test_ghost_buffers_match_jax_schedule(run, jax_ref):
    """Each rank's ghost rows equal a numpy reconstruction from the JAX
    package's own send_idx / recv_slot, and the live shifts give the same
    buffers as the full ring."""
    jd = jax_ref["dist"]
    x = run["x"]
    assert jd.live_shifts == run["dist"].live_shifts
    for rank, out in enumerate(run["res"]):
        want = np.zeros((jd.n_ghost, x.shape[-1]), np.float32)
        for s in range(1, P):
            o = (rank - s) % P
            idx, slot = jd.send_idx[o, s - 1], jd.recv_slot[rank, s - 1]
            for j in np.flatnonzero(slot >= 0):
                if idx[j] >= 0:
                    want[slot[j]] += x[o, idx[j]]
        ex = out["exchange"]
        np.testing.assert_array_equal(ex["ghost_live"], want)
        np.testing.assert_array_equal(ex["ghost_full"], want)


def test_reverse_exchange_is_the_transpose(run):
    """⟨E·x, g⟩ = ⟨x, Eᵀ·g⟩ over the fleet, to 1e-5, and the exchange's
    VJP is the reverse exchange, bitwise."""
    lhs = sum(float((out["exchange"]["ghost_live"].astype(np.float64)
                     * run["g"][r]).sum()) for r, out in enumerate(run["res"]))
    rhs = sum(float((run["x"][r].astype(np.float64)
                     * out["exchange"]["transpose"]).sum())
              for r, out in enumerate(run["res"]))
    assert abs(lhs) > 0.0
    assert abs(lhs - rhs) <= 1e-5 * max(1.0, abs(lhs))
    for out in run["res"]:
        np.testing.assert_array_equal(out["exchange"]["vjp"],
                                      out["exchange"]["transpose"])


def test_debug_halo_check_catches_a_dropped_row(run):
    """The sound schedule passed in every rank (it raised nothing); the
    one whose receiver drops a shipped row fails in every rank."""
    for out in run["res"]:
        assert "checksum mismatch" in out["exchange"]["bad_raised"]


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_distributed_matches_single_device(run, jax_ref, name):
    """The first loss and every gradient leaf within 1e-4 of the JAX
    single-device model's ``value_and_grad`` on the whole graph; three
    epochs within 1e-3 relative of its trainer's; the loss falls; the
    ranks' parameters bitwise equal after every epoch."""
    ref = jax_ref["cases"][name]
    outs = [r["train"][name] for r in run["res"]]
    got = outs[0]
    assert abs(got["loss"] - ref["loss"]) < 1e-4, (got["loss"], ref["loss"])
    assert len(got["grads"]) == len(ref["grads"])
    for a, b in zip(got["grads"], ref["grads"]):
        assert a.shape == b.shape and np.isfinite(a).all()
        assert float(np.abs(a - b).max()) < 1e-4
    rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    assert rel < 1e-3, (got["losses"], ref["losses"])
    assert got["losses"][-1] < got["losses"][0]
    for other in outs[1:]:
        assert other["loss"] == got["loss"] and other["losses"] == got["losses"]
        for pa, pb in zip(other["params"], got["params"]):
            assert all(np.array_equal(a, b) for a, b in zip(pa, pb))


def test_plans_bind_the_expected_paths(run):
    """Alg-1: the corafull analog's layer 0 binds the sparse input path,
    the flickr analog's the dense; the split compositions everywhere but
    the bulk plan and max; the guarded run (every step finite, so every
    step committed) follows the unguarded one."""
    plans = run["plans"]
    for name, plan in plans.items():
        sparse = plan.layers[0].feature_path == "sparse"
        assert sparse == name.split("/")[1].startswith("corafull"), name
        assert (plan.overlap is None) == (name.endswith("bulk")
                                          or name.startswith("SAGE-max")), name
    assert plans["GCN/corafull"].layers[0].agg_primitive == (
        "distributed.dist_spmm_fused_epilogue_split")
    assert plans["GCN/corafull/bulk"].layers[0].agg_primitive == (
        "distributed.dist_spmm_fused_epilogue")
    assert plans["GAT/corafull"].layers[0].agg_primitive == (
        "distributed.dist_spmm_attention_split")
    a = run["res"][0]["train"]["GCN/corafull"]
    b = run["res"][0]["train"]["GCN/corafull/guarded"]
    np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-6)


def test_a_failing_rank_fails_the_call():
    with pytest.raises(RuntimeError, match="rank two gives up"):
        run_ranks(_failing_body, P, device="cpu", timeout_s=60)


# ---------------------------------------------------------------------------
# the card: the kernels on one rank's interior and boundary streams
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_kernels_on_one_ranks_streams():
    """Rank 0's interior and boundary streams of the ogbn-arxiv analog at
    full scale, partitioned 4 ways at ``br=8, bc=32`` (GCN's weighting and
    GAT's): every SpMM kernel (fused, masked, plain) and the three
    attention passes against their plain versions within 1e-4 of the
    output's scale, rows that no item of a stream writes included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ops import BSRDevice

    dev = torch.device("cuda")
    ds = generate_dataset("ogbn-arxiv", scale=1.0, seed=0)
    part = hierarchical_partition(ds.graph, P)
    gen = torch.Generator(device=dev).manual_seed(0)

    def operands(agg):
        d = build_distributed_graph(ds.graph, ds.features, ds.labels,
                                    ds.train_mask, part, br=8, bc=32,
                                    aggregation=agg).rank_slice(0, bulk=False)
        n, nb = d.n_local, d.n_local + d.n_ghost

        def op(s, rows, cols):
            return BSRDevice(
                block_rows=torch.from_numpy(s["rows"][0]).to(dev),
                block_cols=torch.from_numpy(s["cols"][0]).to(dev),
                blocks=torch.from_numpy(s["blocks"][0]).to(dev),
                n_rows=rows, n_cols=cols, n_rows_padded=rows,
                n_cols_padded=cols, br=8, bc=32)

        return {"int_fwd": op(d.fwd_interior, n, n),
                "int_bwd": op(d.bwd_interior, n, n),
                "bnd_fwd": op(d.fwd_boundary, n, nb),
                "bnd_bwd": op(d.bwd_boundary, nb, n)}

    def close(got, want):
        scale = max(float(want.abs().max()), 1.0)
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= 1e-4 * scale

    for name, op in operands("gcn").items():
        x = torch.randn((op.n_cols_padded, 256), generator=gen, device=dev)
        s = torch.randn((op.n_rows_padded, 256), generator=gen, device=dev)
        b = torch.randn(256, generator=gen, device=dev)
        a = torch.full((1,), 1.5, device=dev)
        for exe in ("spmm",):
            close(kops._executor("cuda", exe)(
                op.block_rows, op.block_cols, op.blocks, x, op.n_rows_padded,
                nzc=op.nonzero_columns()),
                kops._executor("torch", exe)(op.block_rows, op.block_cols,
                                             op.blocks, x, op.n_rows_padded))
        y, m = kops._executor("cuda", "fused")(
            op.block_rows, op.block_cols, op.blocks, x, op.n_rows_padded, s,
            b, a, "relu", nzc=op.nonzero_columns())
        yr, mr = kops._executor("torch", "fused")(
            op.block_rows, op.block_cols, op.blocks, x, op.n_rows_padded, s,
            b, a, "relu")
        close(y, yr)
        mask = (torch.rand((op.n_cols_padded, 256), generator=gen,
                           device=dev) > 0.5).float()
        close(kops._executor("cuda", "masked")(
            op.block_rows, op.block_cols, op.blocks, x, mask,
            op.n_rows_padded, nzc=op.nonzero_columns()),
            kops._executor("torch", "masked")(
                op.block_rows, op.block_cols, op.blocks, x, mask,
                op.n_rows_padded))
    ops = operands("sum")
    for stream in ("int", "bnd"):
        fwd, bwd = ops[f"{stream}_fwd"], ops[f"{stream}_bwd"]
        geom = (fwd.n_rows, fwd.n_cols, fwd.n_rows_padded, fwd.n_cols_padded,
                bwd.n_rows_padded, bwd.n_cols_padded)
        z = torch.randn((fwd.n_cols, 3, 250), generator=gen, device=dev)
        a_src = torch.randn((3, 250), generator=gen, device=dev) * 0.05
        a_dst = torch.randn((3, 250), generator=gen, device=dev) * 0.05
        dy = torch.randn((fwd.n_rows, 3, 250), generator=gen, device=dev)
        got = kops.mha_forward(fwd, z, a_src, a_dst, geom, "cuda")
        want = kops.mha_forward(fwd, z, a_src, a_dst, geom, "torch")
        for g_, w_ in zip(got[:3], want[:3]):
            close(g_, w_)
        for g_, w_ in zip(
                kops.mha_backward(fwd, bwd, geom, "cuda", z, a_src, a_dst,
                                  *got, dy),
                kops.mha_backward(fwd, bwd, geom, "torch", z, a_src, a_dst,
                                  *want, dy)):
            close(g_, w_)
