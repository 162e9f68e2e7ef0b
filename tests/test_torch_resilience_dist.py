"""Port parity, the distributed resilience plane: the heartbeat monitor
(``runtime/failure.py``), elastic rescale (``runtime/elastic.py``),
``ResilientDistributedTrainer`` (``runtime/resilience.py``) on 4 gloo rank
processes on the CPU, and ``compressed_psum`` (``training/grad.py``),
against the JAX package.

Spawns: one pool of 4 rank processes for the rank-death schedule (its
two segments: 4 ranks, then 3; the test's pool, handed to the trainer),
one for the straggler schedule (two segments of 4; the trainer's own)
and one for ``compressed_psum``. The
monitors' dead timeout is 0 (one missed beat is DEAD), so the
classification does not hang on the host's speed; the injected faults and
the agreed step times decide it. The JAX package is reached only through
fixtures.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.graph.datasets import generate_dataset  # noqa: E402
from repro_torch.launch.mesh import RankPool, run_ranks  # noqa: E402
from repro_torch.models.gnn import GNNConfig  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    FaultInjector,
    FaultSpec,
    GuardPolicy,
    ResilientDistributedTrainer,
    VirtualClock,
)
from repro_torch.runtime.failure import HeartbeatMonitor  # noqa: E402
from repro_torch.training.optimizer import adam, tree_leaves  # noqa: E402

torch.set_num_threads(1)

P = 4
EPOCHS = 12


# ---------------------------------------------------------------------------
# the heartbeat monitor and elastic rescale (one process)
# ---------------------------------------------------------------------------


def _monitor_script(monitor_cls, clock_cls):
    """One scripted sequence (steps of 0.1 s, rank 2 slow from step 3,
    rank 1 silent from step 6) through a monitor on a virtual clock: its
    states and action after every step."""
    clock = clock_cls()
    mon = monitor_cls(4, dead_timeout=0.25, straggler_factor=3.0, window=4,
                      clock=clock)
    seen = []
    for step in range(10):
        clock.advance(0.1)
        for r in range(4):
            if r == 1 and step >= 6:
                continue
            mon.heartbeat(r, 0.1 * (8.0 if r == 2 and step >= 3 else 1.0))
        seen.append(({r: s.value for r, s in mon.classify().items()},
                     mon.recommend().value))
    return seen


def test_heartbeat_monitor_matches_jax():
    from repro.runtime.failure import HeartbeatMonitor as JMonitor
    from repro.runtime.resilience import VirtualClock as JClock

    got = _monitor_script(HeartbeatMonitor, VirtualClock)
    assert got == _monitor_script(JMonitor, JClock)
    actions = [a for _, a in got]
    assert "rebalance" in actions and actions[-1] == "restart_from_checkpoint"


def test_elastic_rescale_restores_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX package writes (params and Adam state) restores
    through the port's ``rescale`` bit for bit, with JAX's partition for
    the new rank count."""
    import jax

    from repro.graph import datasets as jds
    from repro.models.gnn import GNNConfig as JConfig
    from repro.models.gnn import init_params as j_init
    from repro.runtime.checkpoint import save_checkpoint as j_save
    from repro.runtime.elastic import rescale as j_rescale
    from repro.training.optimizer import adam as j_adam
    from repro_torch.models.gnn import init_params
    from repro_torch.runtime.elastic import rescale

    jg = jds.generate_dataset("corafull", scale=0.004, seed=0)
    dims = [jg.features.shape[1], 16, jg.n_classes]
    jparams = j_init(JConfig(kind="GCN", layer_dims=dims), jax.random.PRNGKey(0))
    jstate = (jparams, j_adam(1e-2).init(jparams))
    j_save(str(tmp_path), 6, jstate)
    _, jplan = j_rescale(str(tmp_path), jg.graph, 3, jstate, old_ranks=4)

    ds = generate_dataset("corafull", scale=0.004, seed=0)
    params = init_params(GNNConfig(kind="GCN", layer_dims=dims),
                         torch.Generator().manual_seed(5), "cpu")
    target = (params, adam(1e-2).init(params))
    (p, s), plan = rescale(str(tmp_path), ds.graph, 3, target, old_ranks=4)
    assert (plan.old_ranks, plan.new_ranks, plan.restored_step) == (4, 3, 6)
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate)]
    got = [a.numpy() for a in tree_leaves(p)] + [np.asarray(s.step)] + [
        a.numpy() for a in tree_leaves(s.m)] + [a.numpy() for a in tree_leaves(s.v)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a).astype(b.dtype), b)
    assert isinstance(s.step, int)
    assert np.array_equal(plan.partition.assignment, jplan.partition.assignment)
    assert plan.partition.phase == jplan.partition.phase


# ---------------------------------------------------------------------------
# ResilientDistributedTrainer on 4 CPU ranks
# ---------------------------------------------------------------------------


def _trainer(ds, tmp_path, faults, **kw):
    cfg = GNNConfig(kind="GCN", layer_dims=[ds.features.shape[1], 16, ds.n_classes])
    return ResilientDistributedTrainer(
        ds.graph, ds.features, ds.labels, ds.train_mask, cfg,
        functools.partial(adam, 1e-2), n_ranks=P, ckpt_dir=str(tmp_path),
        ckpt_every=2, guard=GuardPolicy(),
        injector=FaultInjector(seed=0, faults=faults), dead_timeout=0.0,
        straggler_factor=3.0, window=4, device="cpu", timeout_s=120, **kw)


@pytest.fixture(scope="module")
def rank_death(tmp_path_factory):
    """JAX ``test_resilience.py:634``'s schedule: corafull at scale 0.004,
    GCN [F, 16, C], a NaN gradient at step 1, rank 2 dead from step 3, 12
    epochs. The trainer runs on the test's pool, which stays open after
    the trainer is closed."""
    ds = generate_dataset("corafull", scale=0.004, seed=0)
    with RankPool(P, device="cpu", timeout_s=120) as pool:
        with _trainer(ds, tmp_path_factory.mktemp("death"), [
                FaultSpec(site="rank_dead", steps=range(3, 10_000), rank=2,
                          persistent=True),
                FaultSpec(site="grad", steps=(1,), mode="nan")], pool=pool) as rt:
            out = rt.fit(epochs=EPOCHS)
            loss, grads = rt.loss_and_grads()
        still_open = pool.run(abs, P)
    return {"rt": rt, "out": out, "loss": loss, "grads": grads, "ds": ds,
            "still_open": still_open}


def test_rank_death_rescales_and_recovers(rank_death):
    out = rank_death["out"]
    assert out["final_ranks"] == 3  # one dead rank evicted
    actions = [e.action for e in out["events"]]
    assert actions == ["rescale"]
    ev = out["events"][0]
    assert ev.detail["dead"] == [2] and ev.detail["restored_step"] == 2
    assert ev.step == 4 and ev.recovery_s >= ev.detail["host_s"] > 0
    assert out["guard"]["skipped"] >= 1  # the injected NaN step was skipped
    losses = out["losses"]
    assert len(losses) == EPOCHS and np.isfinite(losses).all()
    assert losses[-1] < losses[0]  # still converging after recovery
    assert [s["ranks"] for s in out["segments"]] == [4, 3]
    assert [s["steps"] for s in out["segments"]] == [4, 8]
    assert rank_death["still_open"] == list(range(P))  # the caller's pool


def test_rank_death_recovery_matches_jax_single_device(rank_death):
    """At the carried params, the 3-rank group's loss and gradients within
    1e-4 of the JAX package's single-device ``GNNModel``."""
    import jax
    import jax.numpy as jnp

    from repro.graph import datasets as jds
    from repro.models.gnn import GNNConfig as JConfig
    from repro.models.gnn import GNNModel

    rt, ds = rank_death["rt"], rank_death["ds"]
    jg = jds.generate_dataset("corafull", scale=0.004, seed=0)
    cfg = JConfig(kind="GCN", layer_dims=[ds.features.shape[1], 16, ds.n_classes])
    params = {"layers": [{k: jnp.asarray(v.numpy()) for k, v in layer.items()}
                         for layer in rt.params["layers"]]}
    model = GNNModel(cfg, jg.graph, use_fused=False)
    ref_loss, ref_grads = jax.value_and_grad(model.loss_fn)(
        params, jg.features, jg.labels, jg.train_mask)
    assert abs(rank_death["loss"] - float(ref_loss)) < 1e-4
    want = jax.tree_util.tree_leaves(ref_grads)
    assert len(rank_death["grads"]) == len(want)
    for a, b in zip(rank_death["grads"], want):
        assert float(np.abs(a - np.asarray(b)).max()) < 1e-4


def test_straggler_rebalances_with_state_carried_bitwise(tmp_path):
    """Rank 1 eight times slower from step 2: the monitors call it a
    straggler, the group re-partitions with Phase III degree balancing at
    the same 4 ranks, and the next segment starts from the state the
    first one ended with, bitwise (the segments' digests)."""
    ds = generate_dataset("corafull", scale=0.004, seed=0)
    with _trainer(ds, tmp_path, [FaultSpec(site="rank_slow", steps=range(2, 10_000),
                                           rank=1, factor=8.0)]) as rt:
        out = rt.fit(epochs=6)
    with pytest.raises(RuntimeError, match="closed"):  # its own pool, stopped
        rt.pool.run(abs, P)
    assert [e.action for e in out["events"]] == ["rebalance"]
    assert out["final_ranks"] == P and rt.partition.phase == "greedy_degree"
    first, second = out["segments"]
    # rank 1's median over its window trips at step 2 or 3: at 2 where the
    # first (cold) step's time is one of its two largest
    assert first["action"] == "rebalance" and first["steps"] in (3, 4)
    assert second["start_digest"] == first["end_digest"]
    assert out["guard"]["skipped"] == 0 and np.isfinite(out["losses"]).all()
    assert len(out["losses"]) == 6 and out["losses"][-1] < out["losses"][0]


# ---------------------------------------------------------------------------
# compressed_psum on 4 CPU ranks
# ---------------------------------------------------------------------------


def _grads(rank):
    """Rank ``rank``'s gradients and error buffer: JAX's own case (the
    constant rank + 1, ``test_distributed.py:218``) as leaf "c", and a
    tree of random leaves at two scales."""
    r = np.random.default_rng(rank)
    return ({"c": np.full(64, rank + 1.0, np.float32),
             "layers": [{"w": r.standard_normal((6, 5)).astype(np.float32) * s,
                         "b": r.standard_normal(5).astype(np.float32)}
                        for s in (1.0, 3e-3)]},
            {"c": np.zeros(64, np.float32),
             "layers": [{"w": r.standard_normal((6, 5)).astype(np.float32) * 1e-3,
                         "b": np.zeros(5, np.float32)} for _ in range(2)]})


def _psum_rank(rank):
    from repro_torch.training.grad import compressed_psum
    from repro_torch.training.optimizer import tree_map

    g, e = _grads(rank)
    means, errs = compressed_psum(tree_map(torch.from_numpy, g),
                                  tree_map(torch.from_numpy, e))
    return ([m.numpy() for m in tree_leaves(means)],
            [x.numpy() for x in tree_leaves(errs)])


def test_compressed_psum_matches_jax():
    """Four ranks' int8 all-reduce with error feedback against JAX's
    ``compressed_psum`` under ``jax.vmap(axis_name="data")`` over the same
    four gradients: the means and every rank's error buffer within 1e-6;
    on JAX's own case, the mean within its bound of 0.2 of the true mean."""
    import jax
    import jax.numpy as jnp

    from repro.training.grad import compressed_psum as j_psum

    per_rank = [_grads(r) for r in range(P)]
    stack = lambda i: jax.tree_util.tree_map(  # noqa: E731
        lambda *xs: jnp.stack(xs), *[pr[i] for pr in per_rank])
    j_means, j_errs = jax.vmap(lambda g, e: j_psum(g, "data", e),
                               axis_name="data")(stack(0), stack(1))
    j_means = [np.asarray(a) for a in jax.tree_util.tree_leaves(j_means)]
    j_errs = [np.asarray(a) for a in jax.tree_util.tree_leaves(j_errs)]
    got = run_ranks(_psum_rank, P, device="cpu", timeout_s=60)
    for rank, (means, errs) in enumerate(got):
        assert len(means) == len(j_means) == len(errs)
        for i, (m, e) in enumerate(zip(means, errs)):
            np.testing.assert_allclose(m, j_means[i][rank], atol=1e-6, rtol=0)
            np.testing.assert_allclose(e, j_errs[i][rank], atol=1e-6, rtol=0)
        assert all(np.array_equal(a, b) for a, b in zip(means, got[0][0]))
    true = np.mean(np.arange(1, P + 1))
    assert np.abs(got[0][0][0] - true).max() < 0.2 * true
