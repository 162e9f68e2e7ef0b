"""Port parity, the single-device runtime (``repro_torch/runtime/``):
the non-distributed part of the JAX package's ``tests/test_resilience.py``
on the port — deterministic fault injection, retries, the guarded step and
its ladder, checkpoint atomicity and validation, guarded and resumed
full-batch and mini-batch training — and checkpoints that cross between
the two packages: a JAX checkpoint resumes in the port (losses and
parameters within 1e-4: float32 sums in other orders), and a port
checkpoint of parameters restores in the JAX package bitwise. Resumes
within the port are bitwise."""
import io
import json
import os
import shutil
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.graph.datasets import generate_dataset  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.gnn import (  # noqa: E402
    GNNConfig,
    GNNModel,
    init_params,
    params_from_jax,
)
from repro_torch.runtime import (  # noqa: E402
    FaultInjector,
    FaultSpec,
    GuardPolicy,
    GuardRunner,
    InjectedFault,
    RetryPolicy,
    VirtualClock,
    guarded_update,
    list_checkpoints,
    nonfinite_count,
    pack_rng_state,
    restore_checkpoint,
    save_checkpoint,
    unpack_rng_state,
)
from repro_torch.training.optimizer import AdamState, adam, tree_leaves  # noqa: E402
from repro_torch.training.trainer import FullBatchTrainer, MiniBatchTrainer  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side, imported in a fixture so the card-marked
    tests collect where JAX is absent."""
    pytest.importorskip("jax")
    import types

    import jax

    from repro.graph.datasets import generate_dataset as jax_generate
    from repro.models.gnn import GNNConfig as JaxConfig
    from repro.models.gnn import GNNModel as JaxModel
    from repro.models.gnn import init_params as jax_init_params
    from repro.runtime import checkpoint as jckpt
    from repro.training.optimizer import adam as jax_adam
    from repro.training.trainer import FullBatchTrainer as JaxTrainer

    return types.SimpleNamespace(
        jax=jax, generate=jax_generate, Config=JaxConfig, Model=JaxModel,
        init_params=jax_init_params, ckpt=jckpt, adam=jax_adam,
        Trainer=JaxTrainer)


# ---------------------------------------------------------------------------
# FaultInjector
# ---------------------------------------------------------------------------


def test_injector_step_faults_fire_deterministically():
    a = FaultInjector(seed=7, faults=[FaultSpec(site="grad", steps=(3, 9))])
    b = FaultInjector(seed=7, faults=[FaultSpec(site="grad", steps=(3, 9))])
    fires_a = [a.fires("grad", s) for s in range(12)]
    assert fires_a == [b.fires("grad", s) for s in range(12)]
    assert [s for s, f in enumerate(fires_a) if f] == [3, 9]


def test_injector_bernoulli_is_seed_stable_and_seed_sensitive():
    spec = FaultSpec(site="prefetch", prob=0.3)
    pats = [[FaultInjector(seed=s, faults=[spec]).fires("prefetch", k)
             for k in range(64)] for s in (1, 1, 2)]
    assert pats[0] == pats[1] and pats[0] != pats[2]
    assert 0.05 < sum(pats[0]) / 64 < 0.6


def test_injector_matches_the_jax_packages_fault_trace(jx):
    """Same seed and spec, same fires: the site digests and Bernoulli
    draws are the JAX package's."""
    from repro.runtime.resilience import FaultInjector as JaxInjector
    from repro.runtime.resilience import FaultSpec as JaxSpec

    t = FaultInjector(seed=3, faults=[FaultSpec(site="grad", prob=0.2)])
    j = JaxInjector(seed=3, faults=[JaxSpec(site="grad", prob=0.2)])
    assert [t.fires("grad", s) for s in range(200)] == \
        [j.fires("grad", s) for s in range(200)]


def test_injector_persistent_fault_latches():
    inj = FaultInjector(seed=0, faults=[
        FaultSpec(site="rank_dead", steps=range(5, 10_000), rank=1,
                  persistent=True)])
    assert inj.dead_ranks(4, n_ranks=4) == set()
    assert inj.dead_ranks(6, n_ranks=4) == {1}
    assert inj.dead_ranks(2, n_ranks=4) == {1}  # latched
    inj.clear("rank_dead")
    assert inj.dead_ranks(6, n_ranks=4) == set()


def test_injector_grad_poison_modes():
    inj = FaultInjector(seed=0, faults=[
        FaultSpec(site="grad", steps=(2,), mode="nan"),
        FaultSpec(site="grad", steps=(5,), mode="inf")])
    assert inj.grad_poison(0) == 0.0
    assert np.isnan(inj.grad_poison(2))
    assert np.isinf(inj.grad_poison(5))


def test_injector_count_bounded_callback_hook():
    inj = FaultInjector(seed=0,
                        faults=[FaultSpec(site="prefetch", prob=1.0, count=2)])
    hook = inj.callback_hook("prefetch")
    outcomes = []
    for _ in range(4):
        try:
            hook(("fwd", 0))
            outcomes.append("ok")
        except InjectedFault:
            outcomes.append("fail")
    assert outcomes == ["fail", "fail", "ok", "ok"]
    assert inj.fired["prefetch"] == 2


def test_injector_maybe_kill_raises_only_on_fire():
    inj = FaultInjector(seed=0, faults=[
        FaultSpec(site="checkpoint_kill", steps=(1,))])
    inj.maybe_kill("checkpoint_kill", 0)  # no-op
    with pytest.raises(InjectedFault):
        inj.maybe_kill("checkpoint_kill", 1)


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------


def test_retry_delays_deterministic_bounded_and_growing():
    rp = RetryPolicy(max_retries=5, base_delay_s=0.01, max_delay_s=0.08,
                     jitter=0.25, seed=3)
    d = [rp.delay("k", a) for a in range(6)]
    assert d == [rp.delay("k", a) for a in range(6)]
    assert all(x <= 0.08 * 1.25 + 1e-12 for x in d)
    assert d[1] > d[0] and d[2] > d[1]
    assert rp.delay("other-key", 0) != d[0]


def test_retry_recovers_transient_and_exhausts_permanent():
    rp = RetryPolicy(max_retries=3, base_delay_s=1e-5, max_delay_s=1e-4)
    calls = []

    def transient():
        calls.append(1)
        if len(calls) < 3:
            raise ValueError("boom")
        return 42

    retries_seen = []
    assert rp.call(transient, key="x",
                   on_retry=lambda a, e: retries_seen.append(a)) == 42
    assert len(calls) == 3 and retries_seen == [0, 1]

    def permanent():
        raise ValueError("always")

    with pytest.raises(ValueError, match="always"):
        rp.call(permanent, key="y")


# ---------------------------------------------------------------------------
# guarded_update + GuardRunner ladder
# ---------------------------------------------------------------------------


def test_guarded_update_commits_finite_and_skips_bad():
    old = {"w": torch.ones(3), "b": torch.zeros(2)}
    new = {"w": torch.full((3,), 3.0), "b": torch.full((2,), 1.0)}
    p, _, _, ok = guarded_update(old, None, new, None, torch.tensor(0.1), 0.5)
    assert bool(ok)
    torch.testing.assert_close(p["w"], torch.full((3,), 2.0))
    p, _, _, ok = guarded_update(old, None, new, None,
                                 torch.tensor(float("nan")), 1.0)
    assert not bool(ok)
    assert torch.equal(p["w"], torch.ones(3))
    bad = {"w": torch.tensor([1.0, float("nan"), 1.0]), "b": new["b"]}
    p, _, _, ok = guarded_update(old, None, bad, None, torch.tensor(0.1), 1.0)
    assert not bool(ok) and torch.equal(p["w"], torch.ones(3))
    _, _, _, ok = guarded_update(old, None, new, None, torch.tensor(0.1), 1.0,
                                 extra_bad=2)
    assert not bool(ok)
    # the optimizer state: tensors selected on the device, the host step
    # count on the host
    s_old = AdamState(step=4, m={"w": torch.zeros(3)}, v={"w": torch.zeros(3)})
    s_new = AdamState(step=5, m={"w": torch.ones(3)}, v={"w": torch.ones(3)})
    _, s, _, ok = guarded_update(old, s_old, bad, s_new, torch.tensor(0.1), 1.0)
    assert s.step == 4 and torch.equal(s.m["w"], torch.zeros(3))
    _, s, _, _ = guarded_update(old, s_old, new, s_new, torch.tensor(0.1), 1.0)
    assert s.step == 5 and torch.equal(s.v["w"], torch.ones(3))
    assert int(nonfinite_count(bad, torch.tensor(float("inf")))) == 2


def test_guarded_update_matches_the_jax_packages(jx):
    from repro.runtime.resilience import guarded_update as jax_guarded

    r = np.random.default_rng(0)
    old = {"w": r.standard_normal((4, 3)).astype(np.float32)}
    new = {"w": r.standard_normal((4, 3)).astype(np.float32)}
    p, _, _, ok = guarded_update({"w": torch.from_numpy(old["w"])}, None,
                                 {"w": torch.from_numpy(new["w"])}, None,
                                 torch.tensor(0.3), 0.25)
    jp, _, _, jok = jax_guarded(old, None, new, None, np.float32(0.3), 0.25)
    assert bool(ok) == bool(jok)
    np.testing.assert_array_equal(p["w"].numpy(), np.asarray(jp["w"]))


def test_guard_runner_ladder_escalates_and_resets():
    restored = []
    gr = GuardRunner(GuardPolicy(backoff_after=1, backoff_factor=0.5,
                                 min_scale=0.25, rollback_after=4),
                     restore_fn=lambda: restored.append(1))
    assert [gr.after_step(False, s) for s in range(4)] == \
        ["skip", "backoff", "backoff", "rollback"]
    assert restored == [1]
    assert gr.scale == 1.0 and gr.consecutive_bad == 0
    for s in (10, 11, 12):
        gr.after_step(False, s)
    assert gr.scale == 0.25
    assert gr.after_step(True, 13) == "none" and gr.scale == 1.0
    s = gr.stats()
    assert s["rollbacks"] == 1 and s["skipped"] == 7


def test_virtual_clock_advances_only_when_told():
    clock = VirtualClock(1.5)
    assert clock() == clock.now() == 1.5
    assert clock.advance(0.25) == 1.75 and clock() == 1.75


# ---------------------------------------------------------------------------
# checkpoint atomicity + validation + GC
# ---------------------------------------------------------------------------


def _ckpt_state():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "n": np.int64(3), "opt": AdamState(step=7, m=[torch.ones(2)],
                                               v=[torch.zeros(2)])}


def test_checkpoint_writer_kill_leaves_latest_valid(tmp_path):
    d = str(tmp_path)
    state = _ckpt_state()
    save_checkpoint(d, 1, state)
    inj = FaultInjector(seed=0, faults=[
        FaultSpec(site="checkpoint_kill", steps=(2,))])
    with pytest.raises(InjectedFault):
        save_checkpoint(d, 2, state, injector=inj)
    assert [p for p in os.listdir(d) if p.startswith(".tmp_")]
    assert list_checkpoints(d) == [1]
    restored, step = restore_checkpoint(d, state)
    assert step == 1
    assert torch.equal(restored["w"], state["w"])
    assert restored["opt"].step == 7 and isinstance(restored["opt"].step, int)
    manifest = json.load(open(os.path.join(d, "step_0000000001",
                                           "manifest.json")))
    assert manifest["paths"] == ["n", "opt/.step", "opt/.m/0", "opt/.v/0", "w"]
    assert manifest["dtypes"][1] == "int32" and manifest["format_version"] == 1


def test_checkpoint_truncated_manifest_is_skipped(tmp_path):
    d = str(tmp_path)
    state = _ckpt_state()
    save_checkpoint(d, 1, state)
    p2 = save_checkpoint(d, 2, state)
    with open(os.path.join(p2, "manifest.json"), "w") as f:
        f.write('{"step": 2, "paths"')
    assert list_checkpoints(d) == [1]
    _, step = restore_checkpoint(d, state)
    assert step == 1
    p3 = save_checkpoint(d, 3, state)
    with open(os.path.join(p3, "manifest.json"), "w") as f:
        json.dump({"step": 3}, f)
    assert list_checkpoints(d) == [1]


def test_checkpoint_restore_validates_shapes_with_named_leaf(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, {"w": torch.zeros((2, 3))})
    with pytest.raises(ValueError, match="'w'"):
        restore_checkpoint(d, {"w": torch.zeros((5, 5))})
    # bit-rot inside a leaf: the digest names it
    path = os.path.join(d, "step_0000000001", "arrays.npz")
    np.savez(path, arr_0=np.ones((2, 3), np.float32))
    with pytest.raises(ValueError, match="'w'.*sha256"):
        restore_checkpoint(d, {"w": torch.zeros((2, 3))})


def test_checkpoint_keep_n_gc_and_tmp_sweep(tmp_path):
    d = str(tmp_path)
    state = _ckpt_state()
    inj = FaultInjector(seed=0, faults=[
        FaultSpec(site="checkpoint_kill", steps=(4,))])
    for s in range(1, 9):
        try:
            save_checkpoint(d, s, state, keep_n=3, injector=inj)
        except InjectedFault:
            pass
    assert list_checkpoints(d) == [6, 7, 8]
    assert not [p for p in os.listdir(d) if p.startswith(".tmp_")]


def test_rng_state_pack_round_trip():
    g = np.random.default_rng(5)
    g.random(17)
    blob = pack_rng_state(g)
    assert blob.dtype == np.uint8
    g2 = np.random.default_rng(0)
    unpack_rng_state(g2, blob)
    np.testing.assert_array_equal(g.random(16), g2.random(16))


# ---------------------------------------------------------------------------
# guarded and resumed training
# ---------------------------------------------------------------------------


def _corafull_model(device="cpu", scale=0.01):
    ds = generate_dataset("corafull", scale=scale, seed=0)
    cfg = GNNConfig(kind="GCN",
                    layer_dims=(ds.features.shape[1], 16, ds.n_classes))
    return ds, cfg, GNNModel(cfg, ds.graph, device=device)


def _params(cfg, device="cpu"):
    return init_params(cfg, torch.Generator().manual_seed(0), device)


def test_fullbatch_guarded_nan_steps_converge_to_parity(tmp_path):
    """NaN gradients on three steps: skipped or backed off, no NaN reaches
    params or the losses, and the run ends within 1e-2 of the fault-free
    run's loss."""
    ds, cfg, model = _corafull_model(scale=0.02)
    params = _params(cfg)
    r0 = FullBatchTrainer(model, adam(1e-2, fused=True)).fit(
        params, ds.features, ds.labels, ds.train_mask, epochs=120)
    inj = FaultInjector(seed=0, faults=[
        FaultSpec(site="grad", steps=(5, 6, 12), mode="nan")])
    tr = FullBatchTrainer(model, adam(1e-2, fused=True), guard=GuardPolicy(),
                          injector=inj, ckpt_dir=str(tmp_path), ckpt_every=10)
    r1 = tr.fit(params, ds.features, ds.labels, ds.train_mask, epochs=120)
    assert np.isfinite(r1.losses).all()
    assert r1.guard["skipped"] == 3
    assert abs(r0.losses[-1] - r1.losses[-1]) < 1e-2
    assert list_checkpoints(str(tmp_path))[-1] == 120


def test_fullbatch_skipped_step_keeps_params_bitwise():
    ds, cfg, model = _corafull_model()
    params = _params(cfg)
    inj = FaultInjector(seed=0, faults=[FaultSpec(site="grad", steps=(2,))])
    tr = FullBatchTrainer(model, adam(1e-2, fused=True), guard=GuardPolicy(),
                          injector=inj)
    before = tr.fit(params, ds.features, ds.labels, ds.train_mask,
                    epochs=2).final_params
    tr2 = FullBatchTrainer(model, adam(1e-2, fused=True), guard=GuardPolicy(),
                           injector=FaultInjector(seed=0, faults=[
                               FaultSpec(site="grad", steps=(2,))]))
    after = tr2.fit(params, ds.features, ds.labels, ds.train_mask,
                    epochs=3).final_params
    for a, b in zip(tree_leaves(before), tree_leaves(after)):
        assert torch.equal(a, b)


def test_fullbatch_guard_rollback_restores_checkpoint(tmp_path):
    """A long burst of bad steps climbs the ladder to a rollback: params
    come back from the last checkpoint."""
    ds, cfg, model = _corafull_model()
    params = _params(cfg)
    inj = FaultInjector(seed=0, faults=[
        FaultSpec(site="grad", steps=tuple(range(12, 22)), mode="inf")])
    tr = FullBatchTrainer(model, adam(1e-2), guard=GuardPolicy(),
                          injector=inj, ckpt_dir=str(tmp_path), ckpt_every=5)
    r = tr.fit(params, ds.features, ds.labels, ds.train_mask, epochs=30)
    assert r.guard["rollbacks"] >= 1
    assert np.isfinite(r.losses).all()
    assert r.losses[-1] < r.losses[0]


def test_fullbatch_resume_is_bitwise(tmp_path):
    """Killed at the epoch-10 save, resumed from epoch 5 by a fresh
    trainer: the same params, bit for bit, as an uninterrupted run."""
    ds, cfg, model = _corafull_model()
    params = _params(cfg)

    def injector(kill=False):
        faults = [FaultSpec(site="grad", steps=(3,))]
        if kill:
            faults.append(FaultSpec(site="checkpoint_kill", steps=(10,)))
        return FaultInjector(seed=0, faults=faults)

    straight = FullBatchTrainer(model, adam(1e-2, fused=True),
                                guard=GuardPolicy(), injector=injector()).fit(
        params, ds.features, ds.labels, ds.train_mask, epochs=10)
    d = str(tmp_path)
    with pytest.raises(InjectedFault):
        FullBatchTrainer(model, adam(1e-2, fused=True), ckpt_dir=d,
                         ckpt_every=5, guard=GuardPolicy(),
                         injector=injector(kill=True)).fit(
            params, ds.features, ds.labels, ds.train_mask, epochs=10)
    assert list_checkpoints(d) == [5]
    resumed = FullBatchTrainer(model, adam(1e-2, fused=True), ckpt_dir=d,
                               ckpt_every=5, guard=GuardPolicy(),
                               injector=injector()).fit(
        params, ds.features, ds.labels, ds.train_mask, epochs=10)
    assert resumed.restored_from == 5
    assert resumed.losses == straight.losses[5:]
    for a, b in zip(tree_leaves(straight.final_params),
                    tree_leaves(resumed.final_params)):
        assert torch.equal(a, b)


def _mini_trainer(**kw):
    ds = generate_dataset("ogbn-arxiv", scale=0.0005, seed=0)
    cfg = GNNConfig(kind="GCN",
                    layer_dims=[ds.features.shape[1], 8, ds.n_classes])
    return MiniBatchTrainer(
        cfg, ds.graph, ds.features, ds.labels, ds.train_mask,
        adam(0.01, fused=True), fanouts=(3, 3), batch_size=16, n_buckets=2,
        seed=0, device="cpu", **kw)


def test_minibatch_guarded_steps_skip_injected_nans(tmp_path):
    inj = FaultInjector(seed=0, faults=[
        FaultSpec(site="grad", steps=(2, 3), mode="inf")])
    tr = _mini_trainer(guard=GuardPolicy(), injector=inj,
                       ckpt_dir=str(tmp_path), ckpt_every=3)
    r = tr.fit(6)
    assert np.isfinite(r.losses).all()
    assert r.guard["skipped"] == 2
    assert r.losses[-1] < r.losses[0]


def test_minibatch_resume_replays_exact_batch_sequence(tmp_path):
    """3 epochs, a 'crash', and a resume to 6 give the losses and params
    of an uninterrupted 6-epoch run, bit for bit: the checkpoint carries
    the shuffle and sampler RNG states."""
    straight = _mini_trainer().fit(6)
    _mini_trainer(ckpt_dir=str(tmp_path), ckpt_every=3).fit(3)
    tb = _mini_trainer(ckpt_dir=str(tmp_path), ckpt_every=3)
    rb = tb.fit(6)
    assert rb.restored_from == 3
    assert rb.losses == straight.losses[3:]
    for a, b in zip(tree_leaves(straight.final_params), tree_leaves(tb.params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------


def test_a_jax_checkpoint_resumes_in_the_port(jx, tmp_path):
    """The JAX trainer checkpoints a GCN at epoch 5; the port's trainer
    resumes from it to epoch 10 as JAX continues its own run: losses and
    params within 1e-4. The port's checkpoint of those params restores in
    the JAX package bitwise."""
    jds = jx.generate("corafull", scale=0.01, seed=0)
    ds, cfg, model = _corafull_model()
    jcfg = jx.Config(kind="GCN", layer_dims=cfg.layer_dims)
    jmodel = jx.Model(jcfg, jds.graph)
    jparams = jx.init_params(jcfg, jx.jax.random.PRNGKey(0))
    data = (jds.features, jds.labels, jds.train_mask)
    first = str(tmp_path / "at5")
    jx.Trainer(jmodel, jx.adam(1e-2), ckpt_dir=first, ckpt_every=5).fit(
        jparams, *data, epochs=5)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(first, jax_dir)
    shutil.copytree(first, port_dir)
    jr = jx.Trainer(jmodel, jx.adam(1e-2), ckpt_dir=jax_dir,
                    ckpt_every=5).fit(jparams, *data, epochs=10)
    tr = FullBatchTrainer(model, adam(1e-2, fused=True), ckpt_dir=port_dir,
                          ckpt_every=5)
    r = tr.fit(_params(cfg), ds.features, ds.labels, ds.train_mask, epochs=10)
    assert r.restored_from == jr.restored_from == 5
    np.testing.assert_allclose(r.losses, jr.losses, atol=1e-4, rtol=1e-4)
    jleaves = jx.jax.tree_util.tree_leaves(jr.final_params)
    for a, b in zip(tree_leaves(r.final_params), jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)
    # the port's checkpoint of these params, restored in the JAX package
    params_dir = str(tmp_path / "params")
    save_checkpoint(params_dir, 10, r.final_params)
    back, step = jx.ckpt.restore_checkpoint(params_dir, jr.final_params)
    assert step == 10
    for a, b in zip(tree_leaves(r.final_params),
                    jx.jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # and the port's full state, (params, AdamState), in the JAX package
    state_dir = str(tmp_path / "state")
    shutil.copytree(port_dir, state_dir)
    jstate, step = jx.ckpt.restore_checkpoint(
        state_dir, (jr.final_params, jx.adam(1e-2).init(jr.final_params)))
    assert step == 10 and int(jstate[1].step) == 10
    params_back = params_from_jax(
        jx.jax.tree_util.tree_map(np.asarray, jstate[0]), device="cpu")
    for a, b in zip(tree_leaves(r.final_params), tree_leaves(params_back)):
        assert torch.equal(a, b)


def test_launch_train_resumes_bitwise(tmp_path):
    """``launch.train --ckpt-dir`` on a tiny gemma3-1b: a run cut at step 2
    and resumed to 4 gives the losses of an uninterrupted run, bit for
    bit (the resumed run draws the batches the straight one drew)."""
    args = ["--arch", "gemma3-1b", "--device", "cpu", "--steps", "4",
            "--seq", "40"]
    d = str(tmp_path)
    with redirect_stdout(io.StringIO()):
        straight = launch_train.main(args)
        launch_train.main(args[:5] + ["2", "--seq", "40", "--ckpt-dir", d,
                                      "--ckpt-every", "2"])
    out = io.StringIO()
    with redirect_stdout(out):
        resumed = launch_train.main(args + ["--ckpt-dir", d, "--ckpt-every", "2"])
    assert out.getvalue().splitlines()[0] == "[train] resumed from step 2"
    assert resumed == straight[2:]
    assert list_checkpoints(d) == [2, 4]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_guarded_resume_is_bitwise(tmp_path):
    """On the card: the guarded GCN skips a NaN step bitwise and resumes
    bitwise, and the sampled trainer resumes bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    ds, cfg, model = _corafull_model("cuda", scale=0.05)
    params = _params(cfg, "cuda")

    def run(epochs, d=None, kill=False):
        faults = [FaultSpec(site="grad", steps=(3,))]
        if kill:
            faults.append(FaultSpec(site="checkpoint_kill", steps=(10,)))
        return FullBatchTrainer(model, adam(1e-2, fused=True), ckpt_dir=d,
                                ckpt_every=5, guard=GuardPolicy(),
                                injector=FaultInjector(0, faults)).fit(
            params, ds.features, ds.labels, ds.train_mask, epochs=epochs)

    at3, at4 = run(3), run(4)
    for a, b in zip(tree_leaves(at3.final_params), tree_leaves(at4.final_params)):
        assert torch.equal(a, b)
    straight = run(10)
    d = str(tmp_path / "full")
    with pytest.raises(InjectedFault):
        run(10, d, kill=True)
    resumed = run(10, d)
    assert resumed.restored_from == 5 and resumed.losses == straight.losses[5:]
    for a, b in zip(tree_leaves(straight.final_params),
                    tree_leaves(resumed.final_params)):
        assert torch.equal(a, b)

    def mini(**kw):
        ds = generate_dataset("ogbn-arxiv", scale=0.005, seed=0)
        c = GNNConfig(kind="SAGE", aggregation="mean",
                      layer_dims=[ds.features.shape[1], 32, ds.n_classes])
        return MiniBatchTrainer(c, ds.graph, ds.features, ds.labels,
                                ds.train_mask, adam(0.01, fused=True),
                                fanouts=(5, 5), batch_size=64, seed=0,
                                device="cuda", **kw)

    s = mini().fit(2)
    mini(ckpt_dir=str(tmp_path / "mini"), ckpt_every=1).fit(1)
    tb = mini(ckpt_dir=str(tmp_path / "mini"), ckpt_every=1)
    rb = tb.fit(2)
    assert rb.restored_from == 1 and rb.losses == s.losses[1:]
    for a, b in zip(tree_leaves(s.final_params), tree_leaves(tb.params)):
        assert torch.equal(a, b)
