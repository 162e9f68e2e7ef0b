"""Port parity, tensor parallelism: the sharded LM on gloo CPU ranks
(``launch/mesh.py:RankPool``, ``make_mesh``) at (data, model) = (1, 2),
(1, 4) and (2, 2), against the JAX package's single-device program.

A reduced llama-type configuration (2 layers, d_model 64, 4 heads over 4
KV heads of 16, d_ff 128, vocabulary 256, tied embeddings), the JAX
package's weights carried over by ``params_from_jax`` and cut by
``shard_tree``. Each rank holds: the forward's gathered logits, a
cached prefill and two decode steps (1e-4); the float32 loss and every
gradient leaf gathered by ``gather_tree`` (1e-4); one AdamW step of the
rank's shards from the JAX gradients' shards (1e-6: the first step moves
a weight by ``lr · g / (|g| + eps)``, which float32 gradients of ~1e-8
cannot hold closer than ~1e-5), and one through ``make_train_step``
(1e-4); the vocabulary-sharded cross entropy against
``_masked_ce`` with -100 labels and a padded vocabulary (1e-6); a
``torch.autograd.gradcheck`` in float64 of each collective inside a
replicated-in, replicated-out composition (a rank-local input would be
perturbed on every rank at once); the serving engine's tokens equal on
every rank and to the one-device engine's; and the dry run's rank step on
the reduced cell at (1, 4) (``build_cell(mesh=)`` over ``meta``): its
persistent bytes the rank's shards' and its collective counts what the
rank's ``CollectiveLog`` read.

The rest of the dense family at the same meshes (``tests/_torch_tp_family.py``):
reduced starcoder2-3b (a KV head split in half at model 4), gemma3-1b (one
KV head, a sliding window, the cache sharded by position) and its 2-query-head
variant (query heads split below one head at model 4), each held on its
logits, cached prefill and decode, loss and gathered gradients, AdamW step
and the rules' shapes. One ``RankPool`` runs every mesh of the file.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_tp_family as fam  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.sharding import ShardingRules, use_rules  # noqa: E402
from repro_torch.distributed.tensor_parallel import (  # noqa: E402
    CollectiveLog,
    check_tp,
    copy_to_model,
    embed_rows,
    gather_from_model,
    gather_tree,
    link_bytes,
    logging_collectives,
    mean_over_data,
    shard_tree,
    sharded_ce,
)
from repro_torch.launch.mesh import RankPool, make_mesh  # noqa: E402
from repro_torch.launch.roofline import NVLINK_BW, analyze  # noqa: E402
from repro_torch.launch.specs import build_cell  # noqa: E402
from repro_torch.launch.step_cost import reckon, tensor_bytes  # noqa: E402
from repro_torch.models.layers import apply_mlp  # noqa: E402
from repro_torch.models.model_zoo import build_model, make_train_step  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.runtime.checkpoint import _flatten_with_paths  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    adamw,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

torch.set_num_threads(1)
MESHES = [(1, 2), (1, 4), (2, 2)]
B, T, T0, S_MAX = 4, 12, 8, 16
LR = 1e-2
TOL = dict(atol=1e-4, rtol=1e-4)
ADAM_TOL = dict(atol=1e-6, rtol=1e-6)
#: the cross entropy's case: a vocabulary of 250 padded to 256
CE_VOCAB = 250
#: the dry run's reduced cell
CELL = dict(batch=4, seq_len=16)


def _cfg(getter):
    return dataclasses.replace(getter("llama3.2-1b").reduced(), n_layers=2, d_model=64,
                               n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
                               head_dim=16)


def _data():
    r = np.random.default_rng(0)
    tokens = r.integers(0, 256, (B, T)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100, np.int32)], 1)
    labels[r.random(labels.shape) < 0.2] = -100  # the data ranks' counts differ
    ce_logits = r.standard_normal((2, 5, 256)).astype(np.float32) * 3
    ce_labels = r.integers(0, CE_VOCAB, (2, 5)).astype(np.int64)
    ce_labels[0, 1] = ce_labels[1, 3] = -100
    prompts = [r.integers(0, 256, n).astype(np.int32) for n in (5, 9, 7)]
    return types.SimpleNamespace(tokens=tokens, labels=labels, ce_logits=ce_logits,
                                 ce_labels=ce_labels, prompts=prompts)


def _serve(model, params):
    eng = ServingEngine(model, params, batch_slots=2, max_seq=24, device="cpu")
    d = _data()
    for i, p in enumerate(d.prompts):
        eng.submit(Request(i, p, max_new_tokens=4))
    return [r.output for r in sorted(eng.run(), key=lambda r: r.rid)]


def _np(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


# ---------------------------------------------------------------------------
# what each rank runs (module-level: pickled by import path)
# ---------------------------------------------------------------------------


def _gradchecks(rules, cfg) -> dict:
    """float64 gradchecks of replicated-in, replicated-out compositions,
    one for each collective: the MLP (copy, reduce), the gather, the
    vocabulary-sharded lookup (reduce) and the sharded cross entropy
    (the MAX and sum reductions)."""
    g = torch.Generator().manual_seed(3)
    m, n_model = rules.mesh.coords["model"], rules.model_size
    x = torch.randn(1, 2, 8, generator=g, dtype=torch.float64, requires_grad=True)
    full = {k: torch.randn(*s, generator=g, dtype=torch.float64) * 0.3 for k, s in
            (("w_gate", (8, 8)), ("w_up", (8, 8)), ("w_down", (8, 8)))}
    cols = slice(m * 8 // n_model, (m + 1) * 8 // n_model)
    local = {"w_gate": full["w_gate"][:, cols], "w_up": full["w_up"][:, cols],
             "w_down": full["w_down"][cols]}
    table = torch.randn(8, 2, generator=g, dtype=torch.float64, requires_grad=True)
    tokens = torch.tensor([[1, 7, 4], [6, 0, 3]])
    logits = torch.randn(1, 3, 8, generator=g, dtype=torch.float64, requires_grad=True)
    labels = torch.tensor([[3, -100, 6]])
    rows = slice(m * 8 // n_model, (m + 1) * 8 // n_model)
    checks = {
        "mlp": (lambda x: apply_mlp(local, x, "swiglu"), x),
        "gather": (lambda x: gather_from_model(copy_to_model(x)[..., cols]), x),
        "embed": (lambda t: embed_rows(copy_to_model(t)[rows], tokens), table),
        "ce": (lambda lg: sharded_ce(copy_to_model(lg)[..., rows], labels, 7)[0], logits),
    }
    return {k: bool(torch.autograd.gradcheck(fn, (inp,))) for k, (fn, inp) in checks.items()}


def _rank(rank, dm, np_params, np_grads):
    cfg = _cfg(get_config)
    d = _data()
    model = build_model(cfg, inner="cuda")
    full = params_from_jax(np_params, device="cpu")
    mesh = make_mesh(*dm)
    rules = ShardingRules(mesh, cfg)
    check_tp(cfg, rules)
    local = shard_tree(full, rules, mesh.coords)
    bl = B // dm[0]
    rows = slice(mesh.coords["data"] * bl, (mesh.coords["data"] + 1) * bl)
    tokens = torch.from_numpy(d.tokens[rows]).long()
    batch = {"tokens": tokens, "labels": torch.from_numpy(d.labels[rows]).long()}
    out = {"coords": dict(mesh.coords)}
    with use_rules(rules):
        with torch.no_grad():
            out["forward"] = model.forward(local, tokens)[0].numpy()
            cache = model.init_cache(bl, S_MAX, dtype=torch.float32, device="cpu")
            out["cache_kv_heads"] = cache["segments"][0][0]["attn"]["k"].shape[-2]
            logits, cache = model.prefill(local, tokens[:, :T0], cache)
            cached = [logits]
            for t in range(T0, T0 + 2):
                logits, cache = model.decode_step(local, cache, tokens[:, t:t + 1])
                cached.append(logits)
            out["cached"] = torch.stack(cached).numpy()
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(local)]
        loss, _ = model.loss(tree_unflatten(local, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        *grads, loss = mean_over_data([*grads, loss.detach()])
        out["loss"], out["grads"] = float(loss), _np(tree_unflatten(local, grads))
        opt = adamw(LR, fused=True)
        log = CollectiveLog()
        with logging_collectives(log):
            new, _, step_loss = make_train_step(model, opt, compute_dtype=torch.float32)(
                local, opt.init(local), batch)
        out["step_loss"], out["params1"] = float(step_loss), _np(new)
        out["step_counts"] = dict(log.counts)
        jax_grads = shard_tree(params_from_jax(np_grads, device="cpu"), rules, mesh.coords)
        out["adam"] = _np(opt.update(jax_grads, opt.init(local), local)[0])
        v = 256 // rules.model_size
        ce_local = torch.from_numpy(d.ce_logits)[..., mesh.coords["model"] * v:][..., :v]
        out["ce"] = float(sharded_ce(ce_local, torch.from_numpy(d.ce_labels), CE_VOCAB)[0])
        out["tokens"] = _serve(model, local)
        out["gradcheck"] = _gradchecks(rules, cfg)
    if dm == (1, 4):  # the dry run's rank step, run for real
        cell = build_cell("llama3.2-1b", "train_4k", cfg=cfg, device="cpu", mesh=mesh,
                          generator=torch.Generator().manual_seed(0), **CELL)
        log = CollectiveLog()
        with logging_collectives(log):
            cell.step(*cell.args)
        out["cell_counts"] = dict(log.counts)
        out["cell_bytes"] = sum(tensor_bytes(t) for t in tree_leaves(cell.args)
                                if isinstance(t, torch.Tensor))
    return out


# ---------------------------------------------------------------------------
# the references and the runs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    """The JAX package's single-device program on the whole batch."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models.model_zoo import build_model as jax_build_model
    from repro.models.transformer import _masked_ce as jax_masked_ce
    from repro.training.optimizer import adamw as jax_adamw

    cfg = _cfg(jax_get_config)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(_cfg(get_config))
    jm = jax_build_model(cfg, remat="none")
    jp = jm.init(jax.random.PRNGKey(0))
    d = _data()
    tokens = jnp.asarray(d.tokens)
    batch = {"tokens": tokens, "labels": jnp.asarray(d.labels)}
    forward = np.asarray(jm.forward(jp, tokens)[0])
    cache = jm.init_cache(B, S_MAX, dtype=jnp.float32)
    logits, cache = jm.prefill(jp, tokens[:, :T0], cache)
    cached = [np.asarray(logits)]
    for t in range(T0, T0 + 2):
        logits, cache = jm.decode_step(jp, cache, tokens[:, t:t + 1])
        cached.append(np.asarray(logits))
    loss, grads = jax.value_and_grad(lambda p: jm.loss(p, batch)[0])(jp)
    opt = jax_adamw(LR)
    # JAX's float32 train step is this loss, these gradients and this update
    adam = opt.update(grads, opt.init(jp), jp)[0]
    ce = jax_masked_ce(jnp.asarray(d.ce_logits), jnp.asarray(d.ce_labels), CE_VOCAB)[0]
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    params = to_np(jp)
    port = build_model(_cfg(get_config), inner="cuda")
    return types.SimpleNamespace(
        params=params, forward=forward, cached=np.stack(cached), loss=float(loss),
        grads=to_np(grads), adam=to_np(adam),
        ce=float(ce), tokens=_serve(port, params_from_jax(params, device="cpu")))


@pytest.fixture(scope="module")
def pool():
    """One pool of 4 CPU ranks for the file's meshes."""
    with RankPool(4, device="cpu") as p:
        yield p


@pytest.fixture(scope="module")
def runs(ref, pool):
    """mesh -> every rank's results."""
    return {dm: pool.run(_rank, dm[0] * dm[1], (dm, ref.params, ref.grads))
            for dm in MESHES}


@pytest.fixture(scope="module")
def dense_ref():
    pytest.importorskip("jax")
    return {name: fam.reference(name) for name in fam.NAMES}


@pytest.fixture(scope="module")
def dense_runs(dense_ref, pool):
    """(configuration, mesh) -> every rank's results."""
    return fam.run_meshes(pool, dense_ref, MESHES, fsdp=False)


DENSE = [(name, dm) for name in fam.NAMES for dm in MESHES]


@pytest.mark.parametrize("name,dm", DENSE)
def test_dense_family_logits_prefill_and_decode(dense_ref, dense_runs, name, dm):
    fam.check_logits(dense_runs[(name, dm)], dense_ref[name], dm)


@pytest.mark.parametrize("name,dm", DENSE)
def test_dense_family_loss_and_gathered_gradients(dense_ref, dense_runs, name, dm):
    fam.check_grads(dense_runs[(name, dm)], dense_ref[name], dm, fam.rules_of(name, dm, False))


@pytest.mark.parametrize("name,dm", DENSE)
def test_dense_family_adamw_step(dense_ref, dense_runs, name, dm):
    fam.check_adam(dense_runs[(name, dm)], dense_ref[name], dm, fam.rules_of(name, dm, False))


@pytest.mark.parametrize("name,dm", DENSE)
def test_dense_family_shapes_follow_the_rules(dense_ref, dense_runs, name, dm):
    fam.check_shapes(dense_runs[(name, dm)], dense_ref[name], fam.rules_of(name, dm, False),
                     name)


def _rules(dm):
    from repro_torch.launch.mesh import abstract_mesh

    return ShardingRules(abstract_mesh(*dm), _cfg(get_config))


def _like(ref):
    return params_from_jax(ref.params, device="cpu")


def _close(got: dict, want, tol):
    for (a, b) in zip(tree_leaves(got), tree_leaves(params_from_jax(want, device="cpu"))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)


@pytest.mark.parametrize("dm", MESHES)
def test_forward_prefill_and_decode(ref, runs, dm):
    for out in runs[dm]:
        d = out["coords"]["data"]
        bl = B // dm[0]
        rows = slice(d * bl, (d + 1) * bl)
        np.testing.assert_allclose(out["forward"], ref.forward[rows], **TOL)
        np.testing.assert_allclose(out["cached"], ref.cached[:, rows], **TOL)
        assert out["cache_kv_heads"] == 4 // dm[1]


@pytest.mark.parametrize("dm", MESHES)
def test_loss_and_gathered_gradients(ref, runs, dm):
    ranks = runs[dm]
    for out in ranks:
        assert out["loss"] == pytest.approx(ref.loss, rel=1e-4, abs=1e-4)
    grads = gather_tree([tree_map(torch.from_numpy, o["grads"]) for o in ranks],
                        _rules(dm), _like(ref))
    _close(grads, ref.grads, TOL)
    # the data replicas of a model rank hold the same gradients, bitwise
    for out in ranks[dm[1]:]:
        twin = ranks[out["coords"]["model"]]
        for a, b in zip(tree_leaves(out["grads"]), tree_leaves(twin["grads"])):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("dm", MESHES)
def test_adamw_step(ref, runs, dm):
    ranks = runs[dm]
    adam = gather_tree([tree_map(torch.from_numpy, o["adam"]) for o in ranks],
                       _rules(dm), _like(ref))
    _close(adam, ref.adam, ADAM_TOL)
    params = gather_tree([tree_map(torch.from_numpy, o["params1"]) for o in ranks],
                         _rules(dm), _like(ref))
    _close(params, ref.adam, TOL)
    rules = _rules(dm)
    replicated = [all(e is None for e in rules.param_spec(p, leaf.shape))
                  for p, leaf in _flatten_with_paths(_like(ref))]
    assert 0 < sum(replicated) < len(replicated)
    for out in ranks:
        assert out["step_loss"] == pytest.approx(ref.loss, rel=1e-4, abs=1e-4)
        # the replicated leaves (the norms) are bitwise equal on every rank,
        # and a data replica's leaves all are
        twin = ranks[out["coords"]["model"]]
        for rep, a, b, c in zip(replicated, tree_leaves(out["params1"]),
                                tree_leaves(ranks[0]["params1"]),
                                tree_leaves(twin["params1"])):
            assert np.array_equal(a, c)
            if rep:
                assert np.array_equal(a, b)


@pytest.mark.parametrize("dm", MESHES)
def test_vocab_sharded_cross_entropy(ref, runs, dm):
    for out in runs[dm]:
        assert out["ce"] == pytest.approx(ref.ce, rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("dm", MESHES)
def test_collectives_gradcheck_float64(runs, dm):
    for out in runs[dm]:
        assert out["gradcheck"] == {"mlp": True, "gather": True, "embed": True, "ce": True}


@pytest.mark.parametrize("dm", MESHES)
def test_engine_tokens_equal_on_every_rank(ref, runs, dm):
    for out in runs[dm]:
        assert out["tokens"] == ref.tokens


def test_dryrun_rank_step_matches_the_ranks(runs):
    """The dry run's (1, 4) rank step on the reduced train cell: the
    rank's persistent bytes are its shards', and its collective counts
    are what a CPU rank's log read running the same step."""
    cfg = _cfg(get_config)
    cell = build_cell("llama3.2-1b", "train_4k", cfg=cfg, device="meta", mesh=(1, 4), **CELL)
    _, cost = reckon(cell.step, *cell.args)
    rank0 = runs[(1, 4)][0]
    assert cell.persistent_bytes == rank0["cell_bytes"]
    assert cost.collective_counts == rank0["cell_counts"]
    assert set(cost.collective_counts) == {"all-reduce"}  # the loss gathers nothing
    roof = analyze(cost, "llama3.2-1b", "train_4k", cfg, cell.shp, cell.min_bytes,
                   mesh=(1, 4))
    assert roof.chips == 4 and roof.t_collective > 0
    assert roof.collective_bytes == 4 * cost.collective_bytes
    # a ring all-reduce over 4 ranks sends 2·3/4 of its operand one way
    assert cost.collective_link_bytes == pytest.approx(1.5 * cost.collective_bytes)
    assert roof.t_collective == pytest.approx(
        cost.collective_link_bytes / NVLINK_BW)
    # the training step placed the same collectives as its plain run on the ranks
    assert rank0["step_counts"]["all-reduce"] > 0


def test_dryrun_mesh_records(tmp_path):
    """``dryrun --mesh 1x8`` reckons llama3.2-1b's decode cell with a
    collective term over NVLink and skips xlstm-1.3b's with
    ``check_tp``'s reason; the report names the most collective cell; ``--mesh 1x1`` is
    the one-card record, without the mesh's keys."""
    from repro_torch.launch import dryrun, report

    mesh_out, card_out = tmp_path / "mesh.jsonl", tmp_path / "card.jsonl"
    for arch in ("llama3.2-1b", "xlstm-1.3b"):
        dryrun.main(["--arch", arch, "--shape", "decode_32k", "--mesh", "1x8",
                     "--out", str(mesh_out)])
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--out", str(card_out)])
    ok, skipped = [report._records(str(mesh_out))[(a, "decode_32k")]
                   for a in ("llama3.2-1b", "xlstm-1.3b")]
    assert ok["status"] == "ok" and ok["chips"] == 8 and ok["t_collective_s"] > 0
    assert ok["mesh_shape"] == {"data": 1, "model": 8}
    assert ok["collective_counts"] == {"all-reduce": 33, "all-gather": 1}
    assert skipped["status"] == "skipped" and "xLSTM layers" in skipped["reason"]
    assert report.pick_hillclimb_cells(str(mesh_out))["most_collective"][:2] == (
        "llama3.2-1b", "decode_32k")
    card = report._records(str(card_out))[("llama3.2-1b", "decode_32k")]
    assert card["mesh"] == "1xH100" and card["t_collective_s"] == 0.0
    assert "mesh_shape" not in card and "collective_counts" not in card


@pytest.mark.parametrize("kind,n,share", [("all-reduce", 1, 0.0), ("all-reduce", 2, 1.0),
                                          ("all-reduce", 8, 1.75), ("all-gather", 4, 3.0),
                                          ("all-to-all", 4, 0.75), ("all-to-all", 2, 0.5)])
def test_link_bytes_of_a_ring(kind, n, share):
    """What a rank sends one way by a ring: 2(n-1)/n of an all-reduce's
    operand, n-1 times an all-gather's, (n-1)/n of an all-to-all's (the
    blocks bound for the other ranks); ``CollectiveLog`` sums it."""
    assert link_bytes(kind, 1000.0, n) == pytest.approx(1000.0 * share)
    log = CollectiveLog()
    log.add(kind, 1000, n=n)
    log.add(kind, 500, n=n)
    assert log.link_bytes == pytest.approx(1500.0 * share) and log.total_bytes == 1500.0
