"""Port parity, expert parallelism: the mixture of experts under the
sharding rules on gloo CPU ranks (``launch/mesh.py:RankPool``), against
the JAX package's single-device program.

Reduced dbrx-132b (4 experts, top-2, expert width 64, cut to 2 layers)
at (data, model) = (1, 2), (1, 4) and (2, 2), its experts over ``(data,
model)`` (2D expert parallelism, the rule ``launch/specs.py:mesh_rules``
applies: the expert count divides the mesh), and at (2, 2) under FSDP
too; a 6-expert variant at (2, 2), where 6 does not divide 4 and the
experts lie over ``model`` alone, 3 a rank (the 1D form: each data rank
takes half of the capacity's slots); and a variant at capacity factor
0.5 over 160 tokens, where both programs drop pairs, and as many: a
capacity reckoned from a rank's own tokens would drop fewer. Each rank
holds: the forward's logits, a cached prefill and two decode steps
(1e-4), the float32 loss with the load-balance ``aux`` and every
gradient leaf gathered by ``gather_tree`` (1e-4), one AdamW step of its
shards from the JAX gradients' shards (1e-6), ``make_train_step``'s
step equal to the AdamW update of the rank's gradients (the loss within
1e-4), and its expert leaves the rules' shards. A
float64 ``gradcheck`` of the all-to-all, of the rows' gather and
reduce-scatter and of the sum over ``data``, each inside a
replicated-in, replicated-out composition; the planted control (each
expert leaf's gradient averaged over ``data`` as if replicated) fails
the gradient gate; the dry run's rank step at (2, 2) (``build_cell(mesh=)``
over ``meta``) counts the collectives, all-to-alls among them, that a
CPU rank's log read running the same step. One ``RankPool`` runs every
case.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import fsdp as fsdp_mod  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.distributed.fsdp import data_mean  # noqa: E402
from repro_torch.distributed.sharding import ShardingRules, use_rules  # noqa: E402
from repro_torch.distributed.tensor_parallel import (  # noqa: E402
    CollectiveLog,
    all_to_all_data,
    check_tp,
    gather_data_rows,
    gather_tree,
    logging_collectives,
    mean_over_data,
    scatter_data_rows,
    shard_tree,
    sum_over_data,
)
from repro_torch.launch.mesh import RankPool, abstract_mesh, make_mesh  # noqa: E402
from repro_torch.launch.specs import build_cell  # noqa: E402
from repro_torch.launch.step_cost import reckon  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.model_zoo import build_model, make_train_step  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.runtime.checkpoint import _flatten_with_paths  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    adamw,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

torch.set_num_threads(1)
B, T, T0, S_MAX = 4, 40, 32, 48
LR = 1e-2
TOL = dict(atol=1e-4, rtol=1e-4)
ADAM_TOL = dict(atol=1e-6, rtol=1e-6)
#: (variant, mesh, fsdp)
CASES = [("dbrx", (1, 2), False), ("dbrx", (1, 4), False), ("dbrx", (2, 2), False),
         ("dbrx", (2, 2), True), ("dbrx-6e", (2, 2), False), ("dbrx-drop", (2, 2), False)]
IDS = [f"{v}-{d}x{m}" + ("-fsdp" if f else "") for v, (d, m), f in CASES]
#: the dry run's reduced cell at (2, 2)
CELL = dict(batch=4, seq_len=16)


def _cfg(variant: str, getter=get_config):
    cfg = dataclasses.replace(getter("dbrx-132b").reduced(), n_layers=2)
    moe = cfg.moe
    if variant == "dbrx-6e":
        moe = dataclasses.replace(moe, n_experts=6)
    elif variant == "dbrx-drop":
        moe = dataclasses.replace(moe, capacity_factor=0.5)
    return dataclasses.replace(cfg, moe=moe)


def _rules(cfg, mesh, fsdp: bool) -> ShardingRules:
    """2D expert parallelism where the experts divide the mesh, as
    ``launch/specs.py:mesh_rules`` chooses it."""
    n = mesh.shape["data"] * mesh.shape["model"]
    return ShardingRules(mesh, cfg, fsdp=fsdp, expert_parallel_2d=cfg.moe.n_experts % n == 0)


def _data(vocab: int):
    r = np.random.default_rng(0)
    tokens = r.integers(0, vocab, (B, T)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100, np.int32)], 1)
    labels[r.random(labels.shape) < 0.2] = -100  # the data ranks' counts differ
    return types.SimpleNamespace(tokens=tokens, labels=labels)


def _np(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


# ---------------------------------------------------------------------------
# what each rank runs (module-level: pickled by import path)
# ---------------------------------------------------------------------------


class _CopyToData(torch.autograd.Function):
    """Identity forward, the gradient's mean over ``data`` backward (what
    ``mean_over_data`` does to a replicated leaf's): a replicated input's
    gradient whole on every data rank, each rank's loss weighted as the
    training step weights it."""

    @staticmethod
    def forward(ctx, x, rules):
        ctx.rules = rules
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return tp._all_reduce(g, "data", ctx.rules) / ctx.rules.data_size, None


def _gradchecks(rules) -> dict:
    """float64 gradchecks of replicated-in, replicated-out compositions:
    the all-to-all between rank-dependent scalings, and the rows' gather
    and reduce-scatter; each output the mean over ``data`` by
    ``sum_over_data`` (whose backward scales by the data size what the
    input's mean over ``data`` divides back)."""
    n, d = rules.data_size, rules.mesh.coords["data"]
    g = torch.Generator().manual_seed(3)
    x = torch.randn(n, 3, 2, generator=g, dtype=torch.float64, requires_grad=True)
    rows = torch.randn(2 * n, 3, generator=g, dtype=torch.float64, requires_grad=True)

    def a2a(x):
        recv = all_to_all_data(_CopyToData.apply(x, rules) * (d + 1.0))
        return sum_over_data(recv * (d + 2.0)) / n

    def gather_scatter(x):
        mine = _CopyToData.apply(x, rules)[2 * d:2 * d + 2] * (d + 1.0)
        summed = scatter_data_rows(gather_data_rows(mine) * (d + 3.0))
        return sum_over_data(summed) / n

    return {"all-to-all": bool(torch.autograd.gradcheck(a2a, (x,))),
            "gather-scatter": bool(torch.autograd.gradcheck(gather_scatter, (rows,)))}


def _drops(record: list):
    """``moe.dispatch_maps`` wrapped: each call's dropped pairs (those at
    the sentinel slot ``E·C``) appended to ``record``."""
    inner = moe_mod.dispatch_maps

    def counted(expert_ids, n_experts, cap):
        slot_pair, pair_slot = inner(expert_ids, n_experts, cap)
        record.append(int((pair_slot == slot_pair.numel()).sum()))
        return slot_pair, pair_slot

    return inner, counted


def _rank(rank, variant, dm, fsdp, np_params, np_grads):
    cfg = _cfg(variant)
    d = _data(cfg.vocab_size)
    model = build_model(cfg, inner="cuda")
    full = params_from_jax(np_params, device="cpu")
    mesh = make_mesh(*dm)
    rules = _rules(cfg, mesh, fsdp)
    check_tp(cfg, rules)
    local = shard_tree(full, rules, mesh.coords)
    bl = B // dm[0]
    rows = slice(mesh.coords["data"] * bl, (mesh.coords["data"] + 1) * bl)
    tokens = torch.from_numpy(d.tokens[rows]).long()
    batch = {"tokens": tokens, "labels": torch.from_numpy(d.labels[rows]).long()}
    out = {"coords": dict(mesh.coords),
           "leaf_shapes": {p: tuple(t.shape) for p, t in _flatten_with_paths(local)}}
    with use_rules(rules):
        drops = []
        inner, counted = _drops(drops)
        moe_mod.dispatch_maps = counted
        try:
            with torch.no_grad():
                out["forward"] = model.forward(local, tokens)[0].numpy()
        finally:
            moe_mod.dispatch_maps = inner
        out["drops"] = drops
        with torch.no_grad():
            cache = model.init_cache(bl, S_MAX, dtype=torch.float32, device="cpu")
            logits, cache = model.prefill(local, tokens[:, :T0], cache)
            cached = [logits]
            for t in range(T0, T0 + 2):
                logits, cache = model.decode_step(local, cache, tokens[:, t:t + 1])
                cached.append(logits)
            out["cached"] = torch.stack(cached).numpy()
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(local)]
        loss, metrics = model.loss(tree_unflatten(local, leaves), batch)
        raw = list(torch.autograd.grad(loss, leaves))
        grads = data_mean(model, local, raw)
        out["loss"] = float(mean_over_data([loss.detach()])[0])
        out["aux"] = float(metrics["aux"].detach())
        out["grads"] = _np(tree_unflatten(local, grads))
        # the planted control: the expert leaves averaged over data as if
        # each data rank held the same experts
        experts = fsdp_mod.expert_leaves
        fsdp_mod.expert_leaves = lambda model: frozenset()
        try:
            out["control"] = _np(tree_unflatten(local, data_mean(model, local, raw)))
        finally:
            fsdp_mod.expert_leaves = experts
        opt = adamw(LR, fused=True)
        jax_grads = shard_tree(params_from_jax(np_grads, device="cpu"), rules, mesh.coords)
        out["adam"] = _np(opt.update(jax_grads, opt.init(local), local)[0])
        out["own_adam"] = _np(opt.update(tree_unflatten(local, grads), opt.init(local),
                                         local)[0])
        log = CollectiveLog()
        with logging_collectives(log):
            new, _, step_loss = make_train_step(model, opt, compute_dtype=torch.float32)(
                local, opt.init(local), batch)
        out["step_loss"], out["params1"] = float(step_loss), _np(new)
        out["step_counts"] = dict(log.counts)
        out["gradcheck"] = _gradchecks(rules) if dm[0] > 1 else {}
    if variant == "dbrx" and dm == (2, 2) and not fsdp:  # the dry run's rank step, run for real
        cell = build_cell("dbrx-132b", "train_4k", cfg=cfg, device="cpu", mesh=mesh,
                          generator=torch.Generator().manual_seed(0), **CELL)
        log = CollectiveLog()
        with logging_collectives(log):
            cell.step(*cell.args)
        out["cell_counts"] = dict(log.counts)
        out["cell_bytes"] = dict(log.bytes)
    return out


# ---------------------------------------------------------------------------
# the references and the runs
# ---------------------------------------------------------------------------


def _jax_reference(variant: str):
    """The JAX package's single-device program on the whole batch, and
    the pairs its forward's MoE layers dropped (a ``jax.debug.callback``
    on each layer's expert ids)."""
    import jax
    import jax.numpy as jnp

    import repro.models.moe as jax_moe
    from repro.configs import get_config as jax_get_config
    from repro.models.model_zoo import build_model as jax_build_model
    from repro.training.optimizer import adamw as jax_adamw

    cfg = _cfg(variant, jax_get_config)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(_cfg(variant))
    jm = jax_build_model(cfg, remat="none")
    jp = jm.init(jax.random.PRNGKey(0))
    d = _data(cfg.vocab_size)
    tokens = jnp.asarray(d.tokens)
    ids = []
    inner = jax_moe._sorted_combine

    def recorded(p, toks, gate_vals, expert_ids, m, expert_spec=None):
        jax.debug.callback(lambda a: ids.append(np.asarray(a)), expert_ids)
        return inner(p, toks, gate_vals, expert_ids, m, expert_spec)

    jax_moe._sorted_combine = recorded
    try:
        forward = np.asarray(jm.forward(jp, tokens)[0])
        jax.effects_barrier()
    finally:
        jax_moe._sorted_combine = inner
    m = cfg.moe
    drops = [int(np.maximum(np.bincount(a.reshape(-1), minlength=m.n_experts)
                            - moe_mod.capacity(a.shape[0], m), 0).sum()) for a in ids]
    cache = jm.init_cache(B, S_MAX, dtype=jnp.float32)
    logits, cache = jm.prefill(jp, tokens[:, :T0], cache)
    cached = [np.asarray(logits)]
    for t in range(T0, T0 + 2):
        logits, cache = jm.decode_step(jp, cache, tokens[:, t:t + 1])
        cached.append(np.asarray(logits))
    batch = {"tokens": tokens, "labels": jnp.asarray(d.labels)}
    (loss, metrics), grads = jax.value_and_grad(lambda p: jm.loss(p, batch), has_aux=True)(jp)
    adam = jax_adamw(LR).update(grads, jax_adamw(LR).init(jp), jp)[0]
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return types.SimpleNamespace(params=to_np(jp), forward=forward, cached=np.stack(cached),
                                 loss=float(loss), aux=float(metrics["aux"]),
                                 grads=to_np(grads), adam=to_np(adam), drops=drops)


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    return {v: _jax_reference(v) for v in dict.fromkeys(v for v, _, _ in CASES)}


@pytest.fixture(scope="module")
def runs(ref):
    """(variant, mesh, fsdp) -> every rank's results, on one pool of 4 CPU
    ranks."""
    with RankPool(4, device="cpu") as pool:
        return {(v, dm, f): pool.run(_rank, dm[0] * dm[1],
                                     (v, dm, f, ref[v].params, ref[v].grads))
                for v, dm, f in CASES}


def _like(r):
    return params_from_jax(r.params, device="cpu")


def _gathered(ranks, key, rules, r):
    return gather_tree([tree_map(torch.from_numpy, o[key]) for o in ranks], rules, _like(r))


def _close(got, want, tol):
    for a, b in zip(tree_leaves(got), tree_leaves(params_from_jax(want, device="cpu"))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)


def _abstract_rules(variant, dm, fsdp):
    return _rules(_cfg(variant), abstract_mesh(*dm), fsdp)


@pytest.mark.parametrize("variant,dm,fsdp", CASES, ids=IDS)
def test_logits_prefill_and_decode(ref, runs, variant, dm, fsdp):
    r = ref[variant]
    for out in runs[(variant, dm, fsdp)]:
        bl = B // dm[0]
        rows = slice(out["coords"]["data"] * bl, (out["coords"]["data"] + 1) * bl)
        np.testing.assert_allclose(out["forward"], r.forward[rows], **TOL)
        np.testing.assert_allclose(out["cached"], r.cached[:, rows], **TOL)


@pytest.mark.parametrize("variant,dm,fsdp", CASES, ids=IDS)
def test_loss_with_aux_and_gathered_gradients(ref, runs, variant, dm, fsdp):
    r = ref[variant]
    ranks = runs[(variant, dm, fsdp)]
    assert r.aux > 0
    for out in ranks:
        assert out["loss"] == pytest.approx(r.loss, rel=1e-4, abs=1e-4)
        assert out["aux"] == pytest.approx(r.aux, rel=1e-4, abs=1e-4)
    _close(_gathered(ranks, "grads", _abstract_rules(variant, dm, fsdp), r), r.grads, TOL)


@pytest.mark.parametrize("variant,dm,fsdp", CASES, ids=IDS)
def test_adamw_step(ref, runs, variant, dm, fsdp):
    r = ref[variant]
    ranks = runs[(variant, dm, fsdp)]
    rules = _abstract_rules(variant, dm, fsdp)
    _close(_gathered(ranks, "adam", rules, r), r.adam, ADAM_TOL)
    for out in ranks:
        # the training step: the gradients above, their mean, one AdamW update
        assert out["step_loss"] == pytest.approx(r.loss, rel=1e-4, abs=1e-4)
        for a, b in zip(tree_leaves(out["params1"]), tree_leaves(out["own_adam"])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant,dm,fsdp", CASES, ids=IDS)
def test_expert_leaves_are_the_rules_shards(ref, runs, variant, dm, fsdp):
    """Every leaf is its ``param_spec`` shard; the experts lie over
    ``(data, model)`` where 2D expert parallelism applies (a rank's own
    block, never gathered under FSDP), over ``model`` alone in the 1D
    form."""
    rules = _abstract_rules(variant, dm, fsdp)
    shape = dict(rules.mesh.shape)
    cfg = _cfg(variant)
    n_blocks = 1
    for path, leaf in _flatten_with_paths(_like(ref[variant])):
        spec = rules.param_spec(path, tuple(leaf.shape))
        want = list(leaf.shape)
        for dim, entry in enumerate(spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    want[dim] //= shape[a]
        for out in runs[(variant, dm, fsdp)]:
            assert out["leaf_shapes"][path] == tuple(want), path
        if path.endswith("we_gate"):
            n_blocks = leaf.shape[-3] // want[-3]
            assert spec[-3] == (("data", "model") if variant != "dbrx-6e" else "model")
    assert n_blocks == (dm[1] if variant == "dbrx-6e" else dm[0] * dm[1])
    assert cfg.moe.n_experts // n_blocks == (3 if variant == "dbrx-6e" else 4 // (dm[0] * dm[1]))


def test_capacity_drops_equal_in_both_programs(ref, runs):
    """At capacity factor 0.5 over 160 tokens both programs drop pairs in
    each MoE layer, and as many: the capacity is the whole batch's."""
    want = ref["dbrx-drop"].drops
    assert len(want) == 2 and min(want) > 0
    for out in runs[("dbrx-drop", (2, 2), False)]:
        assert out["drops"] == want
    # a capacity reckoned from one data rank's 80 tokens drops fewer
    m = _cfg("dbrx-drop").moe
    assert moe_mod.capacity(B * T // 2, m) * 2 > moe_mod.capacity(B * T, m)


@pytest.mark.parametrize("variant,dm,fsdp", [c for c in CASES if c[1][0] > 1],
                         ids=[i for i, c in zip(IDS, CASES) if c[1][0] > 1])
def test_data_collectives_gradcheck_float64(runs, variant, dm, fsdp):
    for out in runs[(variant, dm, fsdp)]:
        assert out["gradcheck"] == {"all-to-all": True, "gather-scatter": True}


@pytest.mark.parametrize("variant,fsdp", [("dbrx", False), ("dbrx", True)])
def test_planted_control_fails_the_gradient_gate(ref, runs, variant, fsdp):
    """Averaging the expert leaves' gradients over ``data``, as if each
    data rank held the same experts, mixes two experts' gradients: the
    gathered expert gradients then part from JAX's far beyond 1e-4, and
    no other leaf moves."""
    r = ref[variant]
    ranks = runs[(variant, (2, 2), fsdp)]
    rules = _abstract_rules(variant, (2, 2), fsdp)
    got = _gathered(ranks, "control", rules, r)
    want = params_from_jax(r.grads, device="cpu")
    worst = {}
    for (path, a), b in zip(_flatten_with_paths(got), tree_leaves(want)):
        worst[path] = float((a - b).norm() / b.norm())
    experts = {p: v for p, v in worst.items() if p.split("/")[-1].startswith("we_")}
    assert len(experts) == 3 and min(experts.values()) > 0.1
    assert max(v for p, v in worst.items() if p not in experts) < 1e-4


def test_dryrun_rank_step_counts_the_all_to_alls(runs):
    """The dry run's (2, 2) rank step on the reduced dbrx train cell counts
    the collectives a CPU rank's log read running the same step, the
    all-to-alls among them (12: a layer's dispatch and combine, forward,
    recomputed and backward, over 2 layers), each at (n-1)/n of its
    operand over a ring."""
    cfg = _cfg("dbrx")
    cell = build_cell("dbrx-132b", "train_4k", cfg=cfg, device="meta", mesh=(2, 2), **CELL)
    _, cost = reckon(cell.step, *cell.args)
    rank0 = runs[("dbrx", (2, 2), False)][0]
    assert cost.collective_counts == rank0["cell_counts"]
    assert cost.collective_detail == rank0["cell_bytes"]
    assert cost.collective_counts["all-to-all"] == 12
    assert cell.knobs["ep2d"] is False and cell.microbatches == 1
    log = CollectiveLog()
    log.add("all-to-all", cost.collective_detail["all-to-all"], n=2)
    assert log.link_bytes == pytest.approx(0.5 * cost.collective_detail["all-to-all"])
