"""Port parity, the mixture of experts and the MoE family end to end.

``repro_torch.models.moe`` against ``repro/models/moe.py``: ``moe_apply``
(sorted and dense) with one set of weights carried over by
``params_from_jax``, its output, aux loss and the gradients of x, the
router, the experts and the shared expert; sorted equal to dense; the
same tokens dropped at the capacity limit; ties broken as
``jax.lax.top_k`` breaks them; and a dispatch and combine that reach no
accumulating scatter and repeat bitwise. Then dbrx-132b and
deepseek-v3-671b at ``.reduced()`` with the JAX package's weights:
``forward``, ``prefill`` and three greedy ``decode_step``s, ``loss`` with
its ``ce``, ``aux`` and ``mtp`` metrics and every leaf's gradient, three
AdamW steps, and ``python -m repro_torch.launch.train``. MLA and the
deepseek serving engine are in ``test_torch_mla.py``.

Tolerances: 1e-4 (absolute and relative) in float32, the JAX suite's; in
bfloat16 (against the JAX steps compiled to round every op, with the
port's silu and routing replayed as JAX rounds and routes them),
``test_torch_lm_train.py``'s: the losses within 1e-2 relative and a
parameter leaf's distance from the JAX one within 0.2 of the JAX steps'
own change (each leaf on dbrx, the whole tree on deepseek), and each
leaf's first gradient nearer JAX's bfloat16 gradient than half the way
to its float32 one. The one test that needs the card is marked ``cuda``
and skips here."""
import contextlib
import dataclasses
import io
import types
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import _torch_lm_family as fam_checks  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import LMConfig, MoEConfig  # noqa: E402
from repro_torch.kernels.fused_adam import CAPACITY, fused_adam  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model_zoo import (  # noqa: E402
    build_model,
    make_dummy_batch,
    make_eval_step,
    make_train_step,
)
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.training import schedule as tsched  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    adamw,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_LOSS_RTOL, BF16_PARAM_REL, BF16_GRAD_REL = 1e-2, 0.2, 0.5
#: the JAX steps' compile: every bfloat16 op rounded as its dtype says, as
#: the port's ops are (XLA's default excess precision keeps fused
#: intermediates in float32)
EXACT = {"xla_allow_excess_precision": False}
LR, WARMUP, STEPS = 1e-2, 2, 3
ARCHS = ("dbrx-132b", "deepseek-v3-671b")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.configs.base import LMConfig as JLMConfig
    from repro.configs.base import MoEConfig as JMoEConfig
    from repro.models import moe as jmoe
    from repro.models.model_zoo import build_model as jax_build_model
    from repro.models.model_zoo import make_train_step as jax_make_train_step
    from repro.training import schedule as jsched
    from repro.training.optimizer import adamw as jax_adamw

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=jax_get_config, LMConfig=JLMConfig,
        MoEConfig=JMoEConfig, moe=jmoe, build_model=jax_build_model,
        make_train_step=jax_make_train_step, sched=jsched, adamw=jax_adamw)


def _moe_cfg(cls, moe_cls, impl="sorted", n_experts=8, k=2, shared=1, cf=1.25):
    return cls(name="t", family="moe", n_layers=1, d_model=32, n_heads=4,
               n_kv_heads=4, d_ff=64, vocab_size=128,
               moe=moe_cls(n_experts=n_experts, n_experts_per_token=k,
                           n_shared_experts=shared, d_ff_expert=16,
                           capacity_factor=cf, impl=impl))


def _both_cfgs(jx, **kw):
    cfg = _moe_cfg(LMConfig, MoEConfig, **kw)
    jcfg = _moe_cfg(jx.LMConfig, jx.MoEConfig, **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg


def _weights(jx, jcfg, seed=0, router_shift=None):
    jp = jx.moe.moe_init(jx.jax.random.PRNGKey(seed), jcfg)
    if router_shift is not None:  # skew the routing towards some experts
        jp = dict(jp, router=jp["router"] + jx.jnp.asarray(router_shift, jx.jnp.float32))
    return jp, params_from_jax(jx.jax.device_get(jp), device="cpu")


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _skewed(jx, jcfg, shape):
    """Weights whose router sends every token of ``_x(shape) + 0.5`` (rows
    summing to about 16) to expert 0 first, and those inputs: at 96 tokens
    and capacity factor 0.25 (64 slots an expert) expert 0 drops 32."""
    shift = np.zeros(jcfg.moe.n_experts, np.float32)
    shift[0] = 1.0
    jp, tp = _weights(jx, jcfg, router_shift=shift)
    return jp, tp, _x(shape) + np.float32(0.5)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [4.0, 0.25], ids=["cf4", "cf0.25"])
@pytest.mark.parametrize("impl", ["sorted", "dense"])
def test_moe_apply_and_grads_match_jax(jx, impl, cf):
    """Out, aux, and the gradients of x, the router, the experts and the
    shared expert of ``sum(out · c) + 3 · aux`` (a random cotangent c).
    96 tokens (192 pairs) all routed to expert 0 first: at capacity
    factor 4 (96 slots an expert) nothing is dropped; at 0.25 (64 slots)
    the sorted path drops 32 of expert 0's pairs."""
    cfg, jcfg = _both_cfgs(jx, impl=impl, cf=cf)
    jp, tp, x = _skewed(jx, jcfg, (2, 48, 32))
    c = _x((2, 48, 32), seed=2)

    def jfn(p, xx):
        out, aux = jx.moe.moe_apply(p, jcfg, xx)
        return (out * c).sum() + 3.0 * aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jx.jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(jp, jx.jnp.asarray(x))
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.moe_apply(tree_unflatten(tp, leaves), cfg, xt)
    grads = torch.autograd.grad((out * torch.from_numpy(c)).sum() + 3.0 * aux,
                                [xt, *leaves])
    _close(out, jout)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), **TOL)
    _close(grads[0], jgx)
    jleaves = jx.jax.tree_util.tree_leaves(jgp)
    assert len(jleaves) == len(leaves) == 7  # router, 3 experts, 3 shared
    for g, jg in zip(grads[1:], jleaves):
        _close(g, jg)
    ids = tmoe.route(torch.softmax(xt.detach().reshape(96, 32) @ tp["router"], -1), 2)[1]
    assert (ids[:, 0] == 0).all()
    cap = tmoe.capacity(96, cfg.moe)
    _, pair_slot = tmoe.dispatch_maps(ids, 8, cap)
    assert int((pair_slot == 8 * cap).sum()) == (32 if cf == 0.25 else 0)


def test_moe_sorted_equals_dense(jx):
    """The JAX suite's ``test_moe_sorted_equals_dense`` inside the port: at
    capacity factor 4 nothing is dropped, and the two paths agree."""
    cfg, jcfg = _both_cfgs(jx, impl="sorted", cf=4.0)
    _, tp = _weights(jx, jcfg)
    x = torch.from_numpy(_x((2, 12, 32)))
    out_s, aux_s = tmoe.moe_apply(tp, cfg, x)
    dense = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="dense"))
    out_d, aux_d = tmoe.moe_apply(tp, dense, x)
    torch.testing.assert_close(out_s, out_d, **TOL)
    torch.testing.assert_close(aux_s, aux_d, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n_tok", [16, 100])
def test_capacity_limit_drops_the_tokens_jax_drops(jx, n_tok):
    """Two experts, top-2 (every token goes to both), capacity factor
    0.25: at 16 tokens the floor of ``min(n_tok · k, 64)`` slots keeps
    every pair; at 100 tokens each expert keeps 64, the first 64 tokens in
    the stable sort's order, and tokens 64-99 lose both experts (their
    output is the shared expert's alone). The same output as JAX's."""
    cfg, jcfg = _both_cfgs(jx, n_experts=2, k=2, cf=0.25)
    jp, tp = _weights(jx, jcfg)
    x = _x((1, n_tok, 32), seed=3)
    jout, _ = jx.moe.moe_apply(jp, jcfg, jx.jnp.asarray(x))
    out, _ = tmoe.moe_apply(tp, cfg, torch.from_numpy(x))
    _close(out, jout)
    cap = tmoe.capacity(n_tok, cfg.moe)
    ids = torch.tensor([[0, 1]] * n_tok)
    slot_pair, pair_slot = tmoe.dispatch_maps(ids, 2, cap)
    dropped = (pair_slot == 2 * cap).reshape(n_tok, 2).all(1)
    assert cap == (32 if n_tok == 16 else 64)
    assert dropped.tolist() == [t >= 64 for t in range(n_tok)]
    s = tp["shared"]
    xt = torch.from_numpy(x[0])
    shared = (torch.nn.functional.silu(xt @ s["w_gate"]) * (xt @ s["w_up"])) @ s["w_down"]
    torch.testing.assert_close(out[0, dropped], shared[dropped], rtol=0, atol=1e-6)
    # the maps are each other's inverse on the kept pairs
    kept = pair_slot < 2 * cap
    assert torch.equal(slot_pair[pair_slot[kept]], torch.arange(2 * n_tok)[kept])


def test_route_breaks_ties_as_lax_top_k(jx):
    """bfloat16 router logits with exact ties (router columns 1 and 5, 2
    and 6 equal, and logits rounded to a few values): ``route`` picks the
    lower expert first, as ``lax.top_k``; ``moe_apply`` at bfloat16
    routes every token to the experts JAX routes it to."""
    r = np.random.default_rng(4)
    probs = np.round(r.random((64, 8)) * 4) / 4  # values in {0, .25, .5, .75, 1}
    jv, ji = jx.jax.lax.top_k(jx.jnp.asarray(probs, jx.jnp.float32), 3)
    tv, ti = tmoe.route(torch.from_numpy(probs).float(), 3)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy(), np.asarray(jv))

    cfg, jcfg = _both_cfgs(jx, k=2, shared=0)
    jp, _ = _weights(jx, jcfg)
    router = np.asarray(jp["router"]).copy()
    router[:, 5], router[:, 6] = router[:, 1], router[:, 2]
    jp = {k: v.astype(jx.jnp.bfloat16) for k, v in dict(jp, router=router).items()}
    tp = {k: torch.from_numpy(np.array(v.astype(jx.jnp.float32))).to(torch.bfloat16)
          for k, v in jp.items()}
    x = _x((2, 24, 32), seed=5)
    seen = {}

    def spy(route):
        def wrapped(p, k):
            out = route(p, k)
            seen.setdefault("ids", []).append(np.asarray(out[1]))
            return out
        return wrapped

    orig = jx.jax.lax.top_k
    jx.moe.jax.lax.top_k = spy(orig)
    try:
        jout, _ = jx.moe.moe_apply(jp, jcfg, jx.jnp.asarray(x).astype(jx.jnp.bfloat16))
    finally:
        jx.moe.jax.lax.top_k = orig
    want = seen.pop("ids")[0]
    troute = tmoe.route
    tmoe.route = spy(troute)
    try:
        out, _ = tmoe.moe_apply(tp, cfg, torch.from_numpy(x).to(torch.bfloat16))
    finally:
        tmoe.route = troute
    got = seen["ids"][0]
    assert np.array_equal(got, want)
    # tokens where a tied pair straddles the top-2 boundary took the lower
    straddles = 0
    for lo, hi in ((1, 5), (2, 6)):
        one = (got == lo).any(1) ^ (got == hi).any(1)
        straddles += int(one.sum())
        assert not (one & (got == hi).any(1)).any()
    assert straddles > 0
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout.astype(jx.jnp.float32)),
                               atol=5e-2, rtol=5e-2)


#: the aten ops that sum in an order CUDA does not fix (``index_put_`` only
#: with ``accumulate=True``)
ACCUMULATING = {"index_add", "index_add_", "scatter_add", "scatter_add_",
                "scatter_reduce", "scatter_reduce_", "put_", "embedding_dense_backward"}


class _OpLog(TorchDispatchMode):
    """Every aten op a region runs, forward and autograd's backward alike."""

    def __init__(self):
        super().__init__()
        self.accumulating = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        accumulate = name in ("index_put", "index_put_", "_index_put_impl_") and (
            kwargs.get("accumulate", args[3] if len(args) > 3 else False))
        if name in ACCUMULATING or accumulate:
            self.accumulating.append(name)
        return func(*args, **kwargs)


def _moe_step(tp, cfg, x, c):
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    xt = x.clone().requires_grad_(True)
    out, aux = tmoe.moe_apply(tree_unflatten(tp, leaves), cfg, xt)
    grads = torch.autograd.grad((out * c).sum() + aux, [xt, *leaves])
    return [out, aux, *grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_and_combine_are_gathers(jx, dtype):
    """The sorted path's forward and backward (at capacity 0.25, so pairs
    are dropped) run no accumulating scatter, and two runs are bitwise
    equal. The op log sees autograd's own ops: plain indexing's backward,
    an ``index_put_(accumulate=True)``, is caught."""
    cfg, jcfg = _both_cfgs(jx, cf=0.25)
    _, tp, x = _skewed(jx, jcfg, (2, 48, 32))
    dt = getattr(torch, dtype)
    tp = tree_map(lambda v: v.to(dt), tp)
    x = torch.from_numpy(x).to(dt)
    c = torch.from_numpy(_x((2, 48, 32), seed=6)).to(dt)
    with _OpLog() as log:
        first = _moe_step(tp, cfg, x, c)
    assert log.accumulating == []
    again = _moe_step(tp, cfg, x, c)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    with _OpLog() as control:
        w = torch.ones(5, 3, requires_grad=True)
        torch.autograd.grad(w[torch.tensor([0, 2, 2])].sum(), w)
    assert control.accumulating


# ---------------------------------------------------------------------------
# dbrx-132b and deepseek-v3-671b, reduced, end to end
# ---------------------------------------------------------------------------

def _batch(cfg, t, seed=0):
    r = np.random.default_rng(seed)
    tokens = r.integers(0, cfg.vocab_size, (4, t)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((4, 1), -100, np.int32)], 1)
    labels[r.random(labels.shape) < 0.1] = -100
    return {"tokens": tokens, "labels": labels}


@pytest.fixture(scope="module", params=ARCHS)
def lm(request, jx):
    """One reduced configuration in both packages with one set of weights,
    and the JAX package's jitted train steps (by compute dtype), each run
    once and kept."""
    arch = request.param
    cfg, jcfg = get_config(arch).reduced(), jx.get_config(arch).reduced()
    jmodel = jx.build_model(jcfg, remat="none")
    jparams = jmodel.init(jx.jax.random.PRNGKey(0))
    batch = _batch(cfg, 16)
    jbatch = {k: jx.jnp.asarray(v) for k, v in batch.items()}
    cache = {}

    def jax_steps(dtype: str):
        """(losses, parameters after the last step, every MoE call's
        expert ids in call order) of STEPS JAX steps, compiled with
        ``EXACT``."""
        if dtype not in cache:
            opt = jx.adamw(jx.sched.warmup_cosine(LR, WARMUP, STEPS))
            routed = []
            with _jax_routing(jx, routed):
                step = jx.jax.jit(jx.make_train_step(
                    jmodel, opt, compute_dtype=getattr(jx.jnp, dtype)),
                    compiler_options=EXACT)
                p, s, losses = jparams, opt.init(jparams), []
                for _ in range(STEPS):
                    p, s, loss = step(p, s, jbatch)
                    losses.append(float(loss))
            jx.jax.effects_barrier()
            cache[dtype] = (losses, [np.asarray(a) for a in jx.jax.tree_util.tree_leaves(p)],
                            routed)
        return cache[dtype]

    def jax_grads(dtype: str):
        """(every leaf's gradient of the loss at the initial weights, each
        leaf cast to ``dtype`` as ``make_train_step`` casts it, and the
        MoE calls' expert ids), compiled with ``EXACT``."""
        key = ("grads", dtype)
        if key not in cache:
            dt = getattr(jx.jnp, dtype)
            routed = []
            with _jax_routing(jx, routed):
                grads = jx.jax.jit(jx.jax.grad(lambda p: jmodel.loss(
                    jx.jax.tree_util.tree_map(lambda a: a.astype(dt), p), jbatch)[0]),
                    compiler_options=EXACT)(jparams)
            jx.jax.effects_barrier()
            cache[key] = ([np.asarray(g) for g in jx.jax.tree_util.tree_leaves(grads)], routed)
        return cache[key]

    return types.SimpleNamespace(
        arch=arch, cfg=cfg, jmodel=jmodel, jparams=jparams, batch=batch, jbatch=jbatch,
        jax_steps=jax_steps, jax_grads=jax_grads, model=build_model(cfg),
        tparams=params_from_jax(jx.jax.device_get(jparams), device="cpu"),
        tbatch={k: torch.from_numpy(v).long() for k, v in batch.items()})


def test_forward_prefill_and_decode_match_jax(jx, lm):
    """``forward`` (logits, aux, hidden), ``prefill`` and three greedy
    ``decode_step``s within 1e-4 of JAX's, the caches float32. Both
    packages see the same [B, T] at every call (capacity counts the
    batch's tokens, so decode is compared with decode, not with
    forward)."""
    cfg, jnp = lm.cfg, jx.jnp
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jlog, jaux, _, jhid = lm.jmodel.forward(lm.jparams, jnp.asarray(toks))
    tlog, aux, _, thid = lm.model.forward(lm.tparams, torch.from_numpy(toks).long())
    _close(tlog, jlog)
    _close(thid, jhid)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert float(aux) > 0
    jcache = lm.jmodel.init_cache(2, 16, dtype=jnp.float32)
    tcache = lm.model.init_cache(2, 16, dtype=torch.float32, device="cpu")
    jl, jcache = lm.jmodel.prefill(lm.jparams, jnp.asarray(toks), jcache)
    tl, tcache = lm.model.prefill(lm.tparams, torch.from_numpy(toks).long(), tcache)
    _close(tl, jl)
    for step in range(3):
        cur = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        assert np.array_equal(cur[:, 0], torch.argmax(tl, -1).numpy())
        jl, jcache = lm.jmodel.decode_step(lm.jparams, jcache, jnp.asarray(cur))
        tl, tcache = lm.model.decode_step(lm.tparams, tcache, torch.from_numpy(cur).long())
        _close(tl, jl)
        assert tcache["idx"] == int(jcache["idx"]) == 10 + step


def test_loss_metrics_and_grads_match_jax(jx, lm):
    """``LM.loss`` (remat="layer") and its metrics, ``mtp`` on deepseek
    (``mtp_depth`` 1), and the gradient of every leaf against
    ``jax.value_and_grad``; the eval step is the same loss."""
    (jloss, jmet), jgrads = jx.jax.jit(jx.jax.value_and_grad(
        lambda p: lm.jmodel.loss(p, lm.jbatch), has_aux=True))(lm.jparams)
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(lm.tparams)]
    loss, met = build_model(lm.cfg, remat="layer").loss(
        tree_unflatten(lm.tparams, leaves), lm.tbatch)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    assert set(met) == set(jmet) == ({"ce", "aux", "denom", "mtp"} if lm.cfg.mtp_depth
                                     else {"ce", "aux", "denom"})
    for key in met:
        np.testing.assert_allclose(float(met[key].detach()), float(jmet[key]), **TOL)
    jleaves = jx.jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, jg in zip(grads, jleaves):
        assert tuple(g.shape) == jg.shape
        _close(g, jg)
    eval_loss, _ = make_eval_step(lm.model)(lm.tparams, lm.tbatch)
    np.testing.assert_allclose(float(eval_loss), float(jloss), **TOL)


def test_remat_changes_nothing(lm):
    """``remat="layer"`` (dbrx's scanned segment recomputed, aux and all)
    and ``"none"``: the same loss and gradients, bitwise."""
    out = []
    for remat in ("layer", "none"):
        leaves = [p.clone().requires_grad_(True) for p in tree_leaves(lm.tparams)]
        loss, _ = build_model(lm.cfg, remat=remat).loss(
            tree_unflatten(lm.tparams, leaves), lm.tbatch)
        out.append([loss, *torch.autograd.grad(loss, leaves)])
    assert all(torch.equal(a, b) for a, b in zip(*out))


@contextlib.contextmanager
def _jax_routing(jx, log: list):
    """Within the block, every ``lax.top_k`` the JAX package traces (the
    MoE router's, in ``moe_apply``) appends its (expert ids, router
    probabilities) to ``log`` as the compiled program runs, in call order
    (an ordered host callback)."""
    top_k = jx.jax.lax.top_k

    def recorded(probs, k):
        vals, ids = top_k(probs, k)
        jx.jax.debug.callback(lambda i, p: log.append((np.asarray(i), np.asarray(p))),
                              ids, probs, ordered=True)
        return vals, ids

    jx.jax.lax.top_k = recorded
    try:
        yield
    finally:
        jx.jax.lax.top_k = top_k


@contextlib.contextmanager
def _replayed_routing(jx_routed: list, parted: list):
    """Within the block, each ``moe.route`` call takes the JAX package's
    expert ids of the same call at the tokens where the two part (the
    gates the port's probabilities at those experts), and records for each
    such token the port's own top-k margin ``p_k - p_(k+1)`` and twice the
    largest difference of the two packages' probabilities there, the most
    by which rounding can have moved two experts past each other: the
    analog, for routing, of ``chip_smoke.py``'s decided ReLU masks."""
    route = tmoe.route
    calls = iter(jx_routed)

    def replayed(probs, k):
        vals, ids = route(probs, k)
        jids, jprobs = next(calls)
        want = torch.from_numpy(np.array(jids)).to(ids)
        differ = (ids.sort(1).values != want.sort(1).values).any(1)
        if differ.any():
            top = torch.sort(probs, dim=-1, descending=True).values
            moved = 2 * (probs - torch.from_numpy(np.array(jprobs))).abs().max(1).values
            parted.extend(zip((top[:, k - 1] - top[:, k])[differ].tolist(),
                              moved[differ].tolist()))
            vals, ids = probs.gather(1, want), want
        return vals, ids

    tmoe.route = replayed
    try:
        yield
    finally:
        tmoe.route = route
    assert next(calls, None) is None, "the port made fewer MoE calls than JAX"


def _port_steps(lm, dtype, remat="layer"):
    opt = adamw(tsched.warmup_cosine(LR, WARMUP, STEPS), fused=True)
    step = make_train_step(build_model(lm.cfg, remat=remat), opt,
                           compute_dtype=getattr(torch, dtype))
    p, s, losses = lm.tparams, opt.init(lm.tparams), []
    for _ in range(STEPS):
        p, s, loss = step(p, s, lm.tbatch)
        losses.append(float(loss))
    return losses, p


def _port_grads(lm, dtype):
    """Every leaf's gradient of the loss at the initial weights, each leaf
    cast to ``dtype`` (``make_train_step``'s first gradient), float32."""
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(lm.tparams)]
    cast = [p.to(getattr(torch, dtype)) for p in leaves]
    loss, _ = build_model(lm.cfg, remat="none").loss(tree_unflatten(lm.tparams, cast),
                                                    lm.tbatch)
    return [g.float().numpy() for g in torch.autograd.grad(loss, leaves)]


def test_train_steps_match_jax(lm):
    """Three float32 AdamW steps with warmup (the fused Adam's plain
    version on the CPU): the losses, and every parameter after the last
    step, within 1e-4; dbrx's stacked expert leaves ``[n_reps, E, D, F]``
    among them."""
    losses, params = _port_steps(lm, "float32")
    jlosses, jleaves, _ = lm.jax_steps("float32")
    np.testing.assert_allclose(losses, jlosses, **TOL)
    got = tree_leaves(params)
    assert len(got) == len(jleaves)
    for a, b in zip(got, jleaves):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, **TOL)
    if lm.arch == "dbrx-132b":
        assert tuple(params["segments"][0][0]["ffn"]["we_gate"].shape) == (4, 4, 64, 64)


def _rel(a, want, unit):
    return float(np.linalg.norm(np.asarray(a, np.float32) - want) / unit)


def test_train_steps_bf16_match_jax(lm):
    """bfloat16 compute against the JAX package's bfloat16 steps, compiled
    with ``EXACT`` and with the port's silu and routing replayed as the
    JAX package rounds and routes them:

    - the three steps' losses within 1e-2 relative;
    - the first step's gradient, each leaf nearer the JAX package's
      bfloat16 gradient than half the way to its float32 one (a port
      that ignored ``compute_dtype`` reads 1, and the test shows it);
    - dbrx: each parameter leaf after the third step within 0.2 of the
      JAX steps' own change from the initial weights (``test_torch_lm_train.py``'s
      bound; the port in float32 reads up to 0.53).

    Why the replays: XLA's default excess precision keeps fused bfloat16
    intermediates in float32, and its CPU backend rounds ``jax.nn.silu``
    at each of exp, add, divide and multiply where PyTorch rounds once.
    With the port's own silu, deepseek's first gradient lies up to 1.18
    times the bfloat16-float32 difference from JAX's (the test prints
    it), so no bound could tell bfloat16 from float32. The routing: a token
    whose top-k margin is within the two packages' probability difference
    may go to other experts, and one such token moves the reduced model's
    weights far past any tolerance; the port takes JAX's routing where the
    two part (``_replayed_routing``; no remat, so the calls pair one to
    one), and the test fails unless each such token's margin is within
    twice the two packages' probability difference there.

    deepseek's parameters are not held leaf by leaf: Adam moves each
    element by about the learning rate whatever its gradient's size, so
    an element whose gradient lies within the two programs' rounding of
    zero moves the other way, and on this configuration that puts a
    correct port at up to 0.28 of the JAX steps' change (one element of a
    64-element norm scale reads 0.25), beside 0.32 for the port in
    float32. Its whole tree is held to 0.2 instead (the port reads 0.096,
    the float32 steps 0.205)."""
    jlosses, jleaves, routed = lm.jax_steps("bfloat16")
    jgrads, routed_1 = lm.jax_grads("bfloat16")
    jgrads_32, _ = lm.jax_grads("float32")
    n_moe = sum(lid >= lm.cfg.first_k_dense_layers for lid in range(lm.cfg.n_layers))
    assert len(routed) == STEPS * len(routed_1) == STEPS * (n_moe + lm.cfg.mtp_depth)
    parted = []
    with fam_checks.xla_rounded():
        with _replayed_routing(routed, parted):
            losses, params = _port_steps(lm, "bfloat16", remat="none")
        with _replayed_routing(routed_1, parted):
            grads = _port_grads(lm, "bfloat16")
    assert all(margin <= moved for margin, moved in parted), parted
    np.testing.assert_allclose(losses, jlosses, rtol=BF16_LOSS_RTOL)

    with _replayed_routing(routed_1, []):
        own_silu = _port_grads(lm, "bfloat16")
    gaps = [np.linalg.norm(want_32 - want) for want, want_32 in zip(jgrads, jgrads_32)]
    grad_rel = [_rel(g, want, gap) for g, want, gap in zip(grads, jgrads, gaps)]
    grad_rel_32 = [_rel(g, want, gap)
                   for g, want, gap in zip(_port_grads(lm, "float32"), jgrads, gaps)]
    assert max(grad_rel) <= BF16_GRAD_REL, grad_rel
    assert min(grad_rel_32) > BF16_GRAD_REL, grad_rel_32

    def readings(leaves, want_leaves):
        """Each leaf's distance from JAX's bfloat16 steps over the JAX
        steps' change, and the same over the whole tree."""
        inits = [t.numpy() for t in tree_leaves(lm.tparams)]
        moved = [np.linalg.norm(w - init) for w, init in zip(want_leaves, inits)]
        assert min(moved) > 0
        flat = [np.concatenate([np.ravel(t) for t in tree])
                for tree in (leaves, want_leaves, inits)]
        return ([_rel(a, w, m) for a, w, m in zip(leaves, want_leaves, moved)],
                _rel(flat[0], flat[1], np.linalg.norm(flat[1] - flat[2])))

    rels, tree_rel = readings([a.numpy() for a in tree_leaves(params)], jleaves)
    # the JAX float32 steps, which the port's float32 steps equal within 1e-4
    rels_32, tree_rel_32 = readings(lm.jax_steps("float32")[1], jleaves)
    print(f"{lm.arch}: first-step gradient, bfloat16 max {max(grad_rel):.4f} "
          f"(port's own silu {max(_rel(g, w, gap) for g, w, gap in zip(own_silu, jgrads, gaps)):.4f}), "
          f"float32 min {min(grad_rel_32):.4f}; parameters, bfloat16 leaves max "
          f"{max(rels):.4f} tree {tree_rel:.4f}, float32 leaves max {max(rels_32):.4f} "
          f"tree {tree_rel_32:.4f}; leaves {np.round(rels, 4).tolist()}")
    assert tree_rel <= BF16_PARAM_REL
    if lm.arch == "dbrx-132b":
        assert max(rels) <= BF16_PARAM_REL, rels


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_on_the_cpu(arch):
    out = io.StringIO()
    with redirect_stdout(out):
        losses = launch_train.main(["--arch", arch, "--device", "cpu", "--steps", "3",
                                    "--seq", "16"])
    lines = out.getvalue().splitlines()
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert lines[0].startswith("[train] step 1/3 loss=") and lines[-1] == "[train] done"


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_moe_training_steps_repeat_bitwise():
    """Two bfloat16 training steps of the reduced deepseek-v3-671b (MLA,
    MoE with a shared expert, MTP) on the card, twice from the same
    weights and batch: the losses, the parameters and the gradients of
    the first step bitwise equal (no accumulating scatter on the MoE
    path); one ``fused_adam`` launch a step for every ``CAPACITY`` leaves
    (the reduced model's 4 unrolled layers and MTP block hold more than
    one launch carries)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    cfg = get_config("deepseek-v3-671b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = make_dummy_batch(cfg, 4, 64, generator=torch.Generator(device=dev).manual_seed(1))
    runs = []
    for _ in range(2):
        leaves = [p.detach().clone().requires_grad_(True) for p in tree_leaves(params)]
        cast = [p.to(torch.bfloat16) for p in leaves]
        loss, _ = model.loss(tree_unflatten(params, cast), batch)
        grads = torch.autograd.grad(loss, leaves)
        opt = adamw(tsched.warmup_cosine(LR, WARMUP, 2), fused=True)
        step = make_train_step(model, opt)
        p, s, losses = params, opt.init(params), []
        before = fused_adam.launches
        for _ in range(2):
            p, s, lo = step(p, s, batch)
            losses.append(lo)
        assert fused_adam.launches - before == 2 * -(-len(leaves) // CAPACITY) == 4
        runs.append([loss.detach(), *grads, *losses, *tree_leaves(p)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
