"""End-to-end parity of one reduced LM configuration, the JAX package's
against the port's, shared by ``test_torch_ssm.py`` (zamba2-7b),
``test_torch_xlstm.py`` (xlstm-1.3b) and ``test_torch_encdec.py``
(whisper-tiny, pixtral-12b).

Each check takes the JAX modules (``jax_modules``, called from a fixture)
and a ``family`` namespace: one configuration in both packages with the
JAX package's weights carried over by ``params_from_jax``, one batch and
the JAX package's jitted programs, each run once and kept. Tolerances are
``test_torch_lm_train.py``'s: 1e-4 (absolute and relative) in float32,
and in bfloat16 the losses within 1e-2 relative; ``check_train_steps``
says how its parameters and bfloat16 gradients are held."""
import contextlib
import dataclasses
import types

import numpy as np
import torch

from repro_torch.kernels import ops as tops
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer
from repro_torch.models.model_zoo import build_model, make_train_step
from repro_torch.models.transformer import params_from_jax
from repro_torch.runtime.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.training import schedule as tsched
from repro_torch.training.optimizer import AdamState, adamw, tree_leaves, tree_unflatten

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_LOSS_RTOL, BF16_GRAD_REL = 1e-2, 0.5
#: the JAX gradients' compile: every bfloat16 op rounded as its dtype says,
#: as the port's ops are (``test_torch_moe.py``'s)
EXACT = {"xla_allow_excess_precision": False}
B, T_TRAIN = 4, 24
LR, WARMUP, STEPS = 1e-2, 2, 3


def jax_modules():
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models.model_zoo import build_model as jax_build_model
    from repro.models.model_zoo import make_train_step as jax_make_train_step
    from repro.runtime import checkpoint as jckpt
    from repro.serving import engine as jengine
    from repro.training import schedule as jsched
    from repro.training.optimizer import adamw as jax_adamw

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=jax_get_config, build_model=jax_build_model,
        make_train_step=jax_make_train_step, ckpt=jckpt, engine=jengine,
        sched=jsched, adamw=jax_adamw)


def family(jx, make_cfg) -> types.SimpleNamespace:
    """``make_cfg(get_config)`` in both packages, the JAX package's weights
    from ``PRNGKey(0)`` carried over, and a training batch (tokens and
    next-token labels with a -100 tail and a few more -100s; standard
    normal ``frontend_embeds`` and ``encoder_frames`` where the
    configuration takes them, ``inputs`` [B, ...] numpy)."""
    from repro_torch.configs import get_config

    cfg, jcfg = make_cfg(get_config), make_cfg(jx.get_config)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = jx.build_model(jcfg, remat="none")
    jparams = jmodel.init(jx.jax.random.PRNGKey(0))
    r = np.random.default_rng(0)
    tokens = r.integers(0, cfg.vocab_size, (B, T_TRAIN)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100, np.int32)], 1)
    labels[r.random(labels.shape) < 0.1] = -100
    r = np.random.default_rng(1)
    inputs = {}
    if cfg.frontend == "vision":
        inputs["frontend_embeds"] = r.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        inputs["encoder_frames"] = r.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    batch = {"tokens": tokens, "labels": labels, **inputs}
    jbatch = {k: jx.jnp.asarray(v) for k, v in batch.items()}
    runs = {}

    def jax_steps(dtype: str):
        """STEPS JAX training steps at ``dtype`` compute, as the JAX
        package's ``make_train_step`` takes them (the loss and gradient of
        the cast leaves, then ``opt.update``), each step's state recorded:
        ``[(params, opt_state, loss, grads)]`` and the final params."""
        if dtype not in runs:
            compute = getattr(jx.jnp, dtype)
            opt = jx.adamw(jx.sched.warmup_cosine(LR, WARMUP, STEPS))

            def loss_fn(p):
                cast = jx.jax.tree_util.tree_map(lambda a: a.astype(compute), p)
                return jmodel.loss(cast, jbatch)[0]

            value_and_grad = jx.jax.jit(jx.jax.value_and_grad(loss_fn))
            update = jx.jax.jit(opt.update)
            p, s, states = jparams, opt.init(jparams), []
            for _ in range(STEPS):
                loss, g = value_and_grad(p)
                states.append((p, s, float(loss), g))
                p, s = update(g, s, p)
            runs[dtype] = (states, p, opt)
        return runs[dtype]

    def jax_grads(dtype: str) -> list:
        """Every leaf's gradient of the loss at the initial weights, each
        leaf cast to ``dtype`` as ``make_train_step`` casts it, compiled
        with ``EXACT``; float32 numpy."""
        key = ("grads", dtype)
        if key not in runs:
            compute = getattr(jx.jnp, dtype)
            grads = jx.jax.jit(jx.jax.grad(lambda p: jmodel.loss(
                jx.jax.tree_util.tree_map(lambda a: a.astype(compute), p), jbatch)[0]),
                compiler_options=EXACT)(jparams)
            runs[key] = [np.asarray(g, np.float32) for g in jx.jax.tree_util.tree_leaves(grads)]
        return runs[key]

    return types.SimpleNamespace(
        cfg=cfg, jcfg=jcfg, jmodel=jmodel, jparams=jparams, batch=batch,
        jbatch=jbatch, jax_steps=jax_steps, jax_grads=jax_grads, inputs=inputs,
        tparams=params_from_jax(jx.jax.device_get(jparams), device="cpu"),
        tbatch={k: _tensor(v) for k, v in batch.items()})


def _tensor(a: np.ndarray) -> torch.Tensor:
    """Integer arrays as the port's index dtype (int64), floats as they are."""
    t = torch.from_numpy(a)
    return t.long() if a.dtype.kind == "i" else t


def _inputs(jx, fam, rows: int):
    """The first ``rows`` rows of the family's frontend or encoder inputs,
    as keyword arguments of the JAX package's and of the port's entry
    points."""
    return ({k: jx.jnp.asarray(v[:rows]) for k, v in fam.inputs.items()},
            {k: torch.from_numpy(v[:rows]) for k, v in fam.inputs.items()})


class _XlaLogistic(torch.autograd.Function):
    """``lax.logistic`` as the JAX package's CPU compile computes it at a
    16-bit dtype: ``1 / (1 + exp(-x))``, each op rounded to x's dtype, and
    its derivative ``s · (1 - s)`` rounded the same way."""

    @staticmethod
    def forward(ctx, x):
        s = torch.reciprocal(torch.exp(-x) + 1)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1 - s))


class _XlaGelu(torch.autograd.Function):
    """``jax.nn.gelu`` (tanh form) as the JAX package's CPU compile computes
    it: ``x · 0.5 · (1 + tanh(c · (x + k · x³)))`` with c and k rounded to
    x's dtype and each op rounded, and its backward in the order of JAX's
    VJP (tanh's derivative as ``(g + g·t) · (1 - t)``, x³'s as ``3·x²``),
    where PyTorch's gelu and its backward round once."""

    @staticmethod
    def forward(ctx, x):
        c, k = (float(torch.tensor(v, dtype=torch.float32).to(x.dtype))
                for v in (np.sqrt(2 / np.pi), 0.044715))
        t = torch.tanh(c * (x + k * (x * x * x)))
        half = 0.5 * (1.0 + t)
        ctx.save_for_backward(x, t, half, 3.0 * (x * x))
        ctx.consts = (c, k)
        return x * half

    @staticmethod
    def backward(ctx, g):
        x, t, half, d3 = ctx.saved_tensors
        c, k = ctx.consts
        p = (0.5 * (x * g)) * (1.0 - t)
        s = c * (p + p * t)
        return (g * half + s) + (k * s) * d3


class _XlaBiasAdd(torch.autograd.Function):
    """``h + b`` for a 16-bit ``h`` [..., F] and ``b`` [F] of one dtype:
    ``b``'s gradient summed over the rows one at a time at that dtype, as
    XLA's CPU backend reduces the broadcast's cotangent (a batch of 96
    rows; ``torch.sum`` accumulates in float32)."""

    @staticmethod
    def forward(ctx, h, b):
        return h + b

    @staticmethod
    def backward(ctx, g):
        rows = g.reshape(-1, g.shape[-1])
        acc = torch.zeros_like(rows[0])
        for row in rows:
            acc = acc + row
        return g, acc


@contextlib.contextmanager
def xla_rounded():
    """Within the block the port's silu, gelu and GELU-MLP bias adds round
    as the JAX package's CPU compile rounds them (``_XlaLogistic``,
    ``_XlaGelu``, ``_XlaBiasAdd``), so that a bfloat16 gradient can be held
    leaf by leaf against the JAX package's."""
    fn = torch.nn.functional
    silu, gelu, apply_mlp = fn.silu, fn.gelu, tlayers.apply_mlp

    def add(h, b):
        return _XlaBiasAdd.apply(h, b) if h.dtype == b.dtype != torch.float32 else h + b

    def mlp(p, x, activation, d_ff=None):  # one device: d_ff shards nothing
        if activation == "swiglu":
            return apply_mlp(p, x, activation, d_ff)
        h = fn.gelu(add(tlayers.dot(x, p["w_in"]), p["b_in"]), approximate="tanh")
        return add(tlayers.dot(h, p["w_out"]), p["b_out"])

    fn.silu = lambda x, inplace=False: x * _XlaLogistic.apply(x)
    def tanh_gelu(x, approximate="none"):
        assert approximate == "tanh"  # the port's only form
        return _XlaGelu.apply(x)

    fn.gelu = tanh_gelu
    tlayers.apply_mlp = ttransformer.apply_mlp = mlp
    try:
        yield
    finally:
        fn.silu, fn.gelu = silu, gelu
        tlayers.apply_mlp = ttransformer.apply_mlp = apply_mlp


class _JaxSoftplus(torch.autograd.Function):
    """``jax.nn.softplus``, ``logaddexp(x, 0)``, as the JAX package computes
    it: ``max(x, 0) + log1p(exp(-|x|))``, each op rounded to x's dtype, and
    its custom JVP ``g · exp(x - out)``; PyTorch's softplus rounds once."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out)


def _prefix_segsum(logs: torch.Tensor) -> torch.Tensor:
    """The JAX package's chunk decay exponents: the difference ``cum_i -
    cum_j`` of two prefix sums over the chunk's axis 2 (the port's
    ``_segsum`` sums each entry from its own terms), each partial sum
    rounded to the dtype: nearer the JAX package's bfloat16 gradients
    than ``torch.cumsum``, which accumulates in float32 and rounds each
    output once (ROADMAP.md Queue 3, item 12)."""
    parts = logs.unbind(2)
    cum = [parts[0]]
    for part in parts[1:]:
        cum.append(cum[-1] + part)
    cum = torch.stack(cum, dim=2)
    return cum[:, :, :, None, :] - cum[:, :, None, :, :]


@contextlib.contextmanager
def jax_ssd():
    """Within the block the port's Mamba2 blocks take their decay
    exponents and softplus as the JAX package does (``_prefix_segsum``,
    ``_JaxSoftplus``), so that a bfloat16 gradient can be held leaf by leaf
    against the JAX package's (ROADMAP.md Queue 3, item 12)."""
    fn = torch.nn.functional
    segsum, softplus = tssm._segsum, fn.softplus
    tssm._segsum = _prefix_segsum
    fn.softplus = lambda x, beta=1.0, threshold=20.0: _JaxSoftplus.apply(x)
    try:
        yield
    finally:
        tssm._segsum, fn.softplus = segsum, softplus


@contextlib.contextmanager
def fed_encoder(enc_out: torch.Tensor):
    """Within the block ``LM.encode`` returns ``enc_out`` (the JAX
    package's encoder output), so that the decoder's gradients are held
    apart from the encoder's float32 rounding."""
    encode = ttransformer.LM.encode
    ttransformer.LM.encode = lambda self, params, frames, cache=None: enc_out
    try:
        yield
    finally:
        ttransformer.LM.encode = encode


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), **tol)


def assert_leaves_close(got, want, tol=TOL):
    got = tree_leaves(got)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.detach().float().numpy(), b, **tol)


def check_forward_loss_and_grads(jx, fam):
    """``LM.forward``'s logits, ``LM.loss`` (remat="layer": every scanned
    layer recomputed in the backward) and every leaf's gradient against
    the JAX package's; remat="none" gives the same loss and gradients
    bitwise. The frontend's or encoder's inputs join every call."""
    toks = fam.batch["tokens"]
    jin, tin = _inputs(jx, fam, B)
    jlog, _, _, _ = jx.jax.jit(fam.jmodel.forward)(fam.jparams, jx.jnp.asarray(toks), **jin)
    tlog, aux, _, _ = build_model(fam.cfg).forward(fam.tparams, torch.from_numpy(toks).long(),
                                                   **tin)
    _close(tlog, jlog)
    assert float(aux) == 0.0
    _, _, jloss, jgrads = fam.jax_steps("float32")[0][0]
    out = []
    for remat in ("layer", "none"):
        leaves = [p.clone().requires_grad_(True) for p in tree_leaves(fam.tparams)]
        loss, met = build_model(fam.cfg, remat=remat).loss(
            tree_unflatten(fam.tparams, leaves), fam.tbatch)
        out.append([loss, *torch.autograd.grad(loss, leaves)])
    np.testing.assert_allclose(float(out[0][0].detach()), float(jloss), **TOL)
    assert float(met["denom"]) == (fam.batch["labels"] >= 0).sum()
    assert_leaves_close(out[0][1:], [np.asarray(g) for g in
                                     jx.jax.tree_util.tree_leaves(jgrads)])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def check_prefill_and_decode(jx, fam, t: int, n_flash: int, monkeypatch):
    """``prefill`` of a ``t``-token prompt (after the frontend's tokens,
    with the encoder's frames, where the configuration takes them) and
    four greedy ``decode_step``s within 1e-4 of JAX's at every step, and
    every layer's cache after the last step (K/V of the attention layers
    and the shared sites, the recurrent states, the encoder's output)
    within 1e-4; the prefill takes the flash executor ``n_flash`` times."""
    jnp = jx.jnp
    model = build_model(fam.cfg)
    toks = np.random.default_rng(8).integers(0, fam.cfg.vocab_size, (2, t)).astype(np.int32)
    jin, tin = _inputs(jx, fam, 2)
    n_front = fam.inputs["frontend_embeds"].shape[1] if "frontend_embeds" in jin else 0
    calls = []
    flash = tops._EXECUTORS["cuda"]["flash"]
    monkeypatch.setitem(tops._EXECUTORS["cuda"], "flash",
                        lambda *a, **k: calls.append(1) or flash(*a, **k))
    jcache = fam.jmodel.init_cache(2, n_front + t + 8, dtype=jnp.float32)
    tcache = model.init_cache(2, n_front + t + 8, dtype=torch.float32, device="cpu")
    prefill, decode = jx.jax.jit(fam.jmodel.prefill), jx.jax.jit(fam.jmodel.decode_step)
    jl, jcache = prefill(fam.jparams, jnp.asarray(toks), jcache, **jin)
    tl, tcache = model.prefill(fam.tparams, torch.from_numpy(toks).long(), tcache, **tin)
    _close(tl, jl)
    assert len(calls) == n_flash
    for step in range(4):
        cur = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        assert np.array_equal(cur[:, 0], torch.argmax(tl, -1).numpy())
        jl, jcache = decode(fam.jparams, jcache, jnp.asarray(cur))
        tl, tcache = model.decode_step(fam.tparams, tcache, torch.from_numpy(cur).long())
        _close(tl, jl)
        assert tcache["idx"] == int(jcache["idx"]) == n_front + t + 1 + step
    assert len(calls) == n_flash
    assert sorted(tcache) == sorted(jcache)
    assert_leaves_close({k: v for k, v in tcache.items() if k != "idx"}, [
        np.asarray(a) for k in sorted(jcache) if k != "idx"
        for a in jx.jax.tree_util.tree_leaves(jcache[k])])


def _requests(cls, cfg):
    """``examples/lm_serve.py``'s traffic: 8 prompts of 4-11 tokens, 12
    new tokens each."""
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                           size=int(rng.integers(4, 12))).astype(np.int32),
                max_new_tokens=12) for i in range(8)]


def check_engine(jx, fam):
    """8 requests, 4 slots, left-padded waves (the padding flows through
    the recurrence, as in the JAX engine), greedy decoding: the JAX
    engine's tokens, request by request."""
    jeng = jx.engine.ServingEngine(fam.jmodel, fam.jparams, batch_slots=4, max_seq=32)
    teng = ServingEngine(build_model(fam.cfg), fam.tparams, batch_slots=4, max_seq=32,
                         device="cpu")
    for jr, tr in zip(_requests(jx.engine.Request, fam.cfg), _requests(Request, fam.cfg)):
        jeng.submit(jr)
        teng.submit(tr)
    jdone, tdone = jeng.run(), teng.run()
    assert [r.rid for r in tdone] == [r.rid for r in jdone] == list(range(8))
    for jr, tr in zip(jdone, tdone):
        assert tr.done and len(tr.output) == 12
        assert tr.output == [int(t) for t in jr.output], tr.rid


def _port_state(jx, state):
    """The JAX package's ``AdamState`` as the port's (a host step count)."""
    return AdamState(int(state.step), params_from_jax(jx.jax.device_get(state.m), device="cpu"),
                     params_from_jax(jx.jax.device_get(state.v), device="cpu"))


def _port_grads(fam, params, dtype):
    """The loss and gradients of ``make_train_step``'s backward at
    ``params`` (float32 leaves cast to ``dtype`` inside the loss); None for
    a leaf the loss does not reach (the encoder under ``fed_encoder``)."""
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(params)]
    cast = [p.to(dtype) for p in leaves]
    loss, _ = build_model(fam.cfg).loss(tree_unflatten(params, cast), fam.tbatch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [None if g is None else g.numpy() for g in grads]


def leaf_names(tree, prefix: str = "") -> list:
    """Each leaf's path (``/segments[0][1]/mamba/a_log``), in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree) for n in leaf_names(t, f"{prefix}[{i}]")]
    return [prefix]


def jax_encoder_fed(jx, fam):
    """``fed_encoder`` with the JAX package's encoder output of the
    family's frames at bfloat16 weights, as its bfloat16 loss computes it."""
    cast = jx.jax.tree_util.tree_map(lambda a: a.astype(jx.jnp.bfloat16), fam.jparams)
    enc = jx.jax.jit(fam.jmodel.encode)(cast, jx.jnp.asarray(fam.batch["encoder_frames"]))
    return fed_encoder(torch.from_numpy(np.array(enc)))


def check_train_steps(jx, fam, dtype: str, bf16_replay=None, bf16_over: tuple = ()):
    """Three steps of AdamW with warmup (fused: its plain version on the
    CPU), ``make_train_step`` in both packages from the same weights: the
    losses within 1e-4 in float32 (1e-2 relative in bfloat16) at every
    step, and falling.

    The parameters are held step by step rather than after three steps:
    both trajectories are right, and they part. At this learning rate the
    reduced models reach points where parameters 1.8e-4 apart (after two
    xlstm steps) give gradients up to 0.17 apart, while at the same
    parameters the two packages' gradients agree within 1e-5 at every
    step; and Adam's first step moves each weight by about the learning
    rate whatever the size of its gradient, so an element whose gradient
    lies within float32 rounding of zero moves by up to 3e-4 either way.
    So at each of the JAX run's three states, float32: the port's loss and
    gradients within 1e-4 of JAX's, and the port's ``opt.update`` of that
    state by JAX's gradients (parameters and both moments) within 1e-6 of
    JAX's. bfloat16, at the first state (``test_torch_moe.py``'s rule):
    each leaf of the port's bfloat16 gradient, its silu, gelu and GELU-MLP
    bias adds rounded as XLA's CPU backend rounds them (``xla_rounded``,
    and within ``bf16_replay(jx, fam)``, a context that replays more of the
    JAX package's computation: ``jax_ssd``, ``jax_encoder_fed``), nearer
    the JAX package's bfloat16 gradient (compiled with ``EXACT``) than
    BF16_GRAD_REL of the way to JAX's float32 one, where the port's
    float32 gradient reads more than that on every such leaf (so the rule
    tells the two apart). The leaves whose path starts with one of
    ``bf16_over`` (ROADMAP.md Queue 3, item 12 has their readings) keep
    the size check alone: the port's bfloat16 gradients, its own ops, lie
    as far from its float32 ones as JAX's bfloat16 gradients from JAX's
    float32 ones (0.5-2x, norm over those leaves). ``test_torch_lm_train.py``'s float32
    parameter rule does not hold here for a correct port: the port's
    float32 steps lie as far from JAX's bfloat16 steps as its bfloat16
    ones (PERF.md §6)."""
    compute = getattr(torch, dtype)
    opt = adamw(tsched.warmup_cosine(LR, WARMUP, STEPS), fused=True)
    step = make_train_step(build_model(fam.cfg), opt, compute_dtype=compute)
    p, s, losses = fam.tparams, opt.init(fam.tparams), []
    for _ in range(STEPS):
        p, s, loss = step(p, s, fam.tbatch)
        losses.append(float(loss))
    assert s.step == STEPS and losses[-1] < losses[0]
    states, _, jopt = fam.jax_steps(dtype)
    jlosses = [loss for _, _, loss, _ in states]
    if dtype == "bfloat16":
        np.testing.assert_allclose(losses, jlosses, rtol=BF16_LOSS_RTOL)
        names = leaf_names(fam.tparams)
        over = [i for i, n in enumerate(names) if n.startswith(tuple(bf16_over))] \
            if bf16_over else []
        held = [i for i in range(len(names)) if i not in over]
        want, want_32 = fam.jax_grads("bfloat16"), fam.jax_grads("float32")
        replay = bf16_replay(jx, fam) if bf16_replay else contextlib.nullcontext()
        with xla_rounded(), replay:
            _, got = _port_grads(fam, fam.tparams, compute)
        _, got_32 = _port_grads(fam, fam.tparams, torch.float32)
        gaps = [np.linalg.norm(want_32[i] - want[i]) for i in held]
        assert min(gaps) > 0
        rel = {names[i]: np.linalg.norm(got[i] - want[i]) / gap for i, gap in zip(held, gaps)}
        rel_32 = [np.linalg.norm(got_32[i] - want[i]) / gap for i, gap in zip(held, gaps)]
        assert max(rel.values()) <= BF16_GRAD_REL, rel
        assert min(rel_32) > BF16_GRAD_REL, rel_32
        if not over:
            return
        _, pg16 = _port_grads(fam, fam.tparams, compute)
        flat = jx.jax.tree_util.tree_leaves
        jg16, jg32 = flat(states[0][3]), flat(fam.jax_steps("float32")[0][0][3])

        def dist(a, b):
            return np.sqrt(sum(np.sum((np.asarray(a[i], np.float32)
                                       - np.asarray(b[i], np.float32)) ** 2) for i in over))

        ratio = dist(pg16, got_32) / dist(jg16, jg32)
        assert 0.5 <= ratio <= 2.0, ratio
        return
    np.testing.assert_allclose(losses, jlosses, **TOL)
    for jp, js, jloss, jg in states:
        tp = params_from_jax(jx.jax.device_get(jp), device="cpu")
        loss, grads = _port_grads(fam, tp, compute)
        np.testing.assert_allclose(loss, jloss, **TOL)
        jgrads = [np.asarray(a) for a in jx.jax.tree_util.tree_leaves(jg)]
        assert_leaves_close([torch.from_numpy(g) for g in grads], jgrads)
        new_p, new_s = opt.update(params_from_jax(jx.jax.device_get(jg), device="cpu"),
                                  _port_state(jx, js), tp)
        want_p, want_s = jopt.update(jg, js, jp)
        assert new_s.step == int(want_s.step)
        for got, want in ((new_p, want_p), (new_s.m, want_s.m), (new_s.v, want_s.v)):
            assert_leaves_close(got, [np.asarray(a) for a in jx.jax.tree_util.tree_leaves(want)],
                                dict(atol=1e-6, rtol=1e-6))


def check_checkpoint_round_trip(jx, fam, tmp_path):
    """The JAX package's checkpoint of (params, AdamW state) restores in
    the port bitwise (the shared sites' empty ``{}`` hold no leaf in
    either), and the port's checkpoint of the same state restores in the
    JAX package bitwise."""
    jopt = jx.adamw(1e-3)
    jstate = (fam.jparams, jopt.init(fam.jparams))
    jx.ckpt.save_checkpoint(str(tmp_path / "jax"), 7, jstate)
    opt = adamw(1e-3, fused=True)
    target = (fam.tparams, opt.init(fam.tparams))
    (params, state), step = restore_checkpoint(str(tmp_path / "jax"), target)
    assert step == 7 and state.step == 0
    jleaves = [np.asarray(a) for a in jx.jax.tree_util.tree_leaves(jstate)]
    got = tree_leaves((params, state))  # params, the step count, m, v
    assert len(got) == len(jleaves)
    for a, b in zip(got, jleaves):
        np.testing.assert_array_equal(np.asarray(a) if isinstance(a, int) else a.numpy(), b)
    save_checkpoint(str(tmp_path / "port"), 8, (params, state))
    back, step = jx.ckpt.restore_checkpoint(str(tmp_path / "port"), jstate)
    assert step == 8
    for a, b in zip(jleaves, jx.jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, np.asarray(b))
