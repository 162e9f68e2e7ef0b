"""Port parity, LM training: ``LM.loss`` and its gradients, three steps of
``make_train_step`` with ``adamw(warmup_cosine(...))``, the schedules, the
gradient utilities, ``make_dummy_batch`` and ``python -m
repro_torch.launch.train``, against the JAX package's.

Three configurations, each with the JAX package's weights carried over by
``params_from_jax``: llama3.2-1b and starcoder2-3b at ``.reduced()``, and
gemma3-1b at ``.reduced()`` with 6 layers (the reduced config keeps 4,
none of them global: ``global_every`` is 6) on 48 tokens, so both its
32-token window and its global layer are exercised.

Tolerances: 1e-4 (absolute and relative) in float32, the JAX suite's;
in bfloat16, the losses within 1e-2 relative and each parameter leaf's
distance from the JAX one within 0.2 of the JAX step's own change from
the initial weights (three bfloat16 steps give up to 0.12, and the
float32 program's parameters about as much: AdamW's first steps move
each weight by about the learning rate whatever the sign noise of its
gradient, so bfloat16 parity cannot be held closer); 1e-6 relative for
the schedules. On the CPU the fused
Adam runs its plain version, so ``fused=True`` is held to the same
JAX program as the plain Adam. The one test that needs the card (the
Hopper Adam kernel in a training step) is marked ``cuda`` and skips
here."""
import dataclasses
import io
import types
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.fused_adam import fused_adam  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.model_zoo import (  # noqa: E402
    build_model,
    make_dummy_batch,
    make_eval_step,
    make_train_step,
)
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.training import grad as tgrad  # noqa: E402
from repro_torch.training import schedule as tsched  # noqa: E402
from repro_torch.training.optimizer import adamw, tree_leaves, tree_unflatten  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
#: bfloat16: the losses' relative tolerance, and a parameter leaf's
#: ``|port - jax| / |jax - init|`` (Frobenius norms)
BF16_LOSS_RTOL, BF16_PARAM_REL = 1e-2, 0.2
#: (architecture, layers or None for the reduced config's, tokens a row)
CONFIGS = {"llama3.2-1b": (None, 24), "gemma3-1b": (6, 48),
           "starcoder2-3b": (None, 24)}
B = 4
LR, WARMUP, STEPS = 1e-2, 2, 3


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models import layers as jlayers
    from repro.models.model_zoo import build_model as jax_build_model
    from repro.models.model_zoo import make_train_step as jax_make_train_step
    from repro.training import grad as jgrad
    from repro.training import schedule as jsched
    from repro.training.optimizer import adamw as jax_adamw

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=jax_get_config, layers=jlayers,
        build_model=jax_build_model, make_train_step=jax_make_train_step,
        grad=jgrad, sched=jsched, adamw=jax_adamw)


def _cfg(getter, arch):
    n_layers, _ = CONFIGS[arch]
    cfg = getter(arch).reduced()
    return cfg if n_layers is None else dataclasses.replace(cfg, n_layers=n_layers)


def _batch(cfg, t, seed=0):
    """Tokens and next-token labels, a -100 tail and a few more -100s."""
    r = np.random.default_rng(seed)
    tokens = r.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100, np.int32)], 1)
    labels[r.random(labels.shape) < 0.1] = -100
    return {"tokens": tokens, "labels": labels}


@pytest.fixture(scope="module", params=list(CONFIGS))
def lm(request, jx):
    """One configuration in both packages with one set of weights; the
    JAX package's jitted loss-and-gradient and train steps (by compute
    dtype and microbatches), each run once and kept."""
    arch = request.param
    cfg = _cfg(get_config, arch)
    jcfg = _cfg(jx.get_config, arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = jx.build_model(jcfg, remat="none")
    jparams = jmodel.init(jx.jax.random.PRNGKey(0))
    batch = _batch(cfg, CONFIGS[arch][1])
    jbatch = {k: jx.jnp.asarray(v) for k, v in batch.items()}
    cache = {}

    def jax_steps(dtype: str, microbatches: int):
        """(losses, parameters after the last step) of STEPS JAX steps."""
        key = (dtype, microbatches)
        if key not in cache:
            opt = jx.adamw(jx.sched.warmup_cosine(LR, WARMUP, STEPS))
            step = jx.jax.jit(jx.make_train_step(
                jmodel, opt, compute_dtype=getattr(jx.jnp, dtype),
                microbatches=microbatches))
            p, s, losses = jparams, opt.init(jparams), []
            for _ in range(STEPS):
                p, s, loss = step(p, s, jbatch)
                losses.append(float(loss))
            cache[key] = (losses, [np.asarray(a) for a in jx.jax.tree_util.tree_leaves(p)])
        return cache[key]

    return types.SimpleNamespace(
        arch=arch, cfg=cfg, jmodel=jmodel, jparams=jparams, batch=batch,
        jbatch=jbatch, jax_steps=jax_steps,
        tparams=params_from_jax(jx.jax.device_get(jparams), device="cpu"),
        tbatch={k: torch.from_numpy(v).long() for k, v in batch.items()})


def _assert_leaves_close(got, want, tol=TOL):
    got = tree_leaves(got)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.detach().float().numpy(), b, **tol)


# ---------------------------------------------------------------------------
# The loss and its gradients
# ---------------------------------------------------------------------------

def test_loss_and_grads_match_jax(jx, lm):
    """``LM.loss`` (remat="layer": every layer recomputed in the backward)
    and torch autograd against ``jax.value_and_grad`` of the JAX loss."""
    (jloss, jmet), jgrads = jx.jax.jit(jx.jax.value_and_grad(
        lambda p: lm.jmodel.loss(p, lm.jbatch), has_aux=True))(lm.jparams)
    model = build_model(lm.cfg, remat="layer")
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(lm.tparams)]
    loss, met = model.loss(tree_unflatten(lm.tparams, leaves), lm.tbatch)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    assert float(met["denom"]) == float(jmet["denom"]) == (lm.batch["labels"] >= 0).sum()
    assert float(met["aux"]) == 0.0
    _assert_leaves_close(list(grads), [np.asarray(g) for g in
                                       jx.jax.tree_util.tree_leaves(jgrads)])


def test_remat_changes_nothing(lm):
    """``remat="layer"`` and ``"none"``: the same loss and gradients,
    bitwise."""
    out = []
    for remat in ("layer", "none"):
        leaves = [p.clone().requires_grad_(True) for p in tree_leaves(lm.tparams)]
        loss, _ = build_model(lm.cfg, remat=remat).loss(
            tree_unflatten(lm.tparams, leaves), lm.tbatch)
        out.append([loss, *torch.autograd.grad(loss, leaves)])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_masked_ce_ignores_labels_and_vocab_padding(jx):
    """``_masked_ce`` against the JAX package's, with padded vocabulary
    columns (-1e30) and every label ignored in one row."""
    from repro.models.transformer import _masked_ce as jax_masked_ce

    from repro_torch.models.transformer import _masked_ce

    r = np.random.default_rng(3)
    logits = r.standard_normal((3, 5, 16)).astype(np.float32) * 4
    labels = r.integers(0, 12, (3, 5)).astype(np.int32)
    labels[1] = -100
    labels[0, 2] = -100
    got, denom = _masked_ce(torch.from_numpy(logits), torch.from_numpy(labels), 12)
    want, jdenom = jax_masked_ce(jx.jnp.asarray(logits), jx.jnp.asarray(labels), 12)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    assert float(denom) == float(jdenom) == 9.0
    none = torch.full((2, 3), -100)
    loss, denom = _masked_ce(torch.zeros(2, 3, 16), none, 12)
    assert float(loss) == 0.0 and float(denom) == 1.0


def test_eval_step_is_the_loss_without_gradients(lm):
    loss, met = make_eval_step(build_model(lm.cfg))(lm.tparams, lm.tbatch)
    want, _ = build_model(lm.cfg).loss(lm.tparams, lm.tbatch)
    assert not loss.requires_grad and torch.equal(loss, want.detach())
    assert set(met) == {"ce", "aux", "denom"}


# ---------------------------------------------------------------------------
# Training steps
# ---------------------------------------------------------------------------

def _port_steps(lm, dtype, microbatches, fused):
    opt = adamw(tsched.warmup_cosine(LR, WARMUP, STEPS), fused=fused)
    step = make_train_step(build_model(lm.cfg), opt,
                           compute_dtype=getattr(torch, dtype),
                           microbatches=microbatches)
    p, s, losses = lm.tparams, opt.init(lm.tparams), []
    for _ in range(STEPS):
        p, s, loss = step(p, s, lm.tbatch)
        losses.append(float(loss))
    assert s.step == STEPS
    assert all(t.dtype == torch.float32 for t in tree_leaves(p))
    return losses, p


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(lm, microbatches, fused):
    """Three float32 steps of AdamW with warmup: the losses and the
    parameters after the last step."""
    losses, params = _port_steps(lm, "float32", microbatches, fused)
    jlosses, jleaves = lm.jax_steps("float32", microbatches)
    np.testing.assert_allclose(losses, jlosses, **TOL)
    assert losses[-1] < losses[0]
    _assert_leaves_close(params, jleaves)


def test_train_steps_bf16_match_jax(lm):
    """The JAX default compute dtype, bfloat16: the losses, and each
    parameter leaf held to the JAX steps' own change from the initial
    weights (an unchanged or zeroed tree gives 1 or more)."""
    losses, params = _port_steps(lm, "bfloat16", 1, True)
    jlosses, jleaves = lm.jax_steps("bfloat16", 1)
    np.testing.assert_allclose(losses, jlosses, rtol=BF16_LOSS_RTOL)
    assert losses[-1] < losses[0]
    got = tree_leaves(params)
    assert len(got) == len(jleaves)
    for a, want, init in zip(got, jleaves, tree_leaves(lm.tparams)):
        moved = np.linalg.norm(want - init.numpy())
        assert moved > 0
        rel = np.linalg.norm(a.detach().numpy() - want) / moved
        assert rel <= BF16_PARAM_REL, (tuple(a.shape), rel)


# ---------------------------------------------------------------------------
# Schedules and gradient utilities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)),
    ("warmup_cosine", (3e-4, 10, 20)),
    ("warmup_cosine", (1e-2, 2, 15, 0.2)),
    ("warmup_cosine", (1e-3, 0, 7)),
    ("linear_warmup", (3e-4, 10)),
])
def test_schedules_match_jax(jx, name, args):
    """Steps 0-20 (past the end too), as the JAX optimizer calls them: an
    int32 step on the device."""
    got = [getattr(tsched, name)(*args)(s) for s in range(21)]
    want = [float(getattr(jx.sched, name)(*args)(jx.jnp.int32(s))) for s in range(21)]
    assert all(isinstance(g, float) for g in got)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _tree(seed):
    r = np.random.default_rng(seed)
    return {"a": r.standard_normal((3, 4)).astype(np.float32),
            "b": [r.standard_normal(5).astype(np.float32) * 10,
                  r.standard_normal(()).astype(np.float32)]}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.asarray(tree))


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_global_norm_and_clip_match_jax(jx, max_norm):
    tree = _tree(0)
    jt = jx.jax.tree_util.tree_map(jx.jnp.asarray, tree)
    np.testing.assert_allclose(float(tgrad.global_norm(_to_torch(tree))),
                               float(jx.grad.global_norm(jt)), rtol=1e-6)
    clipped, norm = tgrad.clip_by_global_norm(_to_torch(tree), max_norm)
    jclipped, jnorm = jx.grad.clip_by_global_norm(jt, max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    _assert_leaves_close(clipped, [np.asarray(a) for a in
                                   jx.jax.tree_util.tree_leaves(jclipped)],
                         dict(atol=1e-6, rtol=1e-6))


def test_accumulators_match_jax(jx):
    trees = [_tree(s) for s in (1, 2, 3)]
    state, jstate = tgrad.accum_init(_to_torch(trees[0])), jx.grad.accum_init(trees[0])
    assert state.count == 0
    _assert_leaves_close(tgrad.accum_mean(state), [np.asarray(a) for a in
                         jx.jax.tree_util.tree_leaves(jx.grad.accum_mean(jstate))])
    for t in trees:
        state = tgrad.accum_add(state, _to_torch(t))
        jstate = jx.grad.accum_add(jstate, jx.jax.tree_util.tree_map(jx.jnp.asarray, t))
    assert state.count == int(jstate.count) == 3
    _assert_leaves_close(tgrad.accum_mean(state), [np.asarray(a) for a in
                         jx.jax.tree_util.tree_leaves(jx.grad.accum_mean(jstate))],
                         dict(atol=1e-6, rtol=1e-6))


def test_int8_round_trip_matches_jax(jx):
    x = (np.random.default_rng(4).standard_normal(1000) * 3).astype(np.float32)
    x[7] = 0.5 * float(np.abs(x).max() / 127.0)  # a tie: rounds half to even
    q, scale = tgrad.quantize_int8(torch.from_numpy(x))
    jq, jscale = jx.grad.quantize_int8(jx.jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-7)
    back = tgrad.dequantize_int8(q, scale)
    np.testing.assert_allclose(back.numpy(), np.asarray(jx.grad.dequantize_int8(jq, jscale)),
                               rtol=1e-7)
    assert float((back - torch.from_numpy(x)).abs().max()) <= float(scale) / 2 + 1e-7


# ---------------------------------------------------------------------------
# Batches, layers and the launcher
# ---------------------------------------------------------------------------

def test_dummy_batch():
    cfg = get_config("llama3.2-1b").reduced()
    batch = make_dummy_batch(cfg, 3, 20, generator=torch.Generator().manual_seed(5))
    again = make_dummy_batch(cfg, 3, 20, generator=torch.Generator().manual_seed(5))
    tokens, labels = batch["tokens"], batch["labels"]
    assert tokens.shape == labels.shape == (3, 20) and tokens.dtype == torch.long
    assert torch.equal(tokens, again["tokens"])
    assert 0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size
    assert torch.equal(labels[:, :-1], tokens[:, 1:])
    assert (labels[:, -1] == -100).all()
    assert make_dummy_batch(cfg, 2, 3)["tokens"].shape == (2, 8)  # at least 8
    # the frontend's and encoder's inputs: tests/test_torch_encdec.py
    assert sorted(make_dummy_batch(get_config("whisper-tiny").reduced(), 2, 16)) == [
        "encoder_frames", "labels", "tokens"]


def test_embed_dense_path_matches_gather_and_jax(jx):
    r = np.random.default_rng(6)
    table = r.standard_normal((40, 8)).astype(np.float32)
    tokens = r.integers(0, 40, (2, 5))
    p = {"table": torch.from_numpy(table)}
    got = tlayers.embed_dense_path(p, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(jx.layers.embed_dense_path(
        {"table": jx.jnp.asarray(table)}, jx.jnp.asarray(tokens))), **TOL)
    torch.testing.assert_close(got, tlayers.embed_lookup(p, torch.from_numpy(tokens)))


def test_launch_train_on_the_cpu(tmp_path):
    out = io.StringIO()
    with redirect_stdout(out):
        losses = launch_train.main(["--arch", "gemma3-1b", "--device", "cpu",
                                    "--steps", "2", "--seq", "40"])
    lines = out.getvalue().splitlines()
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert lines[0].startswith("[train] step 1/2 loss=") and lines[-1] == "[train] done"
    # --ckpt-dir (ROADMAP.md Queue 1, item 6) checkpoints every --ckpt-every
    with redirect_stdout(io.StringIO()):
        again = launch_train.main(["--arch", "gemma3-1b", "--device", "cpu",
                                   "--steps", "2", "--seq", "40", "--ckpt-dir",
                                   str(tmp_path), "--ckpt-every", "1"])
    assert again == losses
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000001", "step_0000000002"]


def test_launch_train_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "llama3.2-1b", "--steps", "1"])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_train_steps_launch_adam_once_and_match_plain():
    """Three bfloat16 steps of the 6-layer gemma3-1b on the card: one
    ``fused_adam`` launch a step and no flash launch (training attention
    is the masked core), the losses within 1e-3 relative and the
    parameters within 1e-3 of the plain-Adam program's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("gemma3-1b").reduced(), n_layers=6)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = make_dummy_batch(cfg, 2, 48, generator=torch.Generator(device=dev).manual_seed(1))
    out = []
    for fused in (True, False):
        opt = adamw(tsched.warmup_cosine(LR, WARMUP, STEPS), fused=fused)
        step = make_train_step(model, opt)
        p, s, losses = params, opt.init(params), []
        adam_before, flash_before = fused_adam.launches, flash_attention.launches
        for _ in range(STEPS):
            p, s, loss = step(p, s, batch)
            losses.append(float(loss))
        assert fused_adam.launches - adam_before == (STEPS if fused else 0)
        assert flash_attention.launches == flash_before
        out.append((losses, [t.cpu() for t in tree_leaves(p)]))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-3)
    _assert_leaves_close(out[0][1], [t.numpy() for t in out[1][1]],
                         dict(atol=1e-3, rtol=1e-3))
