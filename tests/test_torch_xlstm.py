"""Port parity, xLSTM (``models/xlstm.py``, xlstm-1.3b): ``mlstm_apply``
and ``slstm_apply`` on T a multiple of the chunk and not, T = 1 with a
cache and a prefill from a non-zero state, their new caches, and their
gradients against ``jax.grad``; the sLSTM ``torch.autograd.Function``'s
cotangents for ``r_gates``, ``gates_x`` and the entering state against
the JAX package's custom VJP, and its one batched ``d r_gates``
contraction; mLSTM chunked against recurrent in the port; the JAX
package's overflow in ``_chunked_mlstm`` (ROADMAP.md Queue 3, item 11);
then a reduced xlstm-1.3b end to end (``_torch_lm_family.py``).

Weights are the JAX package's init carried over by ``params_from_jax``,
with the gate biases moved off their constant init; inputs are seeded
numpy. Tolerance 1e-4 (absolute and relative, float32), the JAX suite's,
and ``test_torch_lm_train.py``'s rules for training."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_lm_family as fam_checks  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import LMConfig, SSMConfig  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402
from repro_torch.models.model_zoo import build_model, count_params  # noqa: E402
from repro_torch.models.transformer import params_from_jax, plan_segments  # noqa: E402
from repro_torch.training.optimizer import tree_leaves  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "xlstm-1.3b"
KINDS = ("mlstm", "slstm")


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    from repro.models import xlstm as jxlstm

    return types.SimpleNamespace(**vars(fam_checks.jax_modules()), xlstm=jxlstm)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def blocks(jx):
    """The reduced xlstm-1.3b's mLSTM and sLSTM blocks (d_model 64, 4 heads
    of 16, chunk 16) in both packages, the gate biases moved off their
    constant init."""
    cfg, jcfg = get_config(ARCH).reduced(), jx.get_config(ARCH).reduced()
    out = {}
    for i, kind in enumerate(KINDS):
        jp = jx.jax.device_get(getattr(jx.xlstm, kind + "_init")(
            jx.jax.random.PRNGKey(1 + i), jcfg))
        for j, k in enumerate(("b_gate_i", "b_gate_f", "b_gates")):
            if k in jp:
                jp[k] = jp[k] + _np(jp[k].shape, 10 + j, 0.5)
        out[kind] = types.SimpleNamespace(jp=jp, tp=params_from_jax(jp, device="cpu"))
    return types.SimpleNamespace(cfg=cfg, jcfg=jcfg, **out)


def _cache(jx, blocks, kind, seed):
    """A non-zero cache in both packages: normalisers positive, sLSTM's
    stabiliser ``m`` at a few units."""
    jc = jx.jax.device_get(getattr(jx.xlstm, kind + "_cache_init")(blocks.jcfg, 2))
    jc = {k: _np(v.shape, seed + i, 0.5) for i, (k, v) in enumerate(sorted(jc.items()))}
    jc["n"] = np.abs(jc["n"]) + np.float32(0.5 if kind == "slstm" else 0.0)
    return jc, {k: torch.from_numpy(v.copy()) for k, v in jc.items()}


# ---------------------------------------------------------------------------
# The blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("t,cached", [(32, False), (21, False), (21, True), (1, True)])
def test_block_apply_matches_jax(jx, blocks, kind, t, cached):
    """The output, and with a cache (non-zero: a prefill that continues, or
    one decode step) the new states, written into the port's cache in
    place."""
    b = getattr(blocks, kind)
    x = _np((2, t, blocks.cfg.d_model), 3)
    jc, tc = _cache(jx, blocks, kind, 20) if cached else (None, None)
    want, jnew = jx.jax.jit(getattr(jx.xlstm, kind + "_apply"), static_argnums=1)(
        b.jp, blocks.jcfg, jx.jnp.asarray(x), cache=jc)
    got, tnew = getattr(xlstm, kind + "_apply")(b.tp, blocks.cfg, torch.from_numpy(x),
                                                cache=tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if not cached:
        assert tnew is None
        return
    assert sorted(tnew) == sorted(jnew)
    for k in jnew:
        assert tnew[k] is tc[k] and tc[k].dtype == torch.float32
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jnew[k]), **TOL, err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("t", [32, 21])
def test_block_grads_match_jax(jx, blocks, kind, t):
    """Gradients of ⟨out, cot⟩ for every weight and the input against
    ``jax.grad`` (sLSTM's through both packages' custom backward)."""
    b = getattr(blocks, kind)
    x, cot = _np((2, t, blocks.cfg.d_model), 4), _np((2, t, blocks.cfg.d_model), 5)
    japply, tapply = getattr(jx.xlstm, kind + "_apply"), getattr(xlstm, kind + "_apply")

    def jloss(p, xx):
        return (japply(p, blocks.jcfg, xx)[0] * cot).sum()

    jg, jgx = jx.jax.jit(jx.jax.grad(jloss, argnums=(0, 1)))(b.jp, jx.jnp.asarray(x))
    tp = {k: v.clone().requires_grad_(True) for k, v in b.tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    (tapply(tp, blocks.cfg, tx)[0] * torch.from_numpy(cot)).sum().backward()
    for k in sorted(tp):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]), **TOL, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)


def test_slstm_scan_vjp_matches_jax(jx, blocks, monkeypatch):
    """``slstm_scan`` from a non-zero state over 13 steps with random
    cotangents on the final state (all four) and on every step's h: the
    cotangents of ``r_gates``, ``gates_x`` and the entering state against
    the JAX package's custom VJP. The backward takes one ``einsum`` over
    the whole sequence for ``d r_gates`` and one a step for ``dh_prev``."""
    h, dh = 4, 16
    r = _np((h, dh, 4 * dh), 30, 0.25)
    gx = _np((13, 2, 4, h, dh), 31)
    jc, _ = _cache(jx, blocks, "slstm", 32)
    state0 = tuple(jc[k] for k in ("c", "n", "h", "m"))
    cots = (tuple(_np(a.shape, 40 + i) for i, a in enumerate(state0)),
            _np((13, 2, h, dh), 45))

    def jfn(rr, gg, s0):
        return jx.xlstm.slstm_scan(rr, gg, s0)

    @jx.jax.jit
    def jvjp(rr, gg, s0, cot):
        out, vjp = jx.jax.vjp(jfn, rr, gg, s0)
        return out, vjp(cot)

    (jfin, jhs), (jdr, jdgx, jds0) = jvjp(
        jx.jnp.asarray(r), jx.jnp.asarray(gx), tuple(map(jx.jnp.asarray, state0)),
        (tuple(map(jx.jnp.asarray, cots[0])), jx.jnp.asarray(cots[1])))
    tr, tgx = (torch.from_numpy(a).requires_grad_(True) for a in (r, gx))
    ts0 = tuple(torch.from_numpy(a).requires_grad_(True) for a in state0)
    einsums = []
    real = torch.einsum
    monkeypatch.setattr(torch, "einsum", lambda eq, *a: einsums.append(eq) or real(eq, *a))
    fin, hs = xlstm.slstm_scan(tr, tgx, ts0)
    for got, want in zip((*fin, hs), (*jfin, jhs)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    del einsums[:]
    torch.autograd.backward([*fin, hs], [torch.from_numpy(c) for c in (*cots[0], cots[1])])
    assert einsums.count("tbhd,tbhe->hde") == 1 and einsums.count("bhe,hde->bhd") == 13
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jdr), **TOL)
    np.testing.assert_allclose(tgx.grad.numpy(), np.asarray(jdgx), **TOL)
    for got, want in zip(ts0, jds0):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **TOL)


def test_mlstm_chunked_equals_recurrent():
    """The JAX suite's ``test_mlstm_chunked_equals_recurrent`` in the port:
    the chunked form over 10 steps (chunk 4) against ten T = 1 steps."""
    cfg = LMConfig(name="x", family="ssm", n_layers=1, d_model=16, n_heads=2,
                   n_kv_heads=2, d_ff=0, vocab_size=64, ssm=SSMConfig(chunk=4))
    p = xlstm.mlstm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.from_numpy(_np((1, 10, 16), 11, 0.5))
    y_par, _ = xlstm.mlstm_apply(p, cfg, x)
    c = xlstm.mlstm_cache_init(cfg, 1, device="cpu")
    ys = [xlstm.mlstm_apply(p, cfg, x[:, t:t + 1], cache=c)[0] for t in range(10)]
    np.testing.assert_allclose(y_par.numpy(), torch.cat(ys, 1).numpy(),
                               atol=1e-3, rtol=1e-2)


def test_jax_mlstm_gradient_overflows_where_the_port_stays_finite(jx):
    """ROADMAP.md Queue 3, item 11, for mLSTM: a forget gate of sigmoid(-1)
    (-log f = 1.31 a step) over a 128-step chunk sums to 167 above the
    diagonal, past float32 ``exp``'s ~88.7; the forget-gate input reaches
    that in training (its bias starts at 3). The JAX package's
    ``where(mask, exp(rel)·i, 0)`` keeps the value and makes the gradient
    NaN; the port masks first: the same forward within 1e-4 and a finite
    gradient, which matches JAX's where no entry overflows (f =
    sigmoid(3), -log f = 0.049 a step)."""
    r = np.random.default_rng(50)
    q, k, v = (r.standard_normal((1, 128, 2, 8)).astype(np.float32) * 0.3 for _ in range(3))
    i = np.exp(r.standard_normal((1, 128, 2)).astype(np.float32) * 0.5)
    c0, n0 = np.zeros((1, 2, 8, 8), np.float32), np.zeros((1, 2, 8), np.float32)
    rest = (i, q, k, v, c0, n0)

    def jforward(ff, *more):
        return jx.xlstm._chunked_mlstm(ff, *more, chunk=128)[0]

    jforward = jx.jax.jit(jforward)
    jgrad = jx.jax.jit(jx.jax.grad(lambda *a: jforward(*a).sum()))
    for pre, jax_finite in ((-1.0, False), (3.0, True)):
        f = np.full((1, 128, 2), 1 / (1 + np.exp(-pre)), np.float32)
        jy = jforward(*map(jx.jnp.asarray, (f, *rest)))
        jg = np.asarray(jgrad(*map(jx.jnp.asarray, (f, *rest))))
        tf = torch.from_numpy(f).requires_grad_(True)
        y = xlstm._chunked_mlstm(tf, *map(torch.from_numpy, rest), chunk=128)[0]
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
        y.sum().backward()
        assert torch.isfinite(tf.grad).all()
        assert np.isfinite(jg).all() == jax_finite
        if jax_finite:
            np.testing.assert_allclose(tf.grad.numpy(), jg, **TOL)
        else:
            assert np.isnan(jg).any()


# ---------------------------------------------------------------------------
# xlstm-1.3b, reduced, end to end
# ---------------------------------------------------------------------------

def _xlstm_cfg(getter):
    """The reduced xlstm-1.3b (d_model 64, 4 heads of 16, chunk 16) at 8
    layers, an sLSTM block second in each period of 4 (mLSTM, sLSTM,
    mLSTM, mLSTM) scanned twice, as the published config's period of 8
    six times."""
    kinds = tuple("slstm" if i % 4 == 1 else "mlstm" for i in range(8))
    return dataclasses.replace(getter(ARCH).reduced(), n_layers=8, block_pattern=kinds)


@pytest.fixture(scope="module")
def xl(jx):
    return fam_checks.family(jx, _xlstm_cfg)


def test_xlstm_builds_and_counts(jx, xl):
    """The plan (one scanned period), the init tree's shapes leaf for leaf,
    and ``count_params`` exactly the initialised count less the final norm
    and the mLSTM gates' two biases of H (the JAX package's closed form
    leaves both out), for the reduced and the published config."""
    assert [(s.mode, s.n_reps) for s in plan_segments(xl.cfg)] == [("scan", 2)]
    params = build_model(xl.cfg).init(torch.Generator().manual_seed(0), device="cpu")
    assert ([tuple(t.shape) for t in tree_leaves(params)]
            == [tuple(a.shape) for a in jx.jax.tree_util.tree_leaves(xl.jparams)])
    n = sum(t.numel() for t in tree_leaves(params))
    n_mlstm = xl.cfg.blocks.count("mlstm")
    assert count_params(xl.cfg) + xl.cfg.d_model + 2 * xl.cfg.n_heads * n_mlstm == n
    assert count_params(get_config(ARCH)) == 1_283_330_048


def test_xlstm_forward_loss_and_grads_match_jax(jx, xl):
    fam_checks.check_forward_loss_and_grads(jx, xl)


def test_xlstm_prefill_and_decode_match_jax(jx, xl, monkeypatch):
    """A 37-token prompt (2.3 chunks) and four decode steps; no layer
    takes the flash executor."""
    fam_checks.check_prefill_and_decode(jx, xl, 37, 0, monkeypatch)


def test_xlstm_serving_engine_matches_jax(jx, xl):
    fam_checks.check_engine(jx, xl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_train_steps_match_jax(jx, xl, dtype):
    fam_checks.check_train_steps(jx, xl, dtype)


def test_xlstm_jax_checkpoint_restores_in_the_port(jx, xl, tmp_path):
    fam_checks.check_checkpoint_round_trip(jx, xl, tmp_path)
