"""Port parity, Mamba2/SSD and Zamba2's shared block (``models/ssm.py``,
zamba2-7b): ``mamba_apply`` on T a multiple of the chunk and not, T = 1
with a cache and a prefill from a non-zero state, its new cache, and its
gradients (and ``_chunked_ssd``'s, the entering state's among them)
against ``jax.grad``; the chunked form against the recurrence in the port;
its float32 error against float64, where the port's segment sums depart
from the JAX package's prefix-sum differences; the JAX package's overflow
(ROADMAP.md Queue 3, item 11); then a reduced
zamba2-7b end to end (``_torch_lm_family.py``): ``LM.forward``, ``loss``
and its gradients, prefill and decode with the caches, the
``ServingEngine``'s tokens, three AdamW steps in float32 and bfloat16,
and a JAX checkpoint restored in the port and back. The flash kernel at
zamba2-7b's head width, D = 112, on the card (marked ``cuda``).

Weights are the JAX package's init carried over by ``params_from_jax``,
with the biases and ``a_log`` moved off their constant init; inputs are
seeded numpy. Tolerance 1e-4 (absolute and relative, float32), the JAX
suite's, and ``test_torch_lm_train.py``'s rules for training."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_lm_family as fam_checks  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import LMConfig, SSMConfig  # noqa: E402
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.model_zoo import build_model, count_params  # noqa: E402
from repro_torch.models.transformer import params_from_jax, plan_segments  # noqa: E402
from repro_torch.training.optimizer import tree_leaves  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "zamba2-7b"


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    from repro.configs.base import LMConfig as JLMConfig
    from repro.configs.base import SSMConfig as JSSMConfig
    from repro.models import ssm as jssm

    return types.SimpleNamespace(**vars(fam_checks.jax_modules()), ssm=jssm,
                                 LMConfig=JLMConfig, SSMConfig=JSSMConfig)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def block(jx):
    """The reduced zamba2-7b's Mamba2 block (d_model 64, 16 heads of P 8,
    N 8, chunk 16) in both packages, ``a_log``, ``dt_bias`` and ``conv_b``
    moved off their constant init."""
    cfg, jcfg = get_config(ARCH).reduced(), jx.get_config(ARCH).reduced()
    jp = jx.jax.device_get(jx.ssm.mamba_init(jx.jax.random.PRNGKey(1), jcfg))
    for i, k in enumerate(("a_log", "dt_bias", "conv_b", "d_skip")):
        jp[k] = jp[k] + _np(jp[k].shape, 10 + i, 0.3)
    return types.SimpleNamespace(cfg=cfg, jcfg=jcfg, jp=jp,
                                 tp=params_from_jax(jp, device="cpu"))


def _cache(jx, block, seed):
    """A non-zero cache (conv tail and state) in both packages."""
    jc = jx.jax.device_get(jx.ssm.mamba_cache_init(block.jcfg, 2))
    jc = {k: _np(v.shape, seed + i, 0.5) for i, (k, v) in enumerate(sorted(jc.items()))}
    return jc, {k: torch.from_numpy(v.copy()) for k, v in jc.items()}


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,cached", [(32, False), (21, False), (32, True), (21, True),
                                      (1, True)])
def test_mamba_apply_matches_jax(jx, block, t, cached):
    """The output, and with a cache (the state non-zero: a prefill that
    continues, or one decode step) the new conv tail and state, written
    into the port's cache in place."""
    x = _np((2, t, block.cfg.d_model), 3)
    jc, tc = _cache(jx, block, 20) if cached else (None, None)
    want, jnew = jx.jax.jit(jx.ssm.mamba_apply, static_argnums=1)(
        block.jp, block.jcfg, jx.jnp.asarray(x), cache=jc)
    got, tnew = ssm.mamba_apply(block.tp, block.cfg, torch.from_numpy(x), cache=tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if not cached:
        assert tnew is None
        return
    for k in ("conv", "state"):
        assert tnew[k] is tc[k] and tc[k].dtype == torch.float32
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jnew[k]), **TOL)


@pytest.mark.parametrize("t", [32, 21])
def test_mamba_grads_match_jax(jx, block, t):
    """Gradients of ⟨out, cot⟩ for every weight and the input against
    ``jax.grad``."""
    x, cot = _np((2, t, block.cfg.d_model), 4), _np((2, t, block.cfg.d_model), 5)

    def jloss(p, xx):
        return (jx.ssm.mamba_apply(p, block.jcfg, xx)[0] * cot).sum()

    jg, jgx = jx.jax.jit(jx.jax.grad(jloss, argnums=(0, 1)))(block.jp, jx.jnp.asarray(x))
    tp = {k: v.clone().requires_grad_(True) for k, v in block.tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    (ssm.mamba_apply(tp, block.cfg, tx)[0] * torch.from_numpy(cot)).sum().backward()
    for k in sorted(tp):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]), **TOL, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)


def _ssd_inputs(t, dt, h=2, p=4, n=3, seed=6):
    """decay exp(-dt) (a = -1), and the streams of ``_chunked_ssd``."""
    r = np.random.default_rng(seed)
    decay = np.exp(-np.broadcast_to(np.float32(dt), (1, t, h))).astype(np.float32)
    return (decay, r.standard_normal((1, t, h, p)).astype(np.float32),
            r.standard_normal((1, t, n)).astype(np.float32),
            r.standard_normal((1, t, n)).astype(np.float32),
            r.standard_normal((1, h, p, n)).astype(np.float32))


def test_chunked_ssd_grads_match_jax(jx):
    """``_chunked_ssd`` from a non-zero entering state over 2.5 chunks: the
    output and final state, and the gradients of both (random cotangents)
    for the decay, the streams and the entering state."""
    inputs = list(_ssd_inputs(20, 0.0, seed=7))
    inputs[0] = np.exp(-np.abs(_np((1, 20, 2), 8, 0.5))).astype(np.float32)
    cy, cs = _np((1, 20, 2, 4), 9), _np((1, 2, 4, 3), 10)

    def jloss(*a):
        y, s = jx.ssm._chunked_ssd(*a, 8)
        return (y * cy).sum() + (s * cs).sum()

    jy, js = jx.jax.jit(jx.ssm._chunked_ssd, static_argnums=5)(
        *map(jx.jnp.asarray, inputs), 8)
    jgrads = jx.jax.jit(jx.jax.grad(jloss, argnums=tuple(range(5))))(
        *map(jx.jnp.asarray, inputs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    y, s = ssm._chunked_ssd(*ts, 8)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), **TOL)
    ((y * torch.from_numpy(cy)).sum() + (s * torch.from_numpy(cs)).sum()).backward()
    for t, g in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


def test_chunked_ssd_segment_sums_keep_float32_precision(jx):
    """At zamba2's chunk of 128 over 512 steps (dt softplus of a normal),
    the port's float32 SSD within 3e-7 (root mean square, relative) of the
    same function in float64: each decay exponent summed from its own
    terms (``_segsum``). The JAX package's, the difference of two prefix
    sums that reach ~90 in a chunk, lands 1.3e-6 away, over 4x the
    port's."""
    r = np.random.default_rng(12)
    dt = np.log1p(np.exp(r.standard_normal((1, 512, 2))))
    inputs = [np.exp(-dt), r.standard_normal((1, 512, 2, 8)) * dt[..., None],
              r.standard_normal((1, 512, 16)), r.standard_normal((1, 512, 16)),
              np.zeros((1, 2, 8, 16))]
    exact = ssm._chunked_ssd(*map(torch.from_numpy, inputs), 128)[0].numpy()
    port = ssm._chunked_ssd(*(torch.from_numpy(a.astype(np.float32)) for a in inputs),
                            128)[0].numpy()
    jax_y = np.asarray(jx.jax.jit(jx.ssm._chunked_ssd, static_argnums=5)(
        *(jx.jnp.asarray(a, jx.jnp.float32) for a in inputs), 128)[0])

    def rel(y):
        return np.sqrt(np.mean((y.astype(np.float64) - exact) ** 2) / np.mean(exact ** 2))

    assert rel(port) <= 3e-7 and rel(jax_y) >= 4 * rel(port), (rel(port), rel(jax_y))


def test_mamba_chunked_equals_recurrent():
    """The JAX suite's ``test_mamba_chunked_equals_recurrent`` in the port:
    the chunked form over 10 steps (chunk 4) against ten T = 1 steps."""
    cfg = LMConfig(name="m", family="ssm", n_layers=1, d_model=16, n_heads=2,
                   n_kv_heads=2, d_ff=0, vocab_size=64,
                   ssm=SSMConfig(state_dim=4, head_dim=8, chunk=4))
    p = ssm.mamba_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.from_numpy(_np((1, 10, 16), 11, 0.5))
    y_par, _ = ssm.mamba_apply(p, cfg, x)
    c = ssm.mamba_cache_init(cfg, 1, device="cpu")
    ys = [ssm.mamba_apply(p, cfg, x[:, t:t + 1], cache=c)[0] for t in range(10)]
    np.testing.assert_allclose(y_par.numpy(), torch.cat(ys, 1).numpy(),
                               atol=1e-4, rtol=1e-3)


def test_jax_ssd_gradient_overflows_where_the_port_stays_finite(jx):
    """ROADMAP.md Queue 3, item 11: at zamba2's chunk of 128 and a constant
    dt of 0.8, the summed decay above the diagonal reaches 101.6, past
    float32 ``exp``'s ~88.7. The JAX package's ``where(mask, exp(rel), 0)``
    keeps the value and makes the gradient NaN (0 · inf); the port masks
    ``rel`` first: the same forward within 1e-4, a finite gradient that
    matches JAX's at dt 0.3, where neither overflows."""
    def jforward(decay, *rest):
        return jx.ssm._chunked_ssd(decay, *rest, 128)[0]

    jforward = jx.jax.jit(jforward)
    jgrad = jx.jax.jit(jx.jax.grad(lambda *a: jforward(*a).sum()))
    for dt, jax_finite in ((0.8, False), (0.3, True)):
        inputs = _ssd_inputs(128, dt)
        jy = jforward(*map(jx.jnp.asarray, inputs))
        jg = np.asarray(jgrad(*map(jx.jnp.asarray, inputs)))
        decay = torch.from_numpy(inputs[0]).requires_grad_(True)
        y, _ = ssm._chunked_ssd(decay, *map(torch.from_numpy, inputs[1:]), 128)
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
        y.sum().backward()
        assert torch.isfinite(decay.grad).all()
        assert np.isfinite(jg).all() == jax_finite
        if jax_finite:
            np.testing.assert_allclose(decay.grad.numpy(), jg, atol=1e-3, rtol=1e-4)
        else:
            assert np.isnan(jg).all()


# ---------------------------------------------------------------------------
# zamba2-7b, reduced, end to end
# ---------------------------------------------------------------------------

def _zamba_cfg(getter):
    """The reduced zamba2-7b (d_model 64, 4 heads of 16) at 8 layers, a
    shared site every third: a scanned period (mamba, mamba, shared_attn)
    twice and an unrolled tail of two mamba layers, as the published
    config's 13 periods of 6 and tail of 3."""
    kinds = tuple("shared_attn" if i % 3 == 2 else "mamba" for i in range(8))
    return dataclasses.replace(getter(ARCH).reduced(), n_layers=8, block_pattern=kinds)


@pytest.fixture(scope="module")
def zamba(jx):
    return fam_checks.family(jx, _zamba_cfg)


def test_zamba_builds_and_counts(jx, zamba):
    """The plan (a scanned period with its shared site, and a tail), the
    init tree's shapes leaf for leaf (``{}`` at each shared site, one
    ``shared_attn`` block), and ``count_params`` exactly the initialised
    count less the final norm, for the reduced and the published config."""
    segs = plan_segments(zamba.cfg)
    assert [(s.mode, s.kinds, s.n_reps) for s in segs] == [
        ("scan", ("mamba", "mamba", "shared_attn"), 2), ("unroll", ("mamba", "mamba"), 1)]
    params = build_model(zamba.cfg).init(torch.Generator().manual_seed(0), device="cpu")
    assert params["segments"][0][2] == {} and zamba.jparams["segments"][0][2] == {}
    assert ([tuple(t.shape) for t in tree_leaves(params)]
            == [tuple(a.shape) for a in jx.jax.tree_util.tree_leaves(zamba.jparams)])
    n = sum(t.numel() for t in tree_leaves(params))
    assert count_params(zamba.cfg) + zamba.cfg.d_model == n
    assert count_params(get_config(ARCH)) == 5_736_924_992


def test_zamba_forward_loss_and_grads_match_jax(jx, zamba):
    fam_checks.check_forward_loss_and_grads(jx, zamba)


def test_zamba_prefill_and_decode_match_jax(jx, zamba, monkeypatch):
    """A 37-token prompt (2.3 chunks) and four decode steps; the two
    shared sites' prefill attention takes the flash executor."""
    fam_checks.check_prefill_and_decode(jx, zamba, 37, 2, monkeypatch)


def test_zamba_serving_engine_matches_jax(jx, zamba):
    fam_checks.check_engine(jx, zamba)


#: the leaves whose bfloat16 gradient reads over BF16_GRAD_REL with
#: ``jax_ssd`` (ROADMAP.md Queue 3, item 12)
ZAMBA_BF16_OVER = ("/segments[0][0]/mamba/d_skip", "/segments[0][1]/mamba/a_log",
                   "/segments[0][1]/mamba/dt_bias", "/segments[1][0]/mamba/a_log",
                   "/segments[1][1]/mamba/a_log", "/segments[1][1]/mamba/dt_bias")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba_train_steps_match_jax(jx, zamba, dtype):
    """bfloat16 gradients leaf by leaf with JAX's prefix-sum decay
    exponents and composite softplus replayed (``jax_ssd``); six of the
    decay's leaves (``a_log``, ``dt_bias``, one ``d_skip``) still read over
    the rule (0.56-1.06) and keep the size check (ROADMAP.md Queue 3,
    item 12)."""
    fam_checks.check_train_steps(jx, zamba, dtype, bf16_replay=lambda jx, fam: fam_checks.jax_ssd(),
                                 bf16_over=ZAMBA_BF16_OVER)


def test_zamba_jax_checkpoint_restores_in_the_port(jx, zamba, tmp_path):
    fam_checks.check_checkpoint_round_trip(jx, zamba, tmp_path)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_flash_d112_matches_plain():
    """The flash kernel at D = 112 (zamba2-7b's shared block: 32 heads,
    32 KV heads) against its plain version: float32 within 2e-5 at a
    1,024-token prefill (B 2) and on ragged tiles (Tq 150 against Tk 97
    causal, 201 not), a repeat launch bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    assert 112 in HEAD_DIMS
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    for b, h, hkv, tq, tk, causal in ((2, 32, 32, 1024, 1024, True),
                                      (1, 4, 2, 150, 97, True), (1, 4, 4, 150, 201, False)):
        q = torch.randn((b, h, tq, 112), generator=gen, device=dev)
        k, v = (torch.randn((b, hkv, tk, 112), generator=gen, device=dev) for _ in range(2))
        before = flash_attention.launches
        got = flash_attention(q, k, v, causal=causal)
        again = flash_attention(q, k, v, causal=causal)
        assert flash_attention.launches - before == 2
        want = flash_attention_ref(q, k, v, causal=causal)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        assert torch.equal(got, again)
