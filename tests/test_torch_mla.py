"""Port parity, DeepSeek-V3's multi-head latent attention and its serving.

``repro_torch.models.attention``'s ``mla_apply`` against
``repro/models/attention.py``'s, at ``get_config("deepseek-v3-671b")
.reduced()`` with the JAX package's weights carried over by
``params_from_jax``: without a cache, then with the latent cache at
(idx, t) = (0, 9), (0, 1) and (5, 1), float32 and bfloat16, the output
and the latent it writes; the latent cache's compression (the JAX
suite's ``test_mla_latent_cache_is_compressed``); ``LM.init_cache``'s
tree; and ``ServingEngine`` on the reduced deepseek-v3-671b against the
JAX engine. The model's forward, loss and training parity are in
``test_torch_moe.py``.

Tolerance 1e-4 (absolute and relative), the JAX suite's, with the cache
in float32; with a bfloat16 cache both packages read the same rounded
latent, so the same tolerance holds. The engines' greedy tokens must be
equal."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "deepseek-v3-671b"


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models import attention as jattn
    from repro.models.model_zoo import build_model as jax_build_model
    from repro.serving import engine as jengine

    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=jax_get_config,
                                 attn=jattn, build_model=jax_build_model,
                                 engine=jengine)


@pytest.fixture(scope="module")
def mla(jx):
    """One MLA layer's weights in both packages (the JAX package's
    ``mla_init``, carried over)."""
    cfg = get_config(ARCH).reduced()
    jp = jx.attn.mla_init(jx.jax.random.PRNGKey(3), jx.get_config(ARCH).reduced())
    return types.SimpleNamespace(cfg=cfg, jp=jp,
                                 tp=params_from_jax(jx.jax.device_get(jp), device="cpu"))


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want).astype(np.float32), **TOL)


def _latent_dim(cfg) -> int:
    return cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim


@pytest.mark.parametrize("t", [1, 9])
def test_mla_apply_without_cache(jx, mla, t):
    x = np.random.default_rng(4).standard_normal((2, t, mla.cfg.d_model)).astype(np.float32)
    pos = np.arange(t)
    want, _ = jx.attn.mla_apply(mla.jp, mla.cfg, jx.jnp.asarray(x), jx.jnp.asarray(pos))
    got, cache = tattn.mla_apply(mla.tp, mla.cfg, torch.from_numpy(x), torch.from_numpy(pos))
    assert cache is None and tuple(got.shape) == (2, t, mla.cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("idx,t", [(0, 9), (0, 1), (5, 1)])
def test_mla_apply_with_cache(jx, mla, idx, t, cache_dtype):
    """Against the JAX package's cache branch: the output, the latent it
    writes in place at ``idx`` (at the cache's dtype) and the new index.
    Positions before ``idx`` hold an earlier call's latents."""
    b, s_max = 2, 16
    r = np.random.default_rng(5 + idx + t)
    x = r.standard_normal((b, t, mla.cfg.d_model)).astype(np.float32)
    filled = r.standard_normal((b, s_max, _latent_dim(mla.cfg))).astype(np.float32)
    filled[:, idx:] = 0.0
    pos = np.arange(idx, idx + t)
    jdt = getattr(jx.jnp, cache_dtype)
    jcache = {"latent": jx.jnp.asarray(filled).astype(jdt), "idx": jx.jnp.int32(idx)}
    want, jnew = jx.attn.mla_apply(mla.jp, mla.cfg, jx.jnp.asarray(x), jx.jnp.asarray(pos),
                                   cache=jcache)
    tcache = {"latent": torch.from_numpy(filled).to(getattr(torch, cache_dtype)), "idx": idx}
    got, tnew = tattn.mla_apply(mla.tp, mla.cfg, torch.from_numpy(x), torch.from_numpy(pos),
                                cache=tcache)
    _close(got, want)
    assert tnew["latent"] is tcache["latent"]  # updated in place
    assert tnew["idx"] == idx + t == int(jnew["idx"])
    _close(tnew["latent"], jnew["latent"].astype(jx.jnp.float32))


def test_mla_cache_overflow_raises(mla):
    cache = tattn.mla_cache_init(mla.cfg, 1, 4, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        tattn.mla_apply(mla.tp, mla.cfg, torch.zeros(1, 5, mla.cfg.d_model),
                        torch.arange(5), cache={**cache, "idx": 0})


def test_mla_latent_cache_is_compressed(jx):
    """The JAX suite's test at the published widths: the latent is
    kv_lora_rank + qk_rope_head_dim = 576 a position, under an eighth of
    the 2 · 128 · 128 values a full K/V cache of the same heads holds."""
    cfg = get_config(ARCH)
    c = tattn.mla_cache_init(cfg, batch=1, s_max=128, device="cpu")
    jc = jx.attn.mla_cache_init(jx.get_config(ARCH), batch=1, s_max=128)
    assert set(c) == {"latent"} and set(jc) == {"latent", "idx"}
    assert tuple(c["latent"].shape) == jc["latent"].shape == (1, 128, 576)
    assert c["latent"].dtype == torch.bfloat16
    full_kv_dim = 2 * cfg.n_heads * cfg.mla.v_head_dim
    assert _latent_dim(cfg) * 8 < full_kv_dim


@pytest.fixture(scope="module")
def lm(jx):
    cfg = get_config(ARCH).reduced()
    jmodel = jx.build_model(jx.get_config(ARCH).reduced(), remat="none")
    jparams = jmodel.init(jx.jax.random.PRNGKey(0))
    return types.SimpleNamespace(
        cfg=cfg, jmodel=jmodel, jparams=jparams, model=build_model(cfg),
        tparams=params_from_jax(jx.jax.device_get(jparams), device="cpu"))


def test_init_cache_holds_latents(jx, lm):
    """``LM.init_cache``: the JAX tree's shapes (a latent per layer, no
    K/V), index 0; no layer of deepseek calls the flash executor."""
    jc = lm.jmodel.init_cache(2, 16, dtype=jx.jnp.float32)
    tc = lm.model.init_cache(2, 16, dtype=torch.float32, device="cpu")
    jshapes = [tuple(a.shape) for a in jx.jax.tree_util.tree_leaves(jc["segments"])]
    tshapes = [tuple(layer["attn"]["latent"].shape)
               for seg in tc["segments"] for layer in seg]
    assert tshapes == jshapes == [(2, 16, _latent_dim(lm.cfg))] * lm.cfg.n_layers
    assert tc["idx"] == 0


def _requests(cls, cfg):
    rng = np.random.default_rng(2)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                           size=int(rng.integers(4, 20))).astype(np.int32),
                max_new_tokens=8) for i in range(6)]


def test_serving_engine_matches_jax(jx, lm, monkeypatch):
    """Six requests over four slots (two left-padded waves), greedy
    decoding, float32 latent caches: the JAX engine's tokens, request by
    request, and no flash call (MLA takes the masked core)."""
    calls = []
    flash = tops._EXECUTORS["cuda"]["flash"]
    monkeypatch.setitem(tops._EXECUTORS["cuda"], "flash",
                        lambda *a, **k: calls.append(1) or flash(*a, **k))
    jeng = jx.engine.ServingEngine(lm.jmodel, lm.jparams, batch_slots=4, max_seq=40)
    teng = ServingEngine(lm.model, lm.tparams, batch_slots=4, max_seq=40, device="cpu")
    for jr, tr in zip(_requests(jx.engine.Request, lm.cfg), _requests(Request, lm.cfg)):
        jeng.submit(jr)
        teng.submit(tr)
    jdone, tdone = jeng.run(), teng.run()
    assert [r.rid for r in tdone] == [r.rid for r in jdone] == list(range(6))
    for jr, tr in zip(jdone, tdone):
        assert tr.done and len(tr.output) == 8
        assert tr.output == [int(t) for t in jr.output], tr.rid
    assert calls == []
