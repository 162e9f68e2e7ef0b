"""Port parity, the LM substrate's serving path (dense family): at
``get_config("llama3.2-1b").reduced()`` with the JAX package's weights
carried over by ``params_from_jax``, the port's norms, MLPs, RoPE,
``gqa_apply`` (without a cache, and with one at index 0, where the flash
kernel's plain version runs, and past 0; with a sliding window, which
always takes the masked core), ``make_mask`` with windows,
``LM.forward``, ``prefill`` and three ``decode_step``s, and
``ServingEngine`` on the JAX example's traffic against the JAX package's;
the same end to end for gemma3-1b (6 layers, so that layer 5 is global,
with prompts longer than its 32-token reduced window), starcoder2-3b
(LayerNorm, GELU), granite-34b (one KV head), whisper-tiny (text alone:
its cross attention over the cache's zeroed encoder output, as the JAX
engine runs it) and pixtral-12b (text alone); the copied configs,
``plan_segments`` and ``count_params``. The flash kernel's own tests are in
``test_torch_flash_attention.py``, LM training's in
``test_torch_lm_train.py``.

Tolerance 1e-4 (absolute and relative, float32), the JAX suite's: the
same float32 operations in another order (CPU matmuls, the flash
version's softmax against the JAX package's masked softmax over the whole
cache). The engines' greedy tokens must be equal."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.model_zoo import (  # noqa: E402
    build_model,
    count_params,
    make_decode_step,
    make_prefill_step,
)
from repro_torch.models.transformer import params_from_jax, plan_segments  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.training.optimizer import tree_leaves  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "llama3.2-1b"


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models import attention as jattn
    from repro.models import layers as jlayers
    from repro.models.model_zoo import build_model as jax_build_model
    from repro.models.model_zoo import count_params as jax_count_params
    from repro.models.transformer import plan_segments as jax_plan_segments
    from repro.serving import engine as jengine

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=jax_get_config, attn=jattn,
        layers=jlayers, build_model=jax_build_model,
        count_params=jax_count_params, plan_segments=jax_plan_segments,
        engine=jengine)


@pytest.fixture(scope="module")
def lm(jx):
    """The reduced llama in both packages, one set of weights (the JAX
    package's init, carried over)."""
    cfg = get_config(ARCH).reduced()
    jmodel = jx.build_model(jx.get_config(ARCH).reduced(), remat="none")
    jparams = jmodel.init(jx.jax.random.PRNGKey(0))
    tparams = params_from_jax(jx.jax.device_get(jparams), device="cpu")
    return types.SimpleNamespace(cfg=cfg, jmodel=jmodel, jparams=jparams,
                                 tparams=tparams, model=build_model(cfg))


def _np(t):
    return np.asarray(t)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **TOL)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_jax(jx, kind):
    r = np.random.default_rng(1)
    x = (r.standard_normal((2, 5, 24)) * 3 + 1).astype(np.float32)
    p = {"scale": r.standard_normal(24).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = r.standard_normal(24).astype(np.float32)
    got = tlayers.apply_norm(kind, {k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x))
    want = jx.layers.apply_norm(kind, {k: jx.jnp.asarray(v) for k, v in p.items()},
                                jx.jnp.asarray(x))
    _close(got, want)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_mlp_matches_jax(jx, activation):
    p = jx.layers.mlp_init(jx.jax.random.PRNGKey(2), 16, 40, activation)
    if activation == "gelu":  # nonzero biases
        p = {k: v + 0.1 if k.startswith("b_") else v for k, v in p.items()}
    x = np.random.default_rng(2).standard_normal((3, 7, 16)).astype(np.float32)
    got = tlayers.apply_mlp(params_from_jax(jx.jax.device_get(p), device="cpu"),
                            torch.from_numpy(x), activation)
    _close(got, jx.layers.apply_mlp(p, jx.jnp.asarray(x), activation))


@pytest.mark.parametrize("start,theta", [(0, 500_000.0), (29, 10_000.0)])
def test_rope_matches_jax(jx, start, theta):
    """The half-split rotation, angles in float32, at positions from 0 and
    from a decode offset."""
    x = np.random.default_rng(3).standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = np.arange(start, start + 6)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got, jx.layers.apply_rope(jx.jnp.asarray(x), jx.jnp.asarray(pos), theta))
    _close(tlayers.rope_frequencies(16, theta), jx.layers.rope_frequencies(16, theta))


def test_embedding_and_unembedding(lm):
    table = lm.tparams["embed"]
    tokens = torch.tensor([[0, 5, 511]])
    assert torch.equal(tlayers.embed_lookup(table, tokens)[0, 2], table["table"][511])
    x = torch.randn(1, 2, lm.cfg.d_model)
    torch.testing.assert_close(tlayers.unembed(table, x), x @ table["table"].T)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _layer0_attn(lm):
    """Layer 0's attention weights in both packages (the scanned segment's
    stacked leaves, repetition 0)."""
    jp = lm.jparams["segments"][0][0]["attn"]
    return ({k: v[0] for k, v in jp.items()},
            {k: v[0] for k, v in lm.tparams["segments"][0][0]["attn"].items()})


@pytest.mark.parametrize("t", [1, 9])
def test_gqa_apply_without_cache(jx, lm, t):
    jp, tp = _layer0_attn(lm)
    x = np.random.default_rng(4).standard_normal((2, t, lm.cfg.d_model)).astype(np.float32)
    pos = np.arange(t)
    want, _ = jx.attn.gqa_apply(jp, lm.cfg, jx.jnp.asarray(x), jx.jnp.asarray(pos))
    got, cache = tattn.gqa_apply(tp, lm.cfg, torch.from_numpy(x), torch.from_numpy(pos))
    assert cache is None
    _close(got, want)


@pytest.mark.parametrize("idx,t,cache_dtype", [
    (0, 9, "float32"),   # prefill: the flash kernel's path
    (0, 9, "bfloat16"),  # keys read back at the cache's rounding
    (0, 1, "float32"),   # a one-token prompt: the masked core
    (7, 1, "float32"),   # decode
    (5, 4, "float32"),   # a chunk past index 0: the masked core
])
def test_gqa_apply_with_cache(jx, lm, monkeypatch, idx, t, cache_dtype):
    """Against the JAX package's cache branch (a mask over all s_max
    slots): the output, the cache it writes, and which executor ran."""
    jp, tp = _layer0_attn(lm)
    b, s_max = 2, 16
    r = np.random.default_rng(5 + idx + t)
    x = r.standard_normal((b, t, lm.cfg.d_model)).astype(np.float32)
    filled = r.standard_normal((2, b, s_max, lm.cfg.n_kv_heads,
                                lm.cfg.resolved_head_dim)).astype(np.float32)
    filled[:, :, idx:] = 0.0  # what the cache holds before the call
    pos = np.arange(idx, idx + t)
    jdt = getattr(jx.jnp, cache_dtype)
    jcache = {"k": jx.jnp.asarray(filled[0]).astype(jdt),
              "v": jx.jnp.asarray(filled[1]).astype(jdt), "idx": jx.jnp.int32(idx)}
    want, jnew = jx.attn.gqa_apply(jp, lm.cfg, jx.jnp.asarray(x), jx.jnp.asarray(pos),
                                   window=jx.jnp.asarray(0), cache=jcache)
    tdt = getattr(torch, cache_dtype)
    tcache = {"k": torch.from_numpy(filled[0]).to(tdt),
              "v": torch.from_numpy(filled[1]).to(tdt), "idx": idx}
    calls = []
    flash = tops._EXECUTORS["cuda"]["flash"]
    monkeypatch.setitem(tops._EXECUTORS["cuda"], "flash",
                        lambda *a, **k: calls.append(a[0].shape) or flash(*a, **k))
    got, tnew = tattn.gqa_apply(tp, lm.cfg, torch.from_numpy(x), torch.from_numpy(pos),
                                cache=tcache, inner="cuda")
    _close(got, want)
    assert tnew["idx"] == idx + t == int(jnew["idx"])
    assert tnew["k"] is tcache["k"]  # updated in place
    for key in ("k", "v"):
        np.testing.assert_allclose(tnew[key].float().numpy(),
                                   np.asarray(jnew[key].astype(jx.jnp.float32)), **TOL)
    assert calls == ([(b, lm.cfg.n_heads, t, lm.cfg.resolved_head_dim)]
                     if idx == 0 and t > 1 else [])


def test_cache_overflow_raises(lm):
    _, tp = _layer0_attn(lm)
    cache = tattn.gqa_cache_init(lm.cfg, 1, 4, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        tattn.gqa_apply(tp, lm.cfg, torch.zeros(1, 5, lm.cfg.d_model),
                        torch.arange(5), cache={**cache, "idx": 0})


def test_make_mask_matches_jax(jx):
    q, k = np.arange(3, 6), np.arange(8)
    valid = np.arange(8)[None, :] < np.array([[6], [4]])
    got = tattn.make_mask(torch.from_numpy(q), torch.from_numpy(k), True,
                          k_valid=torch.from_numpy(valid))
    want = jx.attn.make_mask(jx.jnp.asarray(q), jx.jnp.asarray(k), True,
                             k_valid=jx.jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window", [None, 0, 1, 3, 32])
def test_make_mask_window_matches_jax(jx, window):
    """Windows 0 (and None: unlimited), 1 (a query sees itself alone) and
    wider, causal, with cache validity: the same NEG_INF sums."""
    q, k = np.arange(30, 36), np.arange(40)
    valid = np.arange(40)[None, :] < np.array([[36], [33]])
    got = tattn.make_mask(torch.from_numpy(q), torch.from_numpy(k), True,
                          window=window, k_valid=torch.from_numpy(valid))
    want = jx.attn.make_mask(jx.jnp.asarray(q), jx.jnp.asarray(k), True,
                             window=None if window is None else jx.jnp.asarray(window),
                             k_valid=jx.jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    seen = (got[0, 0] == 0).sum(-1)
    # query 30 + i sees keys i - window + 31 .. 30 + i
    assert seen.tolist() == [min(window or 99, 31 + i) for i in range(6)]


@pytest.mark.parametrize("idx,t", [(0, 1), (0, 20), (20, 1), (11, 6)])
def test_gqa_apply_with_window_matches_jax(jx, lm, monkeypatch, idx, t):
    """A windowed layer (window 8, keys reaching 20 positions back): the
    uncached call and the cache branch against the JAX package's, and never
    the flash executor, not even on a prefill from index 0."""
    jp, tp = _layer0_attn(lm)
    b, s_max, window = 2, 24, 8
    r = np.random.default_rng(7 + idx + t)
    x = r.standard_normal((b, t, lm.cfg.d_model)).astype(np.float32)
    filled = r.standard_normal((2, b, s_max, lm.cfg.n_kv_heads,
                                lm.cfg.resolved_head_dim)).astype(np.float32)
    filled[:, :, idx:] = 0.0
    pos = np.arange(idx, idx + t)
    calls = []
    flash = tops._EXECUTORS["cuda"]["flash"]
    monkeypatch.setitem(tops._EXECUTORS["cuda"], "flash",
                        lambda *a, **k: calls.append(1) or flash(*a, **k))
    jcache = {"k": jx.jnp.asarray(filled[0]), "v": jx.jnp.asarray(filled[1]),
              "idx": jx.jnp.int32(idx)}
    want, _ = jx.attn.gqa_apply(jp, lm.cfg, jx.jnp.asarray(x), jx.jnp.asarray(pos),
                                window=jx.jnp.asarray(window), cache=jcache)
    tcache = {"k": torch.from_numpy(filled[0]), "v": torch.from_numpy(filled[1]),
              "idx": idx}
    got, _ = tattn.gqa_apply(tp, lm.cfg, torch.from_numpy(x), torch.from_numpy(pos),
                             window=window, cache=tcache, inner="cuda")
    _close(got, want)
    if idx == 0:
        want, _ = jx.attn.gqa_apply(jp, lm.cfg, jx.jnp.asarray(x), jx.jnp.asarray(pos),
                                    window=jx.jnp.asarray(window))
        got, _ = tattn.gqa_apply(tp, lm.cfg, torch.from_numpy(x), torch.from_numpy(pos),
                                 window=window)
        _close(got, want)
    assert calls == []


# ---------------------------------------------------------------------------
# The model and its entry points
# ---------------------------------------------------------------------------

def test_forward_prefill_and_decode_match_jax(jx, lm, monkeypatch):
    """Logits of ``forward`` (every position), ``prefill`` (the last) and
    three greedy ``decode_step``s within 1e-4 of JAX's; the prefill takes
    the flash executor once a layer, the decode steps never."""
    cfg, jnp = lm.cfg, jx.jnp
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jlog, _, _, jhid = lm.jmodel.forward(lm.jparams, jnp.asarray(toks))
    tlog, aux, _, thid = lm.model.forward(lm.tparams, torch.from_numpy(toks).long())
    assert tuple(tlog.shape) == (2, 9, cfg.padded_vocab()) and float(aux) == 0.0
    _close(tlog, jlog)
    _close(thid, jhid)

    calls = []
    flash = tops._EXECUTORS["cuda"]["flash"]
    monkeypatch.setitem(tops._EXECUTORS["cuda"], "flash",
                        lambda *a, **k: calls.append(1) or flash(*a, **k))
    jcache = lm.jmodel.init_cache(2, 16, dtype=jnp.float32)
    tcache = lm.model.init_cache(2, 16, dtype=torch.float32, device="cpu")
    jl, jcache = lm.jmodel.prefill(lm.jparams, jnp.asarray(toks), jcache)
    tl, tcache = make_prefill_step(lm.model)(lm.tparams, torch.from_numpy(toks).long(),
                                             tcache)
    _close(tl, jl)
    assert len(calls) == cfg.n_layers
    decode = make_decode_step(lm.model)
    for step in range(3):
        cur = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        assert np.array_equal(cur[:, 0], torch.argmax(tl, -1).numpy())
        jl, jcache = lm.jmodel.decode_step(lm.jparams, jcache, jnp.asarray(cur))
        tl, tcache = decode(lm.tparams, tcache, torch.from_numpy(cur).long())
        _close(tl, jl)
        assert tcache["idx"] == int(jcache["idx"]) == 10 + step
    assert len(calls) == cfg.n_layers


def test_inner_torch_equals_inner_cuda_on_cpu(lm):
    """On the CPU both executors run the plain version: equal logits."""
    toks = torch.tensor([[3, 1, 4, 1, 5, 9, 2]])
    ref = build_model(lm.cfg, inner="torch")
    out = []
    for model in (lm.model, ref):
        cache = model.init_cache(1, 8, dtype=torch.float32, device="cpu")
        logits, cache = model.prefill(lm.tparams, toks, cache)
        out.append(model.decode_step(lm.tparams, cache, toks[:, :1])[0])
    assert torch.equal(out[0], out[1])
    with pytest.raises(ValueError, match="unknown inner executor"):
        build_model(lm.cfg, inner="xla")


def _mtp_gap(cfg) -> int:
    """What the JAX package's closed form leaves out of an MTP block that
    ``init`` builds as an MoE block: the experts, router and shared
    experts, counted as one dense MLP of width ``d_ff`` instead
    (``repro/models/model_zoo.py:99-100``; ROADMAP.md Queue 3)."""
    if not cfg.mtp_depth or cfg.n_layers - 1 < cfg.first_k_dense_layers:
        return 0
    d, m = cfg.d_model, cfg.moe
    moe = (m.n_experts * 3 * d * m.d_ff_expert + d * m.n_experts
           + 3 * d * m.d_ff_expert * m.n_shared_experts)
    return moe - 3 * d * cfg.d_ff


def _norm_gap(cfg) -> int:
    """What the JAX package's closed form leaves out of the norms: the
    final norm (and whisper's encoder's), and every LayerNorm's bias:
    norm1's and norm2's of each layer, norm_x's of each decoder layer and
    both of each encoder layer."""
    if cfg.norm == "rmsnorm":
        return cfg.d_model
    n_norms = 2 * cfg.n_layers
    if cfg.is_encoder_decoder:
        n_norms += cfg.n_layers + 2 * cfg.n_encoder_layers + 2
    return cfg.d_model * (2 + n_norms)


def test_init_shapes_and_count_params(jx, lm):
    """``LM.init`` gives the JAX tree's shapes leaf for leaf, and for each
    config ``count_params`` is exactly the initialised count less what the
    JAX package's closed form leaves out: the final norms and the
    LayerNorms' biases (``_norm_gap``), and on deepseek-v3-671b the MTP
    block's experts (counted as a dense MLP: 10,923,802,624 parameters at
    the published widths). Within 5% of the count (the JAX suite's
    ``test_param_count_matches_init``) for the dense configs. pixtral-12b
    at its published size: 12,247,777,280 by ``count_params``, its final
    norm's 5,120 beside."""
    jshapes = [tuple(a.shape) for a in jx.jax.tree_util.tree_leaves(lm.jparams)]
    params = lm.model.init(torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(params)] == jshapes
    for arch in ("llama3.2-1b", "starcoder2-3b", "granite-34b", "dbrx-132b",
                 "deepseek-v3-671b", "whisper-tiny", "pixtral-12b"):
        cfg = get_config(arch).reduced()
        p = build_model(cfg).init(torch.Generator().manual_seed(1), device="cpu")
        n = sum(t.numel() for t in tree_leaves(p))
        assert count_params(cfg) + _norm_gap(cfg) + _mtp_gap(cfg) == n, arch
        if cfg.moe is None:
            assert abs(n - count_params(cfg)) / n < 0.05
    assert _mtp_gap(get_config("deepseek-v3-671b").reduced()) > 0
    assert _mtp_gap(get_config("deepseek-v3-671b")) == 10_923_802_624
    assert _mtp_gap(get_config("dbrx-132b")) == 0
    assert get_config(ARCH).param_count() + 2048 == 1_235_814_400
    pixtral = get_config("pixtral-12b")
    assert count_params(pixtral) + _norm_gap(pixtral) == 12_247_777_280 + 5_120
    whisper = get_config("whisper-tiny")
    assert _norm_gap(whisper) == 384 * (2 + 8 + 4 + 8 + 2)


def test_configs_and_count_params_match_jax(jx):
    assert list_archs() == sorted(jx.get_config(a).name for a in list_archs())
    for arch in list_archs():
        cfg, jcfg = get_config(arch), jx.get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(jcfg.reduced())
        for active in (False, True):
            assert count_params(cfg, active) == jx.count_params(jcfg, active), arch


def test_segment_planning_full_configs(jx):
    """The JAX suite's ``test_segment_planning_full_configs``, and every
    config's plan equal to the JAX package's."""
    segs = plan_segments(get_config("deepseek-v3-671b"))
    assert segs[0].mode == "unroll" and len(segs[0].kinds) == 3
    assert segs[1].mode == "scan" and segs[1].n_reps == 58
    segs = plan_segments(get_config("zamba2-7b"))
    assert segs[0].mode == "scan" and len(segs[0].kinds) == 6
    assert segs[0].n_reps == 13
    assert segs[1].mode == "unroll" and len(segs[1].kinds) == 3
    segs = plan_segments(get_config("xlstm-1.3b"))
    assert segs[0].mode == "scan" and len(segs[0].kinds) == 8
    assert segs[0].n_reps == 6
    segs = plan_segments(get_config("granite-34b"))
    assert segs[0].mode == "scan" and segs[0].n_reps == 88
    for arch in list_archs():
        assert ([dataclasses.astuple(s) for s in plan_segments(get_config(arch))]
                == [dataclasses.astuple(s)
                    for s in jx.plan_segments(jx.get_config(arch))]), arch


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _requests(cls, cfg):
    """``examples/lm_serve.py``'s traffic: 8 prompts of 4-11 tokens, 12
    new tokens each."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(8):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=int(rng.integers(4, 12))).astype(np.int32)
        out.append(cls(rid=i, prompt=prompt, max_new_tokens=12))
    return out


def test_serving_engine_matches_jax(jx, lm):
    """8 requests, 4 slots, left-padded waves, greedy decoding: the same
    tokens as the JAX engine, request by request."""
    jeng = jx.engine.ServingEngine(lm.jmodel, lm.jparams, batch_slots=4, max_seq=96)
    teng = ServingEngine(lm.model, lm.tparams, batch_slots=4, max_seq=96, device="cpu")
    for jr, tr in zip(_requests(jx.engine.Request, lm.cfg), _requests(Request, lm.cfg)):
        jeng.submit(jr)
        teng.submit(tr)
    jdone, tdone = jeng.run(), teng.run()
    assert [r.rid for r in tdone] == [r.rid for r in jdone] == list(range(8))
    for jr, tr in zip(jdone, tdone):
        assert tr.done and len(tr.output) == 12
        assert tr.output == [int(t) for t in jr.output], tr.rid


def test_serving_engine_stops_at_eos(lm):
    eng = ServingEngine(lm.model, lm.tparams, batch_slots=2, max_seq=32, device="cpu")
    first = ServingEngine(lm.model, lm.tparams, batch_slots=2, max_seq=32, device="cpu")
    reqs = _requests(Request, lm.cfg)[:2]
    for r in reqs:
        first.submit(Request(rid=r.rid, prompt=r.prompt, max_new_tokens=5))
    probe = first.run()
    eos = probe[0].output[2]
    eng.eos_id = eos
    for r in reqs:
        eng.submit(Request(rid=r.rid, prompt=r.prompt, max_new_tokens=5))
    done = eng.run()
    stop = probe[0].output.index(eos) + 1
    assert done[0].output == probe[0].output[:stop]
    assert all(r.done for r in done)


def test_no_card_raises_unless_cpu_requested(lm, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(lm.model, lm.tparams)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.model.init(torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.model.init_cache(1, 8)


# ---------------------------------------------------------------------------
# gemma3-1b's windows, starcoder2-3b and granite-34b, end to end
# ---------------------------------------------------------------------------

#: (architecture, layers or None for the reduced config's, prompt tokens)
OTHER_ARCHS = {"gemma3-1b": (6, 40), "starcoder2-3b": (None, 9),
               "granite-34b": (None, 9), "whisper-tiny": (None, 9),
               "pixtral-12b": (None, 9)}


def _other_cfg(getter, arch):
    n_layers, _ = OTHER_ARCHS[arch]
    cfg = getter(arch).reduced()
    return cfg if n_layers is None else dataclasses.replace(cfg, n_layers=n_layers)


@pytest.fixture(scope="module", params=list(OTHER_ARCHS))
def other(request, jx):
    arch = request.param
    cfg = _other_cfg(get_config, arch)
    jmodel = jx.build_model(_other_cfg(jx.get_config, arch), remat="none")
    jparams = jmodel.init(jx.jax.random.PRNGKey(0))
    return types.SimpleNamespace(
        arch=arch, cfg=cfg, jmodel=jmodel, jparams=jparams, model=build_model(cfg),
        tparams=params_from_jax(jx.jax.device_get(jparams), device="cpu"))


def test_other_archs_forward_prefill_and_decode_match_jax(jx, other, monkeypatch):
    """``forward``, ``prefill`` and three greedy ``decode_step``s within
    1e-4 of JAX's, on text alone. gemma3-1b's prompt (40 tokens) and
    decode positions lie past its 32-token window on layers 0-4; its
    prefill takes the flash executor on layer 5 alone, whisper-tiny's
    twice a layer (its self-attention, and its cross attention over the
    cache's zeroed encoder output), the others' once a layer."""
    cfg, jnp = other.cfg, jx.jnp
    t = OTHER_ARCHS[other.arch][1]
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, t)).astype(np.int32)
    jlog, _, _, _ = other.jmodel.forward(other.jparams, jnp.asarray(toks))
    tlog, _, _, _ = other.model.forward(other.tparams, torch.from_numpy(toks).long())
    _close(tlog, jlog)

    calls = []
    flash = tops._EXECUTORS["cuda"]["flash"]
    monkeypatch.setitem(tops._EXECUTORS["cuda"], "flash",
                        lambda *a, **k: calls.append(1) or flash(*a, **k))
    jcache = other.jmodel.init_cache(2, t + 8, dtype=jnp.float32)
    tcache = other.model.init_cache(2, t + 8, dtype=torch.float32, device="cpu")
    jl, jcache = other.jmodel.prefill(other.jparams, jnp.asarray(toks), jcache)
    tl, tcache = other.model.prefill(other.tparams, torch.from_numpy(toks).long(), tcache)
    _close(tl, jl)
    n_global = (cfg.n_layers // cfg.global_every if cfg.sliding_window
                else cfg.n_layers) * (2 if cfg.is_encoder_decoder else 1)
    assert len(calls) == n_global == {"gemma3-1b": 1, "whisper-tiny": 8}.get(
        other.arch, cfg.n_layers)
    for step in range(3):
        cur = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        assert np.array_equal(cur[:, 0], torch.argmax(tl, -1).numpy())
        jl, jcache = other.jmodel.decode_step(other.jparams, jcache, jnp.asarray(cur))
        tl, tcache = other.model.decode_step(other.tparams, tcache,
                                             torch.from_numpy(cur).long())
        _close(tl, jl)
        assert tcache["idx"] == int(jcache["idx"]) == t + 1 + step
    assert len(calls) == n_global


def _long_requests(cls, cfg, lo, hi, n=6, new=10):
    rng = np.random.default_rng(1)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                           size=int(rng.integers(lo, hi))).astype(np.int32),
                max_new_tokens=new) for i in range(n)]


def test_other_archs_serving_engine_matches_jax(jx, other):
    """Left-padded waves and greedy decoding: the JAX engine's tokens.
    gemma3-1b's prompts run 33-60 tokens, past its window, so the padding's
    shift of positions under the window is exercised as the JAX engine
    has it."""
    lo, hi = (33, 61) if other.arch == "gemma3-1b" else (4, 12)
    jeng = jx.engine.ServingEngine(other.jmodel, other.jparams, batch_slots=4,
                                   max_seq=80)
    teng = ServingEngine(other.model, other.tparams, batch_slots=4, max_seq=80,
                         device="cpu")
    for jr, tr in zip(_long_requests(jx.engine.Request, other.cfg, lo, hi),
                      _long_requests(Request, other.cfg, lo, hi)):
        jeng.submit(jr)
        teng.submit(tr)
    jdone, tdone = jeng.run(), teng.run()
    assert [r.rid for r in tdone] == [r.rid for r in jdone] == list(range(6))
    for jr, tr in zip(jdone, tdone):
        assert tr.done and len(tr.output) == 10
        assert tr.output == [int(t) for t in jr.output], tr.rid
