"""Port parity, the encoder-decoder and the vision frontend
(``models/attention.py``'s cross attention, ``models/transformer.py``'s
encoder, cross-attention layers and prepended frontend embeddings):
``gqa_apply(kv_source=)`` without a cache, in a prefill (the flash
executor, ``causal=False``) and in decode (the masked core), and with
bfloat16 queries against float32 memory; ``LM.encode``; then the reduced
whisper-tiny (2 encoder layers over 32 frames, 4 decoder layers, heads of
16) and pixtral-12b (8 frontend tokens) end to end
(``_torch_lm_family.py``): ``forward``, ``loss`` and its gradients (remat
"layer" and "none" bitwise equal), prefill with the frames or the
embeddings and four greedy decode steps with the caches, three AdamW
steps in float32 and bfloat16, a JAX checkpoint restored in the port and
back, ``make_dummy_batch``, ``make_prefill_step`` and the training
launcher. The engines' tokens are ``test_torch_lm.py``'s (``OTHER_ARCHS``).
The flash kernel at whisper-tiny's non-causal shapes on the card (marked
``cuda``).

Weights are the JAX package's init carried over by ``params_from_jax``;
inputs are seeded numpy. Tolerance 1e-4 (absolute and relative, float32),
the JAX suite's, unless a test states another."""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_lm_family as fam_checks  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model_zoo import (  # noqa: E402
    build_model,
    make_dummy_batch,
    make_prefill_step,
)
from repro_torch.training.optimizer import tree_leaves  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("whisper-tiny", "pixtral-12b")


@pytest.fixture(scope="module")
def jx():
    import types

    pytest.importorskip("jax")
    from repro.models import attention as jattn
    from repro.models import model_zoo as jzoo

    return types.SimpleNamespace(**vars(fam_checks.jax_modules()), attn=jattn, zoo=jzoo)


@pytest.fixture(scope="module", params=ARCHS)
def fam(request, jx):
    return fam_checks.family(jx, lambda get: get(request.param).reduced())


@pytest.fixture(scope="module")
def whisper(jx):
    return fam_checks.family(jx, lambda get: get("whisper-tiny").reduced())


def _np(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _cross_weights(whisper):
    """Decoder layer 0's cross-attention weights in both packages (the
    scanned segment's stacked leaves, repetition 0)."""
    jp = whisper.jparams["segments"][0][0]["cross"]
    return ({k: v[0] for k, v in jp.items()},
            {k: v[0] for k, v in whisper.tparams["segments"][0][0]["cross"].items()})


def _flash_calls(monkeypatch) -> list:
    """Each flash executor call's (q shape, k shape, causal), recorded."""
    calls = []
    flash = tops._EXECUTORS["cuda"]["flash"]
    monkeypatch.setitem(tops._EXECUTORS["cuda"], "flash",
                        lambda q, k, v, **kw: calls.append(
                            (tuple(q.shape), tuple(k.shape), kw["causal"]))
                        or flash(q, k, v, **kw))
    return calls


# ---------------------------------------------------------------------------
# Cross attention and the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,cached", [(9, False), (9, True), (1, True)])
def test_cross_attention_matches_jax(jx, whisper, monkeypatch, t, cached):
    """Against the JAX package's ``kv_source`` branch (a zero mask over the
    32 keys, no RoPE): the output, the cache returned unchanged (the same
    object, its tensors untouched), and the executor: flash with
    ``causal=False`` over Tq = t against Tk = 32 in a prefill, never in
    decode or without a cache."""
    cfg, jp, tp = whisper.cfg, *_cross_weights(whisper)
    x, src = _np((2, t, cfg.d_model), 1), _np((2, cfg.encoder_seq, cfg.d_model), 2)
    pos = np.arange(5, 5 + t)
    want, jcache = jx.attn.gqa_apply(jp, whisper.jcfg, jx.jnp.asarray(x),
                                     jx.jnp.asarray(pos), kv_source=jx.jnp.asarray(src))
    assert jcache is None
    cache = None
    if cached:
        cache = {**tattn.gqa_cache_init(cfg, 2, 16, torch.float32, device="cpu"), "idx": 5}
        cache["k"].normal_(generator=torch.Generator().manual_seed(3))
    before = None if cache is None else cache["k"].clone()
    calls = _flash_calls(monkeypatch)
    got, tcache = tattn.gqa_apply(tp, cfg, torch.from_numpy(x), torch.from_numpy(pos),
                                  cache=cache, kv_source=torch.from_numpy(src))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tcache is cache
    if cached:
        assert tcache["idx"] == 5 and torch.equal(tcache["k"], before)
        assert not tcache["v"].any()
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    assert calls == ([((2, h, t, dh), (2, cfg.n_kv_heads, cfg.encoder_seq, dh), False)]
                     if cached and t > 1 else [])


def test_cross_attention_bf16_queries_against_f32_memory(jx, whisper, monkeypatch):
    """bfloat16 training's dtype flow: bfloat16 x and weights against the
    float32 encoder output. As in the JAX package, K and V come out float32
    (the weights upcast), q bfloat16, the probabilities rounded to
    bfloat16 and multiplied with V in float32, the output bfloat16; a
    prefill of such mixed dtypes takes the masked core, not flash.
    Tolerance: one bfloat16 rounding of the output (2^-8 relative) beside
    1e-4 absolute."""
    cfg, jp, tp = whisper.cfg, *_cross_weights(whisper)
    jnp = jx.jnp
    x, src = _np((2, 9, cfg.d_model), 4), _np((2, cfg.encoder_seq, cfg.d_model), 5)
    jp16 = {k: v.astype(jnp.bfloat16) for k, v in jp.items()}
    want, _ = jx.attn.gqa_apply(jp16, whisper.jcfg, jnp.asarray(x).astype(jnp.bfloat16),
                                jnp.arange(9), kv_source=jnp.asarray(src))
    calls = _flash_calls(monkeypatch)
    cache = {**tattn.gqa_cache_init(cfg, 2, 16, torch.float32, device="cpu"), "idx": 0}
    got, _ = tattn.gqa_apply({k: v.to(torch.bfloat16) for k, v in tp.items()}, cfg,
                             torch.from_numpy(x).to(torch.bfloat16), torch.arange(9),
                             cache=cache, kv_source=torch.from_numpy(src))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16 and calls == []
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=1e-4, rtol=2 ** -8)


def test_encode_matches_jax(jx, whisper, monkeypatch):
    """``LM.encode`` over the batch's frames against the JAX package's:
    bidirectional, without a cache through the masked core and in a
    prefill (a cache given) through the flash executor, once a layer, at
    Tq = Tk = 32, ``causal=False``: the same output."""
    frames = whisper.inputs["encoder_frames"]
    want = jx.jax.jit(whisper.jmodel.encode)(whisper.jparams, jx.jnp.asarray(frames))
    model = build_model(whisper.cfg)
    calls = _flash_calls(monkeypatch)
    got = model.encode(whisper.tparams, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert calls == []
    cache = model.init_cache(4, 8, dtype=torch.float32, device="cpu")
    got = model.encode(whisper.tparams, torch.from_numpy(frames), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    cfg = whisper.cfg
    one = ((4, cfg.n_heads, cfg.encoder_seq, cfg.resolved_head_dim),
           (4, cfg.n_kv_heads, cfg.encoder_seq, cfg.resolved_head_dim), False)
    assert calls == [one] * cfg.n_encoder_layers == [one] * 2


# ---------------------------------------------------------------------------
# whisper-tiny and pixtral-12b, reduced, end to end
# ---------------------------------------------------------------------------

def test_builds_like_jax(jx, fam):
    """The init tree's keys and shapes leaf for leaf (whisper's
    ``encoder`` and every decoder layer's ``norm_x`` and ``cross``), and
    the zeroed cache's (whisper's ``enc_out`` [B, encoder_seq, D] at the
    cache dtype)."""
    model = build_model(fam.cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert sorted(params) == sorted(fam.jparams)
    assert ([tuple(t.shape) for t in tree_leaves(params)]
            == [tuple(a.shape) for a in jx.jax.tree_util.tree_leaves(fam.jparams)])
    jcache = fam.jmodel.init_cache(2, 12)
    tcache = model.init_cache(2, 12, device="cpu")
    assert sorted(tcache) == sorted(jcache)
    for k in sorted(jcache):
        if k != "idx":
            got, want = tree_leaves(tcache[k]), jx.jax.tree_util.tree_leaves(jcache[k])
            assert [(tuple(a.shape), a.dtype) for a in got] == [
                (tuple(a.shape), torch.bfloat16) for a in want]
    if fam.cfg.is_encoder_decoder:
        assert len(params["encoder"]["layers"]) == fam.cfg.n_encoder_layers == 2
        assert {"norm_x", "cross"} <= set(params["segments"][0][0])


def test_forward_loss_and_grads_match_jax(jx, fam):
    fam_checks.check_forward_loss_and_grads(jx, fam)


def test_prefill_and_decode_match_jax(jx, fam, monkeypatch):
    """A 9-token prompt (after pixtral's 8 frontend tokens; with whisper's
    32 frames) and four decode steps. Flash in the prefill: whisper once a
    encoder layer and twice a decoder layer (its self-attention and its
    cross attention), 2 + 2·4; pixtral once a layer, 4."""
    cfg = fam.cfg
    n_flash = cfg.n_encoder_layers + 2 * cfg.n_layers if cfg.is_encoder_decoder \
        else cfg.n_layers
    assert n_flash == {"whisper-tiny-reduced": 10, "pixtral-12b-reduced": 4}[cfg.name]
    fam_checks.check_prefill_and_decode(jx, fam, 9, n_flash, monkeypatch)


def test_make_prefill_step_matches_jax(jx, fam):
    """``make_prefill_step`` forwards the frontend's or encoder's inputs:
    the JAX package's step's logits and cache index."""
    jin, tin = fam_checks._inputs(jx, fam, 2)
    toks = fam.batch["tokens"][:2, :7]
    jl, jcache = jx.zoo.make_prefill_step(fam.jmodel)(
        fam.jparams, jx.jnp.asarray(toks), fam.jmodel.init_cache(2, 24, jx.jnp.float32),
        **jin)
    model = build_model(fam.cfg)
    tl, tcache = make_prefill_step(model)(
        fam.tparams, torch.from_numpy(toks).long(),
        model.init_cache(2, 24, torch.float32, device="cpu"), **tin)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcache["idx"] == int(jcache["idx"]) == 7 + (8 if fam.cfg.frontend == "vision"
                                                       else 0)


#: whisper-tiny's leaves outside the bfloat16 leaf rule: the encoder's
#: (no gradient with its output fed in) and those reading over BF16_GRAD_REL
#: (ROADMAP.md Queue 3, item 12)
WHISPER_BF16_OVER = ("/encoder", "/embed", "/segments[0][0]/attn", "/segments[0][0]/cross",
                     "/segments[0][0]/ffn", "/segments[0][0]/norm1", "/segments[0][0]/norm2/bias",
                     "/segments[0][0]/norm_x")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_steps_match_jax(jx, fam, dtype):
    """pixtral-12b's bfloat16 gradients leaf by leaf; whisper-tiny's
    decoder leaf by leaf with the JAX package's encoder output fed in
    (``jax_encoder_fed``), where the final norm, the head and ``norm2``'s
    scale hold the rule, and the rest (0.53-0.83) keep the size check with
    the encoder (ROADMAP.md Queue 3, item 12)."""
    whisper = fam.cfg.is_encoder_decoder
    fam_checks.check_train_steps(jx, fam, dtype,
                                 bf16_replay=fam_checks.jax_encoder_fed if whisper else None,
                                 bf16_over=WHISPER_BF16_OVER if whisper else ())


def test_jax_checkpoint_restores_in_the_port(jx, fam, tmp_path):
    fam_checks.check_checkpoint_round_trip(jx, fam, tmp_path)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq", [20, 5])
def test_dummy_batch_matches_jax(jx, arch, seq):
    """The JAX package's keys and shapes (pixtral: ``max(seq - 8, 8)``
    text tokens after 8 frontend embeddings; whisper: 32 frames), its
    float32 inputs, tokens in [0, vocab) (int64, the port's index dtype,
    where JAX's are int32), labels the tokens shifted with a -100 tail."""
    cfg = get_config(arch).reduced()
    want = jx.zoo.make_dummy_batch(jx.get_config(arch).reduced(), 3, seq)
    got = make_dummy_batch(cfg, 3, seq, generator=torch.Generator().manual_seed(2))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert got[k].dtype == (torch.float32 if v.dtype == np.float32 else torch.long), k
    tokens = got["tokens"]
    assert 0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size
    assert torch.equal(got["labels"][:, :-1], tokens[:, 1:])
    assert (got["labels"][:, -1] == -100).all()


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
def test_cuda_flash_whisper_shapes_match_plain():
    """The flash kernel at whisper-tiny's non-causal shapes (6 heads of 64)
    against its plain version: the encoder (B 4, T 1,500, which no query
    tile divides) and the cross attention (Tq 1,024 against Tk 1,500),
    float32 within 2e-5, a repeat launch bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    for tq in (1500, 1024):
        q = torch.randn((4, 6, tq, 64), generator=gen, device=dev)
        k, v = (torch.randn((4, 6, 1500, 64), generator=gen, device=dev) for _ in range(2))
        before = flash_attention.launches
        got = flash_attention(q, k, v, causal=False)
        again = flash_attention(q, k, v, causal=False)
        assert flash_attention.launches - before == 2
        want = flash_attention_ref(q, k, v, causal=False)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        assert torch.equal(got, again)
