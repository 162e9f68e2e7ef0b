"""Port parity, MLA and the encoder-decoder under the sharding rules on
gloo CPU ranks (``launch/mesh.py:RankPool``), against the JAX package's
single-device program.

Three reduced configurations:

- ``deepseek``: deepseek-v3-671b's ``reduced()`` (4 layers, 3 dense and 1
  MoE of 4 experts, top-2, one shared expert; MLA of 4 heads at the
  reduced ranks; ``mtp_depth`` 1): at model 4 a rank attends 1 head, at
  model 2 two, its ``wq_b``/``wkv_b`` columns and ``wo`` rows; the latent
  cache split by position over ``model`` (48 positions: 12 a rank at
  model 4), and whole where the positions do not divide the axis (46 at
  model 4); the experts over ``(data, model)``;
- ``whisper``: whisper-tiny's ``reduced()`` (2 encoder layers over 32
  frames, 4 decoder layers, 4 heads of 16 over 4 KV heads);
- ``whisper-6h``: the same at d_model 96 with 6 heads of 16, so that
  model 4 gives a rank 24 ``wq`` columns, 1.5 heads (the query and K/V
  columns gathered over ``model``), and the 6 KV heads, which 4 does not
  divide, put the self attention's cache over ``model`` by position.

Meshes (data, model) = (1, 2), (1, 4), (2, 2) and (2, 2) under FSDP. Each
rank holds: the forward's logits (whisper's with its frames), a cached
prefill and two decode steps (1e-4); the float32 loss and every gradient
leaf gathered by ``gather_tree``, MTP's included (1e-4); one AdamW step of
its shards from the JAX gradients' shards (1e-6) and
``make_train_step``'s step equal to the AdamW update of its own
gradients; every leaf and cache its rules' shard. The serving engine's
tokens are equal on every rank and to the one-device engine's at (1, 2)
and (1, 4); the dry run's (1, 4) rank steps (deepseek's training and
decode cells, whisper-6h's training cell, ``build_cell(mesh=)`` over
``meta``) count the collectives the ranks' ``CollectiveLog`` read
running the same steps, the latent's all-gather among them. One
``RankPool`` runs every case.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.fsdp import data_mean  # noqa: E402
from repro_torch.distributed.sharding import ShardingRules, use_rules  # noqa: E402
from repro_torch.distributed.tensor_parallel import (  # noqa: E402
    CollectiveLog,
    check_tp,
    gather_tree,
    logging_collectives,
    mean_over_data,
    shard_tree,
)
from repro_torch.launch.mesh import RankPool, abstract_mesh, make_mesh  # noqa: E402
from repro_torch.launch.specs import build_cell  # noqa: E402
from repro_torch.launch.step_cost import reckon  # noqa: E402
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
B, T, T0, S_MAX = 4, 40, 32, 48
#: a cache whose positions model 4 does not divide (it stays whole)
S_ODD = 46
LR = 1e-2
TOL = dict(atol=1e-4, rtol=1e-4)
ADAM_TOL = dict(atol=1e-6, rtol=1e-6)
#: (variant, mesh, fsdp)
CASES = [("deepseek", (1, 2), False), ("deepseek", (1, 4), False),
         ("deepseek", (2, 2), False), ("deepseek", (2, 2), True),
         ("whisper", (1, 2), False), ("whisper", (1, 4), False),
         ("whisper", (2, 2), False), ("whisper", (2, 2), True),
         ("whisper-6h", (1, 4), False), ("whisper-6h", (2, 2), True)]
IDS = [f"{v}-{d}x{m}" + ("-fsdp" if f else "") for v, (d, m), f in CASES]
ARCH = {"deepseek": "deepseek-v3-671b", "whisper": "whisper-tiny",
        "whisper-6h": "whisper-tiny"}
#: the dry run's reduced cells at (1, 4): (variant, shape)
CELLS = (("deepseek", "train_4k"), ("deepseek", "decode_32k"), ("whisper-6h", "train_4k"))
CELL = dict(batch=4, seq_len=16)


def _cfg(variant: str, getter=get_config):
    cfg = getter(ARCH[variant]).reduced()
    if variant == "whisper-6h":
        cfg = dataclasses.replace(cfg, d_model=96, n_heads=6, n_kv_heads=6)
    return cfg


def _rules(cfg, mesh, fsdp: bool) -> ShardingRules:
    """2D expert parallelism where the experts divide the mesh, as
    ``launch/specs.py:mesh_rules`` chooses it."""
    n = mesh.shape["data"] * mesh.shape["model"]
    return ShardingRules(mesh, cfg, fsdp=fsdp, expert_parallel_2d=cfg.moe is not None
                         and cfg.moe.n_experts % n == 0)


def _data(cfg):
    r = np.random.default_rng(0)
    tokens = r.integers(1, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100, np.int32)], 1)
    labels[r.random(labels.shape) < 0.2] = -100  # the data ranks' counts differ
    frames = (r.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
              if cfg.is_encoder_decoder else None)
    prompts = [r.integers(1, cfg.vocab_size, n).astype(np.int32) for n in (5, 9, 7)]
    return types.SimpleNamespace(tokens=tokens, labels=labels, frames=frames,
                                 prompts=prompts)


def _np(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


def _shapes(tree) -> dict:
    return {path: tuple(leaf.shape) for path, leaf in _flatten_with_paths(tree)
            if isinstance(leaf, torch.Tensor)}


def _serve(model, params) -> list:
    """The engine's greedy tokens for three prompts over 2 slots (text
    alone: whisper cross-attends to the cache's zeroed encoder output)."""
    eng = ServingEngine(model, params, batch_slots=2, max_seq=24, device="cpu")
    for i, p in enumerate(_data(model.cfg).prompts):
        eng.submit(Request(i, p, max_new_tokens=4))
    return [r.output for r in sorted(eng.run(), key=lambda r: r.rid)]


# ---------------------------------------------------------------------------
# what each rank runs (module-level: pickled by import path)
# ---------------------------------------------------------------------------


def _cached(model, params, tokens, s_max, bl, extra) -> tuple:
    cache = model.init_cache(bl, s_max, dtype=torch.float32, device="cpu")
    shapes = _shapes(cache)
    logits, cache = model.prefill(params, tokens[:, :T0], cache, **extra)
    out = [logits]
    for t in range(T0, T0 + 2):
        logits, cache = model.decode_step(params, cache, tokens[:, t:t + 1])
        out.append(logits)
    return torch.stack(out).numpy(), shapes


def _rank(rank, variant, dm, fsdp, np_params, np_grads):
    cfg = _cfg(variant)
    d = _data(cfg)
    model = build_model(cfg, inner="cuda")
    mesh = make_mesh(*dm)
    rules = _rules(cfg, mesh, fsdp)
    check_tp(cfg, rules)
    local = shard_tree(params_from_jax(np_params, device="cpu"), rules, mesh.coords)
    bl = B // dm[0]
    rows = slice(mesh.coords["data"] * bl, (mesh.coords["data"] + 1) * bl)
    tokens = torch.from_numpy(d.tokens[rows]).long()
    batch = {"tokens": tokens, "labels": torch.from_numpy(d.labels[rows]).long()}
    extra = {}
    if d.frames is not None:
        extra = {"encoder_frames": torch.from_numpy(d.frames[rows])}
        batch.update(extra)
    out = {"coords": dict(mesh.coords), "leaf_shapes": _shapes(local)}
    with use_rules(rules):
        with torch.no_grad():
            out["forward"] = model.forward(local, tokens, **extra)[0].numpy()
            out["cached"], out["cache_shapes"] = _cached(model, local, tokens, S_MAX, bl,
                                                         extra)
            if cfg.mla is not None:
                out["cached_odd"], out["cache_shapes_odd"] = _cached(
                    model, local, tokens, S_ODD, bl, extra)
            if dm[0] == 1 and not fsdp:
                out["tokens"] = _serve(model, local)
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(local)]
        loss, metrics = model.loss(tree_unflatten(local, leaves), batch)
        grads = data_mean(model, local, list(torch.autograd.grad(loss, leaves)))
        out["loss"] = float(mean_over_data([loss.detach()])[0])
        if "mtp" in metrics:
            out["mtp"] = float(mean_over_data([metrics["mtp"].detach()])[0])
        out["grads"] = _np(tree_unflatten(local, grads))
        opt = adamw(LR, fused=True)
        jax_grads = shard_tree(params_from_jax(np_grads, device="cpu"), rules, mesh.coords)
        out["adam"] = _np(opt.update(jax_grads, opt.init(local), local)[0])
        out["own_adam"] = _np(opt.update(tree_unflatten(local, grads), opt.init(local),
                                         local)[0])
        new, _, step_loss = make_train_step(model, opt, compute_dtype=torch.float32)(
            local, opt.init(local), batch)
        out["step_loss"], out["params1"] = float(step_loss), _np(new)
    if dm == (1, 4) and not fsdp:  # the dry run's rank steps, run for real
        out["cells"] = {}
        for v, shape in CELLS:
            if v != variant:
                continue
            cell = build_cell(ARCH[v], shape, cfg=cfg, device="cpu", mesh=mesh,
                              generator=torch.Generator().manual_seed(0), **CELL)
            log = CollectiveLog()
            with logging_collectives(log):
                cell.step(*cell.args, **cell.kwargs)
            out["cells"][shape] = (dict(log.counts), dict(log.bytes))
    return out


# ---------------------------------------------------------------------------
# the references and the runs
# ---------------------------------------------------------------------------


def _jax_reference(variant: str):
    """The JAX package's single-device program on the whole batch."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models.model_zoo import build_model as jax_build_model
    from repro.training.optimizer import adamw as jax_adamw

    cfg = _cfg(variant, jax_get_config)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(_cfg(variant))
    jm = jax_build_model(cfg, remat="none")
    jp = jm.init(jax.random.PRNGKey(0))
    d = _data(cfg)
    tokens = jnp.asarray(d.tokens)
    extra = {} if d.frames is None else {"encoder_frames": jnp.asarray(d.frames)}
    # compiled whole: op-by-op dispatch of the reduced deepseek's MoE and
    # MTP takes a minute on the CPU
    forward = np.asarray(jax.jit(lambda p, t, e: jm.forward(p, t, **e)[0])(jp, tokens, extra))
    prefill = jax.jit(lambda p, t, c, e: jm.prefill(p, t, c, **e))
    decode = jax.jit(jm.decode_step)
    cache = jm.init_cache(B, S_MAX, dtype=jnp.float32)
    logits, cache = prefill(jp, tokens[:, :T0], cache, extra)
    cached = [np.asarray(logits)]
    for t in range(T0, T0 + 2):
        logits, cache = decode(jp, cache, tokens[:, t:t + 1])
        cached.append(np.asarray(logits))
    batch = {"tokens": tokens, "labels": jnp.asarray(d.labels), **extra}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, batch),
                                                        has_aux=True))(jp)
    adam = jax_adamw(LR).update(grads, jax_adamw(LR).init(jp), jp)[0]
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    params = to_np(jp)
    model = build_model(cfg, inner="cuda")
    return types.SimpleNamespace(params=params, forward=forward, cached=np.stack(cached),
                                 loss=float(loss), grads=to_np(grads), adam=to_np(adam),
                                 mtp=float(metrics["mtp"]) if "mtp" in metrics else None,
                                 tokens=_serve(model, params_from_jax(params, device="cpu")))


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


def _local(full, spec, shape: dict) -> tuple:
    out = list(full)
    for dim, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                out[dim] //= shape[a]
    return tuple(out)


@pytest.mark.parametrize("variant,dm,fsdp", CASES, ids=IDS)
def test_logits_prefill_and_decode(ref, runs, variant, dm, fsdp):
    r = ref[variant]
    for out in runs[(variant, dm, fsdp)]:
        bl = B // dm[0]
        rows = slice(out["coords"]["data"] * bl, (out["coords"]["data"] + 1) * bl)
        np.testing.assert_allclose(out["forward"], r.forward[rows], **TOL)
        np.testing.assert_allclose(out["cached"], r.cached[:, rows], **TOL)
        if "cached_odd" in out:  # a whole latent cache gives the same logits
            np.testing.assert_allclose(out["cached_odd"], r.cached[:, rows], **TOL)


@pytest.mark.parametrize("variant,dm,fsdp", CASES, ids=IDS)
def test_loss_and_gathered_gradients(ref, runs, variant, dm, fsdp):
    """The float32 loss (MTP's part within it and on its own) and every
    gathered gradient leaf, MTP's block and ``proj`` included."""
    r = ref[variant]
    ranks = runs[(variant, dm, fsdp)]
    for out in ranks:
        assert out["loss"] == pytest.approx(r.loss, rel=1e-4, abs=1e-4)
        if r.mtp is not None:
            assert out["mtp"] == pytest.approx(r.mtp, rel=1e-4, abs=1e-4)
    got = _gathered(ranks, "grads", _abstract_rules(variant, dm, fsdp), r)
    _close(got, r.grads, TOL)
    paths = [p for p, _ in _flatten_with_paths(got)]
    if variant == "deepseek":
        assert {"mtp/proj", "mtp/block/attn/wkv_b", "mtp/block/ffn/shared/w_down"} <= set(paths)
    else:
        assert any(p.startswith("encoder/layers/1/attn/") for p in paths)


@pytest.mark.parametrize("variant,dm,fsdp", CASES, ids=IDS)
def test_adamw_step(ref, runs, variant, dm, fsdp):
    r = ref[variant]
    ranks = runs[(variant, dm, fsdp)]
    _close(_gathered(ranks, "adam", _abstract_rules(variant, dm, fsdp), r), r.adam, ADAM_TOL)
    for out in ranks:
        # the training step: the gradients above, their mean, one AdamW update
        assert out["step_loss"] == pytest.approx(r.loss, rel=1e-4, abs=1e-4)
        for a, b in zip(tree_leaves(out["params1"]), tree_leaves(out["own_adam"])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant,dm,fsdp", CASES, ids=IDS)
def test_leaves_and_caches_are_the_rules_shards(ref, runs, variant, dm, fsdp):
    """Every leaf is its ``param_spec`` shard and every cache its
    ``cache_spec`` shard: MLA's latent ``S / model`` positions a rank (and
    whole where S does not divide the axis), whisper's ``enc_out`` the
    rank's rows, whole over ``model``."""
    rules = _abstract_rules(variant, dm, fsdp)
    shape = dict(rules.mesh.shape)
    cfg = _cfg(variant)
    want = {p: _local(t.shape, rules.param_spec(p, tuple(t.shape)), shape)
            for p, t in _flatten_with_paths(_like(ref[variant]))}
    model = build_model(cfg, inner="torch")
    caches = {}
    for key, s in (("cache_shapes", S_MAX), ("cache_shapes_odd", S_ODD)):
        full = model.init_cache(B, s, dtype=torch.float32, device="cpu")
        caches[key] = {p: _local(t.shape, rules.cache_spec(p, tuple(t.shape), global_batch=B),
                                 shape)
                       for p, t in _flatten_with_paths(full) if isinstance(t, torch.Tensor)}
    for out in runs[(variant, dm, fsdp)]:
        assert out["leaf_shapes"] == want
        for key, cache in caches.items():
            if key in out:
                assert out[key] == cache
        got = out["cache_shapes"]
        if cfg.mla is not None:
            latent = got["segments/0/0/attn/latent"]
            assert latent == (B // dm[0], S_MAX // dm[1], 24)
            assert out["cache_shapes_odd"]["segments/0/0/attn/latent"][1] == (
                S_ODD // 2 if dm[1] == 2 else S_ODD)
        else:
            assert got["enc_out"] == (B // dm[0], cfg.encoder_seq, cfg.d_model)


@pytest.mark.parametrize("variant,dm,fsdp", [c for c in CASES if c[1][0] == 1],
                         ids=[i for i, c in zip(IDS, CASES) if c[1][0] == 1])
def test_engine_tokens_equal_on_every_rank(ref, runs, variant, dm, fsdp):
    for out in runs[(variant, dm, fsdp)]:
        assert out["tokens"] == ref[variant].tokens


@pytest.mark.parametrize("variant,shape", CELLS, ids=[f"{v}-{s}" for v, s in CELLS])
def test_dryrun_rank_step_counts_the_ranks_collectives(runs, variant, shape):
    """The dry run's (1, 4) rank step on the reduced cell over ``meta``
    places the collectives, by kind, count and bytes, that a CPU rank's
    log read running the same step; deepseek's decode gathers the latent
    of every MLA layer over ``model``, whisper-6h's training step gathers
    query and K/V columns."""
    cfg = _cfg(variant)
    cell = build_cell(ARCH[variant], shape, cfg=cfg, device="meta", mesh=(1, 4), **CELL)
    _, cost = reckon(cell.step, *cell.args, **cell.kwargs)
    counts, detail = runs[(variant, (1, 4), False)][0]["cells"][shape]
    assert cost.collective_counts == counts
    assert cost.collective_detail == detail
    if shape == "decode_32k":  # one all-gather of the latent a layer, and the logits'
        assert counts["all-gather"] == cfg.n_layers + 1
        latent = B * CELL["seq_len"] // 4 * 24 * 2  # a rank's block, bfloat16
        assert detail["all-gather"] >= cfg.n_layers * latent
    else:
        assert counts["all-reduce"] > 0
        if variant == "whisper-6h":
            assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0
