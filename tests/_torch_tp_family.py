"""The dense family under the sharding rules on gloo CPU ranks, against the
JAX package's single-device program: shared by
``test_torch_tensor_parallel.py`` (meshes (1, 2), (1, 4), (2, 2)) and
``test_torch_fsdp.py`` (FSDP at (2, 1) and (2, 2)).

Three reduced configurations, each cut to 2 layers:

- ``starcoder2``: starcoder2-3b's family (LayerNorm, a GELU MLP with
  biases, untied head), 4 heads over 2 KV heads of 16: at model 4 a rank
  holds half a KV head's columns and a quarter of the cache's positions;
- ``gemma3``: gemma3-1b's (one KV head, tied embeddings, a sliding window
  of 32 on layer 0 and a global layer 1), the KV head split at every model
  size, the cache sharded by position;
- ``gemma3-2q``: the same with 2 query heads, so that at model 4 the
  query heads split below one head too (gemma3-1b's case at model 8).

The prompts (44 tokens, longer than the window, two rows left-padded with
token 0 as the engine pads them) are prefilled to 40 and decoded 2 steps
into a cache of 48 positions. Each rank returns its logits, cache and
leaf shapes, its float32 loss and gradients (``fsdp.data_mean``), one
AdamW step of its shards from the JAX gradients' shards, and one
``make_train_step`` step.
"""
import dataclasses
import hashlib
import types

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.distributed.fsdp import data_mean
from repro_torch.distributed.sharding import ShardingRules, use_rules
from repro_torch.distributed.tensor_parallel import (
    CollectiveLog,
    check_tp,
    gather_tree,
    logging_collectives,
    mean_over_data,
    shard_tree,
)
from repro_torch.launch.mesh import abstract_mesh, make_mesh
from repro_torch.models.model_zoo import build_model, make_train_step
from repro_torch.models.transformer import params_from_jax
from repro_torch.runtime.checkpoint import _flatten_with_paths
from repro_torch.training.optimizer import adamw, tree_leaves, tree_map, tree_unflatten

B, T, T0, S_MAX = 4, 44, 40, 48
LR = 1e-2
TOL = dict(atol=1e-4, rtol=1e-4)
ADAM_TOL = dict(atol=1e-6, rtol=1e-6)
NAMES = ("starcoder2", "gemma3", "gemma3-2q")


def config(name: str, getter=get_config):
    if name == "starcoder2":
        return dataclasses.replace(getter("starcoder2-3b").reduced(), n_layers=2)
    cfg = dataclasses.replace(getter("gemma3-1b").reduced(), n_layers=2, global_every=2)
    return dataclasses.replace(cfg, n_heads=2) if name == "gemma3-2q" else cfg


def data(vocab: int):
    r = np.random.default_rng(0)
    tokens = r.integers(1, vocab, (B, T)).astype(np.int32)
    tokens[1, :5] = tokens[3, :11] = 0  # left padding, as the engine pads a wave
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100, np.int32)], 1)
    labels[r.random(labels.shape) < 0.2] = -100  # the data ranks' counts differ
    return types.SimpleNamespace(tokens=tokens, labels=labels)


def reference(name: str):
    """The JAX package's single-device program on the whole batch."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models.model_zoo import build_model as jax_build_model
    from repro.training.optimizer import adamw as jax_adamw

    cfg = config(name, jax_get_config)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(config(name))
    jm = jax_build_model(cfg, remat="none")
    jp = jm.init(jax.random.PRNGKey(0))
    d = data(cfg.vocab_size)
    tokens = jnp.asarray(d.tokens)
    forward = np.asarray(jm.forward(jp, tokens)[0])
    cache = jm.init_cache(B, S_MAX, dtype=jnp.float32)
    logits, cache = jm.prefill(jp, tokens[:, :T0], cache)
    cached = [np.asarray(logits)]
    for t in range(T0, T0 + 2):
        logits, cache = jm.decode_step(jp, cache, tokens[:, t:t + 1])
        cached.append(np.asarray(logits))
    batch = {"tokens": tokens, "labels": jnp.asarray(d.labels)}
    loss, grads = jax.value_and_grad(lambda p: jm.loss(p, batch)[0])(jp)
    opt = jax_adamw(LR)
    adam = opt.update(grads, opt.init(jp), jp)[0]
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return types.SimpleNamespace(params=to_np(jp), forward=forward, cached=np.stack(cached),
                                 loss=float(loss), grads=to_np(grads), adam=to_np(adam))


def _np(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


def _shapes(tree) -> dict:
    return {path: tuple(leaf.shape) for path, leaf in _flatten_with_paths(tree)
            if isinstance(leaf, torch.Tensor)}


def rank_run(rank, name, dm, fsdp, np_params, np_grads) -> dict:
    """One rank of a ``dm`` mesh (FSDP where ``fsdp``) on configuration
    ``name``."""
    cfg = config(name)
    d = data(cfg.vocab_size)
    model = build_model(cfg, inner="cuda")
    full = params_from_jax(np_params, device="cpu")
    mesh = make_mesh(*dm)
    rules = ShardingRules(mesh, cfg, fsdp=fsdp)
    check_tp(cfg, rules)
    local = shard_tree(full, rules, mesh.coords)
    bl = B // dm[0]
    rows = slice(mesh.coords["data"] * bl, (mesh.coords["data"] + 1) * bl)
    tokens = torch.from_numpy(d.tokens[rows]).long()
    batch = {"tokens": tokens, "labels": torch.from_numpy(d.labels[rows]).long()}
    out = {"coords": dict(mesh.coords), "leaf_shapes": _shapes(local)}
    with use_rules(rules):
        with torch.no_grad():
            out["forward"] = model.forward(local, tokens)[0].numpy()
            cache = model.init_cache(bl, S_MAX, dtype=torch.float32, device="cpu")
            out["cache_shapes"] = _shapes(cache)
            logits, cache = model.prefill(local, tokens[:, :T0], cache)
            cached = [logits]
            for t in range(T0, T0 + 2):
                logits, cache = model.decode_step(local, cache, tokens[:, t:t + 1])
                cached.append(logits)
            out["cached"] = torch.stack(cached).numpy()
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(local)]
        loss, _ = model.loss(tree_unflatten(local, leaves), batch)
        grads = data_mean(model, local, list(torch.autograd.grad(loss, leaves)))
        out["loss"] = float(mean_over_data([loss.detach()])[0])
        out["grads"] = _np(tree_unflatten(local, grads))
        out["digests"] = {p: hashlib.sha256(g.numpy().tobytes()).hexdigest()
                          for (p, _), g in zip(_flatten_with_paths(local), grads)}
        opt = adamw(LR, fused=True)
        jax_grads = shard_tree(params_from_jax(np_grads, device="cpu"), rules, mesh.coords)
        out["adam"] = _np(opt.update(jax_grads, opt.init(local), local)[0])
        log = CollectiveLog()
        with logging_collectives(log):
            new, _, step_loss = make_train_step(model, opt, compute_dtype=torch.float32)(
                local, opt.init(local), batch)
        out["step_loss"], out["params1"] = float(step_loss), _np(new)
        out["step_counts"] = dict(log.counts)
    return out


def run_meshes(pool, ref: dict, meshes, fsdp: bool) -> dict:
    """(name, mesh) -> every rank's results, on ``pool``."""
    return {(name, dm): pool.run(rank_run, dm[0] * dm[1],
                                 (name, dm, fsdp, ref[name].params, ref[name].grads))
            for name in NAMES for dm in meshes}


def rules_of(name: str, dm, fsdp: bool) -> ShardingRules:
    return ShardingRules(abstract_mesh(*dm), config(name), fsdp=fsdp)


def _like(ref):
    return params_from_jax(ref.params, device="cpu")


def _close(got, want, tol):
    for a, b in zip(tree_leaves(got), tree_leaves(params_from_jax(want, device="cpu"))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)


def _gathered(ranks, key, rules, ref):
    return gather_tree([tree_map(torch.from_numpy, o[key]) for o in ranks], rules, _like(ref))


def check_logits(ranks, ref, dm):
    for out in ranks:
        bl = B // dm[0]
        rows = slice(out["coords"]["data"] * bl, (out["coords"]["data"] + 1) * bl)
        np.testing.assert_allclose(out["forward"], ref.forward[rows], **TOL)
        np.testing.assert_allclose(out["cached"], ref.cached[:, rows], **TOL)


def check_grads(ranks, ref, dm, rules):
    """The loss on every rank, every gathered gradient leaf, and the
    replicated ``b_in`` (and every leaf a model group shares) bitwise
    equal on the model ranks of a data rank."""
    for out in ranks:
        assert abs(out["loss"] - ref.loss) <= 1e-4 + 1e-4 * abs(ref.loss)
    _close(_gathered(ranks, "grads", rules, ref), ref.grads, TOL)
    shape = dict(rules.mesh.shape)
    for out in ranks:
        row0 = ranks[out["coords"]["data"] * dm[1]]
        for path, leaf in _flatten_with_paths(_like(ref)):
            spec = rules.param_spec(path, tuple(leaf.shape))
            if all(e != "model" for e in spec) and shape["model"] > 1:
                assert out["digests"][path] == row0["digests"][path], path
    assert any(p.endswith("b_in") for p in ranks[0]["digests"])  # every case is GELU


def check_adam(ranks, ref, dm, rules):
    _close(_gathered(ranks, "adam", rules, ref), ref.adam, ADAM_TOL)
    _close(_gathered(ranks, "params1", rules, ref), ref.adam, TOL)
    for out in ranks:
        assert abs(out["step_loss"] - ref.loss) <= 1e-4 + 1e-4 * abs(ref.loss)


def check_shapes(ranks, ref, rules, name):
    """Every rank's leaves are its ``param_spec`` shards and its caches its
    ``cache_spec`` shards (the rank's rows of the batch)."""
    shape = dict(rules.mesh.shape)

    def local(full, spec):
        out = list(full)
        for dim, entry in enumerate(spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    out[dim] //= shape[a]
        return tuple(out)

    want = {path: local(leaf.shape, rules.param_spec(path, tuple(leaf.shape)))
            for path, leaf in _flatten_with_paths(_like(ref))}
    model = build_model(config(name), inner="torch")
    cache = model.init_cache(B, S_MAX, dtype=torch.float32, device="cpu")
    want_cache = {path: local(leaf.shape, rules.cache_spec(path, tuple(leaf.shape),
                                                           global_batch=B))
                  for path, leaf in _flatten_with_paths(cache) if isinstance(leaf, torch.Tensor)}
    for out in ranks:
        assert out["leaf_shapes"] == want
        assert out["cache_shapes"] == want_cache
