"""The LM substrate on PyTorch: dense, MoE, Mamba2, xLSTM, the
encoder-decoder and the vision frontend.

Counterpart of ``repro/models/transformer.py`` for every configuration.
Block kinds: ``"attn"``, GQA with RoPE
(global or with a sliding window) or DeepSeek's MLA with its latent
cache, then a dense FFN or a mixture of experts (``models/moe.py``) from
layer ``first_k_dense_layers`` on; ``"mamba"``, a Mamba2/SSD block
(``models/ssm.py``); ``"mlstm"`` and ``"slstm"``, the xLSTM blocks
(``models/xlstm.py``); ``"shared_attn"``, Zamba2's weight-shared block:
its layer holds ``{}`` and every such site runs ``params["shared_attn"]``
(one GQA block and MLP) with a K/V cache of its own. DeepSeek-V3's
multi-token prediction joins the loss. whisper-tiny's encoder
(``LM.encode``: bidirectional GQA without RoPE over the stub frontend's
frame embeddings) feeds a cross attention in every decoder layer
(``norm_x``, ``cross``); pixtral-12b's stub vision frontend hands over
patch embeddings that are prepended to the text, and the loss drops
their logits.

Parameters keep the JAX package's tree: ``{"embed": {"table"},
"segments": [...], "final_norm": {...}, "head"?, "shared_attn"?,
"encoder"?: {"layers": [...], "final_norm"}, "mtp"?}``, where a segment that
``plan_segments`` scans keeps its layers stacked on a leading
``[n_reps]`` axis (``params_from_jax`` carries the JAX tree over leaf by
leaf) and the repetitions run in a Python loop over the views that one
``torch.unbind`` a leaf gives (``_unbind``: one stacked gradient); an
unrolled segment is a list of per-layer dicts; each layer gets its own
window (``_layer_window``) as a Python int, where the JAX package scans
an int array of them. ``shard_activation`` marks the JAX package's two
sites (``tokens_bsd`` after the token embeddings, before a vision
frontend's embeddings join them, and ``logits``) and returns its input.
Under sharding rules with a ``model`` axis
(``distributed/tensor_parallel.py``) ``embed_lookup`` sums the ranks'
vocabulary-sharded lookups, so the embeddings are whole wherever it is
called; the logits stay the rank's vocabulary slice, ``forward``,
``prefill`` and ``decode_step`` gather them whole on every rank and
``loss`` takes the vocabulary-sharded cross entropy
(``tensor_parallel.sharded_ce``, whose mean over the data ranks is the
whole batch's), never gathering ``[B, T, V]``; a vocabulary the model
axis does not divide stays whole on every rank. Under FSDP rules
(``distributed/fsdp.py``) each layer's leaves, the embedding and the head
are gathered over ``data`` where they are read, a layer's inside its
``checkpoint``. ``remat="layer"`` recomputes each layer of a scanned
segment in the backward (``torch.utils.checkpoint``), as the JAX
package's ``jax.checkpoint`` of the scan body does, the MoE layers'
load-balance loss included: every layer returns its ``aux`` and the
segments sum it in layer order; the encoder's output is an input of
each recomputed layer, so its gradient reaches the encoder. The entry points are
``forward``, ``loss`` (training), ``prefill`` (which unembeds only the
last position: the full ``[B, T, V]`` logits of a 4 x 1024 prefill at
llama3.2-1b width would take 2.1 GB) and ``decode_step``. Caches are
updated in place (``models/attention.py``, ``models/ssm.py``,
``models/xlstm.py``): a layer's holds ``"attn"`` (K/V or the latent),
``"ssm"`` or ``"xl"`` by its kind, the recurrent states always float32;
the index ``idx`` a Python int on the host; an encoder-decoder's cache
holds the encoder's output ``"enc_out"``, which a prefill with frames
replaces.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import LMConfig
from repro_torch.distributed import fsdp
from repro_torch.distributed.sharding import current_rules, shard_activation
from repro_torch.distributed.tensor_parallel import (
    gather_from_model,
    latent_shards,
    model_sharded,
    seq_shards,
    sharded_ce,
)
from repro_torch.kernels.ops import _executor
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    dense_init,
    embed_init,
    embed_lookup,
    mlp_init,
    norm_init,
    unembed,
)
from repro_torch.training.optimizer import tree_map

# ---------------------------------------------------------------------------
# Segment planning (a copy of the JAX package's)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segment:
    mode: str  # "scan" | "unroll"
    kinds: tuple  # period pattern (scan) or explicit kinds (unroll)
    n_reps: int  # scan repetitions (1 for unroll)
    layer_ids: tuple  # global layer indices covered, in order


def plan_segments(cfg: LMConfig) -> list[Segment]:
    blocks = list(cfg.blocks)
    ids = list(range(cfg.n_layers))
    segs: list[Segment] = []
    k0 = cfg.first_k_dense_layers
    if k0:
        segs.append(Segment("unroll", tuple(blocks[:k0]), 1, tuple(ids[:k0])))
        blocks, ids = blocks[k0:], ids[k0:]
    if not blocks:
        return segs
    # find the smallest period
    period = len(blocks)
    for p in range(1, min(len(blocks), 12) + 1):
        if all(blocks[i] == blocks[i % p] for i in range(len(blocks))):
            period = p
            break
        # allow a non-repeating tail: check truncated repetition
        reps = len(blocks) // p
        if reps >= 2 and all(
            blocks[i] == blocks[i % p] for i in range(reps * p)
        ):
            period = p
            break
    reps = len(blocks) // period
    main = reps * period
    if reps >= 2:
        segs.append(Segment("scan", tuple(blocks[:period]), reps, tuple(ids[:main])))
        if main < len(blocks):
            segs.append(Segment("unroll", tuple(blocks[main:]), 1, tuple(ids[main:])))
    else:
        segs.append(Segment("unroll", tuple(blocks), 1, tuple(ids)))
    return segs


#: the block kinds the port builds, each with the key of its layer's cache
CACHE_KEYS = {"attn": "attn", "shared_attn": "attn", "mamba": "ssm",
              "mlstm": "xl", "slstm": "xl"}


def check_ported(cfg: LMConfig) -> None:
    """Raise ``ValueError`` for a block kind the JAX package does not know
    either."""
    unknown = sorted(set(cfg.blocks) - set(CACHE_KEYS))
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block kinds {unknown}")


def _layer_is_moe(cfg: LMConfig, layer_id: int) -> bool:
    return cfg.moe is not None and layer_id >= cfg.first_k_dense_layers


def _layer_window(cfg: LMConfig, layer_id: int) -> int:
    """0 = global attention; >0 = sliding-window size."""
    if cfg.sliding_window and cfg.global_every:
        is_global = (layer_id + 1) % cfg.global_every == 0
        return 0 if is_global else cfg.sliding_window
    return 0


# ---------------------------------------------------------------------------
# Per-layer init / apply
# ---------------------------------------------------------------------------

def _init_layer(generator, cfg: LMConfig, kind: str, layer_id: int, lead: tuple,
                device) -> dict:
    """Layer ``layer_id``'s block of ``kind``: for ``"attn"`` MLA or GQA,
    then MoE or a dense MLP (an encoder-decoder's with ``norm_x`` and the
    ``cross`` attention); ``{}`` for a shared site."""
    d = cfg.d_model
    if kind == "attn":
        a = (attn.mla_init(generator, cfg, lead, device) if cfg.mla
             else attn.gqa_init(generator, cfg, lead, device))
        ffn = (moe_mod.moe_init(generator, cfg, lead, device)
               if _layer_is_moe(cfg, layer_id)
               else mlp_init(generator, d, cfg.d_ff, cfg.activation, lead, device))
        p = {"norm1": norm_init(cfg.norm, d, lead, device), "attn": a,
             "norm2": norm_init(cfg.norm, d, lead, device), "ffn": ffn}
        if cfg.is_encoder_decoder:
            p["norm_x"] = norm_init(cfg.norm, d, lead, device)
            p["cross"] = attn.gqa_init(generator, cfg, lead, device)
        return p
    if kind == "shared_attn":
        return {}  # weights live in params["shared_attn"]
    init = {"mamba": ssm_mod.mamba_init, "mlstm": xlstm_mod.mlstm_init,
            "slstm": xlstm_mod.slstm_init}[kind]
    return {"norm": norm_init(cfg.norm, d, lead, device),
            kind: init(generator, cfg, lead, device)}


#: the recurrent blocks' apply functions, by kind
_RECURRENT = {"mamba": ssm_mod.mamba_apply, "mlstm": xlstm_mod.mlstm_apply,
              "slstm": xlstm_mod.slstm_apply}


def _apply_layer(p, cfg: LMConfig, kind: str, x, positions, window: int, cache,
                 inner: str, shared=None, enc_out=None):
    """One pre-norm block of ``kind``: for attention x + attn(norm1(x)),
    then, given the encoder's output ``enc_out``, + cross(norm_x(x)) over
    it, then + ffn(norm2(x)) (``shared``'s weights at a shared site, always
    GQA and an MLP); for a recurrent block x + block(norm(x)). Returns
    ``(x, new_cache, aux)``: the MoE's load-balance loss, or None."""
    if kind in _RECURRENT:
        h = apply_norm(cfg.norm, p["norm"], x)
        y, new_cache = _RECURRENT[kind](p[kind], cfg, h, cache=cache)
        return x + y, new_cache, None
    if kind == "shared_attn":
        p, window = shared, 0
    h = apply_norm(cfg.norm, p["norm1"], x)
    if cfg.mla and kind == "attn":
        a, new_cache = attn.mla_apply(p["attn"], cfg, h, positions, cache=cache)
    else:
        a, new_cache = attn.gqa_apply(p["attn"], cfg, h, positions, window=window,
                                      cache=cache, inner=inner)
    x = x + a
    if enc_out is not None:
        hx = apply_norm(cfg.norm, p["norm_x"], x)
        c, _ = attn.gqa_apply(p["cross"], cfg, hx, positions, cache=cache,
                              kv_source=enc_out, inner=inner)
        x = x + c
    h2 = apply_norm(cfg.norm, p["norm2"], x)
    if "router" in p["ffn"]:
        f, aux = moe_mod.moe_apply(p["ffn"], cfg, h2)
    else:
        f, aux = apply_mlp(p["ffn"], h2, cfg.activation, cfg.d_ff), None
    return x + f, new_cache, aux


def _gathered(lp, where):
    """A layer's leaves with its FSDP leaves gathered (``where``: the plan,
    the layer's path and whether it is a scanned repetition)."""
    return lp if where is None else fsdp.gather(lp, where[0], where[1], where[2])


def _index(tree, r: int):
    """Repetition ``r`` of a stacked segment's dict of tensors (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def _unbind(tree, n: int) -> list:
    """A stacked segment's dict of tensors as ``n`` per-repetition dicts of
    views, split by one ``torch.unbind`` a leaf: its backward stacks the
    repetitions' gradients into one tensor, where ``n`` separate
    ``tree[r]`` would each fill a zeroed tensor of the whole stack."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: v[r] for k, v in parts.items()} for r in range(n)]
    return list(torch.unbind(tree))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class LM:
    """The model over ``inner``'s prefill attention for GQA layers and
    shared sites without a window, and for the encoder and the cross
    attention of an encoder-decoder: ``"cuda"`` the flash kernel (its
    plain version for CPU tensors), ``"torch"`` the plain version on any
    device (MLA layers always take ``_attn_core``; the recurrent blocks
    run no kernel of the port). ``remat="layer"`` recomputes each layer
    of a scanned segment in the backward of an uncached call; ``"none"``
    keeps every activation."""

    def __init__(self, cfg: LMConfig, inner: str = "cuda", remat: str = "layer"):
        check_ported(cfg)
        _executor(inner, "flash")  # validates inner now
        if remat not in ("layer", "none"):
            raise ValueError(f"remat must be 'layer' or 'none', got {remat!r}")
        self.cfg = cfg
        self.inner = inner
        self.remat = remat
        self.segments = plan_segments(cfg)

    def init(self, generator: torch.Generator, device=None) -> dict:
        """Random weights with the JAX package's names, shapes and scales,
        drawn from ``generator`` on its own device and placed on ``device``
        (CUDA unless asked; raises without a card)."""
        cfg = self.cfg
        device = resolve_device(device)
        params: dict = {"embed": embed_init(generator, cfg.padded_vocab(),
                                            cfg.d_model, device)}
        segs = []
        for seg in self.segments:
            lead = () if seg.mode == "unroll" else (seg.n_reps,)
            segs.append([_init_layer(generator, cfg, kind, lid, lead, device)
                         for kind, lid in zip(seg.kinds, seg.layer_ids)])
        params["segments"] = segs
        params["final_norm"] = norm_init(cfg.norm, cfg.d_model, (), device)
        if not cfg.tie_embeddings:
            params["head"] = embed_init(generator, cfg.padded_vocab(),
                                        cfg.d_model, device)
        d = cfg.d_model
        if "shared_attn" in cfg.blocks:
            params["shared_attn"] = {
                "norm1": norm_init(cfg.norm, d, (), device),
                "attn": attn.gqa_init(generator, cfg, (), device),
                "norm2": norm_init(cfg.norm, d, (), device),
                "ffn": mlp_init(generator, d, cfg.d_ff, cfg.activation, (), device)}
        if cfg.is_encoder_decoder:
            params["encoder"] = {
                "layers": [{"norm1": norm_init(cfg.norm, d, (), device),
                            "attn": attn.gqa_init(generator, cfg, (), device),
                            "norm2": norm_init(cfg.norm, d, (), device),
                            "ffn": mlp_init(generator, d, cfg.d_ff, cfg.activation, (),
                                            device)}
                           for _ in range(cfg.n_encoder_layers)],
                "final_norm": norm_init(cfg.norm, d, (), device)}
        if cfg.mtp_depth > 0:
            params["mtp"] = {
                "proj": dense_init(generator, 2 * d, d, (), device),
                "norm": norm_init(cfg.norm, d, (), device),
                "block": _init_layer(generator, cfg, "attn", cfg.n_layers - 1, (),
                                     device)}
        return params

    def encode(self, params, frames: torch.Tensor, cache: Optional[dict] = None):
        """whisper's encoder over ``frames`` [B, Tk, D]: pre-norm layers of
        bidirectional attention (cross attention of the frames over
        themselves, no RoPE, as in the JAX package) and an MLP, then the
        final norm. ``cache`` only says that the call serves a prefill,
        where the attention is the flash kernel (``attention._cross``).
        Under the rules each layer runs on the rank's heads and ``d_ff``
        columns, its leaves gathered over ``data`` where FSDP shards
        them."""
        cfg = self.cfg
        plan = fsdp.plan(self)
        x = frames
        pos = torch.arange(x.shape[1], device=x.device)
        for i, lp in enumerate(params["encoder"]["layers"]):
            lp = fsdp.gather(lp, plan, f"encoder/layers/{i}")
            h = apply_norm(cfg.norm, lp["norm1"], x)
            a, _ = attn.gqa_apply(lp["attn"], cfg, h, pos, cache=cache, kv_source=h,
                                  inner=self.inner)
            x = x + a
            x = x + apply_mlp(lp["ffn"], apply_norm(cfg.norm, lp["norm2"], x),
                              cfg.activation, cfg.d_ff)
        return apply_norm(cfg.norm, params["encoder"]["final_norm"], x)

    def _run_segments(self, params, x, positions, cache, enc_out=None, plan=None):
        """Returns ``(x, aux, new_cache)``: ``aux`` the float32 sum of the
        MoE layers' load-balance losses, in layer order; every attention
        layer cross-attends to ``enc_out`` where it is given. Under an FSDP
        ``plan`` each layer's leaves are gathered over ``data`` where the
        layer runs, inside its ``checkpoint`` (``distributed/fsdp.py``)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        shared = params.get("shared_attn")
        cache_idx = None if cache is None else cache["idx"]
        shards = 1 if cache is None else cache.get("seq_shards", 1)
        new_segs = None if cache is None else []
        for si, seg in enumerate(self.segments):
            seg_p = params["segments"][si]
            seg_c = None if cache is None else cache["segments"][si]
            reps = 1 if seg.mode == "unroll" else seg.n_reps
            remat = (self.remat == "layer" and seg.mode == "scan" and cache is None
                     and torch.is_grad_enabled())
            period = len(seg.kinds)
            scan = seg.mode == "scan"
            if scan:
                seg_p = [_unbind(p, reps) if plan is None
                         else fsdp.unbind(p, reps, plan, f"segments/{si}/{j}")
                         for j, p in enumerate(seg_p)]
            for r in range(reps):
                for j, kind in enumerate(seg.kinds):
                    window = _layer_window(cfg, seg.layer_ids[r * period + j])
                    lp = seg_p[j][r] if scan else seg_p[j]
                    where = None if plan is None else (plan, f"segments/{si}/{j}", scan)
                    if remat:
                        x, layer_aux = checkpoint(self._layer_out, lp, kind, x,
                                                  positions, window, shared, enc_out, where,
                                                  use_reentrant=False)
                    else:
                        lc = None
                        if seg_c is not None:
                            key = CACHE_KEYS[kind]
                            lc = seg_c[j][key]
                            if scan:
                                lc = _index(lc, r)
                            if key == "attn":
                                lc = {**lc, "idx": cache_idx}
                                if shards > 1:
                                    lc["seq_shards"] = shards
                        x, _, layer_aux = _apply_layer(_gathered(lp, where), cfg, kind, x,
                                                       positions, window, lc, self.inner,
                                                       shared, enc_out)
                    if layer_aux is not None:
                        aux = aux + layer_aux
            if new_segs is not None:
                new_segs.append(seg_c)  # its tensors were updated in place
        new_cache = None
        if cache is not None:
            new_cache = {"idx": cache_idx + x.shape[1], "segments": new_segs}
            if shards > 1:
                new_cache["seq_shards"] = shards
            if enc_out is not None:
                new_cache["enc_out"] = enc_out
        return x, aux, new_cache

    def _layer_out(self, lp, kind: str, x, positions, window: int, shared, enc_out,
                   where=None):
        """An uncached layer's output and its aux (None but for an MoE
        FFN), the unit ``remat`` recomputes (its FSDP gathers with it)."""
        x, _, aux = _apply_layer(_gathered(lp, where), self.cfg, kind, x, positions,
                                 window, None, self.inner, shared, enc_out)
        return x, aux

    def _hidden(self, params, tokens, cache, positions, frontend_embeds=None,
                encoder_frames=None):
        """The final-normed hidden states, ``frontend_embeds`` [B, F, D]
        prepended to the tokens' embeddings at their dtype; an
        encoder-decoder cross-attends to the encoding of
        ``encoder_frames``, else to the cache's ``enc_out`` (none without
        either)."""
        cfg = self.cfg
        plan = fsdp.plan(self)
        embed = fsdp.gather(params["embed"], plan, "embed")
        x = embed_lookup(embed, tokens, cfg.padded_vocab()) * float(np.sqrt(cfg.d_model))
        x = shard_activation(x, "tokens_bsd")
        if frontend_embeds is not None:
            x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        enc_out = None
        if cfg.is_encoder_decoder:
            if encoder_frames is not None:
                enc_out = self.encode(params, encoder_frames, cache)
            elif cache is not None and "enc_out" in cache:
                enc_out = cache["enc_out"]
        x, aux, new_cache = self._run_segments(params, x, positions, cache, enc_out, plan)
        return apply_norm(cfg.norm, params["final_norm"], x), aux, new_cache

    def _head(self, params):
        """The unembedding's table, gathered over ``data`` under FSDP."""
        key = "embed" if self.cfg.tie_embeddings else "head"
        return fsdp.gather(params[key], fsdp.plan(self), key)

    def _logits(self, params, hidden):
        """The logits of ``hidden``: the rank's vocabulary slice where the
        rules shard the vocabulary over ``model``."""
        return shard_activation(unembed(self._head(params), hidden, self.cfg.padded_vocab()),
                                "logits")

    def _whole(self, logits):
        """Logits gathered whole over ``model`` where they are a slice."""
        return gather_from_model(logits) if model_sharded(self.cfg.padded_vocab()) \
            else logits

    def forward(self, params, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None,
                encoder_frames: Optional[torch.Tensor] = None,
                cache: Optional[dict] = None,
                positions: Optional[torch.Tensor] = None):
        """tokens [B, T] (``frontend_embeds`` [B, F, D] prepended;
        ``encoder_frames`` [B, Tk, D] encoded for the cross attention).
        Returns ``(logits [B, F + T, Vpad], aux_loss, new_cache, hidden)``;
        ``aux_loss`` sums the MoE layers' (0 where there are none)."""
        hidden, aux, new_cache = self._hidden(params, tokens, cache, positions,
                                              frontend_embeds, encoder_frames)
        logits = self._whole(self._logits(params, hidden))
        return logits, aux, new_cache, hidden

    def loss(self, params, batch: dict) -> tuple:
        """batch: tokens [B, S], labels [B, S] (-100 = ignore), and
        ``frontend_embeds`` / ``encoder_frames`` where the model takes
        them. Returns ``(ce + 0.01·aux [+ 0.3·mtp], {"ce", "aux",
        "denom"[, "mtp"]})`` over the text positions (the frontend's
        logits dropped), as the JAX package's ``LM.loss``."""
        cfg = self.cfg
        front = batch.get("frontend_embeds")
        hidden, aux, _ = self._hidden(params, batch["tokens"], None, None, front,
                                      batch.get("encoder_frames"))
        logits = self._logits(params, hidden)
        if front is not None:
            logits = logits[:, front.shape[1]:]
        ce_of = _masked_ce if current_rules() is None else sharded_ce
        ce, denom = ce_of(logits, batch["labels"], cfg.vocab_size)
        total = ce + 0.01 * aux
        metrics = {"ce": ce, "aux": aux, "denom": denom}
        if cfg.mtp_depth > 0:
            mtp = self._mtp_loss(params, hidden, batch["tokens"], batch["labels"])
            total = total + 0.3 * mtp
            metrics["mtp"] = mtp
        return total, metrics

    def _mtp_loss(self, params, hidden, tokens, labels):
        """DeepSeek-V3's multi-token prediction (depth 1): position t's
        final hidden state, normed, beside the embedding of token t + 1,
        projected and run through ``params["mtp"]["block"]`` (its aux
        dropped, as the JAX package drops it), predicts token t + 2 (the
        label at t + 1). Under the rules the block runs on the rank's heads
        and experts, ``proj`` (in no rule's list) replicated, the
        embedding, the head and the block's leaves gathered over ``data``
        where FSDP shards them, and the loss is the vocabulary-sharded
        cross entropy, the whole batch's mean over the data ranks."""
        cfg = self.cfg
        plan = fsdp.plan(self)
        mp = fsdp.gather(params["mtp"], plan, "mtp")
        embed = fsdp.gather(params["embed"], plan, "embed")
        nxt = embed_lookup(embed, tokens[:, 1:], cfg.padded_vocab()) \
            * float(np.sqrt(cfg.d_model))
        z = torch.cat([apply_norm(cfg.norm, mp["norm"], hidden[:, :-1]), nxt], -1)
        z = z @ mp["proj"]
        pos = torch.arange(z.shape[1], device=z.device)
        z, _, _ = _apply_layer(mp["block"], cfg, "attn", z, pos, 0, None, self.inner)
        logits2 = unembed(self._head(params), apply_norm(cfg.norm, params["final_norm"], z),
                          cfg.padded_vocab())
        ce_of = _masked_ce if current_rules() is None else sharded_ce
        ce, _ = ce_of(logits2, labels[:, 1:], cfg.vocab_size)
        return ce

    def init_cache(self, batch: int, s_max: int, dtype=torch.bfloat16,
                   device=None) -> dict:
        """Zeroed caches in the JAX package's tree (a scanned segment's
        stacked on ``[n_reps]``): K/V at ``dtype`` (the rank's KV heads
        under tensor parallelism) for GQA layers and
        shared sites, the latent for MLA layers, and float32 states for
        the recurrent blocks (``"ssm"``, ``"xl"``, whatever ``dtype``, as
        the JAX package's); an encoder-decoder's ``enc_out`` [B,
        encoder_seq, D] at ``dtype`` (the rank's batch, whole over
        ``model``); ``idx = 0``, on ``device``. Where the rules split the
        K/V caches by position (KV heads the model axis does not divide)
        or MLA's latent (whose positions they split wherever ``model``
        divides them), ``seq_shards`` at the root says into how many
        blocks, each rank holding its own."""
        device = resolve_device(device)
        cfg = self.cfg

        def layer_cache(kind, lead):
            if kind == "mamba":
                return {"ssm": ssm_mod.mamba_cache_init(cfg, batch, lead=lead,
                                                        device=device)}
            if kind in ("mlstm", "slstm"):
                init = (xlstm_mod.mlstm_cache_init if kind == "mlstm"
                        else xlstm_mod.slstm_cache_init)
                return {"xl": init(cfg, batch, lead, device)}
            init = (attn.mla_cache_init if cfg.mla and kind == "attn"
                    else attn.gqa_cache_init)
            return {"attn": init(cfg, batch, s_max, dtype, lead, device)}

        segs = []
        for seg in self.segments:
            lead = () if seg.mode == "unroll" else (seg.n_reps,)
            segs.append([layer_cache(kind, lead) for kind in seg.kinds])
        cache = {"idx": 0, "segments": segs}
        shards = latent_shards(s_max) if cfg.mla else seq_shards(cfg.n_kv_heads, s_max)
        if shards > 1 and any(kind in ("attn", "shared_attn") for kind in cfg.blocks):
            cache["seq_shards"] = shards  # each rank holds s_max / shards positions
        if cfg.is_encoder_decoder:
            cache["enc_out"] = torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                           dtype=dtype, device=device)
        return cache

    def prefill(self, params, tokens: torch.Tensor, cache: dict,
                frontend_embeds: Optional[torch.Tensor] = None,
                encoder_frames: Optional[torch.Tensor] = None):
        """Run the whole prompt [B, T] (after ``frontend_embeds`` [B, F, D],
        at positions 0..F + T - 1) through the model, filling ``cache``
        from its index (an encoder-decoder's ``enc_out`` with the encoding
        of ``encoder_frames`` where given); returns ``(last-position logits
        [B, Vpad], new_cache)``."""
        n_front = 0 if frontend_embeds is None else frontend_embeds.shape[1]
        positions = torch.arange(tokens.shape[1] + n_front, device=tokens.device)
        hidden, _, new_cache = self._hidden(params, tokens, cache, positions,
                                            frontend_embeds, encoder_frames)
        return self._whole(self._logits(params, hidden[:, -1])), new_cache

    def decode_step(self, params, cache: dict, tokens: torch.Tensor):
        """One decode step: tokens [B, 1] at position ``cache["idx"]``."""
        idx = cache["idx"]
        positions = torch.arange(idx, idx + 1, device=tokens.device)
        hidden, _, new_cache = self._hidden(params, tokens, cache, positions)
        return self._whole(self._logits(params, hidden[:, -1])), new_cache


def _masked_ce(logits, labels, vocab_size: int):
    """Mean next-token cross entropy over the labels >= 0, and their count
    (at least 1): the vocabulary padding's logits set to -1e30 at the
    logits' dtype, the log-softmax in float32."""
    vpad = logits.shape[-1]
    if vpad > vocab_size:
        pad = torch.arange(vpad, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    mask = labels >= 0
    safe = labels.clamp(min=0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    denom = mask.sum().clamp(min=1).float()
    return torch.where(mask, nll, torch.zeros_like(nll)).sum() / denom, denom


def params_from_jax(tree, device=None):
    """The JAX package's LM parameters (numpy leaves, e.g. from
    ``jax.device_get``) as the port's tree of float32 tensors on
    ``device`` (CUDA unless asked): the same keys, lists and stacked
    ``[n_reps, ...]`` segment axes, the MoE layers' bare ``router`` and
    stacked ``[n_reps, E, D, F]`` experts, MLA's weights and ``mtp``
    included, the empty ``{}`` of Zamba2's shared sites beside
    ``shared_attn``, and an encoder-decoder's ``encoder`` (a list of layer
    dicts and ``final_norm``) and each decoder layer's ``norm_x`` and
    ``cross``."""
    device = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device),
                    tree)

