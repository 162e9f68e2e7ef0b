"""One (arch × ``SHAPES``) cell as one H100 runs it: its step closure, its
inputs, and the bytes it holds and must move.

The single-card counterpart of ``repro/launch/specs.py``, whose
``build_cell`` hands ``ShapeDtypeStruct`` stand-ins with their shardings to
``jax.jit(step).lower``. Here the stand-ins are ``meta`` tensors, which
hold no values and run on any machine: the parameters' shapes come from
``LM.init`` under ``FakeTensorMode`` (as JAX takes them from
``jax.eval_shape``), and the batch's from ``make_dummy_batch``. With
``device="cpu"`` or ``"cuda"`` the same cell holds real tensors from a
seeded generator, which is how ``chip_smoke.py`` phase 25 runs the cell it
reckons.

Dtypes as in the JAX package: float32 parameters and AdamW state for
training (the step casts its leaves to bfloat16 inside the loss), bfloat16
weights and a bfloat16 cache of ``seq_len`` positions for serving (the
recurrent states float32, as ``LM.init_cache`` keeps them). The steps are
``models/model_zoo.py``'s closures over ``build_model(cfg, inner="cuda")``:
flash attention in prefill, one ``fused_adam`` call a training step. A
decode cell takes its one step at the cache's last position.

JAX's per-chip FSDP choice has no counterpart on one card; the fit on its
80 GB is decided in ``launch/dryrun.py`` from the bytes here and the
simulated peak of ``launch/step_cost.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import LMConfig, ShapeConfig, cell_is_runnable
from repro_torch.launch.step_cost import tensor_bytes
from repro_torch.models.model_zoo import (
    build_model,
    make_decode_step,
    make_dummy_batch,
    make_prefill_step,
    make_train_step,
)
from repro_torch.training.optimizer import adamw, tree_leaves, tree_map

#: the JAX dry run's optimizer (``repro/launch/specs.py``), fused
LR = 3e-4


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str  # the SHAPES key
    cfg: LMConfig
    shp: ShapeConfig  # the shape run: the cell's, its batch cut where asked
    step: Callable
    args: tuple
    kwargs: dict
    persistent: dict  # kind -> bytes held before the step (params, opt_state, cache, inputs)
    min_bytes: float  # the least bytes the step must move
    n_params: int  # the initialised parameters
    microbatches: int = 1

    @property
    def persistent_bytes(self) -> int:
        return int(sum(self.persistent.values()))


def _bytes(tree) -> int:
    return sum(tensor_bytes(t) for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _values(make: Callable, device, generator: Optional[torch.Generator]):
    """``make(generator, device)``'s tree: value-less on ``meta`` (drawn
    under ``FakeTensorMode``, then each leaf an empty ``meta`` tensor of its
    shape and dtype), else drawn from ``generator`` (a CPU generator
    seeded 0 if none) on ``device``."""
    if torch.device(device).type != "meta":
        return make(generator or torch.Generator().manual_seed(0), device)
    with FakeTensorMode():
        fake = make(torch.Generator().manual_seed(0), "cpu")
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
                    if isinstance(t, torch.Tensor) else t, fake)


def _slot_bytes(cache: dict, seq: int) -> int:
    """The bytes one decode step writes into ``cache``: one position of each
    attention cache (K/V or MLA's latent), and the recurrent states whole."""
    total = 0
    for seg in cache["segments"]:
        for layer in seg:
            for key, leaves in layer.items():
                total += _bytes(leaves) // seq if key == "attn" else _bytes(leaves)
    return total


def build_cell(arch: str, shape: str, *, batch: Optional[int] = None,
               microbatches: int = 1, device="meta",
               generator: Optional[torch.Generator] = None,
               cfg: Optional[LMConfig] = None, seq_len: Optional[int] = None) -> Cell:
    """The cell ``(arch, shape)`` on ``device`` (``meta``: value-less).
    ``batch`` cuts the cell's batch (never its width or length);
    ``microbatches`` splits a training batch. ``cfg`` and ``seq_len``
    replace the architecture's configuration and the cell's length, for
    reduced rehearsals on the CPU."""
    runnable, why = cell_is_runnable(arch, shape)
    if not runnable:
        raise ValueError(f"cell ({arch},{shape}) skipped: {why}")
    cfg = cfg or get_config(arch)
    shp = SHAPES[shape]
    if batch is not None:
        shp = dataclasses.replace(shp, global_batch=batch)
    if seq_len is not None:
        shp = dataclasses.replace(shp, seq_len=seq_len)
    b, seq = shp.global_batch, shp.seq_len
    model = build_model(cfg, inner="cuda", remat="layer")
    params = _values(lambda g, d: model.init(g, device=d), device, generator)
    n_params = sum(p.numel() for p in tree_leaves(params))
    inputs = _values(lambda g, d: tree_map(lambda t: t.to(d), make_dummy_batch(cfg, b, seq, g)),
                     device, generator)

    if shp.kind == "train":
        opt = adamw(LR, fused=True)
        opt_state = opt.init(params)
        step = make_train_step(model, opt, microbatches=microbatches)
        persistent = {"params": _bytes(params), "opt_state": _bytes(opt_state),
                      "inputs": _bytes(inputs)}
        # p read and written; g written and read; m and v read and written; the loss
        min_bytes = 8 * persistent["params"] + persistent["inputs"] + 4
        return Cell(arch, shape, cfg, shp, step, (params, opt_state, inputs), {},
                    persistent, min_bytes, n_params, microbatches)

    params = tree_map(lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t,
                      params)
    cache = model.init_cache(b, seq, dtype=torch.bfloat16, device=device)
    logits = b * cfg.padded_vocab() * 2  # the last position's, bfloat16
    if shp.kind == "prefill":
        tokens = inputs.pop("tokens")
        inputs.pop("labels")
        persistent = {"params": _bytes(params), "cache": _bytes(cache),
                      "inputs": _bytes(tokens) + _bytes(inputs)}
        # weights read once, every cache position written, inputs and logits
        min_bytes = sum(persistent.values()) + logits
        return Cell(arch, shape, cfg, shp, make_prefill_step(model),
                    (params, tokens, cache), inputs, persistent, min_bytes, n_params)

    cache["idx"] = seq - 1  # one step at the last position
    tokens = torch.zeros((b, 1), dtype=torch.int64, device=device)
    persistent = {"params": _bytes(params), "cache": _bytes(cache), "inputs": _bytes(tokens)}
    # weights and the cache read once, one slot written, the token and logits
    min_bytes = sum(persistent.values()) + _slot_bytes(cache, seq) + logits
    return Cell(arch, shape, cfg, shp, make_decode_step(model), (params, cache, tokens), {},
                persistent, min_bytes, n_params)
