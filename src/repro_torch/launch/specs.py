"""One (arch × ``SHAPES``) cell as one H100 runs it, or as one rank of a
(data × model) mesh of H100s runs it: its step closure, its inputs, and
the bytes it holds and must move.

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

The JAX dry run's knobs (``repro/launch/specs.py:82-101,153-154``) are
applied as there: ``remat`` to ``build_model``, ``ssm_chunk`` and
``moe_impl`` by ``dataclasses.replace`` on ``cfg.ssm.chunk`` and
``cfg.moe.impl``, ``expert_parallel_2d`` forcing 2D expert parallelism on
a mesh; ``microbatches`` splits a training batch.

On a mesh (``mesh=(data, model)``) the cell is one rank's: the JAX
package's FSDP and 2D expert-parallel choices (``specs.py:107-121``) are
made as there, and ``tensor_parallel.check_tp`` refuses, with its reason,
the families the port has no runtime for under the rules yet (SSM and
xLSTM layers); a mixture of experts runs with its experts over ``(data,
model)`` or over ``model`` (``models/moe.py``), MLA on the rank's heads
with its latent cache split by position, the encoder-decoder on the
rank's heads and ``d_ff`` columns; the parameters
are the rank's shards of the whole model (``tensor_parallel.shard_tree``
at the rank's coordinates; under FSDP a quarter of a 2-D leaf at (2, 2),
its layer gathered where it runs), the batch its data rank's rows, the
cache its KV heads or, where those do not divide the model axis, its
block of positions, and the step runs under the ``ShardingRules``
(``distributed/sharding.py``), whose collectives send nothing on the
abstract mesh and are counted by kind (``step_cost.StepCost``):
all-reduces, all-gathers over ``model`` (MLA's latent positions among
them) and FSDP's over ``data``, reduce-scatters, and the experts'
all-to-alls over ``data``.
The fit on the card's 80 GB is decided in ``launch/dryrun.py`` from the
bytes here and the simulated peak of ``launch/step_cost.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import LMConfig, ShapeConfig, cell_is_runnable
from repro_torch.distributed.sharding import ShardingRules, use_rules
from repro_torch.distributed.tensor_parallel import check_tp, shard_tree
from repro_torch.launch.mesh import Mesh, abstract_mesh
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
    knobs: dict = dataclasses.field(default_factory=dict)  # the dry run's, as run

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


def mesh_rules(cfg: LMConfig, shp: ShapeConfig, mesh: Mesh,
               fsdp: Optional[bool] = None,
               expert_parallel_2d: bool = False) -> ShardingRules:
    """The rules of a cell on ``mesh``, with the JAX package's FSDP and 2D
    expert-parallel choices (``repro/launch/specs.py:107-121``; ``fsdp``
    given: that choice instead, as a reduced or depth-cut rehearsal of a
    configuration keeps the whole one's; ``expert_parallel_2d`` forces 2D
    expert parallelism on, as the JAX dry run's ``--ep2d``); raises
    ``NotImplementedError`` (``check_tp``) where the port has no runtime
    for them."""
    model_size = mesh.shape["model"]
    n_params = cfg.param_count()
    if fsdp is None and shp.kind == "train":
        fsdp = n_params * 12 / model_size > 10e9
    elif fsdp is None:
        fsdp = n_params * 2 / model_size > 8e9
    n_dm = mesh.shape["data"] * model_size
    ep = expert_parallel_2d or (cfg.moe is not None
                                and (cfg.moe.n_experts % mesh.size == 0
                                     or cfg.moe.n_experts % n_dm == 0))
    rules = ShardingRules(mesh, cfg, fsdp=fsdp, expert_parallel_2d=ep)
    check_tp(cfg, rules)
    return rules


def _under(rules: Optional[ShardingRules], step: Callable) -> Callable:
    """``step`` run under ``rules`` (itself without)."""
    if rules is None:
        return step

    def ranked(*args, **kwargs):
        with use_rules(rules):
            return step(*args, **kwargs)

    return ranked


def build_cell(arch: str, shape: str, *, batch: Optional[int] = None,
               microbatches: int = 1, device="meta",
               generator: Optional[torch.Generator] = None,
               cfg: Optional[LMConfig] = None, seq_len: Optional[int] = None,
               mesh=None, fsdp: Optional[bool] = None, remat: str = "layer",
               ssm_chunk: int = 0, expert_parallel_2d: bool = False,
               moe_impl: str = "") -> Cell:
    """The cell ``(arch, shape)`` on ``device`` (``meta``: value-less).
    ``batch`` cuts the cell's batch (never its width or length);
    ``microbatches`` splits a training batch (a data rank's). ``cfg`` and
    ``seq_len`` replace the architecture's configuration and the cell's
    length, for reduced rehearsals on the CPU. ``mesh`` (``(data,
    model)``, or a ``launch/mesh.py:Mesh`` a rank made) gives the cell of
    the mesh's rank: of rank 0 on an abstract mesh; ``None`` or ``(1,
    1)`` the one-card cell. ``fsdp`` overrides the JAX package's FSDP
    choice (``mesh_rules``). A batch the data ranks do not divide is
    replicated over them, as ``ShardingRules.batch_spec`` replicates it
    (long_500k's one sequence). ``remat``, ``ssm_chunk``,
    ``expert_parallel_2d`` and ``moe_impl`` are the JAX dry run's knobs
    (0 and "" leave the configuration's own)."""
    runnable, why = cell_is_runnable(arch, shape)
    if not runnable:
        raise ValueError(f"cell ({arch},{shape}) skipped: {why}")
    cfg = cfg or get_config(arch)
    if ssm_chunk and cfg.ssm is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=ssm_chunk))
    if moe_impl and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl=moe_impl))
    knobs = {"remat": remat, "ssm_chunk": ssm_chunk, "ep2d": expert_parallel_2d,
             "microbatches": microbatches, "moe_impl": moe_impl}
    shp = SHAPES[shape]
    if batch is not None:
        shp = dataclasses.replace(shp, global_batch=batch)
    if seq_len is not None:
        shp = dataclasses.replace(shp, seq_len=seq_len)
    if isinstance(mesh, tuple):
        mesh = None if mesh == (1, 1) else abstract_mesh(*mesh)
    rules = None if mesh is None else mesh_rules(cfg, shp, mesh, fsdp, expert_parallel_2d)
    b, seq = shp.global_batch, shp.seq_len
    model = build_model(cfg, inner="cuda", remat=remat)
    params = _values(lambda g, d: model.init(g, device=d), device, generator)
    n_params = sum(p.numel() for p in tree_leaves(params))
    inputs = _values(lambda g, d: tree_map(lambda t: t.to(d), make_dummy_batch(cfg, b, seq, g)),
                     device, generator)
    if rules is not None:
        params = shard_tree(params, rules, mesh.coords)
        if rules.batch_spec(b) is not None:
            b //= rules.data_size
            inputs = tree_map(lambda t: t.narrow(0, mesh.coords["data"] * b, b).clone(),
                              inputs)

    if shp.kind == "train":
        opt = adamw(LR, fused=True)
        opt_state = opt.init(params)
        step = _under(rules, make_train_step(model, opt, microbatches=microbatches))
        persistent = {"params": _bytes(params), "opt_state": _bytes(opt_state),
                      "inputs": _bytes(inputs)}
        # p read and written; g written and read; m and v read and written; the loss
        min_bytes = 8 * persistent["params"] + persistent["inputs"] + 4
        return Cell(arch, shape, cfg, shp, step, (params, opt_state, inputs), {},
                    persistent, min_bytes, n_params, microbatches, knobs)

    params = tree_map(lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t,
                      params)
    with use_rules(rules):
        cache = model.init_cache(b, seq, dtype=torch.bfloat16, device=device)
    logits = b * cfg.padded_vocab() * 2  # the last position's, bfloat16
    if shp.kind == "prefill":
        tokens = inputs.pop("tokens")
        inputs.pop("labels")
        persistent = {"params": _bytes(params), "cache": _bytes(cache),
                      "inputs": _bytes(tokens) + _bytes(inputs)}
        # weights read once, every cache position written, inputs and logits
        min_bytes = sum(persistent.values()) + logits
        return Cell(arch, shape, cfg, shp, _under(rules, make_prefill_step(model)),
                    (params, tokens, cache), inputs, persistent, min_bytes, n_params,
                    knobs=knobs)

    cache["idx"] = seq - 1  # one step at the last position
    tokens = torch.zeros((b, 1), dtype=torch.int64, device=device)
    persistent = {"params": _bytes(params), "cache": _bytes(cache), "inputs": _bytes(tokens)}
    # weights and the cache read once, one slot written, the token and logits
    min_bytes = sum(persistent.values()) + _slot_bytes(cache, seq) + logits
    return Cell(arch, shape, cfg, shp, _under(rules, make_decode_step(model)),
                (params, cache, tokens), {}, persistent, min_bytes, n_params, knobs=knobs)
