"""What one step costs, reckoned op by op as the port dispatches it.

The single-card counterpart of the JAX package's ``launch/hlo_analysis.py``
(loop-aware FLOPs, bytes and collective bytes from the optimized HLO) and
``launch/jaxpr_flops.py`` (``dot_general`` FLOPs from the jaxpr). The port
runs eagerly, so its program is the sequence of operators a step
dispatches: ``StepCost`` is a ``TorchDispatchMode`` that sees each of them,
over value-less (``meta``) tensors as over real ones, and counts

- FLOPs of the products, by the dtype class they run in: the formulas of
  ``torch.utils.flop_counter`` (2·M·N·K for ``mm``/``bmm``/``addmm``) at
  the class of their first operand (``bf16`` for 16-bit floats, ``fp32``
  for float32, which the port runs outside the tensor cores since it turns
  TF32 off), and the port's kernels by their own formulas
  (``kernels/flash_attention.py:flash_cost``, at the class of its inputs);
- bytes: each operator's inputs read once and its outputs written once (a
  view moves nothing; an allocation writes nothing; a gather reads the rows
  it gathers; ``fused_adam`` by ``kernels/fused_adam.py:fused_adam_cost``);
- the launches of the port's kernels (flash one a call; ``fused_adam`` one
  for every ``CAPACITY`` nonempty leaves, as its wrapper launches);
- the simulated peak: the largest sum of the storages the step allocated
  that are alive at once (each storage counted from the operator that
  made it until its last tensor is freed), over what existed before.

With ``sample=k`` the loops of ``models/loops.py`` run their first ``k``
steps and their counts are scaled to the trip count, as
``hlo_analysis.py`` multiplies a while body by its ``known_trip_count``.
The stack of a sampled loop's per-step tensors is one allocation of the
full stack, its bytes those of the full stack, and the peak at it counts
the skipped steps' tensors as alive, as they are where every step runs.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
import torch._dynamo  # noqa: F401  (see below)
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.flash_attention import flash_cost
from repro_torch.kernels.fused_adam import fused_adam_cost
from repro_torch.models import loops

# ``torch._dynamo`` is imported above, with this module, and not lazily by
# the dispatch mode's first operator: an import inside a reckoned step
# leaves the step's frames in reference cycles, so its tensors outlive
# their last use until a garbage collection, at a point that varies from
# run to run, and the simulated peak with it.
aten = torch.ops.aten

#: operators that allocate without writing a value
_ALLOCATE = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
             aten.new_empty.default, aten.new_empty_strided.default}
#: operators that overwrite their first argument without reading it
_OVERWRITE = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor, aten.zero_.default}
#: operators that read only the rows they gather from their first argument
_GATHER = {aten.index.Tensor, aten.index_select.default, aten.embedding.default,
           aten.gather.default}
#: the port's kernels, as operators
FLASH = torch.ops.repro_torch.flash_attention.default
ADAM = torch.ops.repro_torch.fused_adam.default
KERNELS = {FLASH: "flash_attention", ADAM: "fused_adam"}


def dtype_class(dtype: torch.dtype) -> str:
    """The peak a product at ``dtype`` runs against on the card:
    ``"bf16"`` for 16-bit floats (the tensor cores), ``"fp32"`` otherwise."""
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "fp32"


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes of the distinct elements ``t`` addresses (a broadcast axis
    of stride 0 is read once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class StepCost(TorchDispatchMode):
    """Counts a step's FLOPs (``flops``: dtype class -> FLOPs), bytes,
    kernel launches (``launches``) and simulated peak (``peak``, bytes)
    while it is entered; ``sample > 0`` samples the same-shape loops."""

    def __init__(self, sample: int = 0):
        super().__init__()
        self.sample = sample
        self.flops: dict = defaultdict(float)
        self.bytes = 0.0
        self.launches: dict = defaultdict(float)
        self.dispatched = 0  # operators this run dispatched
        self.live = 0
        self.peak = 0
        self._owned: set = set()
        self._outer = None

    # -- the mode -----------------------------------------------------------
    def __enter__(self):
        self._outer = loops._reckoning
        if self.sample:
            loops._reckoning = self
        return super().__enter__()

    def __exit__(self, *exc):
        loops._reckoning = self._outer
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.dispatched += 1
        inputs = _tensors((args, kwargs))
        outputs = _tensors(out)
        if func in KERNELS:
            self._kernel(func, args)
        else:
            count = flop_registry.get(func.overloadpacket)
            if count is not None:
                self.flops[dtype_class(inputs[0].dtype)] += count(*args, **kwargs, out_val=out)
            if not func.is_view and func not in _ALLOCATE:
                self.bytes += self._moved(func, args, inputs, outputs)
        if not func.is_view:
            self._track(func, inputs, outputs)
        return out

    def _kernel(self, func, args) -> None:
        if func is FLASH:
            q, k, _, causal, _ = args
            b, h, tq, d = q.shape
            cost = flash_cost(b, h, k.shape[1], tq, k.shape[2], d, causal, q.element_size())
            self.flops[dtype_class(q.dtype)] += cost["flop"]
            self.launches[KERNELS[func]] += 1
        else:
            cost = fused_adam_cost([p.numel() for p in args[0]])
            self.launches[KERNELS[func]] += cost["launches"]
        self.bytes += cost["bytes"]

    @staticmethod
    def _moved(func, args, inputs, outputs) -> int:
        written = sum(tensor_bytes(t) for t in outputs)
        if func in _GATHER:
            return 2 * written + sum(tensor_bytes(t) for t in inputs[1:])
        if func in _OVERWRITE:
            inputs = inputs[1:]
        return sum(tensor_bytes(t) for t in inputs) + written

    # -- the simulated peak -------------------------------------------------
    def _track(self, func, inputs, outputs) -> None:
        """Count each output storage the operator made. A view's outputs
        are never new; an operator whose schema lets an output alias an
        input (in place, ``out=``) made only those that no input holds."""
        aliasing = any(r.alias_info is not None for r in func._schema.returns)
        seen = {t.untyped_storage()._cdata for t in inputs} if aliasing else set()
        for t in outputs:
            storage = t.untyped_storage()
            key = storage._cdata
            if key in seen or key in self._owned:
                continue
            seen.add(key)
            nbytes = storage.nbytes()
            self._owned.add(key)
            self.live += nbytes
            self.peak = max(self.peak, self.live)
            weakref.finalize(storage, self._free, key, nbytes)

    def _free(self, key, nbytes) -> None:
        self._owned.discard(key)
        self.live -= nbytes

    # -- sampled loops ------------------------------------------------------
    def _counts(self) -> tuple:
        return dict(self.flops), self.bytes, dict(self.launches)

    def sampled_steps(self, n: int):
        """``loops.steps``' indices: the first ``sample`` of ``n``, their
        counts then scaled to all ``n``."""
        k = min(self.sample, n)
        before = self._counts()
        yield from range(k)
        if k == n:
            return
        flops, nbytes, launches = self._counts()
        scale = (n - k) / k
        for c, v in flops.items():
            self.flops[c] += (v - before[0].get(c, 0.0)) * scale
        for c, v in launches.items():
            self.launches[c] += (v - before[2].get(c, 0.0)) * scale
        self.bytes += (nbytes - before[1]) * scale

    def stack_sampled(self, items: list, n: int, dim: int) -> torch.Tensor:
        """``loops.stack`` of a sampled loop: the ``n``-step stack as one
        allocation, moving the bytes ``torch.stack`` of ``n`` items moves;
        the peak at it holds the ``n - len(items)`` skipped items too."""
        last = items[-1]
        shape = list(last.shape)
        shape.insert(dim % (last.dim() + 1), n)
        item = tensor_bytes(last)
        self.peak = max(self.peak, self.live + (n - len(items)) * item + n * item)
        out = torch.empty(shape, dtype=last.dtype, device=last.device)
        self.bytes += 2 * n * item
        return out

    def total_flops(self) -> float:
        return float(sum(self.flops.values()))


def reckon(step, *args, sample: int = 1, **kwargs) -> tuple:
    """``step(*args, **kwargs)`` under a fresh ``StepCost``; returns
    ``(its output, the StepCost)``. The output is dropped by the caller
    when it wants the peak of the step alone."""
    cost = StepCost(sample=sample)
    with cost:
        out = step(*args, **kwargs)
    return out, cost

