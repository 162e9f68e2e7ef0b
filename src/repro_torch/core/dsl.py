"""Morphling DSL front-end — paper Listing 1 on PyTorch.

Counterpart of ``repro/core/dsl.py``. The paper's program::

    gnn.load(g, Dataset);
    gnn.initializeLayers(neuronsPerLayer, "xaviers");
    for epoch { forwardPass; backPropagation; gnn.optimizer("adam", 0.01, 0.9, 0.999); }

maps here to::

    gnn = GNNProgram.load(dataset, arch="GCN", aggregation="gcn")
    gnn.initialize_layers([in, 256, 256, n_classes], "xavier", seed=0)
    gnn.set_optimizer("adam", 0.01, 0.9, 0.999)
    prog = gnn.compile(engine="cuda", fused_optimizer=True)
    for epoch in range(E): metrics = prog.train_epoch()

``compile()`` runs the lowering pass (``core/lowering.py:lower``): the
Algorithm-1 engine decides a dense/sparse path per layer, binds each
decision to a registry primitive and builds the sparse operands on the
card, once. ``prog.plan`` is the synthesized program, inspectable. An
epoch runs eagerly: forward, backward and the optimizer, with no read
back from the card but the loss the caller asks for.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.lowering import ModelPlan, lower
from repro_torch.core.sparsity import PAPER_GAMMA_DEFAULT, SparsityDecision
from repro_torch.graph.csr import CSRGraph
from repro_torch.models.gnn import GNNConfig, GNNModel, init_params, params_from_jax
from repro_torch.training.optimizer import Optimizer, get_optimizer
from repro_torch.training.trainer import train_step


@dataclasses.dataclass
class CompiledProgram:
    """The synthesized training program: its plan, model, parameters and
    optimizer state, and the data on the plan's device."""

    model: GNNModel
    params: dict
    opt: Optimizer
    opt_state: object
    x: torch.Tensor
    labels: torch.Tensor
    train_mask: torch.Tensor
    plan: ModelPlan
    _epoch: int = 0

    @property
    def sparsity_decision(self) -> SparsityDecision:
        """Layer 0's Alg-1 decision."""
        return self.plan.input_decision

    def describe_plan(self) -> str:
        return self.plan.describe()

    def train_epoch(self) -> dict:
        self.params, self.opt_state, loss = train_step(
            self.model, self.opt, self.params, self.opt_state, self.x,
            self.labels, self.train_mask)
        self._epoch += 1
        return {"epoch": self._epoch, "loss": float(loss)}

    def accuracy(self) -> float:
        return float(self.model.accuracy(self.params, self.x, self.labels,
                                         self.train_mask))


class GNNProgram:
    """Listing-1 front-end object. Methods mirror the DSL's gnn.* calls."""

    def __init__(self, graph: CSRGraph, features: np.ndarray,
                 labels: np.ndarray, train_mask: np.ndarray, n_classes: int,
                 arch: str = "GCN", aggregation: str = "gcn",
                 gat_heads: int = 4):
        self.graph = graph
        self.features = np.asarray(features, dtype=np.float32)
        self.labels = np.asarray(labels)
        self.train_mask = np.asarray(train_mask)
        self.n_classes = int(n_classes)
        self.arch = arch
        self.aggregation = aggregation
        self.gat_heads = int(gat_heads)
        self._layer_dims: Optional[Sequence[int]] = None
        self._seed = 0
        self._opt_spec = ("adam", 0.01, 0.9, 0.999)
        self._opt_kw: dict = {}
        self.gamma = PAPER_GAMMA_DEFAULT

    # -- gnn.load -----------------------------------------------------------
    @classmethod
    def load(cls, dataset, arch: str = "GCN", aggregation: str = "gcn",
             gat_heads: int = 4) -> "GNNProgram":
        return cls(
            graph=dataset.graph, features=dataset.features,
            labels=dataset.labels, train_mask=dataset.train_mask,
            n_classes=dataset.n_classes, arch=arch, aggregation=aggregation,
            gat_heads=gat_heads,
        )

    # -- gnn.initializeLayers -------------------------------------------------
    def initialize_layers(self, neurons_per_layer: Sequence[int],
                          init: str = "xavier", seed: int = 0):
        if init not in ("xavier", "xaviers"):
            raise ValueError("only xavier init is supported (as in the paper)")
        dims = list(neurons_per_layer)
        if dims[0] != self.features.shape[1]:
            dims = [self.features.shape[1], *dims]
        if dims[-1] != self.n_classes:
            dims = [*dims, self.n_classes]
        self._layer_dims = dims
        self._seed = seed
        return self

    # -- gnn.optimizer --------------------------------------------------------
    def set_optimizer(self, name: str, lr: float, *args, **kw):
        self._opt_spec = (name, lr, *args)
        self._opt_kw = kw
        return self

    # -- synthesis ------------------------------------------------------------
    def compile(self, engine: Optional[str] = None, device=None,
                use_fused: bool = True, fused_optimizer: bool = False,
                layout: "str | None" = None,
                fuse_attention: bool = True,
                params: Optional[dict] = None) -> CompiledProgram:
        """Lower the spec to per-layer plans with operands on ``device``.

        ``engine`` names a registered backend (``"cuda" | "torch" |
        "gather"``; ``None`` is ``cuda``); ``device`` is CUDA unless asked
        (``"cpu"`` runs the plain versions, as the tests do).
        ``fused_optimizer=True`` runs Adam through the fused kernel.
        ``layout`` takes ``None | "none" | "degree" | "rcm"``.
        ``fuse_attention=False`` keeps GAT / GT on the segment-softmax
        gather path instead of the fused BSR attention. ``params``
        takes the JAX package's parameters as a numpy tree
        (``params_from_jax``), so one set of weights drives both packages;
        without it, Xavier weights are drawn from the program's seed.
        """
        if self._layer_dims is None:
            raise RuntimeError("call initialize_layers first")
        dev = resolve_device(device)
        config = GNNConfig(kind=self.arch, layer_dims=self._layer_dims,
                           aggregation=self.aggregation.lower(),
                           gat_heads=self.gat_heads)
        # Alg 1 Phase 1, per layer: runtime analysis & lowering
        plan = lower(config, self.graph, self.features, gamma=self.gamma,
                     engine=engine, use_fused=use_fused, layout=layout,
                     fuse_attention=fuse_attention, device=dev)
        model = GNNModel(config, self.graph, use_fused=use_fused, plan=plan)
        if params is None:
            p = init_params(config, torch.Generator().manual_seed(self._seed),
                            dev)
        else:
            p = params_from_jax(params, dev)
        name, lr, *rest = self._opt_spec
        opt = get_optimizer(name, lr, *rest, fused=fused_optimizer,
                            **self._opt_kw)
        return CompiledProgram(
            model=model, params=p, opt=opt, opt_state=opt.init(p),
            x=torch.from_numpy(self.features).to(dev),
            labels=torch.from_numpy(self.labels).to(dev),
            train_mask=torch.from_numpy(self.train_mask.astype(bool)).to(dev),
            plan=plan,
        )
