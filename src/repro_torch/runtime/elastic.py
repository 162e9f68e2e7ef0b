"""Elastic scaling: resume training on a different rank count.

Counterpart of ``repro/runtime/elastic.py``. The checkpoint format stores
unsharded host arrays and a structural manifest (``runtime/checkpoint.py``),
so elasticity reduces to restoring the same tree and re-partitioning the
graph for the new rank count with the hierarchical partitioner — the step
the paper's static METIS pipeline cannot do cheaply, but Phase III
(O(|V| log |V|) greedy) can. The new group itself is the caller's
(``runtime.resilience.ResilientDistributedTrainer`` spawns it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.partitioner import PartitionResult, hierarchical_partition
from repro_torch.graph.csr import CSRGraph
from repro_torch.runtime.checkpoint import restore_checkpoint


@dataclasses.dataclass
class ElasticPlan:
    old_ranks: Optional[int]
    new_ranks: int
    partition: PartitionResult
    restored_step: Optional[int]


def rescale(
    ckpt_dir: str,
    graph: CSRGraph,
    new_ranks: int,
    target_state: object,
    old_ranks: Optional[int] = None,
    partition_seed: int = 0,
) -> tuple[object, ElasticPlan]:
    """Resume from ``ckpt_dir`` onto ``new_ranks`` ranks.

    Model/optimizer state is topology-independent (saved unsharded); only
    the graph partition is recomputed. Returns (state, plan): ``state``
    shaped like ``target_state`` (its tensors on the target leaves'
    devices), ``target_state`` itself where no checkpoint exists.
    """
    state, step = restore_checkpoint(ckpt_dir, target_state)
    part = hierarchical_partition(graph, max(new_ranks, 1), seed=partition_seed)
    return state, ElasticPlan(
        old_ranks=old_ranks, new_ranks=new_ranks, partition=part, restored_step=step
    )
