"""Alg 1, aggregation weighting, the layout stage and the sampled lowering."""
from repro_torch.core.layout import LayoutPlan, cached_layout, plan_layout
from repro_torch.core.sparsity import (
    SparsityDecision,
    calibrate_gamma,
    decide_execution_path,
    efficiency_ratio_threshold,
    feature_sparsity,
)
