"""Alg 1, aggregation weighting, layout orders and the sampled lowering."""
