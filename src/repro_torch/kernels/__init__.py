"""Hopper kernels (CUDA C++ under ``csrc/``), their plain PyTorch versions
(``ref.py``) and differentiable wrappers (``ops.py``)."""
