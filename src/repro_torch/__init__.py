"""Morphling on PyTorch and CUDA for NVIDIA Hopper (H100).

The port of ``repro`` (JAX/Pallas on TPU), module for module. It imports
no JAX and nothing of ``repro``: host code it shares with the JAX package
is copied, so the JAX package stays the untouched reference its tests
compare against. Every Pallas kernel on a ported path is a CUDA C++
kernel written for ``sm_90a`` (``kernels/csrc/``), beside a plain PyTorch
version that runs for CPU tensors.

Precision: float32 everywhere, as in the JAX package. Importing the
package turns TF32 off for matmuls and cuDNN, so the dense X·W products
(``torch.matmul``) run in full float32 on the card as XLA ran them.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. With no card, CUDA raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
