"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Port of ``src/repro/kernels/__init__.py``. Where the reference resolves
``interpret=None`` from the JAX backend (compiled Pallas on a TPU, the
interpreter elsewhere), the port resolves from the TENSOR: a wrapper launches
its CUDA kernel for a CUDA tensor and computes its plain PyTorch version for
a CPU tensor — never one in place of the other. Kernels are compiled from
``csrc/`` by ``_build.py`` at first use.
"""

from __future__ import annotations

import torch

__all__ = ["available", "resolve_device"]


def resolve_device(device) -> torch.device:
    """The explicit device an entry point runs on; raises when it names CUDA
    and no card is visible (an entry point never carries on on the CPU by
    itself — the caller asks for ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def available() -> bool:
    """True when a CUDA card is visible and ``nvcc`` can build the kernels."""
    from . import _build
    return torch.cuda.is_available() and _build.find_nvcc() is not None
