"""PyTorch/CUDA port of the SEM-O-RAN reproduction (``src/repro``).

The JAX package is the reference; this package mirrors its layout module for
module, imports neither ``jax`` nor ``repro``, and runs its entry points on
the card (``device="cuda"``) unless the caller asks for the CPU. Every TPU
kernel of the ported path is a hand-written CUDA kernel for Hopper under
``kernels/csrc`` with a plain PyTorch version beside it.
"""
