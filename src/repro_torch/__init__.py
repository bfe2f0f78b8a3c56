"""PyTorch/CUDA port of the offload reproduction.

``repro_torch`` mirrors ``repro``'s layout (``core``, ``analysis``,
``kernels``) and names, runs on an NVIDIA Hopper card, and imports neither
JAX nor ``repro``.  The offload runtime (``repro_torch.core.offload``)
maps the paper's accelerator clusters onto rows of cluster-major tensors
on one device; phase F of AXPY, Matmul, ATAX and Covariance runs through
the hand-written CUDA kernels of ``repro_torch.kernels``.
"""
