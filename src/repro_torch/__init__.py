"""PyTorch/CUDA port of the offload reproduction.

``repro_torch`` mirrors ``repro``'s layout (``core``, ``analysis``,
``kernels``, ``models``, ``serve``, ``data``, ``launch``) and names, runs
on an NVIDIA Hopper card, and imports neither JAX nor ``repro``.  The
offload runtime (``repro_torch.core.offload``) maps the paper's
accelerator clusters onto rows of cluster-major tensors on one device;
phase F of AXPY, Matmul, ATAX and Covariance runs through the hand-written
CUDA kernels of ``repro_torch.kernels``.  The serve engine
(``repro_torch.serve``) runs the dense models of ``repro_torch.models`` on
one device, with prefill attention in the hand-written flash-attention
kernel.
"""
