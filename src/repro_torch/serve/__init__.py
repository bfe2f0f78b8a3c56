"""Serving substrate: batched prefill/decode engine + continuous batching
(twin of ``repro.serve``; ``ServeTenant`` comes with the fabric)."""
from repro_torch.serve.engine import (
    ServeConfig, ServeEngine, build_ragged_step, build_serve_step,
)
__all__ = ["ServeConfig", "ServeEngine", "build_ragged_step",
           "build_serve_step"]
