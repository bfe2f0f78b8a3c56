"""Serving substrate: batched prefill/decode engine, continuous batching
and the lease-holding fabric tenant (twin of ``repro.serve``)."""
from repro_torch.serve.engine import (
    ServeConfig, ServeEngine, ServeTenant, build_ragged_step,
    build_serve_step,
)
__all__ = ["ServeConfig", "ServeEngine", "ServeTenant", "build_ragged_step",
           "build_serve_step"]
