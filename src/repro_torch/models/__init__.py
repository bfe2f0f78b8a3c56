"""The model path of the port: the dense GQA transformer and the Mamba-1
SSM (twin of ``repro.models``, restricted to what is ported; ``loss_fn``
comes with training, the other families with ROADMAP.md Queue 1 item
12)."""

from repro_torch.models.config import (
    FrontendConfig, HybridConfig, MLAConfig, MoEConfig, ModelConfig, SSMConfig,
    reduced,
)
from repro_torch.models.model import (
    CallConfig, Transformer, decode_step, decode_step_ragged, forward,
    init_cache, init_params, prefill,
)
from repro_torch.models.registry import ARCHS, count_params, get

__all__ = [
    "ARCHS", "CallConfig", "FrontendConfig", "HybridConfig", "MLAConfig",
    "MoEConfig", "ModelConfig", "SSMConfig", "Transformer", "count_params",
    "decode_step", "decode_step_ragged", "forward", "get", "init_cache",
    "init_params", "prefill", "reduced",
]
