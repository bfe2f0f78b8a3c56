"""The model path of the port: the dense GQA transformer, the MoE family
(with GQA, or with DeepSeek-V2's MLA attention), the Mamba-1 SSM, the
Mamba-2 hybrid with Zamba2's shared attention block, and the stub modality
frontends (PaliGemma's vision prefix, MusicGen's audio tokens) — twin of
``repro.models``, with ``loss_fn`` for training (``repro_torch.train``)."""

from repro_torch.models.config import (
    FrontendConfig, HybridConfig, MLAConfig, MoEConfig, ModelConfig, SSMConfig,
    reduced,
)
from repro_torch.models.model import (
    CallConfig, Transformer, decode_step, decode_step_ragged, forward,
    init_cache, init_params, loss_fn, prefill,
)
from repro_torch.models.registry import ARCHS, count_params, get

__all__ = [
    "ARCHS", "CallConfig", "FrontendConfig", "HybridConfig", "MLAConfig",
    "MoEConfig", "ModelConfig", "SSMConfig", "Transformer", "count_params",
    "decode_step", "decode_step_ragged", "forward", "get", "init_cache",
    "init_params", "loss_fn", "prefill", "reduced",
]
