"""Architecture registry: the 10 assigned configurations, exactly as listed
(twin of ``repro.models.registry``; the configurations are data and are the
reference's, field for field).

``count_params`` counts from the port's own ``init_params`` on the ``meta``
device (shapes only, nothing allocated) in place of ``jax.eval_shape``.
The port builds every family listed here, the stub frontends of
paligemma-3b and musicgen-large included (they hold no weights).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.models.config import (
    FrontendConfig,
    HybridConfig,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SSMConfig,
)

ARCHS: Dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


PHI3_MEDIUM = _register(ModelConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
    d_ff=17920, vocab_size=100352,
))

QWEN15_110B = _register(ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=49152, vocab_size=152064, qkv_bias=True,
))

SMOLLM_360M = _register(ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab_size=49152, tie_embeddings=True,
))

YI_9B = _register(ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab_size=64000,
))

LLAMA4_SCOUT = _register(ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192, n_shared=1),
))

DEEPSEEK_V2_LITE = _register(ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
))

PALIGEMMA_3B = _register(ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=257216,
    act="gelu", embed_scale=True, tie_embeddings=True,
    frontend=FrontendConfig(kind="vision_stub", n_prefix_tokens=256),
))

ZAMBA2_27B = _register(ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    ssm=SSMConfig(version=2, d_state=64, headdim=64),
    hybrid=HybridConfig(period=6, shared_attn_heads=32, shared_attn_kv_heads=32),
))

MUSICGEN_LARGE = _register(ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    pos_embedding="sinusoidal",
    frontend=FrontendConfig(kind="audio_stub"),
))

FALCON_MAMBA_7B = _register(ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=65024,
    ssm=SSMConfig(version=1, d_state=16, expand=2),
))


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


# --- analytic parameter counting (no allocation: init on the meta device) -------


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    from repro_torch.models.model import init_params   # avoid cycle
    model = init_params(cfg, device="meta")
    total = 0
    for name, p in model.named_parameters():
        n = p.numel()
        if active_only and cfg.moe is not None and ".experts." in name:
            n = n * cfg.moe.top_k // cfg.moe.n_experts
        total += n
    return total
