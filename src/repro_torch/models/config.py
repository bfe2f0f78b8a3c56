"""Model configuration schema covering every assigned architecture family.

One frozen dataclass tree describes dense transformers (GQA/RoPE/SwiGLU,
optional QKV bias), MLA attention (DeepSeek-V2), MoE blocks (shared + routed
experts, top-k), Mamba-1 selective SSM, Mamba-2 SSD hybrids with a shared
attention block (Zamba2), and stub multimodal frontends (PaliGemma SigLIP
patches, MusicGen EnCodec tokens).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int                 # routed experts
    top_k: int
    d_ff_expert: int               # per-expert FFN width
    n_shared: int = 0              # always-on shared experts
    router_noise: float = 0.0      # jitter for load balancing (train only)
    aux_loss_coef: float = 0.01    # load-balancing auxiliary loss
    # port only: layers i < first_dense are dense (a gated MLP of the
    # model's d_ff), as DeepSeek-V2's ``first_k_dense_replace``
    first_dense: int = 0
    # port only: False keeps the softmax's top-k probabilities as they are
    # (DeepSeek-V2's ``norm_topk_prob``); True renormalises them to sum 1
    norm_topk: bool = True


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int              # compressed KV dim (the MLA cache)
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """YaRN's rotary scaling as DeepSeek-V2 publishes it (``rope_scaling``
    of its ``config.json``): the rotary frequencies blend the original and
    the ``factor``-interpolated ones over a ramp between the dims that
    ``beta_fast`` and ``beta_slow`` turns fit into
    ``original_max_position_embeddings``, and the softmax scale gains
    ``m(factor, mscale_all_dim)²`` (``layers.yarn_*``).  Port only."""

    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0
    type: str = "yarn"

    def __post_init__(self):
        if self.type != "yarn":
            raise ValueError(f"rope_scaling type {self.type!r}: the port "
                             "builds 'yarn' only")


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    version: int                   # 1 = Mamba-1 (S6), 2 = Mamba-2 (SSD)
    d_state: int
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64              # Mamba-2 only
    chunk: int = 256               # chunked-scan block length
    dt_rank: int = 0               # Mamba-1: 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: one *shared* attention block applied every `period`
    SSM layers (weights reused at every application)."""

    period: int = 6
    shared_attn_heads: int = 32
    shared_attn_kv_heads: int = 32


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Stub modality frontend: input_specs() provides precomputed embeddings."""

    kind: str                      # "vision_stub" | "audio_stub"
    n_prefix_tokens: int = 0       # vision: patch tokens prepended (prefix-LM)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | vlm | hybrid | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int                   # 0 for attention-free (ssm)
    n_kv_heads: int
    d_ff: int                      # 0 for pure-ssm blocks
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    pos_embedding: str = "rope"    # "rope" | "sinusoidal" (musicgen)
    act: str = "silu"              # "silu" (SwiGLU) | "gelu" (GeGLU, gemma)
    embed_scale: bool = False      # gemma multiplies embeddings by sqrt(d)
    logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    frontend: Optional[FrontendConfig] = None
    # port only: YaRN frequencies and softmax factor (MLA's rope dims)
    rope_scaling: Optional[RopeScaling] = None
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        for name, kind in _NESTED.items():
            value = getattr(self, name)
            if isinstance(value, Mapping):
                object.__setattr__(self, name, _coerce(kind, value, name))
        if self.n_heads and self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family not in ("dense", "moe", "vlm", "hybrid", "audio", "ssm"):
            raise ValueError(f"unknown family {self.family!r}")
        if self.n_heads and self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads (GQA)")

    # ---- derived sizes -------------------------------------------------------

    @property
    def q_dim(self) -> int:
        if self.mla:
            return self.n_heads * (
                self.mla.qk_nope_head_dim + self.mla.qk_rope_head_dim
            )
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        if self.mla:
            return self.mla.kv_lora_rank + self.mla.qk_rope_head_dim
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k-token contexts (state-based decode)?"""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (drives roofline MODEL_FLOPS = 6·N·D)."""
        from repro_torch.models.registry import count_params  # avoid cycle
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.registry import count_params
        return count_params(self, active_only=True)


#: the nested parts a configuration file may give as plain mappings
_NESTED = {"moe": MoEConfig, "mla": MLAConfig, "ssm": SSMConfig,
           "hybrid": HybridConfig, "frontend": FrontendConfig,
           "rope_scaling": RopeScaling}


def _coerce(kind: type, value: Mapping[str, Any], name: str):
    """``value``'s keys as ``kind``; a key ``kind`` lacks raises."""
    names = {f.name for f in dataclasses.fields(kind)}
    unknown = sorted(set(value) - names)
    if unknown:
        raise ValueError(f"{name}: unknown keys {unknown} for "
                         f"{kind.__name__}")
    return kind(**value)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized sibling of the same family (tests/per-arch smoke)."""
    base = dict(
        n_layers=min(cfg.n_layers, 2 if not cfg.hybrid else cfg.hybrid.period + 1),
        d_model=128,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=32 if cfg.n_heads else 0,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
    )
    if cfg.moe:
        base["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=64,
            n_shared=min(cfg.moe.n_shared, 1),
        )
    if cfg.mla:
        base["mla"] = MLAConfig(
            kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16,
            v_head_dim=32,
        )
    if cfg.ssm:
        base["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=8, headdim=16, chunk=16,
        )
    if cfg.hybrid:
        base["hybrid"] = HybridConfig(
            period=2, shared_attn_heads=4, shared_attn_kv_heads=2
        )
        base["n_layers"] = 4
    if cfg.frontend:
        base["frontend"] = dataclasses.replace(cfg.frontend, n_prefix_tokens=8)
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-reduced", **base)
