"""Model assembly: init / forward / prefill / decode — twin of
``repro.models.model`` for every family of the registry: the dense, the
MoE (with GQA or with DeepSeek-V2's MLA attention), the SSM (Mamba-1), the
hybrid (Mamba-2 + Zamba2's shared attention block) and the two stub
modality frontends (PaliGemma's vision prefix, MusicGen's audio tokens).

The model is an ``nn.Module`` (:class:`Transformer`): the embedding, an
``nn.ModuleList`` of layers (a decoder layer — GQA or MLA attention, a
gated MLP or an MoE block — a Mamba-1 layer for the ``ssm`` family or a
Mamba-2 layer for the ``hybrid`` one), the hybrid's one ``shared_block``,
the final norm and the LM head.  Its parameter names follow the
reference's tree with the layer index put in (``layers/attn/wq`` stacked
over L becomes ``layers.<i>.attn.wq``, ``layers/moe/experts/wi`` becomes
``layers.<i>.moe.experts.wi``, ``layers/mixer/A_log`` becomes
``layers.<i>.mixer.A_log``; ``shared_block/attn/wq`` is not stacked and
stays ``shared_block.attn.wq``), so ``convert.model_params_from_numpy``
maps one onto the other.  A port-only ``MoEConfig.first_dense`` makes the
first layers dense (DeepSeek-V2's ``first_k_dense_replace``:
``layers.0.mlp.*`` beside ``layers.<i>.moe.*``), which no stacked tree
holds, so the converter refuses it.  The
reference's ``lax.scan`` over the stacked layers is a loop over the
``ModuleList``, and its ``lax.cond`` on the layer index (the shared block
after every ``period``-th layer) a Python test on the loop's index; every
entry point is a function of (model, tensors), with the device taken from
the model.

The frontends are stubs, as in the reference, and hold no weights: the
vision stub (``vlm``, PaliGemma) takes precomputed patch embeddings
``batch["patches"]`` (B, P, d_model) and puts them before the token
embeddings, attended bidirectionally (the prefix-LM mask); the audio stub
(``audio``, MusicGen) is a decoder over codec tokens with sinusoidal
positions and adds nothing to the embedding.  A configuration that mixes
families the reference never combines (a frontend or MoE layers on the
state-space families) raises :class:`NotImplementedError`.
Of the reference's ``CallConfig`` fields, the sharding knobs
(``residual_spec``, ``attn_q_sharding``, ``moe_buffer_sharding``) are not
ported: they constrain how XLA lays arrays out over a device mesh, and one
card lays nothing out.  ``remat`` recomputes each layer in the backward
pass (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` with
nothing saveable), so a training step keeps the layers' inputs only;
``attn_chunk_remat`` recomputes each chunk of the chunked attention in the
backward pass as well (a checkpoint nested in the layer's), so the layer's
recomputed backward keeps the chunks' carries, not their score tiles.

:func:`loss_fn` is the reference's next-token cross entropy.  The kernels
have no backward: under autograd a kernel wrapper raises, so a training
call runs the plain attention and scan (``repro_torch.train``'s default
``CallConfig``), as the reference's trains through its XLA paths.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    dense_init_,
    gated_mlp,
    rms_norm,
    sinusoidal_positions,
    softcap,
)

Cache = Dict[str, Any]

#: what the port builds, and why a mix of families is refused
_MIXED = "the reference never combines these parts"
_BUILDS = ("the port builds every family of the registry: dense, moe (GQA "
           "or MLA), ssm, hybrid, and the vlm and audio frontends on "
           "decoder layers")
_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def require_ported(cfg: ModelConfig) -> None:
    """Raise for a configuration that mixes families the port does not
    combine: the state-space families (``ssm``, ``hybrid``) take no MoE,
    MLA or frontend part, only the ``hybrid`` family a shared block, and
    each its own Mamba version."""
    parts: Tuple[Tuple[str, Any], ...] = ()
    if cfg.family in ("ssm", "hybrid"):
        parts += (("moe", cfg.moe), ("mla", cfg.mla),
                  ("frontend", cfg.frontend))
    if cfg.family != "hybrid":
        parts += (("hybrid", cfg.hybrid),)
    version = {"ssm": 1, "hybrid": 2}.get(cfg.family)
    if version is None:
        parts += (("ssm", cfg.ssm),)
    elif cfg.ssm is None or cfg.ssm.version != version:
        parts += ((f"{cfg.family} family without Mamba-{version} layers",
                   True),)
    elif cfg.family == "hybrid" and cfg.hybrid is None:
        parts += (("hybrid family without its shared block", True),)
    for what, present in parts:
        if present is not None:
            raise NotImplementedError(
                f"{cfg.name}: the {what} part of a {cfg.family} model is not "
                f"ported; {_BUILDS} ({_MIXED})")
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported; {_BUILDS}")


def prefix_tokens(cfg: ModelConfig) -> int:
    """The positions the vision stub's patches take before the prompt
    (``frontend.n_prefix_tokens``; 0 for every other model): a cache for
    a prompt of S tokens needs P + S positions before the first decode
    step."""
    fe = cfg.frontend
    return fe.n_prefix_tokens if fe and fe.kind == "vision_stub" else 0


def shared_config(cfg: ModelConfig) -> ModelConfig:
    """The hybrid's shared attention block as a config of its own (the
    reference's ``shared_cfg``): its heads, its KV heads, head dim
    d_model // heads, no QKV bias."""
    hb = cfg.hybrid
    return dataclasses.replace(
        cfg, n_heads=hb.shared_attn_heads, n_kv_heads=hb.shared_attn_kv_heads,
        head_dim=cfg.d_model // hb.shared_attn_heads, qkv_bias=False)


@dataclasses.dataclass(frozen=True)
class CallConfig:
    """Per-call knobs owned by the launcher, not the architecture."""

    attn_impl: str = "auto"         # "plain" | "chunked" | "kernel" | "auto"
    attn_chunk: int = 512
    ssm_impl: str = "auto"          # "plain" | "kernel" | "auto" (SSM scan)
    # recompute each layer's activations in the backward pass (forward
    # under autograd only; the reference's ``jax.checkpoint``)
    remat: bool = True
    moe_no_drop: bool = False       # exact MoE routing (serving / eval)
    attn_chunk_remat: bool = False  # recompute chunk bodies in backward
    # one compute-dtype copy of every f32 layer weight per call (the MoE
    # router too, as in the reference).  Off by default: at full width a
    # copy costs half the weights again (deepseek-v2-lite-16b's 64.84 GB
    # of f32 would add 32.4 GB of bf16, more than one 80 GB card has left).
    # A serving engine on the card narrows its weights once instead
    # (``narrow_serving_weights``); this copy leaves those leaves as they are
    cast_params_once: bool = False


# =============================================================================
# The module
# =============================================================================


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, hq = cfg.d_model, cfg.n_heads * cfg.head_dim
        hkv = cfg.n_kv_heads * cfg.head_dim
        self.wq = _param((d, hq), dtype, device)
        self.wk = _param((d, hkv), dtype, device)
        self.wv = _param((d, hkv), dtype, device)
        self.wo = _param((hq, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = _param((hq,), dtype, device)
            self.bk = _param((hkv,), dtype, device)
            self.bv = _param((hkv,), dtype, device)


class MLP(nn.Module):
    def __init__(self, d: int, f: int, dtype, device):
        super().__init__()
        self.wi = _param((d, f), dtype, device)
        self.wg = _param((d, f), dtype, device)
        self.wo = _param((f, d), dtype, device)


class MLAAttention(nn.Module):
    """DeepSeek-V2's multi-head latent attention, under the reference's
    names: ``wq`` to H heads of nope + rope, ``wdkv`` to the compressed
    KV (rank) and the shared rotary key (rope), ``kv_norm`` over the
    rank, ``wuk``/``wuv`` up from the rank to H heads of nope/v, ``wo``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        self.wq = _param((d, h * qk), dtype, device)
        self.wdkv = _param((d, m.kv_lora_rank + m.qk_rope_head_dim), dtype,
                           device)
        self.kv_norm = _param((m.kv_lora_rank,), dtype, device)
        self.wuk = _param((m.kv_lora_rank, h * m.qk_nope_head_dim), dtype,
                          device)
        self.wuv = _param((m.kv_lora_rank, h * m.v_head_dim), dtype, device)
        self.wo = _param((h * m.v_head_dim, d), dtype, device)


class Experts(nn.Module):
    """The routed experts stacked on a leading E axis: ``wi``/``wg`` (E,
    d, fe), ``wo`` (E, fe, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        e, d, fe = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
        self.wi = _param((e, d, fe), dtype, device)
        self.wg = _param((e, d, fe), dtype, device)
        self.wo = _param((e, fe, d), dtype, device)


class MoE(nn.Module):
    """One layer's MoE block: the ``router`` (d, E), float32 whatever the
    parameter dtype, as in the reference; the ``experts``; and, with
    ``n_shared``, the always-on ``shared`` experts as one gated MLP of
    width n_shared · fe."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        m = cfg.moe
        self.router = _param((cfg.d_model, m.n_experts), torch.float32,
                             device)
        self.experts = Experts(cfg, dtype, device)
        if m.n_shared:
            self.shared = MLP(cfg.d_model, m.n_shared * m.d_ff_expert, dtype,
                              device)


def moe_layer(cfg: ModelConfig, i: int) -> bool:
    """Whether decoder layer ``i`` holds an MoE block: every layer of an
    MoE model from ``moe.first_dense`` on (the ones before are dense)."""
    return cfg.moe is not None and i >= cfg.moe.first_dense


class DecoderLayer(nn.Module):
    """A decoder layer: ``ln1``, GQA (``Attention``) or MLA
    (``MLAAttention``) attention, ``ln2``, and a gated MLP (``mlp``, of
    width ``d_ff``) or an MoE block (``moe``), as :func:`moe_layer` says
    for layer ``index``."""

    def __init__(self, cfg: ModelConfig, dtype, device, index: int = 0):
        super().__init__()
        self.ln1 = _param((cfg.d_model,), dtype, device)
        self.ln2 = _param((cfg.d_model,), dtype, device)
        self.attn = (MLAAttention if cfg.mla else Attention)(cfg, dtype,
                                                             device)
        if moe_layer(cfg, index):
            self.moe = MoE(cfg, dtype, device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)


class Mamba1Mixer(nn.Module):
    """One Mamba-1 (S6) mixer's weights, under the reference's names."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        s = cfg.ssm
        din, d, n = cfg.d_inner, cfg.d_model, s.d_state
        r = s.dt_rank or -(-d // 16)
        self.in_proj = _param((d, 2 * din), dtype, device)
        self.conv_w = _param((din, s.d_conv), dtype, device)
        self.conv_b = _param((din,), dtype, device)
        self.x_proj = _param((din, r + 2 * n), dtype, device)
        self.dt_proj = _param((r, din), dtype, device)
        self.dt_bias = _param((din,), dtype, device)
        self.A_log = _param((din, n), dtype, device)
        self.D = _param((din,), dtype, device)
        self.out_proj = _param((din, d), dtype, device)


class Mamba2Mixer(nn.Module):
    """One Mamba-2 (SSD, groups = 1) mixer's weights, under the
    reference's names: ``in_proj`` gives z, x·B·C and dt (2·d_inner + 2N
    + H columns), the conv runs over x·B·C, and A_log, D and dt_bias are
    one scalar per head."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        s = cfg.ssm
        din, d, n = cfg.d_inner, cfg.d_model, s.d_state
        nh = din // s.headdim
        conv_dim = din + 2 * n
        self.in_proj = _param((d, 2 * din + 2 * n + nh), dtype, device)
        self.conv_w = _param((conv_dim, s.d_conv), dtype, device)
        self.conv_b = _param((conv_dim,), dtype, device)
        self.A_log = _param((nh,), dtype, device)
        self.D = _param((nh,), dtype, device)
        self.dt_bias = _param((nh,), dtype, device)
        self.norm = _param((din,), dtype, device)
        self.out_proj = _param((din, d), dtype, device)


class MambaLayer(nn.Module):
    """A Mamba layer: its norm and its mixer (Mamba-1 for the ``ssm``
    family, Mamba-2 for the ``hybrid`` one)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln = _param((cfg.d_model,), dtype, device)
        mixer = Mamba2Mixer if cfg.family == "hybrid" else Mamba1Mixer
        self.mixer = mixer(cfg, dtype, device)


class SharedBlock(nn.Module):
    """Zamba2's shared transformer block, held once and applied after
    every ``period``-th layer: ``ln1``, attention at
    :func:`shared_config`'s widths, ``ln2`` and a gated MLP."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = _param((cfg.d_model,), dtype, device)
        self.attn = Attention(shared_config(cfg), dtype, device)
        self.ln2 = _param((cfg.d_model,), dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)


def _tree(module: nn.Module, dtype: Optional[torch.dtype]
          ) -> Dict[str, Any]:
    """``module``'s weights as the reference's nested tree (a child
    module is a sub-tree: ``{"moe": {"router", "experts": {...}}}``); with
    ``dtype``, float32 leaves are cast copies."""
    out: Dict[str, Any] = {
        n: t.to(dtype) if dtype is not None and t.dtype == torch.float32
        else t for n, t in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        out[name] = _tree(child, dtype)
    return out


#: the leaves every read takes in float32: the norm gains, which
#: ``layers.rms_norm`` reads (``ln``, ``ln1``, ``ln2``, ``final_norm``,
#: MLA's ``kv_norm``, Mamba-2's ``norm``), the MoE ``router``
#: (``moe.moe_block``) and the SSM's ``A_log``, ``D`` and ``dt_bias``
#: (``ssm``).  Every other leaf is read through a cast to the compute dtype.
F32_READS = frozenset({"ln", "ln1", "ln2", "final_norm", "kv_norm", "norm",
                       "router", "A_log", "D", "dt_bias"})
#: the most :func:`narrow_serving_weights` allocates: one chunk of
#: compute-dtype values
NARROW_CHUNK_BYTES = 64 << 20


@torch.no_grad()
def narrow_serving_weights(model: nn.Module, cfg: ModelConfig) -> int:
    """Narrow ``model``'s float32 leaves to ``cfg.compute_dtype`` in their
    own storage, once, for serving.  Returns the float32 bytes narrowed.

    Each leaf outside :data:`F32_READS` gets its compute-dtype values
    written over the front half of its own bytes, front to back in chunks
    of at most :data:`NARROW_CHUNK_BYTES`.  Element k of the narrow view
    lies at byte 2k, below float32 element k, so no unread element is
    overwritten.  The parameter then points at that view: same shape,
    contiguous strides, same storage.  Every use reads the values its cast
    made before, without the cast.  A leaf that is not contiguous, or does
    not start on a 16-byte boundary, is copied (``leaf.to``) instead.
    Nothing is narrowed, and 0 returned, where the compute dtype is not a
    16-bit float or no float32 leaf is left to narrow (a second call)."""
    dt = _dtype(cfg.compute_dtype)
    if dt not in (torch.bfloat16, torch.float16):
        return 0
    chunk = NARROW_CHUNK_BYTES // dt.itemsize
    narrowed = 0
    for name, param in model.named_parameters():
        src = param.data
        if (src.dtype != torch.float32
                or name.rsplit(".", 1)[-1] in F32_READS):
            continue
        if src.is_contiguous() and src.data_ptr() % 16 == 0:
            flat = src.view(-1)
            narrow = flat.view(dt)[:flat.numel()]
            for k in range(0, flat.numel(), chunk):
                narrow[k:k + chunk].copy_(flat[k:k + chunk].to(dt))
            param.data = narrow.view(src.shape)
        else:
            param.data = src.to(dt)
        narrowed += src.numel() * src.element_size()
    return narrowed


class Transformer(nn.Module):
    """A decoder-only model at ``cfg``'s widths: a dense or MoE
    transformer (GQA or MLA attention; the ``vlm`` and ``audio`` families
    are dense transformers whose stub frontends hold no weights), a stack
    of Mamba-1 layers for the ``ssm`` family, or a stack of Mamba-2 layers
    with one shared attention block for the ``hybrid`` family."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        require_ported(cfg)
        dtype = _dtype(cfg.param_dtype)
        self.embed = _param((cfg.vocab_size, cfg.d_model), dtype, device)
        self.final_norm = _param((cfg.d_model,), dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab_size), dtype,
                                  device)
        if cfg.family in ("ssm", "hybrid"):
            layers = (MambaLayer(cfg, dtype, device)
                      for _ in range(cfg.n_layers))
        else:
            layers = (DecoderLayer(cfg, dtype, device, i)
                      for i in range(cfg.n_layers))
        self.layers = nn.ModuleList(layers)
        if cfg.family == "hybrid":
            self.shared_block = SharedBlock(cfg, dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def layer_params(self, i: int, dtype: Optional[torch.dtype] = None
                     ) -> Dict[str, Any]:
        """Layer ``i``'s weights as the reference's tree (``{"ln1", "ln2",
        "attn": {...}, "mlp": {...}}`` or ``"moe": {"router", "experts":
        {...}, "shared": {...}}``, or ``{"ln", "mixer": {...}}``); with
        ``dtype``, float32 leaves are cast copies."""
        return _tree(self.layers[i], dtype)

    def shared_params(self, dtype: Optional[torch.dtype] = None
                      ) -> Dict[str, Any]:
        """The hybrid's shared block as the reference's tree (``{"ln1",
        "ln2", "attn": {...}, "mlp": {...}}``); with ``dtype``, float32
        leaves are cast copies."""
        return _tree(self.shared_block, dtype)


def _init_mamba1_(mixer: Mamba1Mixer, g: torch.Generator) -> None:
    """The reference's ``_mamba1_params`` values: matrices drawn on their
    fan-in axes (``conv_w`` on -1), ``A_log`` = log(1…N) on every channel,
    ``dt_bias`` -4.6 (softplus⁻¹(0.01)), ``D`` ones, ``conv_b`` zeros."""
    dense_init_(mixer.in_proj, g)
    dense_init_(mixer.conv_w, g, in_axis=-1)
    mixer.conv_b.zero_()
    dense_init_(mixer.x_proj, g)
    dense_init_(mixer.dt_proj, g)
    mixer.dt_bias.fill_(-4.6)
    n = mixer.A_log.shape[-1]
    mixer.A_log.copy_(torch.log(torch.arange(
        1, n + 1, dtype=torch.float32, device=mixer.A_log.device)))
    mixer.D.fill_(1.0)
    dense_init_(mixer.out_proj, g)


def _init_mamba2_(mixer: Mamba2Mixer, g: torch.Generator) -> None:
    """The reference's ``_mamba2_params`` values: ``in_proj`` and
    ``out_proj`` drawn on their fan-in axes, ``conv_w`` on its last,
    ``A_log`` zeros (A = -1 on every head), ``D`` ones, ``dt_bias`` -4.6,
    ``norm`` ones, ``conv_b`` zeros."""
    dense_init_(mixer.in_proj, g)
    dense_init_(mixer.conv_w, g, in_axis=-1)
    mixer.conv_b.zero_()
    mixer.A_log.zero_()
    mixer.D.fill_(1.0)
    mixer.dt_bias.fill_(-4.6)
    mixer.norm.fill_(1.0)
    dense_init_(mixer.out_proj, g)


def _init_attention_(attn_mod: Attention, qkv_bias: bool,
                     g: torch.Generator) -> None:
    for name in ("wq", "wk", "wv", "wo"):
        dense_init_(getattr(attn_mod, name), g)
    if qkv_bias:
        for name in ("bq", "bk", "bv"):
            getattr(attn_mod, name).zero_()


def _init_mlp_(mlp: nn.Module, g: torch.Generator) -> None:
    for name in ("wi", "wg", "wo"):
        dense_init_(getattr(mlp, name), g)


def _init_mla_(mla: MLAAttention, g: torch.Generator) -> None:
    """The reference's ``_mla_params`` values: every matrix drawn on its
    fan-in axis, ``kv_norm`` ones."""
    for name in ("wq", "wdkv", "wuk", "wuv", "wo"):
        dense_init_(getattr(mla, name), g)
    mla.kv_norm.fill_(1.0)


def _init_moe_(moe: MoE, g: torch.Generator) -> None:
    """The reference's ``_moe_params`` values: the router and every
    expert matrix drawn on its fan-in axis (d for ``wi``/``wg``, fe for
    ``wo``), the shared experts as a gated MLP."""
    dense_init_(moe.router, g)
    _init_mlp_(moe.experts, g)
    if hasattr(moe, "shared"):
        _init_mlp_(moe.shared, g)


def init_params(cfg: ModelConfig, *,
                generator: Optional[torch.Generator] = None,
                device=None) -> Transformer:
    """A :class:`Transformer` with the reference's initialisation: every
    matrix truncated-normal at 1/sqrt(fan_in) (``layers.dense_init``), norms
    at one, biases at zero, the SSM's constants as the reference sets them
    — drawn from ``generator``, which must live on ``device``.  On the
    ``meta`` device nothing is drawn (shapes only, for ``count_params``)."""
    model = Transformer(cfg, device=device)
    if model.device.type == "meta":
        return model
    if generator is None:
        raise ValueError("init_params needs a torch.Generator on the "
                         "model's device")
    g = generator
    with torch.no_grad():
        dense_init_(model.embed, g, in_axis=-1)
        model.final_norm.fill_(1.0)
        if not cfg.tie_embeddings:
            dense_init_(model.lm_head, g)
        for layer in model.layers:
            if cfg.family == "ssm":
                layer.ln.fill_(1.0)
                _init_mamba1_(layer.mixer, g)
            elif cfg.family == "hybrid":
                layer.ln.fill_(1.0)
                _init_mamba2_(layer.mixer, g)
            else:
                layer.ln1.fill_(1.0)
                layer.ln2.fill_(1.0)
                if cfg.mla:
                    _init_mla_(layer.attn, g)
                else:
                    _init_attention_(layer.attn, cfg.qkv_bias, g)
                if hasattr(layer, "moe"):
                    _init_moe_(layer.moe, g)
                else:
                    _init_mlp_(layer.mlp, g)
        if cfg.family == "hybrid":
            sb = model.shared_block
            sb.ln1.fill_(1.0)
            sb.ln2.fill_(1.0)
            _init_attention_(sb.attn, False, g)
            _init_mlp_(sb.mlp, g)
    return model


# =============================================================================
# Embedding / unembedding
# =============================================================================


def _embed_tokens(model: Transformer, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    dt = _dtype(cfg.compute_dtype)
    x = model.embed[tokens.to(torch.long)].to(dt)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    return x


def embed_inputs(model: Transformer, cfg: ModelConfig,
                 batch: Mapping[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """-> (x, positions, prefix_len).  The vision stub's precomputed
    patches (``batch["patches"]``, (B, P, d_model)) go before the token
    embeddings, cast to the compute dtype and not scaled; the positions
    run over P + S and ``prefix_len`` is P (0 for every other model)."""
    dt = _dtype(cfg.compute_dtype)
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    x = _embed_tokens(model, cfg, tokens)
    prefix_len = 0
    if cfg.frontend and cfg.frontend.kind == "vision_stub":
        patches = torch.as_tensor(batch["patches"],
                                  device=model.device).to(dt)
        x = torch.cat([patches, x], dim=1)
        prefix_len = patches.shape[1]
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    if cfg.pos_embedding == "sinusoidal":
        x = x + sinusoidal_positions(positions, cfg.d_model).to(dt)
    return x, positions, prefix_len


def unembed(model: Transformer, cfg: ModelConfig,
            x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, model.final_norm, cfg.norm_eps, plus_one=cfg.embed_scale)
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    logits = torch.matmul(x, head.to(x.dtype))
    return softcap(logits.to(torch.float32), cfg.logit_softcap)


# =============================================================================
# Forward / prefill (a loop over the layer list)
# =============================================================================


def _layer_list(model: Transformer, cfg: ModelConfig,
                call: CallConfig) -> List[Dict[str, Any]]:
    """Every layer's weights; under ``cast_params_once`` one compute-dtype
    copy of them, made before the first layer runs (the layers then read
    2-byte weights)."""
    dt = _dtype(cfg.compute_dtype) if call.cast_params_once else None
    return [model.layer_params(i, dt) for i in range(cfg.n_layers)]


def _mlp(h, lp, cfg: ModelConfig):
    return gated_mlp(h, lp["mlp"]["wi"], lp["mlp"]["wg"], lp["mlp"]["wo"],
                     cfg.act)


def _ffn(h, lp, cfg: ModelConfig, no_drop: bool
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A decoder layer's second half: its MoE block (-> (delta, aux)) or
    its gated MLP (-> (delta, None)), whichever the layer ``lp`` holds."""
    if "moe" in lp:
        return moe_lib.moe_block(h, lp["moe"], cfg, no_drop=no_drop)
    return _mlp(h, lp, cfg), None


def _shared_weights(model: Transformer, cfg: ModelConfig,
                    call: CallConfig) -> Dict[str, Any]:
    """The shared block's weights: as they are (each use casts them, as
    the reference's programs do), or under ``cast_params_once`` one
    compute-dtype copy for the whole call (the same values)."""
    return model.shared_params(
        _dtype(cfg.compute_dtype) if call.cast_params_once else None)


def _applies_shared(cfg: ModelConfig, idx: int) -> bool:
    """Whether the shared block runs after layer ``idx`` (the reference's
    ``lax.cond((idx + 1) % period == 0)``, on the static index)."""
    return (idx + 1) % cfg.hybrid.period == 0


def shared_attn_block(x: torch.Tensor, sb: Mapping[str, Any],
                      cfg: ModelConfig, positions: torch.Tensor,
                      call: CallConfig = CallConfig()) -> torch.Tensor:
    """Zamba2's shared transformer block on the full sequence (the
    reference's ``_shared_attn_block``; ``sb`` from
    :meth:`Transformer.shared_params`)."""
    h = rms_norm(x, sb["ln1"], cfg.norm_eps)
    x = x + attn.gqa_attention(h, sb["attn"], shared_config(cfg), positions,
                               impl=call.attn_impl, chunk=call.attn_chunk,
                               remat_chunk=call.attn_chunk_remat)
    h = rms_norm(x, sb["ln2"], cfg.norm_eps)
    return x + _mlp(h, sb, cfg)


def _decoder_layer(x, lp, cfg: ModelConfig, positions, prefix_len: int,
                   call: CallConfig) -> Tuple[torch.Tensor, Any]:
    """A decoder layer on the full sequence -> (x, MoE aux loss or None)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps, plus_one=cfg.embed_scale)
    if cfg.mla:
        x = x + attn.mla_attention(h, lp["attn"], cfg, positions,
                                   impl=call.attn_impl, chunk=call.attn_chunk,
                                   remat_chunk=call.attn_chunk_remat)
    else:
        x = x + attn.gqa_attention(h, lp["attn"], cfg, positions,
                                   impl=call.attn_impl, prefix_len=prefix_len,
                                   chunk=call.attn_chunk,
                                   remat_chunk=call.attn_chunk_remat)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps, plus_one=cfg.embed_scale)
    delta, aux = _ffn(h, lp, cfg, call.moe_no_drop)
    return x + delta, aux


def _mamba1_layer(x, lp, cfg: ModelConfig, call: CallConfig) -> torch.Tensor:
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    return x + ssm_lib.mamba1_block(h, lp["mixer"], cfg, impl=call.ssm_impl)


def _hybrid_layer(x, lp, sb, shared: bool, cfg: ModelConfig, positions,
                  call: CallConfig) -> torch.Tensor:
    """A Mamba-2 layer, then the shared block where it applies (inside the
    body, as the reference's ``lax.cond`` is inside its scan body)."""
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    x = x + ssm_lib.mamba2_block(h, lp["mixer"], cfg, impl=call.ssm_impl)
    if shared:
        x = shared_attn_block(x, sb, cfg, positions, call)
    return x


def _requires_grad(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.requires_grad
    return isinstance(tree, Mapping) and any(
        _requires_grad(v) for v in tree.values())


def _run_layer(call: CallConfig, body, x, lp, *args):
    """``body(x, lp, *args)``; with ``remat``, when autograd records it (x
    or a weight of the layer requires grad), recomputed in the backward
    pass (``torch.utils.checkpoint``): only the layer's inputs are kept,
    as the reference's ``jax.checkpoint(nothing_saveable)``."""
    if (call.remat and torch.is_grad_enabled()
            and (x.requires_grad or _requires_grad(lp))):
        return torch.utils.checkpoint.checkpoint(body, x, lp, *args,
                                                 use_reentrant=False)
    return body(x, lp, *args)


def forward(model: Transformer, cfg: ModelConfig,
            batch: Mapping[str, torch.Tensor],
            call: CallConfig = CallConfig()
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward pass -> (logits f32, aux_loss)."""
    require_ported(cfg)
    x, positions, prefix_len = embed_inputs(model, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        sb = _shared_weights(model, cfg, call)
        for idx, lp in enumerate(_layer_list(model, cfg, call)):
            x = _run_layer(call, _hybrid_layer, x, lp, sb,
                           _applies_shared(cfg, idx), cfg, positions, call)
        return unembed(model, cfg, x), aux
    for lp in _layer_list(model, cfg, call):
        if cfg.family == "ssm":
            x = _run_layer(call, _mamba1_layer, x, lp, cfg, call)
            continue
        x, layer_aux = _run_layer(call, _decoder_layer, x, lp, cfg,
                                  positions, prefix_len, call)
        if layer_aux is not None:
            aux = aux + layer_aux
    return unembed(model, cfg, x), aux


def loss_fn(model: Transformer, cfg: ModelConfig,
            batch: Mapping[str, torch.Tensor],
            call: CallConfig = CallConfig()
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy (text positions only for the vision stub)
    + MoE aux -> (total, {"nll", "aux"}).  ``batch["labels"]`` (B, S);
    ``batch["loss_mask"]``, when given, weights the positions (the mean is
    over its sum, at least 1).  The log-softmax runs in float32 on the
    float32 logits."""
    logits, aux = forward(model, cfg, batch, call)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    if cfg.frontend and cfg.frontend.kind == "vision_stub":
        logits = logits[:, -labels.shape[1]:]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.to(torch.long)[..., None])[..., 0]
    mask = batch.get("loss_mask")
    mask = (torch.ones_like(nll) if mask is None
            else torch.as_tensor(mask, device=nll.device).to(nll.dtype))
    nll = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return nll + aux, {"nll": nll, "aux": aux}


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype_str: Optional[str] = None, device=None) -> Cache:
    """The KV cache: ``k``/``v`` (L, B, max_len, Hkv·dh) and ``pos``, the
    next position to write (a device int32 scalar, as in the reference:
    a decode step reads it on the device, never on the host).  For the
    ``ssm`` family the state cache: ``conv`` (L, B, K-1, d_inner), the
    last K-1 pre-conv inputs, ``h`` (L, B, d_inner, N) float32 and
    ``pos``.  For the ``hybrid`` family ``conv`` (L, B, K-1, d_inner + 2N),
    ``h`` (L, B, H, P, N) float32, the shared block's ``k``/``v`` (L //
    period, B, max_len, Hkv·dh), one slot per application, and ``pos``.
    For MLA the compressed cache: ``c`` (L, B, max_len, kv_lora_rank),
    ``krope`` (L, B, max_len, rope) and ``pos``."""
    require_ported(cfg)
    dt = _dtype(dtype_str or cfg.compute_dtype)
    if cfg.mla:
        m = cfg.mla
        return {"c": torch.zeros((cfg.n_layers, batch_size, max_len,
                                  m.kv_lora_rank), dtype=dt, device=device),
                "krope": torch.zeros((cfg.n_layers, batch_size, max_len,
                                      m.qk_rope_head_dim), dtype=dt,
                                     device=device),
                "pos": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.family == "hybrid":
        s, scfg = cfg.ssm, shared_config(cfg)
        nh = cfg.d_inner // s.headdim
        apps = cfg.n_layers // cfg.hybrid.period
        kv = (apps, batch_size, max_len, scfg.n_kv_heads * scfg.head_dim)
        return {"conv": torch.zeros((cfg.n_layers, batch_size, s.d_conv - 1,
                                     cfg.d_inner + 2 * s.d_state), dtype=dt,
                                    device=device),
                "h": torch.zeros((cfg.n_layers, batch_size, nh, s.headdim,
                                  s.d_state), dtype=torch.float32,
                                 device=device),
                "k": torch.zeros(kv, dtype=dt, device=device),
                "v": torch.zeros(kv, dtype=dt, device=device),
                "pos": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.family == "ssm":
        s = cfg.ssm
        return {"conv": torch.zeros((cfg.n_layers, batch_size, s.d_conv - 1,
                                     cfg.d_inner), dtype=dt, device=device),
                "h": torch.zeros((cfg.n_layers, batch_size, cfg.d_inner,
                                  s.d_state), dtype=torch.float32,
                                 device=device),
                "pos": torch.zeros((), dtype=torch.int32, device=device)}
    kvd = cfg.n_kv_heads * cfg.head_dim
    shape = (cfg.n_layers, batch_size, max_len, kvd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _into(cache: Optional[Cache], cfg: ModelConfig, b: int, max_len: int,
          device) -> Cache:
    """``cache`` reset to :func:`init_cache`'s zeros (a caller's static
    cache, which a captured decode program reads at fixed addresses), or
    a new one."""
    if cache is None:
        return init_cache(cfg, b, max_len, device=device)
    want = init_cache(cfg, b, max_len, device="meta")
    for name, t in want.items():
        got = cache[name]
        if got.shape != t.shape or got.dtype != t.dtype:
            raise ValueError(
                f"cache[{name!r}] is {tuple(got.shape)}/{got.dtype}, the "
                f"prefill needs {tuple(t.shape)}/{t.dtype}")
        got.zero_()
    return cache


def prefill(model: Transformer, cfg: ModelConfig,
            batch: Mapping[str, torch.Tensor], max_len: int,
            call: CallConfig = CallConfig(),
            cache: Optional[Cache] = None) -> Tuple[torch.Tensor, Cache]:
    """Process a full prompt -> (last-position logits (B, 1, V), primed
    cache).  With ``cache`` (an :func:`init_cache` of this batch and
    ``max_len``) the prompt is written into it, in place; otherwise into a
    new one.  The ``ssm`` family's cache holds no positions, so
    ``max_len`` does not bound its prompt (as in the reference); the
    ``hybrid`` family's shared block keeps K/V, so it does.  The vision
    stub's patches take the first P positions of the cache, and its
    ``pos`` is P + S."""
    require_ported(cfg)
    x, positions, prefix_len = embed_inputs(model, cfg, batch)
    b, s = x.shape[0], x.shape[1]
    if cfg.family == "hybrid":
        return _prefill_hybrid(model, cfg, x, positions, max_len, call,
                               cache)
    if cfg.family == "ssm":
        cache = _into(cache, cfg, b, max_len, x.device)
        for i, lp in enumerate(_layer_list(model, cfg, call)):
            h = rms_norm(x, lp["ln"], cfg.norm_eps)
            y, (conv_tail, h_last) = ssm_lib.mamba1_block(
                h, lp["mixer"], cfg, return_state=True, impl=call.ssm_impl)
            x = x + y
            cache["conv"][i] = conv_tail.to(cache["conv"].dtype)
            cache["h"][i] = h_last
        cache["pos"].fill_(s)
        return unembed(model, cfg, x[:, -1:]), cache
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    dt = x.dtype
    cache = _into(cache, cfg, b, max_len, x.device)
    for i, lp in enumerate(_layer_list(model, cfg, call)):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps, plus_one=cfg.embed_scale)
        if cfg.mla:
            # the compressed states are the cache: computed once, stashed
            c, krope = attn.mla_compress_kv(h, lp["attn"], cfg, positions)
            x = x + attn.mla_attention(h, lp["attn"], cfg, positions,
                                       impl=call.attn_impl, c=c,
                                       k_rope=krope, chunk=call.attn_chunk,
                                       remat_chunk=call.attn_chunk_remat)
            cache["c"][i, :, :s] = c.to(cache["c"].dtype)
            cache["krope"][i, :, :s] = krope[:, 0].to(cache["krope"].dtype)
        else:
            q, k, v = attn.gqa_project(h, lp["attn"], cfg, positions)
            o = attn.multihead_attention(q, k, v, impl=call.attn_impl,
                                         prefix_len=prefix_len,
                                         chunk=call.attn_chunk,
                                         remat_chunk=call.attn_chunk_remat)
            x = x + torch.matmul(attn._merge_heads(o),
                                 lp["attn"]["wo"].to(dt))
            cache["k"][i, :, :s] = attn._merge_heads(k).to(cache["k"].dtype)
            cache["v"][i, :, :s] = attn._merge_heads(v).to(cache["v"].dtype)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps, plus_one=cfg.embed_scale)
        x = x + _ffn(h, lp, cfg, call.moe_no_drop)[0]
    cache["pos"].fill_(s)
    return unembed(model, cfg, x[:, -1:]), cache


def _prefill_hybrid(model: Transformer, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, max_len: int, call: CallConfig,
                    cache: Optional[Cache]) -> Tuple[torch.Tensor, Cache]:
    """The hybrid's prefill: every Mamba-2 layer on the full prompt, its
    conv tail and state into the cache; after every ``period``-th layer the
    shared block, its K/V written into slot ``idx // period``."""
    b, s = x.shape[0], x.shape[1]
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    dt = x.dtype
    scfg = shared_config(cfg)
    cache = _into(cache, cfg, b, max_len, x.device)
    sb = _shared_weights(model, cfg, call)
    for idx, lp in enumerate(_layer_list(model, cfg, call)):
        h = rms_norm(x, lp["ln"], cfg.norm_eps)
        y, (conv_tail, h_last) = ssm_lib.mamba2_block(
            h, lp["mixer"], cfg, return_state=True, impl=call.ssm_impl)
        x = x + y
        cache["conv"][idx] = conv_tail.to(cache["conv"].dtype)
        cache["h"][idx] = h_last
        if not _applies_shared(cfg, idx):
            continue
        app = idx // cfg.hybrid.period
        hh = rms_norm(x, sb["ln1"], cfg.norm_eps)
        q, k, v = attn.gqa_project(hh, sb["attn"], scfg, positions)
        o = attn.multihead_attention(q, k, v, impl=call.attn_impl,
                                     chunk=call.attn_chunk,
                                     remat_chunk=call.attn_chunk_remat)
        x = x + torch.matmul(attn._merge_heads(o), sb["attn"]["wo"].to(dt))
        cache["k"][app, :, :s] = attn._merge_heads(k).to(cache["k"].dtype)
        cache["v"][app, :, :s] = attn._merge_heads(v).to(cache["v"].dtype)
        hh = rms_norm(x, sb["ln2"], cfg.norm_eps)
        x = x + _mlp(hh, sb, cfg)
    cache["pos"].fill_(s)
    return unembed(model, cfg, x[:, -1:]), cache


# =============================================================================
# Decode steps (one token, cache updated in place)
# =============================================================================


def decode_step(model: Transformer, cfg: ModelConfig, cache: Cache,
                tokens: torch.Tensor, call: CallConfig = CallConfig()
                ) -> Tuple[torch.Tensor, Cache]:
    """tokens: (B, 1) -> (logits (B, 1, V) f32, cache).  The cache's
    tensors are written in place at ``cache["pos"]``; the returned dict
    holds the same tensors and ``pos + 1`` (a new device scalar).

    The position stays on the device and attention covers the whole cache
    under a mask, so no shape depends on it and no tensor value is read
    on the host: one CUDA graph captures the step for every position
    (``core/graphs.py``)."""
    require_ported(cfg)
    dt = _dtype(cfg.compute_dtype)
    pos = torch.as_tensor(cache["pos"], dtype=torch.int32,
                          device=model.device)
    tokens = torch.as_tensor(tokens, device=model.device)
    b = tokens.shape[0]
    x = _embed_tokens(model, cfg, tokens)
    if cfg.pos_embedding == "sinusoidal":
        x = x + sinusoidal_positions(pos.expand(b, 1), cfg.d_model).to(dt)
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            lp = model.layer_params(i)
            hin = rms_norm(x, lp["ln"], cfg.norm_eps)
            y, conv, h = ssm_lib.mamba1_decode(
                hin, lp["mixer"], cfg, cache["conv"][i], cache["h"][i])
            x = x + y
            cache["conv"][i] = conv
            cache["h"][i] = h
        new_cache = {"conv": cache["conv"], "h": cache["h"], "pos": pos + 1}
        return unembed(model, cfg, x), new_cache
    if cfg.family == "hybrid":
        scfg = shared_config(cfg)
        sb = model.shared_params()
        for i in range(cfg.n_layers):
            lp = model.layer_params(i)
            hin = rms_norm(x, lp["ln"], cfg.norm_eps)
            y, conv, h = ssm_lib.mamba2_decode(
                hin, lp["mixer"], cfg, cache["conv"][i], cache["h"][i])
            x = x + y
            cache["conv"][i] = conv
            cache["h"][i] = h
            if not _applies_shared(cfg, i):
                continue
            app = i // cfg.hybrid.period
            hin = rms_norm(x, sb["ln1"], cfg.norm_eps)
            o, _, _ = attn.gqa_decode(hin, sb["attn"], scfg, cache["k"][app],
                                      cache["v"][app], pos)
            x = x + o
            hin = rms_norm(x, sb["ln2"], cfg.norm_eps)
            x = x + _mlp(hin, sb, cfg)
        new_cache = {name: cache[name] for name in ("conv", "h", "k", "v")}
        new_cache["pos"] = pos + 1
        return unembed(model, cfg, x), new_cache
    # the MLA and GQA branches: attention against the cache, then the MLP
    # or the MoE block with exact routing (no_drop, as the reference's
    # decode steps route whatever the call says)
    names = ("c", "krope") if cfg.mla else ("k", "v")
    decode = attn.mla_decode if cfg.mla else attn.gqa_decode
    for i in range(cfg.n_layers):
        lp = model.layer_params(i)
        hin = rms_norm(x, lp["ln1"], cfg.norm_eps, plus_one=cfg.embed_scale)
        o, _, _ = decode(hin, lp["attn"], cfg, cache[names[0]][i],
                         cache[names[1]][i], pos)
        x = x + o
        hin = rms_norm(x, lp["ln2"], cfg.norm_eps, plus_one=cfg.embed_scale)
        x = x + _ffn(hin, lp, cfg, True)[0]
    new_cache = {name: cache[name] for name in names}
    new_cache["pos"] = pos + 1
    return unembed(model, cfg, x), new_cache


def decode_step_ragged(model: Transformer, cfg: ModelConfig, cache: Cache,
                       tokens: torch.Tensor, pos_b: torch.Tensor,
                       call: CallConfig = CallConfig()
                       ) -> Tuple[torch.Tensor, Cache]:
    """One decode step with *per-row* positions (continuous batching).

    ``pos_b``: (B,) integer tensor on the model's device — each row writes
    its KV at its own cache position and attends over its own prefix.  The
    returned ``pos`` is ``max(pos_b) + 1`` as a device scalar (no sync).
    GQA attention only (the dense family and MoE with GQA), as in the
    reference: an SSM state cache is a position-free recurrence whose rows
    cannot be shifted, and MLA keeps the uniform-``pos`` path."""
    if cfg.family in ("ssm", "hybrid") or cfg.mla or cfg.frontend:
        raise NotImplementedError(
            "ragged decode is implemented for the plain attention family "
            "only (no SSM/hybrid/MLA state, no modality-prefix frontends)")
    require_ported(cfg)
    dt = _dtype(cfg.compute_dtype)
    tokens = torch.as_tensor(tokens, device=model.device)
    x = _embed_tokens(model, cfg, tokens)
    if cfg.pos_embedding == "sinusoidal":
        x = x + sinusoidal_positions(pos_b[:, None], cfg.d_model).to(dt)
    for i in range(cfg.n_layers):
        lp = model.layer_params(i)
        hin = rms_norm(x, lp["ln1"], cfg.norm_eps, plus_one=cfg.embed_scale)
        o, _, _ = attn.gqa_decode_ragged(hin, lp["attn"], cfg, cache["k"][i],
                                         cache["v"][i], pos_b)
        x = x + o
        hin = rms_norm(x, lp["ln2"], cfg.norm_eps, plus_one=cfg.embed_scale)
        x = x + _ffn(hin, lp, cfg, True)[0]
    new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos_b.max() + 1}
    return unembed(model, cfg, x), new_cache
