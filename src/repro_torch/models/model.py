"""Model assembly: init / forward / prefill / decode — twin of
``repro.models.model`` for the dense and the SSM (Mamba-1) families.

The model is an ``nn.Module`` (:class:`Transformer`): the embedding, an
``nn.ModuleList`` of layers (a decoder layer, or a Mamba-1 layer for the
``ssm`` family), the final norm and the LM head.  Its parameter names
follow the reference's tree with the layer index put in (``layers/attn/wq``
stacked over L becomes ``layers.<i>.attn.wq``, ``layers/mixer/A_log``
becomes ``layers.<i>.mixer.A_log``), so ``convert.model_params_from_numpy``
maps one onto the other.  The reference's ``lax.scan`` over the stacked
layers is a loop over the ``ModuleList``; every entry point is a function
of (model, tensors), with the device taken from the model.

The other families — MoE, MLA, hybrid and the modality frontends — raise
:class:`NotImplementedError` naming the ROADMAP item that brings them.
Of ``CallConfig``'s fields, the reference's sharding knobs
(``residual_spec``, ``attn_q_sharding``, ``moe_buffer_sharding``) have no
meaning on one device, ``attn_chunk_remat`` none without a backward pass,
and ``moe_no_drop`` comes with the MoE family: none is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention as attn
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

#: where each family the port cannot build yet comes from
_WAITS = "ROADMAP.md Queue 1 item 12"


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def require_ported(cfg: ModelConfig) -> None:
    """Raise for every configuration the port cannot build yet: it builds
    the dense family and the ``ssm`` family (Mamba-1)."""
    parts = (("moe", cfg.moe), ("mla", cfg.mla), ("hybrid", cfg.hybrid),
             ("frontend", cfg.frontend))
    if cfg.family != "ssm":
        parts += (("ssm", cfg.ssm),)
    elif cfg.ssm is None or cfg.ssm.version != 1:
        parts += (("Mamba-2", cfg.ssm),)
    for what, present in parts:
        if present is not None:
            raise NotImplementedError(
                f"{cfg.name}: the {what} part of the model is not ported "
                f"yet (it comes with {_WAITS}); the port builds the dense "
                "and ssm families only")
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (it comes "
            f"with {_WAITS}); the port builds the dense and ssm families "
            "only")


@dataclasses.dataclass(frozen=True)
class CallConfig:
    """Per-call knobs owned by the launcher, not the architecture."""

    attn_impl: str = "auto"         # "plain" | "chunked" | "kernel" | "auto"
    attn_chunk: int = 512
    ssm_impl: str = "auto"          # "plain" | "kernel" | "auto" (SSM scan)
    # kept for the reference's signature; it means nothing without a
    # backward pass and is ignored until training lands (Queue 1 item 14)
    remat: bool = True
    cast_params_once: bool = False  # one compute-dtype weight copy per call


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


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = _param((cfg.d_model,), dtype, device)
        self.ln2 = _param((cfg.d_model,), dtype, device)
        self.attn = Attention(cfg, dtype, device)
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


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln = _param((cfg.d_model,), dtype, device)
        self.mixer = Mamba1Mixer(cfg, dtype, device)


class Transformer(nn.Module):
    """A decoder-only model at ``cfg``'s widths: a dense transformer, or a
    stack of Mamba-1 layers for the ``ssm`` family."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        require_ported(cfg)
        dtype = _dtype(cfg.param_dtype)
        self.embed = _param((cfg.vocab_size, cfg.d_model), dtype, device)
        self.final_norm = _param((cfg.d_model,), dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab_size), dtype,
                                  device)
        layer = MambaLayer if cfg.family == "ssm" else DecoderLayer
        self.layers = nn.ModuleList(
            layer(cfg, dtype, device) for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def layer_params(self, i: int, dtype: Optional[torch.dtype] = None
                     ) -> Dict[str, Any]:
        """Layer ``i``'s weights as the reference's tree (``{"ln1", "ln2",
        "attn": {...}, "mlp": {...}}``, or ``{"ln", "mixer": {...}}``);
        with ``dtype``, float32 leaves are cast copies."""
        layer = self.layers[i]

        def leaf(t):
            return t.to(dtype) if dtype is not None and \
                t.dtype == torch.float32 else t

        out: Dict[str, Any] = {n: leaf(t) for n, t in
                               layer.named_parameters(recurse=False)}
        for name, child in layer.named_children():
            out[name] = {n: leaf(t) for n, t in child.named_parameters()}
        return out


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
                continue
            layer.ln1.fill_(1.0)
            layer.ln2.fill_(1.0)
            for name in ("wq", "wk", "wv", "wo"):
                dense_init_(getattr(layer.attn, name), g)
            if cfg.qkv_bias:
                for name in ("bq", "bk", "bv"):
                    getattr(layer.attn, name).zero_()
            for name in ("wi", "wg", "wo"):
                dense_init_(getattr(layer.mlp, name), g)
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
    """-> (x, positions, prefix_len)."""
    dt = _dtype(cfg.compute_dtype)
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    x = _embed_tokens(model, cfg, tokens)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    if cfg.pos_embedding == "sinusoidal":
        x = x + sinusoidal_positions(positions, cfg.d_model).to(dt)
    return x, positions, 0


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


def forward(model: Transformer, cfg: ModelConfig,
            batch: Mapping[str, torch.Tensor],
            call: CallConfig = CallConfig()
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward pass -> (logits f32, aux_loss)."""
    require_ported(cfg)
    x, positions, prefix_len = embed_inputs(model, cfg, batch)
    for lp in _layer_list(model, cfg, call):
        if cfg.family == "ssm":
            h = rms_norm(x, lp["ln"], cfg.norm_eps)
            x = x + ssm_lib.mamba1_block(h, lp["mixer"], cfg,
                                         impl=call.ssm_impl)
            continue
        h = rms_norm(x, lp["ln1"], cfg.norm_eps, plus_one=cfg.embed_scale)
        x = x + attn.gqa_attention(h, lp["attn"], cfg, positions,
                                   impl=call.attn_impl, prefix_len=prefix_len,
                                   chunk=call.attn_chunk)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps, plus_one=cfg.embed_scale)
        x = x + _mlp(h, lp, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(model, cfg, x), aux


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype_str: Optional[str] = None, device=None) -> Cache:
    """The KV cache: ``k``/``v`` (L, B, max_len, Hkv·dh) and ``pos``, the
    next position to write (a device int32 scalar, as in the reference:
    a decode step reads it on the device, never on the host).  For the
    ``ssm`` family the state cache: ``conv`` (L, B, K-1, d_inner), the
    last K-1 pre-conv inputs, ``h`` (L, B, d_inner, N) float32 and
    ``pos``."""
    require_ported(cfg)
    dt = _dtype(dtype_str or cfg.compute_dtype)
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
    ``max_len`` does not bound its prompt (as in the reference)."""
    require_ported(cfg)
    x, positions, prefix_len = embed_inputs(model, cfg, batch)
    b, s = x.shape[0], x.shape[1]
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
        q, k, v = attn.gqa_project(h, lp["attn"], cfg, positions)
        o = attn.multihead_attention(q, k, v, impl=call.attn_impl,
                                     prefix_len=prefix_len,
                                     chunk=call.attn_chunk)
        x = x + torch.matmul(attn._merge_heads(o), lp["attn"]["wo"].to(dt))
        cache["k"][i, :, :s] = attn._merge_heads(k).to(cache["k"].dtype)
        cache["v"][i, :, :s] = attn._merge_heads(v).to(cache["v"].dtype)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps, plus_one=cfg.embed_scale)
        x = x + _mlp(h, lp, cfg)
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
    for i in range(cfg.n_layers):
        lp = model.layer_params(i)
        hin = rms_norm(x, lp["ln1"], cfg.norm_eps, plus_one=cfg.embed_scale)
        o, _, _ = attn.gqa_decode(hin, lp["attn"], cfg, cache["k"][i],
                                  cache["v"][i], pos)
        x = x + o
        hin = rms_norm(x, lp["ln2"], cfg.norm_eps, plus_one=cfg.embed_scale)
        x = x + _mlp(hin, lp, cfg)
    new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
    return unembed(model, cfg, x), new_cache


def decode_step_ragged(model: Transformer, cfg: ModelConfig, cache: Cache,
                       tokens: torch.Tensor, pos_b: torch.Tensor,
                       call: CallConfig = CallConfig()
                       ) -> Tuple[torch.Tensor, Cache]:
    """One decode step with *per-row* positions (continuous batching).

    ``pos_b``: (B,) integer tensor on the model's device — each row writes
    its KV at its own cache position and attends over its own prefix.  The
    returned ``pos`` is ``max(pos_b) + 1`` as a device scalar (no sync).
    Attention families only, as in the reference: an SSM state cache is a
    position-free recurrence whose rows cannot be shifted."""
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
        x = x + _mlp(hin, lp, cfg)
    new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos_b.max() + 1}
    return unembed(model, cfg, x), new_cache
