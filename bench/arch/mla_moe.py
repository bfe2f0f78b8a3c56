"""DeepSeek-V2's decoder (multi-head latent attention, a leading dense
layer, routed and shared experts): its leaves, and the work its traffic
needs, counted from the configuration's shapes.

The counts are of the model's work, not of what the program executes: a
token's 6 routed experts and the 2 shared ones, not the 64 a no-drop
buffer would run; the causal half of the scores; the head at the positions
read.  A decode step's bytes are a lower bound: every weight outside the
routed experts once, ``top_k`` routed experts a MoE layer (the fewest any
routing of the batch reads) and the live latent cache, in bf16.
"""

from __future__ import annotations

from typing import List, Mapping, Tuple

import torch

from bench import work


def _moe(cfg: Mapping) -> Mapping:
    return cfg["moe"]


def _mla(cfg: Mapping) -> Mapping:
    return cfg["mla"]


def first_dense(cfg: Mapping) -> int:
    return _moe(cfg).get("first_dense", 0)


def qk_dim(cfg: Mapping) -> int:
    m = _mla(cfg)
    return m["qk_nope_head_dim"] + m["qk_rope_head_dim"]


def leaf_shapes(cfg: Mapping) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every leaf, named as the program's state dict
    names them, ``x @ W`` layout: a matrix is (in, out); the routed
    experts stacked (E, in, out)."""
    d, v, h = cfg["d_model"], cfg["vocab_size"], cfg["n_heads"]
    m, moe = _mla(cfg), _moe(cfg)
    rank, rope = m["kv_lora_rank"], m["qk_rope_head_dim"]
    e, fe = moe["n_experts"], moe["d_ff_expert"]
    fs = moe.get("n_shared", 0) * fe
    out = [("embed", (v, d)), ("final_norm", (d,))]
    if not cfg.get("tie_embeddings"):
        out.append(("lm_head", (d, v)))
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        out += [(p + "ln1", (d,)), (p + "ln2", (d,)),
                (p + "attn.wq", (d, h * qk_dim(cfg))),
                (p + "attn.wdkv", (d, rank + rope)),
                (p + "attn.kv_norm", (rank,)),
                (p + "attn.wuk", (rank, h * m["qk_nope_head_dim"])),
                (p + "attn.wuv", (rank, h * m["v_head_dim"])),
                (p + "attn.wo", (h * m["v_head_dim"], d))]
        if i < first_dense(cfg):
            f = cfg["d_ff"]
            out += [(p + "mlp.wi", (d, f)), (p + "mlp.wg", (d, f)),
                    (p + "mlp.wo", (f, d))]
            continue
        out += [(p + "moe.router", (d, e)),
                (p + "moe.experts.wi", (e, d, fe)),
                (p + "moe.experts.wg", (e, d, fe)),
                (p + "moe.experts.wo", (e, fe, d))]
        if fs:
            out += [(p + "moe.shared.wi", (d, fs)),
                    (p + "moe.shared.wg", (d, fs)),
                    (p + "moe.shared.wo", (fs, d))]
    return out


def init_leaf(name: str, leaf: torch.Tensor) -> None:
    """``bench.weights.init_leaf``'s rule, with a stacked expert's fan-in
    on its axis 1 (axis 0 counts the experts)."""
    if leaf.dim() == 1:
        leaf.mul_(0.1).add_(1.0)
    elif name == "embed":
        leaf.mul_(leaf.shape[1] ** -0.5)
    elif ".experts." in name:
        leaf.mul_(leaf.shape[1] ** -0.5)
    else:
        leaf.mul_(leaf.shape[0] ** -0.5)


def attention_weights(cfg: Mapping) -> int:
    """One layer's MLA matrices a token multiplies in a prefill: q, the
    compressed KV and its rotary key, the up-projections of K and V, o."""
    d, h, m = cfg["d_model"], cfg["n_heads"], _mla(cfg)
    rank = m["kv_lora_rank"]
    return (d * h * qk_dim(cfg) + d * (rank + m["qk_rope_head_dim"])
            + rank * h * (m["qk_nope_head_dim"] + m["v_head_dim"])
            + h * m["v_head_dim"] * d)


def expert_weights(cfg: Mapping) -> int:
    """One routed expert's matrices."""
    return 3 * cfg["d_model"] * _moe(cfg)["d_ff_expert"]


def ffn_weights(cfg: Mapping, i: int) -> int:
    """Layer ``i``'s second half a token multiplies: the dense MLP, or the
    router, ``top_k`` routed experts and the shared ones."""
    d, moe = cfg["d_model"], _moe(cfg)
    if i < first_dense(cfg):
        return 3 * d * cfg["d_ff"]
    return (d * moe["n_experts"]
            + (moe["top_k"] + moe.get("n_shared", 0)) * expert_weights(cfg))


def token_weights(cfg: Mapping) -> int:
    """Every layer's weights a token multiplies (the head aside)."""
    return sum(attention_weights(cfg) + ffn_weights(cfg, i)
               for i in range(cfg["n_layers"]))


def head_weights(cfg: Mapping) -> int:
    return cfg["d_model"] * cfg["vocab_size"]


def attention_flops(cfg: Mapping, length: int, positions: int) -> int:
    """MLA over ``length`` queries ending at position ``positions`` (causal,
    aligned bottom-right), every layer: q·k at nope + rope, p·v at v."""
    dims = qk_dim(cfg) + _mla(cfg)["v_head_dim"]
    return (2 * cfg["n_heads"] * dims * cfg["n_layers"]
            * work.causal_pairs(length, positions))


def prefill_flops(cfg: Mapping, length: int) -> int:
    """A prefill of ``length`` tokens of one sequence: every layer's
    weights on every token, the head on the last one, causal MLA."""
    return (2 * token_weights(cfg) * length + 2 * head_weights(cfg)
            + attention_flops(cfg, length, length))


def cache_bytes_per_position(cfg: Mapping) -> int:
    """The latent cache of one position over every layer, in bf16: the
    compressed KV and the rotary key."""
    m = _mla(cfg)
    return (cfg["n_layers"] * (m["kv_lora_rank"] + m["qk_rope_head_dim"])
            * work.BF16_BYTES)


def step_weight_bytes(cfg: Mapping) -> int:
    """The least weights a decode step reads in bf16: everything outside
    the routed experts once, and ``top_k`` routed experts a MoE layer (as
    one token multiplies them), the head."""
    return work.BF16_BYTES * (token_weights(cfg) + head_weights(cfg))


def step_least_s(cfg: Mapping, batch: int, positions: int) -> float:
    """A decode step's least time: its least bytes (the weights above and
    ``batch`` rows of ``positions`` cached positions) at the HBM rate."""
    return ((step_weight_bytes(cfg)
             + batch * positions * cache_bytes_per_position(cfg))
            / work.HBM_BYTES_PER_S)


def call_least_s(cfg: Mapping, batch: int, length: int, n_new: int
                 ) -> float:
    """One ``generate`` call's least time: the prefill of ``batch`` rows of
    ``length`` tokens at the bf16 peak, then ``n_new - 1`` decode steps
    (the first token comes from the prefill), step t attending
    ``length + t + 1`` positions."""
    return (batch * prefill_flops(cfg, length) / work.PEAK_BF16_FLOPS
            + sum(step_least_s(cfg, batch, length + t + 1)
                  for t in range(n_new - 1)))


def experts_least_s(cfg: Mapping, tokens: int) -> float:
    """The grouped expert products of ``tokens`` tokens through every MoE
    layer: each token's ``top_k`` rows through three matrices; the bytes
    of ``top_k`` experts' bf16 weights (the fewest any routing reads) and
    of the rows read and written once."""
    moe, d = _moe(cfg), cfg["d_model"]
    rows = tokens * moe["top_k"]
    n_moe = cfg["n_layers"] - first_dense(cfg)
    flops = 2 * rows * expert_weights(cfg)
    nbytes = work.BF16_BYTES * (moe["top_k"] * expert_weights(cfg)
                                + 2 * rows * d)
    return n_moe * work.least_s(flops, nbytes)


def call_experts_least_s(cfg: Mapping, batch: int, length: int,
                         n_new: int) -> float:
    """The grouped products' least time in one ``generate`` call: the
    prefill's and each of its ``n_new - 1`` decode steps'."""
    return (experts_least_s(cfg, batch * length)
            + (n_new - 1) * experts_least_s(cfg, batch))
