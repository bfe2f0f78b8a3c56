"""A dense GQA decoder (SmolLM, Yi): its leaves, and the work its traffic
needs, counted from the configuration's shapes.

The counts are of the model's work, not of what the program executes: no
recompute, no casts, no masked-out half of a causal score matrix.  A
program that does less work than it does today cannot lower them, only
its time.  ``train_step_flops`` follows ``chip_smoke.train_step_work``
without its recompute and with the causal half of the scores.
"""

from __future__ import annotations

from typing import List, Mapping, Tuple

from bench import work


def head_dim(cfg: Mapping) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def leaf_shapes(cfg: Mapping) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every leaf, named as the program's state dict
    names them, ``x @ W`` layout: a matrix is (in, out)."""
    d, f, v = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    hq = cfg["n_heads"] * head_dim(cfg)
    hkv = cfg["n_kv_heads"] * head_dim(cfg)
    out = [("embed", (v, d)), ("final_norm", (d,))]
    if not cfg.get("tie_embeddings"):
        out.append(("lm_head", (d, v)))
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        out += [(p + "ln1", (d,)), (p + "ln2", (d,)),
                (p + "attn.wq", (d, hq)), (p + "attn.wk", (d, hkv)),
                (p + "attn.wv", (d, hkv)), (p + "attn.wo", (hq, d)),
                (p + "mlp.wi", (d, f)), (p + "mlp.wg", (d, f)),
                (p + "mlp.wo", (f, d))]
    return out


def layer_weights(cfg: Mapping) -> int:
    """Matmul weights of one decoder layer: q, k, v, o and the gated MLP."""
    d, hd = cfg["d_model"], head_dim(cfg)
    return (d * (cfg["n_heads"] + 2 * cfg["n_kv_heads"]) * hd
            + cfg["n_heads"] * hd * d + 3 * d * cfg["d_ff"])


def head_weights(cfg: Mapping) -> int:
    """The output head's weights (the embedding's, when tied)."""
    return cfg["d_model"] * cfg["vocab_size"]


def matmul_weights(cfg: Mapping) -> int:
    """Every weight a token's forward pass multiplies: the layers and the
    head (the embedding is a lookup)."""
    return cfg["n_layers"] * layer_weights(cfg) + head_weights(cfg)


def attention_flops(cfg: Mapping, batch: int, seq: int) -> int:
    """Forward attention of every layer over ``batch`` causal sequences:
    two products of 2 operations per visible pair, head and head dim."""
    return (4 * batch * cfg["n_heads"] * work.causal_pairs(seq, seq)
            * head_dim(cfg) * cfg["n_layers"])


def train_step_flops(cfg: Mapping, batch: int, seq: int) -> int:
    """One training step's model work: 6 operations a weight a token
    (forward 2, backward 4) and the causal attention, forward and twice
    backward.  No recompute."""
    return (6 * matmul_weights(cfg) * batch * seq
            + 3 * attention_flops(cfg, batch, seq))


def prefill_flops(cfg: Mapping, length: int) -> int:
    """A prefill of ``length`` tokens: every layer's weights on every
    token, the head on the last one, and the causal attention."""
    return (2 * cfg["n_layers"] * layer_weights(cfg) * length
            + 2 * head_weights(cfg) + attention_flops(cfg, 1, length))


def cache_bytes_per_position(cfg: Mapping) -> int:
    """K and V of one position over every layer, in bf16."""
    return (cfg["n_layers"] * 2 * cfg["n_kv_heads"] * head_dim(cfg)
            * work.BF16_BYTES)


def decode_flops(cfg: Mapping, positions: int) -> int:
    """One decoded token: every weight once, and the attention of every
    layer over ``positions`` cached positions."""
    return (2 * matmul_weights(cfg)
            + 4 * cfg["n_heads"] * head_dim(cfg) * cfg["n_layers"] * positions)


def step_weight_bytes(cfg: Mapping) -> int:
    """The weights one decode step reads, once, in bf16."""
    return work.BF16_BYTES * matmul_weights(cfg)


def prefill_flash_bound_s(cfg: Mapping, length: int) -> float:
    """The least time of a prefill's flash calls: one a layer, q (1, Hq,
    L, d) against k, v (1, Hkv, L, d) in bf16, causal."""
    hd = head_dim(cfg)
    nbytes, ops = work.flash_work((1, cfg["n_heads"], length, hd),
                                  (1, cfg["n_kv_heads"], length, hd), True,
                                  work.BF16_BYTES)
    return cfg["n_layers"] * work.least_s(ops, nbytes)
