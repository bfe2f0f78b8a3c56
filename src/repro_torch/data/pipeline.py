"""Synthetic token stream + input specs (twin of ``repro.data.pipeline``).

``SyntheticStream.batch(i)`` is a pure function of (seed, i): restartable,
shardable (each data-parallel group slices its rows), and cheap.  The token
distribution is Zipf-like with a 30 % repeat-previous structure.  The code
is the reference's, in numpy only, so both packages draw bit-identical
batches from one Philox stream per ``(seed, index)``.

``input_specs`` stands in for every model input of an (architecture ×
input-shape) cell with a tensor on the ``meta`` device (shape and dtype,
nothing allocated), where the reference gives ``jax.ShapeDtypeStruct``s:
the batch shapes ``train.build_train_step`` and ``dist.batch_specs`` take.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch_size: int
    seq_len: int
    seed: int = 0
    zipf_alpha: float = 1.1
    repeat_prob: float = 0.3


class SyntheticStream:
    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig | None = None):
        self.cfg = cfg
        self.model_cfg = model_cfg

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.Generator(np.random.Philox(key=[c.seed, index]))
        b, s = c.batch_size, c.seq_len
        # Zipf-ish unigram draw via inverse-CDF power law.
        u = rng.random((b, s + 1))
        base = np.minimum(
            (c.vocab_size * u ** c.zipf_alpha).astype(np.int64),
            c.vocab_size - 1,
        )
        # Short-range structure: repeat the previous token with prob p.
        rep = rng.random((b, s + 1)) < c.repeat_prob
        toks = base.copy()
        for col in range(1, s + 1):
            toks[:, col] = np.where(rep[:, col], toks[:, col - 1], toks[:, col])
        out = {
            "tokens": toks[:, :s].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        mc = self.model_cfg
        if mc is not None and mc.frontend and mc.frontend.kind == "vision_stub":
            # Precomputed patch embeddings (the SigLIP stub): deterministic.
            p = mc.frontend.n_prefix_tokens
            out["patches"] = rng.standard_normal(
                (b, p, mc.d_model)).astype(np.float32) * 0.02
        return out

    def __iter__(self):
        i = 0
        while True:
            yield self.batch(i)
            i += 1


# --- input specs ---------------------------------------------------------------------


def input_specs(
    cfg: ModelConfig,
    *,
    mode: str,                  # "train" | "prefill" | "decode"
    batch: int,
    seq: int,
) -> Dict[str, torch.Tensor]:
    """``meta`` tensors standing in for every model input of a cell."""
    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    i32, f32 = torch.int32, torch.float32
    if mode == "decode":
        return {"tokens": spec((batch, 1), i32)}
    specs: Dict[str, torch.Tensor] = {}
    if cfg.frontend and cfg.frontend.kind == "vision_stub":
        p = cfg.frontend.n_prefix_tokens
        text = max(seq - p, 1)
        specs["patches"] = spec((batch, p, cfg.d_model), f32)
        specs["tokens"] = spec((batch, text), i32)
        if mode == "train":
            specs["labels"] = spec((batch, text), i32)
        return specs
    specs["tokens"] = spec((batch, seq), i32)
    if mode == "train":
        specs["labels"] = spec((batch, seq), i32)
    return specs
