"""Plain PyTorch reference of DeepSeek-V2's decoder (DeepSeek-V2-Lite:
arXiv:2405.04434 and its ``config.json``), its forward pass for serving.

Float32 throughout, with TF32 off (:func:`exact_matmuls`); no kernel, no
cache, no batching across requests, no capacity.  The block, as published:
RMSNorm before attention and before the feed-forward part; multi-head
latent attention without a query compression (q from x; the compressed KV
c and one rotary key shared by the heads from x, c normalised, K's nope
part and V up-projected from c), its rotary part under YaRN (DeepSeek-V2's
``yarn_find_correction_range``, ``yarn_linear_ramp_mask`` and
``yarn_get_mscale``) and its softmax scaled by (nope + rope)^-1/2 times
m(factor, mscale_all_dim)²; causal.  Layers before ``first_dense`` have a
SwiGLU MLP (``wo(silu(x wg) * (x wi))``); the others a softmax router
over the routed experts, the top k probabilities kept as they are
(``norm_topk_prob`` false) times ``routed_scaling_factor`` (1), each
routed expert a SwiGLU over only the tokens routed to it, and the shared
experts, one SwiGLU of their joint width, on every token.  A final
RMSNorm and the output head, computed only at the positions read.

The work is done in blocks so that a sequence of 13,809 positions fits
beside the weights: attention by blocks of query rows (each against the
keys it sees), each expert over its own tokens, the head at the positions
asked for.

``precision="fp8"`` is the control: every matrix product takes both its
operands rounded to float8 e4m3, each tensor scaled by its own absolute
maximum (the step below the configuration's bf16 compute).

Departures from the published model, each the program's stated behaviour:
the rotary dims are rotated by half rotation (the checkpoint stores them
interleaved and the published code de-interleaves them first: under random
weights a fixed permutation of the rope columns of ``wq`` and ``wdkv``,
so the same model); the router's top k is ``torch.topk``'s (a tie between
two random float32 probabilities does not occur); the weights are random,
from the seed.

Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import List, Mapping, Sequence

import torch
import torch.nn.functional as F

Weights = Mapping[str, torch.Tensor]
E4M3_MAX = 448.0
#: query rows a block of the attention computes at once
QUERY_BLOCK = 1024


def exact_matmuls() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in
    float32."""
    amax = x.abs().amax().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_bounds(rs: Mapping, dim: int, base: float):
    """DeepSeek-V2's ``yarn_find_correction_range``."""
    def dim_of(rotations: float) -> float:
        return (dim * math.log(rs["original_max_position_embeddings"]
                               / (rotations * 2 * math.pi))
                / (2 * math.log(base)))
    low = math.floor(dim_of(rs["beta_fast"]))
    high = math.ceil(dim_of(rs["beta_slow"]))
    return max(low, 0), min(high, dim - 1)


def inv_freq(cfg: Mapping, dim: int, device) -> torch.Tensor:
    """The rotary frequencies (dim/2,): YaRN's blend under
    ``rope_scaling``, else base^(-2i/dim)."""
    base = cfg["rope_theta"]
    extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))
    rs = cfg.get("rope_scaling")
    if not rs:
        return extra
    low, high = yarn_bounds(rs, dim, base)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return (extra / rs["factor"]) * (1 - mask) + extra * mask


class Decoder:
    """The reference model over ``weights`` (leaf name -> float32 tensor)."""

    def __init__(self, cfg: Mapping, weights: Weights,
                 precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.cfg, self.w, self.precision = cfg, weights, precision
        m = cfg["mla"]
        self.nope, self.rope = m["qk_nope_head_dim"], m["qk_rope_head_dim"]
        self.vd, self.rank = m["v_head_dim"], m["kv_lora_rank"]
        rs = cfg.get("rope_scaling")
        self.scale = (self.nope + self.rope) ** -0.5
        self.rope_gain = 1.0
        if rs:
            if rs.get("mscale_all_dim"):
                self.scale *= yarn_mscale(rs["factor"],
                                          rs["mscale_all_dim"]) ** 2
            self.rope_gain = (yarn_mscale(rs["factor"], rs.get("mscale", 1))
                              / yarn_mscale(rs["factor"],
                                            rs.get("mscale_all_dim", 0)))

    # -- pieces -------------------------------------------------------------

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            a, b = fp8_round(a), fp8_round(b)
        return torch.matmul(a, b)

    def _norm(self, x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.cfg["norm_eps"]) * gain

    def _rotate(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Half rotation of x (S, ..., rope) at positions ``pos`` (S,)."""
        d = x.shape[-1]
        ang = pos[:, None].to(torch.float32) * inv_freq(self.cfg, d, x.device)
        shape = (ang.shape[0],) + (1,) * (x.dim() - 2) + (d // 2,)
        cos = (torch.cos(ang) * self.rope_gain).view(shape)
        sin = (torch.sin(ang) * self.rope_gain).view(shape)
        x1, x2 = x[..., :d // 2], x[..., d // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _swiglu(self, x: torch.Tensor, p: str) -> torch.Tensor:
        w = self.w
        g = F.silu(self._mm(x, w[p + "wg"])) * self._mm(x, w[p + "wi"])
        return self._mm(g, w[p + "wo"])

    def _attention(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """MLA of one sequence x (S, d), causal."""
        w, h = self.w, self.cfg["n_heads"]
        p = f"layers.{i}.attn."
        s = x.shape[0]
        pos = torch.arange(s, device=x.device)
        q = self._mm(x, w[p + "wq"]).view(s, h, self.nope + self.rope)
        q = torch.cat([q[..., :self.nope],
                       self._rotate(q[..., self.nope:], pos)], dim=-1)
        ckv = self._mm(x, w[p + "wdkv"])
        c = self._norm(ckv[:, :self.rank], w[p + "kv_norm"])
        k_rope = self._rotate(ckv[:, self.rank:], pos)            # (S, rope)
        k_nope = self._mm(c, w[p + "wuk"]).view(s, h, self.nope)
        k = torch.cat([k_nope, k_rope[:, None].expand(s, h, self.rope)],
                      dim=-1).transpose(0, 1)                     # (H, S, qk)
        v = self._mm(c, w[p + "wuv"]).view(s, h, self.vd).transpose(0, 1)
        out = torch.empty(s, h * self.vd, dtype=x.dtype, device=x.device)
        for r0 in range(0, s, QUERY_BLOCK):
            r1 = min(r0 + QUERY_BLOCK, s)
            qb = q[r0:r1].transpose(0, 1)                         # (H, b, qk)
            scores = self._mm(qb, k[:, :r1].transpose(1, 2)) * self.scale
            rows = torch.arange(r0, r1, device=x.device)[:, None]
            cols = torch.arange(r1, device=x.device)[None, :]
            scores = scores.masked_fill(cols > rows, float("-inf"))
            o = self._mm(torch.softmax(scores, dim=-1), v[:, :r1])
            out[r0:r1] = o.transpose(0, 1).reshape(r1 - r0, h * self.vd)
            del scores, o
        return self._mm(out, w[p + "wo"])

    def _moe(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """The routed experts, each over its own tokens, and the shared."""
        cfg, w = self.cfg, self.w
        moe, p = cfg["moe"], f"layers.{i}.moe."
        probs = torch.softmax(self._mm(x, w[p + "router"]), dim=-1)
        top, idx = torch.topk(probs, moe["top_k"], dim=-1)       # (S, k)
        if moe.get("norm_topk", True):
            top = top / top.sum(-1, keepdim=True)
        top = top * cfg.get("routed_scaling_factor", 1.0)
        y = torch.zeros_like(x)
        for e in range(moe["n_experts"]):
            tok, slot = torch.nonzero(idx == e, as_tuple=True)
            if tok.numel() == 0:
                continue
            xe = x[tok]
            g = (F.silu(self._mm(xe, w[p + "experts.wg"][e]))
                 * self._mm(xe, w[p + "experts.wi"][e]))
            ye = self._mm(g, w[p + "experts.wo"][e])
            y.index_add_(0, tok, ye * top[tok, slot][:, None])
        if moe.get("n_shared"):
            y = y + self._swiglu(x, p + "shared.")
        return y

    def _layer(self, x: torch.Tensor, i: int) -> torch.Tensor:
        w, p = self.w, f"layers.{i}."
        x = x + self._attention(self._norm(x, w[p + "ln1"]), i)
        h = self._norm(x, w[p + "ln2"])
        if i < self.cfg["moe"].get("first_dense", 0):
            return x + self._swiglu(h, p + "mlp.")
        return x + self._moe(h, i)

    # -- entry points -------------------------------------------------------

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """One sequence (S,) of token ids -> the last layer's output (S,
        d), before the final norm."""
        x = self.w["embed"][tokens.long()]
        for i in range(self.cfg["n_layers"]):
            x = self._layer(x, i)
        return x

    @torch.no_grad()
    def logits_at(self, tokens: torch.Tensor,
                  positions: Sequence[int]) -> torch.Tensor:
        """One sequence (S,) -> the logits (len(positions), V) at those
        positions, float32."""
        h = self.hidden(tokens)
        idx = torch.as_tensor(list(positions), device=h.device)
        head = (self.w["embed"].T if self.cfg.get("tie_embeddings")
                else self.w["lm_head"])
        return self._mm(self._norm(h[idx], self.w["final_norm"]), head)


def served_logits(cfg: Mapping, weights: Weights, prompt: torch.Tensor,
                  served: torch.Tensor, precision: str = "float32"
                  ) -> torch.Tensor:
    """The logits (n, V) from which each of the ``n`` served tokens was
    chosen: the prompt and the served tokens but the last, read at the
    prompt's last position and the served tokens' but the last."""
    tokens = torch.cat([prompt, served[:-1]])
    p = prompt.numel()
    return Decoder(cfg, weights, precision).logits_at(
        tokens, range(p - 1, p - 1 + served.numel()))


def gaps(ref: torch.Tensor, chosen: torch.Tensor) -> List[float]:
    """How far each chosen token's reference logit lies below the
    reference's best, per row."""
    best = ref.max(dim=-1).values
    got = ref.gather(-1, chosen.long()[:, None])[:, 0]
    return (best - got).tolist()
