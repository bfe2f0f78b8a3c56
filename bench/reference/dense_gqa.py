"""Plain PyTorch reference of a dense GQA decoder (SmolLM, Yi), its loss,
gradients and AdamW step.

Float32 throughout, with TF32 off (:func:`exact_matmuls`); no kernel, no
cache, no batching across requests.  The block is the Llama-style one these
models publish: RMSNorm before attention and before the MLP, rotary
positions by half rotation (theta from the configuration) on q and k,
grouped-query attention (query head h reads key/value head h // (Hq /
Hkv)) under a causal mask, SwiGLU (``wo(silu(x wg) * (x wi))``), a final
RMSNorm and the output head (the embedding, transposed, when tied).  The
loss is the mean next-token cross entropy over every position.

``precision="fp8"`` is the control: every matrix product takes both its
operands rounded to float8 e4m3, each tensor scaled by its own absolute
maximum (the step below the configuration's bf16 compute).  Rounding is
straight-through under autograd.

Departures from the published descriptions, each the program's stated
behaviour: the norms' eps and rope theta come from the configuration file;
AdamW (:func:`adamw_step`) clips by the global norm and decays every leaf
of rank 2, counting a per-layer leaf's layer axis, so the per-layer norm
gains are decayed and the final norm's is not.

Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

Weights = Mapping[str, torch.Tensor]
E4M3_MAX = 448.0


def exact_matmuls() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in
    float32; straight-through under autograd."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x).detach()


class Decoder:
    """The reference model over ``weights`` (leaf name -> float32 tensor)."""

    def __init__(self, cfg: Mapping, weights: Weights,
                 precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.cfg, self.w, self.precision = cfg, weights, precision
        self.hd = cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]

    # -- pieces -------------------------------------------------------------

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            a, b = fp8_round(a), fp8_round(b)
        return torch.matmul(a, b)

    def _norm(self, x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.cfg["norm_eps"]) * gain

    def _rope(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        freqs = 1.0 / (self.cfg["rope_theta"] ** (
            torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
        ang = positions[:, None].to(torch.float32) * freqs     # (S, d/2)
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :d // 2], x[..., d // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attention(self, x: torch.Tensor, i: int) -> torch.Tensor:
        cfg, w, hd = self.cfg, self.w, self.hd
        p = f"layers.{i}.attn."
        b, s, _ = x.shape
        hq, hkv = cfg["n_heads"], cfg["n_kv_heads"]
        q = self._mm(x, w[p + "wq"]).view(b, s, hq, hd).transpose(1, 2)
        k = self._mm(x, w[p + "wk"]).view(b, s, hkv, hd).transpose(1, 2)
        v = self._mm(x, w[p + "wv"]).view(b, s, hkv, hd).transpose(1, 2)
        pos = torch.arange(s, device=x.device)
        q, k = self._rope(q, pos), self._rope(k, pos)
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
        scores = self._mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        o = self._mm(torch.softmax(scores, dim=-1), v)
        o = o.transpose(1, 2).reshape(b, s, hq * hd)
        return self._mm(o, w[p + "wo"])

    def _layer(self, x: torch.Tensor, i: int) -> torch.Tensor:
        w, p = self.w, f"layers.{i}."
        x = x + self._attention(self._norm(x, w[p + "ln1"]), i)
        h = self._norm(x, w[p + "ln2"])
        g = F.silu(self._mm(h, w[p + "mlp.wg"])) * self._mm(h, w[p + "mlp.wi"])
        return x + self._mm(g, w[p + "mlp.wo"])

    def _head(self) -> torch.Tensor:
        return (self.w["embed"].T if self.cfg.get("tie_embeddings")
                else self.w["lm_head"])

    # -- entry points -------------------------------------------------------

    def hidden(self, tokens: torch.Tensor, checkpoint: bool = False
               ) -> torch.Tensor:
        """(B, S) token ids -> the final norm's output (B, S, d)."""
        x = self.w["embed"][tokens.long()]
        for i in range(self.cfg["n_layers"]):
            if checkpoint and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(
                    self._layer, x, i, use_reentrant=False)
            else:
                x = self._layer(x, i)
        return self._norm(x, self.w["final_norm"])

    @torch.no_grad()
    def logits_at(self, tokens: torch.Tensor,
                  positions: Sequence[int]) -> torch.Tensor:
        """One sequence (S,) -> the logits (len(positions), V) at those
        positions, float32."""
        h = self.hidden(tokens[None])[0]
        idx = torch.as_tensor(list(positions), device=h.device)
        return self._mm(h[idx], self._head())

    def loss_sum(self, tokens: torch.Tensor, labels: torch.Tensor,
                 checkpoint: bool = True) -> torch.Tensor:
        """Summed next-token cross entropy of (B, S) rows."""
        h = self.hidden(tokens, checkpoint=checkpoint)
        logits = self._mm(h, self._head())
        return F.cross_entropy(logits.flatten(0, 1), labels.long().flatten(),
                               reduction="sum")


# -- training ------------------------------------------------------------------


def lr_at(step: int, base_lr: float, warmup_steps: int, total_steps: int,
          final_frac: float = 0.1) -> float:
    """Linear warm-up, then cosine to ``final_frac`` of the base rate."""
    if step < warmup_steps:
        return base_lr * (step + 1) / max(1, warmup_steps)
    t = min(max((step - warmup_steps) / max(1, total_steps - warmup_steps),
                0.0), 1.0)
    return base_lr * (final_frac + (1 - final_frac)
                      * 0.5 * (1 + math.cos(math.pi * t)))


def decays(name: str, p: torch.Tensor) -> bool:
    """Rank 2 or more, a per-layer leaf counting its layer axis."""
    return p.ndim + name.startswith("layers.") >= 2


@torch.no_grad()
def adamw_step(params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: Dict, lr: float,
               hyper: Mapping) -> Dict[str, torch.Tensor]:
    """One AdamW step in place; returns the gradients as clipped."""
    state["count"] += 1
    t = state["count"]
    gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                          for g in grads.values()))
    clip = hyper["clip_norm"]
    scale = min(1.0, clip / max(gnorm, 1e-9)) if clip > 0 else 1.0
    b1, b2 = hyper["b1"], hyper["b2"]
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    clipped = {}
    for name, p in params.items():
        g = grads[name] * scale
        clipped[name] = g
        m = state["mu"].setdefault(name, torch.zeros_like(p))
        v = state["nu"].setdefault(name, torch.zeros_like(p))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (m / c1) / (torch.sqrt(v / c2) + hyper["eps"])
        if hyper["weight_decay"] > 0 and decays(name, p):
            upd = upd + hyper["weight_decay"] * p
        p.sub_(lr * upd)
    return clipped


def train_steps(cfg: Mapping, weights: Dict[str, torch.Tensor],
                batches: Sequence[Mapping[str, torch.Tensor]],
                hyper: Mapping, precision: str = "float32",
                rows: Optional[int] = None) -> Dict[str, object]:
    """Train ``weights`` (changed in place) through ``batches`` ->
    ``losses`` a step, ``grad_norms`` (leaf -> norm of the first step's
    clipped gradient) and ``change_norms`` (leaf -> norm of the change
    over all steps).  ``rows`` keeps only the first rows of each batch
    (the half-batch fault); the loss is the mean over the rows kept.
    Gradients are accumulated one row at a time, each layer recomputed in
    the backward pass, so a long sequence fits."""
    model = Decoder(cfg, weights, precision)
    start = {n: p.detach().clone() for n, p in weights.items()}
    state: Dict = {"count": 0, "mu": {}, "nu": {}}
    out: Dict[str, object] = {"losses": []}
    adam = hyper["adamw"]
    for step, batch in enumerate(batches):
        tokens, labels = batch["tokens"], batch["labels"]
        if rows is not None:
            tokens, labels = tokens[:rows], labels[:rows]
        count = tokens.numel()
        for p in weights.values():
            p.requires_grad_(True)
            p.grad = None
        total = 0.0
        for r in range(tokens.shape[0]):
            with torch.enable_grad():
                loss = model.loss_sum(tokens[r:r + 1], labels[r:r + 1])
                (loss / count).backward()
            total += float(loss.detach())
        grads = {n: p.grad for n, p in weights.items()}
        for p in weights.values():
            p.requires_grad_(False)
            p.grad = None
        out["losses"].append(total / count)
        lr = lr_at(step, hyper["base_lr"], hyper["warmup_steps"],
                   hyper["total_steps"])
        clipped = adamw_step(weights, grads, state, lr, adam)
        if step == 0:
            out["grad_norms"] = {n: float(torch.linalg.vector_norm(g))
                                 for n, g in clipped.items()}
        del grads, clipped
    out["change_norms"] = {n: float(torch.linalg.vector_norm(p - start[n]))
                           for n, p in weights.items()}
    return out


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
