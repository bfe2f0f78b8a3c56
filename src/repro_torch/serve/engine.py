"""Batched serving engine: prefill + greedy/temperature decode loop — twin
of ``repro.serve.engine`` on one device.

The engine owns one device and the model's weights on it: one cluster in
the offload runtime's terms.  Its counters (``stats``) mean what the
reference engine's mean on a 1×1 mesh, under the same key names
(``xla_dispatches`` counts the port's dispatches: one decode step, or one
chunk of steps).  The reference's jitted program builders become plain
closures over the model (``build_serve_step``, ``build_sampling_step``,
``build_decode_chunk``, ``build_ragged_step``); PyTorch runs them eagerly
and the card queues their work asynchronously.

Decode modes, as in the reference:

* ``decode_mode="step"`` (default) — sampling runs on the device after each
  step; the token never visits the host between steps.  Zero
  host->device transfers per decoded token.
* ``decode_mode="chunk"`` — ``decode_chunk`` steps per dispatch, counted
  as one job by the CompletionUnit.  Here it is a loop of single steps
  (capturing it as one CUDA graph is later work); a trailing remainder
  runs through the single-step closure, as in the reference.
* ``decode_mode="host"`` — the host round-trip loop: fetch the logits,
  sample on the host, upload the token.  The measurable "before".

Continuous batching (``generate_many``) runs the reference's slot
scheduler: bucketed prefill-inserts of ``prompt[:-1]`` into free slots'
cache rows, one ragged decode step advancing every occupied slot, retire on
the done-mask and refill from the queue, and one drain of the tokens at the
end.  As in the reference it needs the plain attention family: it raises
:class:`NotImplementedError` for the ``ssm`` and ``hybrid`` families, MLA
and the modality frontends.  ``generate`` serves the ``ssm`` family
(falcon-mamba) with its state cache (``conv``, ``h``, ``pos``).

Sampling: temperature sampling draws from a ``torch.Generator`` seeded with
``ServeConfig.seed`` on each call (Gumbel-max over ``logits /
temperature``); the draws follow the steps, so ``step`` and ``chunk`` emit
the same tokens.  ``jax.random`` cannot be reproduced, so only greedy
decoding equals the reference token for token.

The caches are updated in place (the reference donates them to each
program).  ``ServeTenant`` waits for ``core/fabric.py`` (ROADMAP.md Queue 1
item 10).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import broadcast as bc
from repro_torch.core.completion import CompletionUnit
from repro_torch.core.policy import Staging, coerce_enum
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    CallConfig, Transformer, decode_step, decode_step_ragged, init_cache,
    prefill,
)


class _ByteCounter:
    """Duck-typed stats sink for :mod:`repro_torch.core.broadcast`."""

    def __init__(self):
        self.h2d_bytes = 0
        self.d2d_bytes = 0


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """The engine's device: the card unless the caller asks for the CPU.
    Raises when CUDA is asked for (explicitly or by default) and absent."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the serve engine runs on a CUDA device and none is present; "
                "pass device='cpu' to serve on the CPU")
        if dev.index is None:        # as tensors report it: cuda:<current>
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _sampler(temperature: float):
    """(logits (B, V), generator) -> (B,) int32."""
    def sample(logits: torch.Tensor, generator: torch.Generator):
        if temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device, dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits.to(torch.float32) / temperature + gumbel,
                            dim=-1).to(torch.int32)
    return sample


def build_serve_step(model: Transformer, cfg: ModelConfig,
                     call: CallConfig = CallConfig()):
    """-> step(cache, tokens (B, 1)) -> (logits (B, 1, V), cache)."""
    def step(cache, tokens):
        return decode_step(model, cfg, cache, tokens, call)
    return step


def build_sampling_step(model: Transformer, cfg: ModelConfig,
                        temperature: float,
                        call: CallConfig = CallConfig()):
    """Device-resident decode+sample, one token per call:
    (cache, tok (B, 1), generator) -> (next tok (B, 1), cache)."""
    sample = _sampler(temperature)

    def step(cache, tok, generator):
        logits, cache = decode_step(model, cfg, cache, tok, call)
        return sample(logits[:, 0], generator)[:, None], cache
    return step


def build_decode_chunk(model: Transformer, cfg: ModelConfig,
                       temperature: float, chunk: int,
                       call: CallConfig = CallConfig()):
    """``chunk`` tokens per call, a loop of the single step's body:
    (cache, tok (B, 1), generator) -> (toks (B, chunk), tok', cache)."""
    step = build_sampling_step(model, cfg, temperature, call)

    def chunk_fn(cache, tok, generator):
        toks = []
        for _ in range(chunk):
            tok, cache = step(cache, tok, generator)
            toks.append(tok)
        return torch.cat(toks, dim=1), tok, cache
    return chunk_fn


def build_ragged_step(model: Transformer, cfg: ModelConfig,
                      temperature: float,
                      call: CallConfig = CallConfig()):
    """Continuous-batching decode step: per-slot positions + done-mask.

    (cache, tok (B,1), pos_b (B,), active (B,), generator) ->
        (next tok (B,1), pos_b', cache).
    Free slots (``active == 0``) hold their position, so their writes stay
    confined to one stale cell that the next prefill-insert overwrites.
    """
    sample = _sampler(temperature)

    def step(cache, tok, pos_b, active, generator):
        logits, cache = decode_step_ragged(model, cfg, cache, tok, pos_b,
                                           call)
        nxt = sample(logits[:, 0], generator)
        return nxt[:, None], pos_b + active.to(pos_b.dtype), cache
    return step


@dataclasses.dataclass
class ServeConfig:
    batch: int = 8
    max_len: int = 256
    temperature: float = 0.0         # 0 = greedy
    seed: int = 0
    decode_mode: str = "step"        # "step" | "chunk" | "host" (legacy)
    decode_chunk: int = 8            # tokens per dispatch in "chunk" mode
    prefill_bucket: int = 16         # generate_many pads prefills to this
                                     # granularity
    staging: Staging = Staging.DIRECT  # weight placement and prefill
                                     # inserts: DIRECT | TREE | TREE_RESHARD
                                     # (repro_torch.core.policy.Staging).
                                     # Raw strings are accepted with a
                                     # DeprecationWarning.

    def __post_init__(self):
        self.staging = coerce_enum(Staging, self.staging, "staging",
                                   warn_legacy=True)
        if self.staging is Staging.HOST_FANOUT:
            valid = tuple(m.value for m in Staging
                          if m is not Staging.HOST_FANOUT)
            raise ValueError(f"staging {self.staging.value!r} not in {valid}")


class ServeEngine:
    """Static-batch decode engine with per-slot generation state.

    ``params`` is a :class:`Transformer`.  On the engine's device it is
    used as it is; elsewhere (host weights) call :meth:`place_params`
    first — it places the weights under ``scfg.staging`` and records the
    link bytes in ``stats``.  ``device=None`` means the card, and raises
    without one.
    """

    def __init__(self, cfg: ModelConfig, params: Transformer,
                 scfg: ServeConfig,
                 call: CallConfig = CallConfig(), *,
                 device: Union[None, str, torch.device] = None):
        self.cfg, self.scfg, self.call = cfg, scfg, call
        self.device = resolve_device(device)
        self.params = params
        self.unit = CompletionUnit(n_units=8)
        self._jobid = 0
        # the engine's one cluster, for tree staging
        self._stager: Optional[bc.TreeStager] = None
        self.stats = {"h2d_token_puts": 0, "xla_dispatches": 0,
                      "tokens_emitted": 0, "prefill_inserts": 0,
                      "requests_retired": 0, "batch_padded_rows": 0,
                      "h2d_bytes": 0, "d2d_bytes": 0}

    # -- placement (weights + prefill inserts) -------------------------------------

    def _get_stager(self) -> bc.TreeStager:
        if self._stager is None:
            self._stager = bc.TreeStager(self.device, [0])
        return self._stager

    def _put_replicated(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` onto the engine's device under ``scfg.staging``, link
        bytes counted."""
        place = bc.Placement(1)
        counted = _ByteCounter()
        if self.scfg.staging in bc.TREE_MODES:
            out = self._get_stager().put_replicated(
                arr, reshard=self.scfg.staging == "tree_reshard",
                stats=counted)
        else:
            counted.h2d_bytes += bc.placement_bytes(arr, place)
            out = bc.upload(place.to_clusters(arr), self.device)
        self.stats["h2d_bytes"] += counted.h2d_bytes
        self.stats["d2d_bytes"] += counted.d2d_bytes
        return out[0]

    def place_params(self, host_params: Transformer) -> Transformer:
        """Place host-side weights onto the device and adopt them.

        Every leaf is replicated onto the engine's one cluster; under
        ``staging="tree"`` it goes through the broadcast tree's stager,
        else directly.  ``stats["h2d_bytes"]`` / ``["d2d_bytes"]`` record
        the link traffic as the reference's ``place_params`` does.
        """
        host = {name: t.detach().cpu().numpy()
                for name, t in host_params.state_dict().items()}
        placements = {name: bc.Placement(1) for name in host}
        counted = _ByteCounter()
        if self.scfg.staging in bc.TREE_MODES:
            placed = bc.place_pytree(
                host, placements, self._get_stager(),
                reshard=self.scfg.staging == "tree_reshard", stats=counted)
        else:
            placed = {}
            for name, arr in host.items():
                counted.h2d_bytes += bc.placement_bytes(arr, placements[name])
                placed[name] = bc.upload(placements[name].to_clusters(arr),
                                         self.device)
        self.stats["h2d_bytes"] += counted.h2d_bytes
        self.stats["d2d_bytes"] += counted.d2d_bytes
        model = Transformer(self.cfg, device="meta")
        model.load_state_dict({k: v[0] for k, v in placed.items()},
                              assign=True)
        self.params = model
        return model

    def _model(self) -> Transformer:
        if self.params.device != self.device:
            raise RuntimeError(
                f"the weights lie on {self.params.device}, the engine on "
                f"{self.device}: call place_params first")
        return self.params

    # -- generation ---------------------------------------------------------------

    def generate(self, prompts: np.ndarray, n_new: int) -> np.ndarray:
        """prompts: (b, S_prompt) int32 -> (b, n_new) generated ids.

        ``b`` may be any size up to the configured batch: a sub-batch is
        padded to ``scfg.batch`` (repeating the last prompt row) and the
        output sliced back.  Batch rows are computed independently, so
        padding does not change the real rows' tokens.  (The reference's
        ``extra_inputs`` feed the modality frontends, which come with
        ROADMAP.md Queue 1 item 12.)
        """
        model = self._model()
        prompts = np.asarray(prompts)
        b = prompts.shape[0]
        if b > self.scfg.batch:
            raise ValueError(
                f"batch {b} exceeds configured batch {self.scfg.batch}")
        if b < self.scfg.batch:
            pad = self.scfg.batch - b
            self.stats["batch_padded_rows"] += pad
            prompts = np.concatenate(
                [prompts, np.broadcast_to(
                    prompts[-1:], (pad,) + prompts.shape[1:])], axis=0)
        mode = self.scfg.decode_mode
        if mode not in ("host", "step", "chunk"):
            raise ValueError(f"decode_mode {mode!r} not in host/step/chunk")
        tokens = torch.as_tensor(prompts).to(self.device)
        logits, cache = prefill(model, self.cfg, {"tokens": tokens},
                                self.scfg.max_len, self.call)
        if mode == "host":
            out = self._generate_host_loop(model, logits, cache, n_new)
        else:
            out = self._generate_resident(model, logits, cache, n_new)
        return out[:b]

    def _generator(self, device: torch.device) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(self.scfg.seed)

    def _generate_resident(self, model, logits, cache,
                           n_new: int) -> np.ndarray:
        """Device-resident decode: the token never visits the host."""
        gen = self._generator(self.device)
        sample = _sampler(self.scfg.temperature)
        tok = sample(logits[:, -1], gen)[:, None]
        # the prefill-token sample is a dispatch emitting token 0
        self.stats["xla_dispatches"] += 1
        self.stats["tokens_emitted"] += 1
        toks = [tok]
        steps = n_new - 1
        done = 0
        if self.scfg.decode_mode == "chunk" and self.scfg.decode_chunk > 1:
            c = self.scfg.decode_chunk
            chunk_fn = build_decode_chunk(model, self.cfg,
                                          self.scfg.temperature, c, self.call)
            while steps - done >= c:
                job = self._dispatch_begin()
                ys, tok, cache = chunk_fn(cache, tok, gen)
                self._dispatch_end(job, tokens=c)
                toks.append(ys)
                done += c
        if done < steps:
            step_fn = build_sampling_step(model, self.cfg,
                                          self.scfg.temperature, self.call)
            while done < steps:
                job = self._dispatch_begin()
                tok, cache = step_fn(cache, tok, gen)
                self._dispatch_end(job, tokens=1)
                toks.append(tok)
                done += 1
        out = torch.cat(toks, dim=1).cpu().numpy()     # the one drain
        if out.shape[1] != n_new:
            raise AssertionError((out.shape, n_new))
        return out

    def _generate_host_loop(self, model, logits, cache,
                            n_new: int) -> np.ndarray:
        """The host round trip: sample on the host, upload each token."""
        sample = _sampler(self.scfg.temperature)
        gen = self._generator(torch.device("cpu"))
        step_fn = build_serve_step(model, self.cfg, self.call)
        out = []
        tok = sample(logits[:, -1].cpu(), gen)
        for _ in range(n_new):
            out.append(tok)
            job = self._dispatch_begin()
            tok_dev = tok[:, None].to(self.device)
            self.stats["h2d_token_puts"] += 1
            logits, cache = step_fn(cache, tok_dev)
            tok = sample(logits[:, 0].cpu(), gen)
            self._dispatch_end(job, tokens=1)
        return torch.stack(out, dim=1).numpy()

    # -- continuous batching -------------------------------------------------------

    def generate_many(self, requests: Sequence[Tuple[np.ndarray, int]],
                      arrival_steps: Optional[Sequence[int]] = None
                      ) -> List[np.ndarray]:
        """Continuous batching over ``requests`` = [(prompt, n_new), ...].

        Prompts are variable-length 1-D int32 arrays.  Requests are
        admitted into free slots of the fixed decode batch in arrival
        order; each decode step advances every occupied slot through one
        ragged step; a slot that has emitted its ``n_new`` tokens retires
        and refills from the queue.  Returns the (n_new_r,) generated ids
        per request, in request order.  ``arrival_steps`` gives each
        request the earliest decode step at which it may be admitted;
        steps where the batch is idle are skipped, not decoded.  Greedy
        outputs are schedule-independent.
        """
        if (self.cfg.family in ("ssm", "hybrid") or self.cfg.mla
                or self.cfg.frontend):
            raise NotImplementedError(
                "continuous batching requires the plain attention family "
                "(ragged per-slot cache positions; modality-prefix "
                "frontends would shift every slot's positions)")
        model = self._model()
        scfg = self.scfg
        reqs = [(np.asarray(p, np.int32).ravel(), int(m))
                for p, m in requests]
        R = len(reqs)
        arrivals = ([0] * R if arrival_steps is None
                    else [int(a) for a in arrival_steps])
        if len(arrivals) != R:
            raise ValueError(
                f"{len(arrivals)} arrival steps for {R} requests")
        for prompt, m in reqs:
            if prompt.size < 1:
                raise ValueError("empty prompt")
            if m < 1:
                raise ValueError(f"n_new must be >= 1, got {m}")
            if prompt.size - 1 + m > scfg.max_len:
                raise ValueError(
                    f"prompt ({prompt.size}) + n_new ({m}) exceeds "
                    f"max_len {scfg.max_len}")

        step_fn = build_ragged_step(model, self.cfg, scfg.temperature,
                                    self.call)
        B = scfg.batch
        dev = self.device
        cache = init_cache(self.cfg, B, scfg.max_len, device=dev)
        tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        pos_b = torch.zeros((B,), dtype=torch.int32, device=dev)
        active = torch.zeros((B,), dtype=torch.int32, device=dev)
        gen = self._generator(dev)

        slots: List[Optional[Dict[str, int]]] = [None] * B
        free = list(range(B))
        order = sorted(range(R), key=lambda r: (arrivals[r], r))
        queue: collections.deque = collections.deque()
        step_log: List[Tuple[torch.Tensor, List[Tuple[int, int]]]] = []
        t = 0
        pi = 0
        while pi < R or queue or any(s is not None for s in slots):
            while pi < R and arrivals[order[pi]] <= t:
                queue.append(order[pi])
                pi += 1
            # prefill-insert: refill free slots from the queue
            while queue and free:
                r = queue.popleft()
                j = free.pop(0)
                tok = self._insert(model, cache, tok, pos_b, active, j,
                                   reqs[r][0])
                slots[j] = {"req": r, "remaining": reqs[r][1]}
            if all(s is None for s in slots):
                t = arrivals[order[pi]]     # batch idle: skip to next arrival
                continue
            # one resident decode step advances every occupied slot
            job = self._dispatch_begin()
            tok, pos_b, cache = step_fn(cache, tok, pos_b, active, gen)
            live = [(j, s["req"]) for j, s in enumerate(slots)
                    if s is not None]
            self._dispatch_end(job, tokens=len(live))
            step_log.append((tok, live))
            for j, s in enumerate(slots):
                if s is None:
                    continue
                s["remaining"] -= 1
                if s["remaining"] == 0:     # done-mask: retire the slot
                    slots[j] = None
                    free.append(j)
                    free.sort()
                    active[j] = 0
                    self.stats["requests_retired"] += 1
            t += 1

        # tokens stayed device-resident throughout; one drain at the end
        results: List[List[int]] = [[] for _ in range(R)]
        if step_log:
            fetched = torch.stack([tk for tk, _ in step_log]).cpu().numpy()
            for tk_host, (_, live) in zip(fetched, step_log):
                for j, r in live:
                    results[r].append(tk_host[j, 0])
        return [np.asarray(seq, np.int32) for seq in results]

    def _insert(self, model, cache, tok, pos_b, active, slot: int,
                prompt: np.ndarray) -> torch.Tensor:
        """Admit ``prompt`` into ``slot``: bucketed prefill of
        ``prompt[:-1]`` written into the slot's cache rows (in place); the
        last prompt token becomes the slot's pending decode token at
        position ``len(prompt) - 1``.  Returns the new token tensor (a
        copy: the old one is a logged step output)."""
        s = int(prompt.size)
        if s > 1:
            bucket = max(1, self.scfg.prefill_bucket)
            # bucketed up, but never past the cache length
            sb = min(-(-(s - 1) // bucket) * bucket, self.scfg.max_len)
            padded = np.zeros((1, sb), np.int32)
            padded[0, :s - 1] = prompt[:-1]
            _, pcache = prefill(model, self.cfg,
                                {"tokens": self._put_replicated(padded)},
                                self.scfg.max_len, self.call)
            cache["k"][:, slot:slot + 1] = pcache["k"]
            cache["v"][:, slot:slot + 1] = pcache["v"]
        tok = tok.clone()
        tok[slot, 0] = int(prompt[-1])
        self.stats["h2d_token_puts"] += 1   # the pending prompt token
        pos_b[slot] = s - 1
        active[slot] = 1
        self.stats["prefill_inserts"] += 1
        return tok

    # -- completion accounting (one offloaded job per dispatch) -------------------

    def _dispatch_begin(self) -> int:
        job = self._jobid
        self._jobid += 1
        self.unit.program(1, job)
        return job

    def _dispatch_end(self, job: int, tokens: int) -> None:
        self.unit.arrive(job, 1)   # the step's fused arrival reduction
        self.unit.collect(job)
        self.stats["xla_dispatches"] += 1
        self.stats["tokens_emitted"] += tokens
