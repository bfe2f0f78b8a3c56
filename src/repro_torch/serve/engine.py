"""Batched serving engine: prefill + greedy/temperature decode loop — twin
of ``repro.serve.engine`` on one device.

The engine runs on one device and the model's weights on it.  It serves a
window of the device's logical clusters (``cluster_ids``; one cluster by
default), where the reference serves a (k, 1) mesh of k devices, each with
its own replica of the weights.  Here the window's clusters share one copy
of the weights on the device, and ``stats`` counts the link bytes the
reference's placement moves for the same window (k replicas under
``direct``; one upload and k - 1 fan-out copies under the tree modes), so
its counters mean what the reference engine's mean, under the same key
names (``xla_dispatches`` counts the port's dispatches: one decode step,
or one chunk of steps).  The batch is not split over the window: batch
rows are computed independently, so greedy tokens do not depend on it.
The reference's jitted program builders become plain closures over the
model (``build_serve_step``, ``build_sampling_step``,
``build_decode_chunk``, ``build_ragged_step``).  On the card the engine
runs each as a captured CUDA graph (``core/graphs.py``), one per (mode,
batch, max_len, chunk, temperature), captured at its first call and
replayed across ``generate`` calls: the engine owns one static decode
state per (batch, max_len) — the cache prefill writes into, the pending
token, the ragged positions — which the graphs read and rewrite in place,
and it copies each step's tokens out on the launch stream.  Its sampling
generator is registered with every graph, so a replay draws what the
eager body would.  Prefill stays eager.  On the CPU the same bodies run
eagerly.

Decode modes, as in the reference:

* ``decode_mode="step"`` (default) — sampling runs on the device after each
  step; the token never visits the host between steps.  Zero
  host->device transfers per decoded token.
* ``decode_mode="chunk"`` — ``decode_chunk`` steps per dispatch, counted
  as one job by the CompletionUnit: on the card one graph replay; a
  trailing remainder runs through the single-step program, as in the
  reference.
* ``decode_mode="host"`` — the host round-trip loop: fetch the logits,
  sample on the host, upload the token.  The measurable "before".

Continuous batching (``generate_many``) runs the reference's slot
scheduler: bucketed prefill-inserts of ``prompt[:-1]`` into free slots'
cache rows, one ragged decode step advancing every occupied slot, retire on
the done-mask and refill from the queue, and one drain of the tokens at the
end.  As in the reference it needs GQA attention (the dense family, or
MoE with GQA such as llama4-scout): it raises
:class:`NotImplementedError` for the ``ssm`` and ``hybrid`` families, MLA
and the modality frontends.  Beside the reference's counters, ``stats``
holds the host nanoseconds of the continuous batching (``HOST_NS``: the
whole call, its inserts, its ragged steps' launches, its retires, its
drain), and a
call records the spans ``serve.*`` (``core/trace.py``) while tracing is
on.  ``generate`` serves the ``ssm`` family
(falcon-mamba) with its state cache (``conv``, ``h``, ``pos``), the
``hybrid`` family (zamba2) with its state cache and the shared block's
K/V, one slot per application (``conv``, ``h``, ``k``, ``v``, ``pos``),
MLA (deepseek-v2-lite) with its compressed cache (``c``, ``krope``,
``pos``), and the frontends: the vision stub's patches come in
``extra_inputs`` and take the cache's first positions (paligemma), the
audio stub needs none (musicgen).  MoE layers route without drops in
every serving program (``SERVE_CALL``), as the reference's do.

Sampling: temperature sampling draws from a ``torch.Generator`` seeded with
``ServeConfig.seed`` on each call (Gumbel-max over ``logits /
temperature``); the draws follow the steps, so ``step`` and ``chunk`` emit
the same tokens.  ``jax.random`` cannot be reproduced, so only greedy
decoding equals the reference token for token.

The caches are updated in place (the reference donates them to each
program).

``ServeTenant`` serves as a lease-holding tenant of a
:class:`~repro_torch.core.fabric.FabricScheduler`: a floor lease between
decode bursts, grown into the free clusters for each burst, with one engine
per distinct window (its own caches and counters) and one copy of the
weights shared by all of them.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import broadcast as bc
from repro_torch.core import graphs, trace
from repro_torch.core.completion import CompletionUnit
from repro_torch.core.fabric import (
    ClusterLease, FabricScheduler, LeaseUnavailable, Tenant,
)
from repro_torch.core.offload import resolve_device
from repro_torch.core.policy import Staging, TenantKind, coerce_enum
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    CallConfig, Transformer, decode_step, decode_step_ragged, init_cache,
    prefill, prefix_tokens,
)


#: the serving programs' call: exact MoE routing (C = tokens), as the
#: reference's engine and its `build_*` programs default to
SERVE_CALL = CallConfig(moe_no_drop=True)

#: the host nanoseconds ``generate_many`` adds to ``stats``: the whole
#: call, its inserts, its ragged steps from the launch through the
#: dispatch's end, its retire loops, and its drain; each part includes
#: whatever wait for the device its own calls meet
HOST_NS = ("call_host_ns", "insert_host_ns", "step_host_ns",
           "retire_host_ns", "drain_host_ns")
#: every counter of ``stats`` the reference's engine does not keep: the
#: host nanoseconds above, and ``generate``'s prefilled positions and
#: host nanoseconds
PORT_COUNTERS = HOST_NS + ("prefill_tokens", "generate_host_ns")


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
                     call: CallConfig = SERVE_CALL):
    """-> step(cache, tokens (B, 1)) -> (logits (B, 1, V), cache)."""
    def step(cache, tokens):
        return decode_step(model, cfg, cache, tokens, call)
    return step


def build_sampling_step(model: Transformer, cfg: ModelConfig,
                        temperature: float,
                        call: CallConfig = SERVE_CALL):
    """Device-resident decode+sample, one token per call:
    (cache, tok (B, 1), generator) -> (next tok (B, 1), cache)."""
    sample = _sampler(temperature)

    def step(cache, tok, generator):
        logits, cache = decode_step(model, cfg, cache, tok, call)
        return sample(logits[:, 0], generator)[:, None], cache
    return step


def build_decode_chunk(model: Transformer, cfg: ModelConfig,
                       temperature: float, chunk: int,
                       call: CallConfig = SERVE_CALL):
    """``chunk`` tokens per call, a loop of the single step's body (one
    graph on the card): (cache, tok (B, 1), generator) -> (toks (B,
    chunk), tok', cache)."""
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
                      call: CallConfig = SERVE_CALL):
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


class DecodeState:
    """The static decode state of one (batch, max_len): the cache prefill
    writes into, the pending token, and the ragged step's per-slot
    positions and done-mask.  The captured decode programs read and
    rewrite these tensors in place, at fixed addresses."""

    def __init__(self, cfg: ModelConfig, batch: int, max_len: int,
                 device: torch.device):
        self.cache = init_cache(cfg, batch, max_len, device=device)
        self.tok = torch.zeros((batch, 1), dtype=torch.int32, device=device)
        self.pos_b = torch.zeros((batch,), dtype=torch.int32, device=device)
        self.active = torch.zeros((batch,), dtype=torch.int32,
                                  device=device)

    def advance(self, tok: torch.Tensor, cache) -> None:
        """Take a step's token and position (its k/v or state were written
        in place)."""
        self.tok.copy_(tok)
        self.cache["pos"].copy_(cache["pos"])

    def reset(self) -> None:
        """Back to :func:`init_cache`'s zeros (continuous batching starts
        from an empty cache)."""
        for t in (*self.cache.values(), self.tok, self.pos_b, self.active):
            t.zero_()


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
    without one.  ``cluster_ids`` is the engine's window of logical
    clusters (global ids; one cluster when omitted).
    """

    def __init__(self, cfg: ModelConfig, params: Transformer,
                 scfg: ServeConfig,
                 call: CallConfig = SERVE_CALL, *,
                 device: Union[None, str, torch.device] = None,
                 cluster_ids: Optional[Sequence[int]] = None):
        self.cfg, self.scfg, self.call = cfg, scfg, call
        self.device = resolve_device(device, "the serve engine", "serve")
        if self.device == torch.device("cuda"):   # as tensors report it
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._card = self.device.type == "cuda"
        self.params = params
        # the engine's fabric window (global cluster ids): what its
        # placements count as replicated onto
        self.cluster_ids = (None if cluster_ids is None
                            else tuple(int(c) for c in cluster_ids))
        self.unit = CompletionUnit(n_units=8)
        self._jobid = 0
        #: the decode programs, captured on the card (core/graphs.py)
        self.graphs = graphs.GraphCache(self.device)
        self._states: Dict[Tuple[int, int], DecodeState] = {}
        self._gen: Optional[torch.Generator] = None
        self.stats = {"h2d_token_puts": 0, "xla_dispatches": 0,
                      "tokens_emitted": 0, "prefill_inserts": 0,
                      "requests_retired": 0, "batch_padded_rows": 0,
                      "h2d_bytes": 0, "d2d_bytes": 0,
                      **dict.fromkeys(PORT_COUNTERS, 0)}

    # -- placement (weights + prefill inserts) -------------------------------------

    def _count_replicated(self, nbytes: int) -> None:
        """Count the link bytes of replicating ``nbytes`` onto the window
        under ``scfg.staging``, as the reference's placement moves them:
        one copy per cluster over the host link (``direct``), or one
        upload to the tree's root and a device copy to each other cluster
        (``tree``, ``tree_reshard``).  The data itself lands once."""
        k = 1 if self.cluster_ids is None else len(self.cluster_ids)
        if self.scfg.staging in bc.TREE_MODES:
            self.stats["h2d_bytes"] += nbytes
            self.stats["d2d_bytes"] += nbytes * (k - 1)
        else:
            self.stats["h2d_bytes"] += nbytes * k

    def _put_replicated(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` onto the engine's device, link bytes counted."""
        self._count_replicated(np.asarray(arr).nbytes)
        return bc.upload(arr, self.device)

    def place_params(self, params: Transformer) -> Transformer:
        """Place the weights on the device and adopt them.

        Every leaf is replicated onto each cluster of the window, as the
        reference replicates it onto each device of its mesh;
        ``stats["h2d_bytes"]`` / ``["d2d_bytes"]`` record that link
        traffic under ``scfg.staging`` as the reference's
        ``place_params`` does.  On the device the window holds one copy:
        weights already there are adopted, not copied (the window engines
        of a :class:`ServeTenant` share them); others are uploaded once.
        """
        state = params.state_dict()
        for t in state.values():
            self._count_replicated(t.numel() * t.element_size())
        # the captured decode programs read the weights they were built on
        self.graphs = graphs.GraphCache(self.device)
        if params.device == self.device:
            self.params = params
            return params
        model = Transformer(self.cfg, device="meta")
        model.load_state_dict(
            {name: bc.upload(t.detach().cpu().numpy(), self.device)
             for name, t in state.items()}, assign=True)
        self.params = model
        return model

    def _model(self) -> Transformer:
        if self.params.device != self.device:
            raise RuntimeError(
                f"the weights lie on {self.params.device}, the engine on "
                f"{self.device}: call place_params first")
        return self.params

    # -- generation ---------------------------------------------------------------

    def generate(self, prompts: np.ndarray, n_new: int,
                 extra_inputs: Optional[Dict[str, np.ndarray]] = None
                 ) -> np.ndarray:
        """prompts: (b, S_prompt) int32 -> (b, n_new) generated ids.

        ``b`` may be any size up to the configured batch: a sub-batch is
        padded to ``scfg.batch`` (repeating the last prompt row, and the
        last row of every extra input) and the output sliced back.  Batch
        rows are computed independently (MoE routing without drops
        included), so padding does not change the real rows' tokens.
        ``extra_inputs`` feed the modality frontends: ``{"patches": (b, P,
        d_model)}`` for the vision stub, whose P positions come before the
        prompt's in the cache.  A prefill longer than ``scfg.max_len``
        raises :class:`ValueError`.

        ``stats`` counts the positions prefilled (``prefill_tokens``, the
        padded batch times the prompt) and the call's host nanoseconds
        (``generate_host_ns``); the call records the spans
        ``serve.generate``, ``serve.prefill``, ``serve.step`` (each decode
        replay) and ``serve.drain`` while tracing is on.
        """
        t0 = time.perf_counter_ns()
        with trace.span("serve.generate"):
            out = self._generate(prompts, n_new, extra_inputs)
        self.stats["generate_host_ns"] += time.perf_counter_ns() - t0
        return out

    def _generate(self, prompts, n_new, extra_inputs) -> np.ndarray:
        model = self._model()
        prompts = np.asarray(prompts)
        extra = {k: np.asarray(v) for k, v in (extra_inputs or {}).items()}
        b = prompts.shape[0]
        if b > self.scfg.batch:
            raise ValueError(
                f"batch {b} exceeds configured batch {self.scfg.batch}")
        prefix = (extra["patches"].shape[1] if prefix_tokens(self.cfg)
                  and "patches" in extra else 0)
        length = prefix + prompts.shape[1]
        if self.cfg.family != "ssm" and length > self.scfg.max_len:
            raise ValueError(
                f"a prefill of {length} positions ({prefix} prefix + "
                f"{prompts.shape[1]} prompt tokens) exceeds the engine's "
                f"max_len {self.scfg.max_len}")
        if b < self.scfg.batch:
            pad = self.scfg.batch - b
            self.stats["batch_padded_rows"] += pad

            def padded(a):
                return np.concatenate(
                    [a, np.broadcast_to(a[-1:], (pad,) + a.shape[1:])],
                    axis=0)
            prompts = padded(prompts)
            extra = {k: padded(v) for k, v in extra.items()}
        mode = self.scfg.decode_mode
        if mode not in ("host", "step", "chunk"):
            raise ValueError(f"decode_mode {mode!r} not in host/step/chunk")
        batch = {k: torch.as_tensor(v).to(self.device)
                 for k, v in dict(extra, tokens=prompts).items()}
        state = self._state()
        with trace.span("serve.prefill", device=self._card):
            logits, _ = prefill(model, self.cfg, batch, self.scfg.max_len,
                                self.call, cache=state.cache)
        self.stats["prefill_tokens"] += prompts.size
        if mode == "host":
            out = self._generate_host_loop(model, logits, state, n_new)
        else:
            out = self._generate_resident(model, logits, state, n_new)
        return out[:b]

    def _state(self) -> DecodeState:
        """The engine's static decode state for its (batch, max_len)."""
        key = (self.scfg.batch, self.scfg.max_len)
        state = self._states.get(key)
        if state is None:
            state = self._states[key] = DecodeState(self.cfg, *key,
                                                    self.device)
        return state

    def _generator(self, device: torch.device) -> torch.Generator:
        """A generator seeded with ``scfg.seed``: on the engine's device
        one generator, reseeded each call (the decode graphs are
        registered with it); on the host a new one."""
        if device != self.device:
            return torch.Generator(device=device).manual_seed(self.scfg.seed)
        if self._gen is None:
            self._gen = torch.Generator(device=device)
        return self._gen.manual_seed(self.scfg.seed)

    def _program(self, mode: str, chunk: int, make_body, *,
                 copy: bool = False):
        """Run the decode program ``mode`` once: the graph of (mode,
        batch, max_len, chunk, temperature) on the card, the body
        eagerly on the CPU."""
        key = (mode, self.scfg.batch, self.scfg.max_len, chunk,
               self.scfg.temperature)
        gens = () if self._gen is None else (self._gen,)
        return self.graphs.run(key, make_body, generators=gens, copy=copy)

    def _generate_resident(self, model, logits, state: DecodeState,
                           n_new: int) -> np.ndarray:
        """Device-resident decode: the token never visits the host."""
        gen = self._generator(self.device)
        temp = self.scfg.temperature
        sample = _sampler(temp)
        tok = sample(logits[:, -1], gen)[:, None]
        state.tok.copy_(tok)
        # the prefill-token sample is a dispatch emitting token 0
        self.stats["xla_dispatches"] += 1
        self.stats["tokens_emitted"] += 1
        toks = [tok]
        steps = n_new - 1
        done = 0
        if self.scfg.decode_mode == "chunk" and self.scfg.decode_chunk > 1:
            c = self.scfg.decode_chunk

            def make_chunk():
                chunk_fn = build_decode_chunk(model, self.cfg, temp, c,
                                              self.call)

                def body():
                    ys, nxt, cache = chunk_fn(state.cache, state.tok, gen)
                    state.advance(nxt, cache)
                    return ys
                return body

            while steps - done >= c:
                job = self._dispatch_begin()
                with trace.span("serve.step", device=self._card):
                    toks.append(self._program("chunk", c, make_chunk,
                                              copy=True))
                self._dispatch_end(job, tokens=c)
                done += c
        if done < steps:
            def make_step():
                step_fn = build_sampling_step(model, self.cfg, temp,
                                              self.call)

                def body():
                    nxt, cache = step_fn(state.cache, state.tok, gen)
                    state.advance(nxt, cache)
                    return state.tok
                return body

            while done < steps:
                job = self._dispatch_begin()
                with trace.span("serve.step", device=self._card):
                    toks.append(self._program("step", 1, make_step).clone())
                self._dispatch_end(job, tokens=1)
                done += 1
        with trace.span("serve.drain"):
            out = torch.cat(toks, dim=1).cpu().numpy()     # the one drain
        if out.shape[1] != n_new:
            raise AssertionError((out.shape, n_new))
        return out

    def _generate_host_loop(self, model, logits, state: DecodeState,
                            n_new: int) -> np.ndarray:
        """The host round trip: sample on the host, upload each token."""
        sample = _sampler(self.scfg.temperature)
        gen = self._generator(torch.device("cpu"))

        def make_step():
            step_fn = build_serve_step(model, self.cfg, self.call)

            def body():
                lg, cache = step_fn(state.cache, state.tok)
                state.cache["pos"].copy_(cache["pos"])
                return lg
            return body

        out = []
        tok = sample(logits[:, -1].cpu(), gen)
        for _ in range(n_new):
            out.append(tok)
            job = self._dispatch_begin()
            state.tok.copy_(tok[:, None])          # the upload
            self.stats["h2d_token_puts"] += 1
            with trace.span("serve.step", device=self._card):
                logits = self._program("host", 1, make_step)
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
        t0 = time.perf_counter_ns()
        with trace.span("serve.generate_many"):
            out = self._generate_many(requests, arrival_steps)
        self.stats["call_host_ns"] += time.perf_counter_ns() - t0
        return out

    def _generate_many(self, requests, arrival_steps):
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

        B = scfg.batch
        state = self._state()
        state.reset()
        gen = self._generator(self.device)
        stats = self.stats

        def make_step():
            step_fn = build_ragged_step(model, self.cfg, scfg.temperature,
                                        self.call)

            def body():
                nxt, pos_b, cache = step_fn(state.cache, state.tok,
                                            state.pos_b, state.active, gen)
                state.advance(nxt, cache)
                state.pos_b.copy_(pos_b)
                return state.tok
            return body

        slots: List[Optional[Dict[str, int]]] = [None] * B
        free = list(range(B))
        order = sorted(range(R), key=lambda r: (arrivals[r], r))
        # queued requests, each with its arrival (its ``serve.queue`` span)
        queue: collections.deque = collections.deque()
        step_log: List[Tuple[torch.Tensor, List[Tuple[int, int]]]] = []
        t = 0
        pi = 0
        while pi < R or queue or any(s is not None for s in slots):
            while pi < R and arrivals[order[pi]] <= t:
                queue.append((order[pi], time.time_ns()))
                pi += 1
            # prefill-insert: refill free slots from the queue
            while queue and free:
                r, since = queue.popleft()
                j = free.pop(0)
                t0 = time.perf_counter_ns()
                trace.interval("serve.queue", since, time.time_ns(), req=r)
                with trace.span("serve.insert", req=r, device=self._card):
                    self._insert(model, state, j, reqs[r][0])
                stats["insert_host_ns"] += time.perf_counter_ns() - t0
                slots[j] = {"req": r, "remaining": reqs[r][1]}
            if all(s is None for s in slots):
                t = arrivals[order[pi]]     # batch idle: skip to next arrival
                continue
            # one resident decode step advances every occupied slot
            t0 = time.perf_counter_ns()
            with trace.span("serve.step", device=self._card):
                job = self._dispatch_begin()
                tok = self._program("ragged", 1, make_step).clone()
            live = [(j, s["req"]) for j, s in enumerate(slots)
                    if s is not None]
            self._dispatch_end(job, tokens=len(live))
            stats["step_host_ns"] += time.perf_counter_ns() - t0
            step_log.append((tok, live))
            t0 = time.perf_counter_ns()
            with trace.span("serve.retire"):
                for j, s in enumerate(slots):
                    if s is None:
                        continue
                    s["remaining"] -= 1
                    if s["remaining"] == 0:     # done-mask: retire the slot
                        slots[j] = None
                        free.append(j)
                        free.sort()
                        state.active[j] = 0
                        stats["requests_retired"] += 1
            stats["retire_host_ns"] += time.perf_counter_ns() - t0
            t += 1

        # tokens stayed device-resident throughout; one drain at the end
        t0 = time.perf_counter_ns()
        with trace.span("serve.drain"):
            results: List[List[int]] = [[] for _ in range(R)]
            if step_log:
                fetched = torch.stack([tk for tk, _ in step_log]).cpu().numpy()
                for tk_host, (_, live) in zip(fetched, step_log):
                    for j, r in live:
                        results[r].append(tk_host[j, 0])
        stats["drain_host_ns"] += time.perf_counter_ns() - t0
        return [np.asarray(seq, np.int32) for seq in results]

    def _insert(self, model, state: DecodeState, slot: int,
                prompt: np.ndarray) -> None:
        """Admit ``prompt`` into ``slot``: bucketed prefill of
        ``prompt[:-1]`` written into the slot's cache rows; the last
        prompt token becomes the slot's pending decode token at position
        ``len(prompt) - 1`` (all in place in the static state; the logged
        step tokens are copies)."""
        cache = state.cache
        s = int(prompt.size)
        if s > 1:
            bucket = max(1, self.scfg.prefill_bucket)
            # bucketed up, but never past the cache length
            sb = min(-(-(s - 1) // bucket) * bucket, self.scfg.max_len)
            padded = np.zeros((1, sb), np.int32)
            padded[0, :s - 1] = prompt[:-1]
            with trace.span("serve.insert.prefill", device=self._card):
                _, pcache = prefill(model, self.cfg,
                                    {"tokens": self._put_replicated(padded)},
                                    self.scfg.max_len, self.call)
            with trace.span("serve.insert.cache_write", device=self._card):
                cache["k"][:, slot:slot + 1] = pcache["k"]
                cache["v"][:, slot:slot + 1] = pcache["v"]
        state.tok[slot, 0] = int(prompt[-1])
        self.stats["h2d_token_puts"] += 1   # the pending prompt token
        state.pos_b[slot] = s - 1
        state.active[slot] = 1
        self.stats["prefill_inserts"] += 1

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


class ServeTenant:
    """A lease-holding serve tenant: elastic grow/shrink between bursts.

    A ``ServeTenant`` holds a *floor* lease on the
    :class:`~repro_torch.core.fabric.FabricScheduler` and, per decode burst
    (one ``generate`` / ``generate_many`` call), grows toward its
    preferred ``burst`` size using whatever clusters are free, shrinking
    back to the floor when the burst completes — offload tenants get the
    head-room between bursts, the serve/offload split of the fabric.

    One :class:`ServeEngine` is kept per distinct lease window (the
    scheduler's in-place resizing makes the windows recur), with its own
    caches and counters, as in the reference.  Where the reference places
    one replica of the weights per device of each window's mesh, the
    windows here are logical clusters of one device: every engine shares
    one copy of the weights, and each counts the link bytes of its own
    window's placement (:meth:`ServeEngine.place_params`).  ``params``
    may be host weights, placed at the first burst, or a model already on
    the scheduler's device, adopted as it is.
    """

    def __init__(self, scheduler: FabricScheduler, cfg: ModelConfig,
                 host_params: Optional[Transformer], scfg: ServeConfig, *,
                 tenant: str = "serve",
                 floor: int = 1,
                 burst: Optional[int] = None,
                 call: CallConfig = SERVE_CALL):
        if floor < 1:
            raise ValueError(f"floor must be >= 1, got {floor}")
        self.scheduler = scheduler
        self.cfg, self.scfg, self.call = cfg, scfg, call
        #: the weights every window engine shares (the caller's until the
        #: first burst places them on the device)
        self.params = host_params
        self.floor = floor
        self.burst = scheduler.num_clusters if burst is None else burst
        if self.burst < floor:
            raise ValueError(
                f"burst size {self.burst} below the floor {floor}")
        self.lease: ClusterLease = scheduler.request(
            Tenant(tenant, kind=TenantKind.SERVE), n=floor)
        # the scheduler's overload ladder shrinks elastic serve leases
        # (back to, then below, this floor) before revoking anything
        scheduler.register_elastic(self.lease, floor)
        self._engines: Dict[Tuple[int, ...], ServeEngine] = {}

    def _engine(self) -> ServeEngine:
        key = self.lease.clusters
        eng = self._engines.get(key)
        if eng is None:
            eng = ServeEngine(self.cfg, self.params, self.scfg, self.call,
                              device=self.lease.device, cluster_ids=key)
            self.params = eng.place_params(self.params)
            self._engines[key] = eng
        return eng

    def _sync(self) -> None:
        # a fabric failover (FabricScheduler.fail_clusters) replaces the
        # lease object in place — same id, healthy window — leaving this
        # tenant's reference stale; refresh it before keying any
        # scheduler call (or engine cache) on the window
        cur = self.scheduler.current_lease(self.lease)
        if cur is not None and cur is not self.lease:
            self.lease = cur
        # overload pressure may have shrunk the floor itself (graceful
        # degradation); adopt the scheduler's view so _grow/_shrink
        # target the degraded floor instead of fighting the ladder
        floor = self.scheduler.elastic_floor(self.lease)
        if floor is not None and floor != self.floor:
            self.floor = floor

    def _grow(self) -> None:
        self._sync()
        # the global free count is an upper bound; the free space may be
        # fragmented into windows smaller than it, so walk the target
        # down until a contiguous grow (or relocation) fits — a burst
        # takes the largest window available, never fails the generate
        headroom = len(self.scheduler.free_clusters())
        target = max(self.floor, min(self.burst, self.lease.n + headroom))
        while target > self.lease.n:
            try:
                self.lease = self.scheduler.resize(self.lease, target)
                return
            except LeaseUnavailable:
                target -= 1

    def _shrink(self) -> None:
        self._sync()
        if self.lease.n > self.floor:
            self.lease = self.scheduler.resize(self.lease, self.floor)
        elif self.lease.n < self.floor:
            # a failover or the overload ladder left the lease under the
            # floor; growing back is best-effort while pressure persists
            try:
                self.lease = self.scheduler.resize(self.lease, self.floor)
            except LeaseUnavailable:
                pass

    def generate(self, prompts: np.ndarray, n_new: int,
                 extra_inputs: Optional[Dict[str, np.ndarray]] = None
                 ) -> np.ndarray:
        """One decode burst: grow the lease, generate, shrink back."""
        self._grow()
        try:
            return self._engine().generate(prompts, n_new, extra_inputs)
        finally:
            self._shrink()

    def generate_many(self, requests: Sequence[Tuple[np.ndarray, int]],
                      arrival_steps: Optional[Sequence[int]] = None
                      ) -> List[np.ndarray]:
        """One continuous-batching burst under the elastic lease."""
        self._grow()
        try:
            return self._engine().generate_many(requests, arrival_steps)
        finally:
            self._shrink()

    @property
    def windows(self) -> Tuple[Tuple[int, ...], ...]:
        """Every lease window this tenant has served a burst on (each
        backs one warm engine), smallest first."""
        return tuple(sorted(self._engines, key=len))

    @property
    def peak_burst(self) -> int:
        """The widest burst window served so far (clusters)."""
        return max((len(w) for w in self._engines), default=self.lease.n)

    @property
    def stats(self) -> Dict[str, int]:
        """Engine counters summed across every lease window served."""
        agg: Dict[str, int] = {}
        for eng in self._engines.values():
            for k, v in eng.stats.items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def close(self) -> None:
        """Release the floor lease (the tenant leaves the fabric)."""
        self._sync()
        self.scheduler.unregister_elastic(self.lease)
        if self.lease.active:
            self.lease.release()
