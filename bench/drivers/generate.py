"""``generate``: static-batch serving, calls of ``ServeEngine.generate``, one
call of ``batch`` prompts a length of the mix's ``prompt_lengths``, in
order, as one cycle; ``n_new`` tokens each, greedy.  The engine's call
(``attn_impl``, ``attn_chunk``, routing without drops) comes from the
mix."""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from bench import arch, devtrace
from bench.drivers import Serving, Window, load_model, tokens
from bench.spec import derive


class Generate(Serving):
    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        self.lengths = list(self.mix["prompt_lengths"])
        self.b, self.n_new = self.mix["batch"], self.mix["n_new"]
        #: every call of the window: (prompts (B, L), outputs (B, n_new))
        self.calls: List[Tuple[np.ndarray, np.ndarray]] = []

    def prompts(self, length: int, *tag: object) -> np.ndarray:
        v = self.cfg["vocab_size"]
        return np.stack([tokens(derive(self.seed, *tag, r), length, v)
                         for r in range(self.b)])

    def engine(self, batch: int, max_len: int):
        from repro_torch.models.model import CallConfig, Transformer
        from repro_torch.serve.engine import ServeConfig, ServeEngine
        # the model's structure before its weights: a program that cannot
        # build it fails here, in seconds
        Transformer(self.mcfg, device="meta")
        self.model = load_model(self.mcfg, self.weights())
        self.sync()
        self.mark("weights")
        call = CallConfig(attn_impl=self.mix["attn_impl"],
                          attn_chunk=self.mix["attn_chunk"],
                          moe_no_drop=True)
        return ServeEngine(self.mcfg, self.model,
                           ServeConfig(batch=batch, max_len=max_len,
                                       temperature=0.0),
                           call, device=self.device)

    def setup(self) -> None:
        self.eng = self.engine(self.b, self.mix["max_len"])
        self.mark("engine")
        # every prefill length once, and the captured decode step
        for length in sorted(set(self.lengths)):
            self.eng.generate(self.prompts(length, "warmup"), 2)
        self.sync()
        self.mark("warm-up")

    def window(self, seconds: float) -> Window:
        before = dict(self.eng.stats)
        failed = cycles = 0
        t0 = time.perf_counter()
        while True:
            for i, length in enumerate(self.lengths):
                prompts = self.prompts(length, "cycle", cycles, i)
                t = time.perf_counter()
                out = self.eng.generate(prompts, self.n_new)
                print(f"cycle {cycles} call {i} ({length}) "
                      f"{time.perf_counter() - t:.4f} s", file=sys.stderr)
                failed += sum(row.size != self.n_new for row in out)
                self.calls.append((prompts, out))
            cycles += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        emitted = sum(out.size for _, out in self.calls)
        a = arch.load(self.cfg)
        least = sum(a.call_least_s(self.cfg, self.b, length, self.n_new)
                    for length in self.lengths)
        stats = {k: self.eng.stats[k] - before[k] for k in before}
        return Window(
            metrics={"serve_tokens_per_s": emitted / elapsed},
            attempted=len(self.calls) * self.b, failed=failed,
            records={"driver": "generate", "window_s": elapsed,
                     "cycles": cycles, "least_s": cycles * least,
                     "batch": self.b, "stats": stats})

    def profile(self) -> Dict[str, object]:
        """One call of the longest length, its spans recorded."""
        length = max(self.lengths)
        prompts = self.prompts(length, "trace")

        def one_call():
            with torch.profiler.record_function("bench.generate"):
                self.eng.generate(prompts, self.n_new)
        rec = devtrace.profiled(one_call)
        rec["experts_bound_s"] = arch.load(self.cfg).call_experts_least_s(
            self.cfg, self.b, length, self.n_new)
        return rec

    def served(self):
        return [(p, o) for prompts, outs in self.calls
                for p, o in zip(prompts, outs)]


DRIVER = Generate
