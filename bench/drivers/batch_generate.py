"""``batch_generate``: offline batch generation, calls of
``ServeEngine.generate_many`` over the mix's requests, all arriving at step
0, greedy."""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from bench import arch, devtrace, work
from bench.drivers import Serving, Window, tokens
from bench.spec import derive


class BatchGenerate(Serving):
    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        self.requests = [tuple(r) for r in self.mix["requests"]]
        self.calls: List[Tuple[List[np.ndarray], List[np.ndarray]]] = []

    def prompts(self, tag: object) -> List[np.ndarray]:
        v = self.cfg["vocab_size"]
        return [tokens(derive(self.seed, tag, r), p, v)
                for r, (p, _) in enumerate(self.requests)]

    def call(self, prompts: List[np.ndarray]) -> List[np.ndarray]:
        return self.eng.generate_many(
            [(p, n) for p, (_, n) in zip(prompts, self.requests)])

    def setup(self) -> None:
        self.eng = self.engine(self.mix["batch"], self.mix["max_len"])
        self.mark("engine")
        # every insert's shape (one prompt of each length) and the
        # captured ragged step
        v = self.cfg["vocab_size"]
        lengths = sorted({p for p, _ in self.requests})
        self.eng.generate_many([(tokens(derive(self.seed, "warmup", p), p, v),
                                 2) for p in lengths])
        self.sync()
        self.mark("warm-up")

    def window(self, seconds: float) -> Window:
        before = dict(self.eng.stats)
        failed = 0
        t0 = time.perf_counter()
        while True:
            prompts = self.prompts(("call", len(self.calls)))
            t = time.perf_counter()
            outs = self.call(prompts)
            print(f"call {len(self.calls)} {time.perf_counter() - t:.4f} s",
                  file=sys.stderr)
            failed += sum(o.size != n for o, (_, n) in
                          zip(outs, self.requests))
            self.calls.append((prompts, outs))
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        stats = {k: self.eng.stats[k] - before[k] for k in before}
        n_calls = len(self.calls)
        emitted = sum(o.size for _, outs in self.calls for o in outs)
        least = work.batch_generate_least_s(self.cfg, self.requests,
                                            self.mix["batch"])
        return Window(
            metrics={"serve_tokens_per_s": emitted / elapsed},
            attempted=n_calls * len(self.requests), failed=failed,
            records={"driver": "batch_generate", "window_s": elapsed,
                     "calls": n_calls, "least_s": n_calls * least,
                     "batch": self.mix["batch"], "stats": stats})

    def profile(self) -> Dict[str, object]:
        """One call of the mix's first ``profile_requests`` requests, into
        the same slots: a whole call of the window's holds millions of
        device operations, which take minutes to record and read."""
        part = self.requests[:self.mix["profile_requests"]]
        v = self.cfg["vocab_size"]
        prompts = [tokens(derive(self.seed, "trace", r), p, v)
                   for r, (p, _) in enumerate(part)]

        def one_call():
            with torch.profiler.record_function("bench.generate_many"):
                self.eng.generate_many(
                    [(p, n) for p, (_, n) in zip(prompts, part)])
        # the inserts' eager operations are many host events a call: the
        # host is seen in its CUDA calls alone
        rec = devtrace.profiled(one_call, host_ops=False)
        # each insert prefills its prompt but the last token
        a = arch.load(self.cfg)
        rec["flash_bound_s"] = sum(a.prefill_flash_bound_s(self.cfg, p - 1)
                                   for p, _ in part if p > 1)
        return rec

    def served(self):
        return [(p, o) for prompts, outs in self.calls
                for p, o in zip(prompts, outs)]


DRIVER = BatchGenerate
