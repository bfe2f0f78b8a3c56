"""``train``: a closed loop of training steps through
``repro_torch.train.build_train_step``, random token rows from the seed."""

from __future__ import annotations

import math
import time
from typing import Dict, Mapping, Optional

import torch

from bench import arch, compare, devtrace
from bench.drivers import Driver, Window, free_device, load_model, reference
from bench.spec import derive


class Train(Driver):
    """Training steps; the check's steps are the first ``check_steps``
    steps of the same object, through the same call and feed."""

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        from repro_torch.models.model import CallConfig
        from repro_torch.optim.adamw import AdamWConfig
        from repro_torch.train.step import TrainConfig
        m, t = self.mix, self.mix["train"]
        self.b, self.s = m["batch"], m["seq"]
        call = CallConfig(attn_impl=m["attn_impl"], attn_chunk=m["attn_chunk"],
                          ssm_impl="plain", remat=m["remat"],
                          attn_chunk_remat=m["attn_chunk_remat"])
        self.tcfg = TrainConfig(
            base_lr=t["base_lr"], warmup_steps=t["warmup_steps"],
            total_steps=t["total_steps"], microbatches=1,
            adamw=AdamWConfig(**t["adamw"]), call=call)
        self.i = 0

    def batch(self, i: int) -> Dict[str, torch.Tensor]:
        """Step ``i``'s rows: (B, S + 1) random ids, shifted by one for the
        labels."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(derive(self.seed, "batch", i))
        x = torch.randint(0, self.cfg["vocab_size"], (self.b, self.s + 1),
                          generator=gen, device=self.device,
                          dtype=torch.int32)
        return {"tokens": x[:, :-1].contiguous(),
                "labels": x[:, 1:].contiguous()}

    def _step(self) -> float:
        _, _, met = self.step(self.model, self.opt, self.batch(self.i),
                              self.i)
        self.i += 1
        return float(met["loss"])

    def setup(self) -> None:
        from repro_torch.data import input_specs
        from repro_torch.optim import adamw_init
        from repro_torch.train import build_train_step
        self.model = load_model(self.mcfg, self.weights())
        self.sync()
        self.mark("weights")
        self.opt = adamw_init(self.model, self.tcfg.adamw)
        self.step, *_ = build_train_step(
            self.mcfg, self.tcfg,
            input_specs(self.mcfg, mode="train", batch=self.b, seq=self.s),
            device=self.device)
        self.sync()
        self.mark("train step")
        b1 = self.tcfg.adamw.b1
        self.first: Dict[str, object] = {"losses": []}
        for _ in range(self.mix["check_steps"]):
            self.first["losses"].append(self._step())
            if self.i == 1:      # the first gradient, as AdamW got it
                self.first["grad_norms"] = self._norms(
                    {n: m / (1 - b1) for n, m in self.opt["mu"].items()})
        start = self.weights()
        self.first["change_norms"] = self._norms(
            {n: p.detach() - start[n]
             for n, p in self.model.named_parameters()})
        del start
        self.mark("check steps")

    @staticmethod
    def _norms(leaves: Mapping[str, torch.Tensor]) -> Dict[str, float]:
        names = list(leaves)
        vals = torch.stack([torch.linalg.vector_norm(leaves[n].float())
                            for n in names]).tolist()
        return dict(zip(names, vals))

    def window(self, seconds: float) -> Window:
        losses = []
        t0 = time.perf_counter()
        while True:
            losses.append(self._step())
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        n = len(losses)
        return Window(
            metrics={"train_tokens_per_s": n * self.b * self.s / elapsed},
            attempted=n,
            failed=sum(not math.isfinite(x) for x in losses),
            records={"driver": "train", "window_s": elapsed, "steps": n,
                     "model_flops": n * arch.load(self.cfg).train_step_flops(
                         self.cfg, self.b, self.s)})

    def profile(self) -> Dict[str, object]:
        def steps():
            for _ in range(self.mix["profile_steps"]):
                with torch.profiler.record_function("bench.train_step"):
                    self._step()
        return devtrace.profiled(steps)

    def release(self) -> None:
        del self.model, self.opt, self.step
        free_device()

    def numbers(self, precision: str = "float32",
                rows: Optional[int] = None) -> Dict[str, object]:
        """The reference's readings over the check's steps."""
        ref = reference(self.cfg)
        ref.exact_matmuls()
        batches = [self.batch(i) for i in range(self.mix["check_steps"])]
        return ref.train_steps(self.cfg, self.weights(), batches,
                               self.mix["train"], precision=precision,
                               rows=rows)

    def check(self) -> Dict[str, float]:
        return compare.train_numbers(self.first, self.numbers())

    def limit_readings(self, seconds: float) -> Dict[str, object]:
        """The program's readings from its first steps, as in a run, and
        the reference put in the program's place computed in fp8 (the
        control) and over half of each batch (a fault), each read against
        the float32 reference."""
        self.setup()
        self.release()
        ref = self.numbers()
        return {"program": compare.train_numbers(self.first, ref),
                "fp8": compare.train_numbers(self.numbers("fp8"), ref),
                "half_batch": compare.train_numbers(
                    self.numbers(rows=self.b // 2), ref)}


DRIVER = Train
