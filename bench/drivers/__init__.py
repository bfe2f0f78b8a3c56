"""The ways a mix drives the program, one module each, named by the mix's
``driver``: ``bench/drivers/<driver>.py`` defines ``DRIVER``, a subclass of
:class:`Driver`.

A driver builds the program in ``setup`` (weights from the seed, the
check's first steps or a warm-up over every shape the mix sends), runs the
window, profiles a short slice of the same work, frees the program, and
then checks what the window produced against the plain reference.  What a
mix holds is data: lengths, batch, call settings, sample sizes.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import time
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from bench import compare
from bench.spec import Cell, derive
from bench.weights import make_weights


@dataclasses.dataclass
class Window:
    metrics: Dict[str, float]
    attempted: int
    failed: int
    records: Dict[str, object]


def load(name: str) -> type:
    """The driver class of ``bench/drivers/<name>.py``."""
    return importlib.import_module(f"bench.drivers.{name}").DRIVER


def model_config(cfg: Mapping):
    """The program's ``ModelConfig`` from the configuration file."""
    from repro_torch.models.config import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def load_model(mcfg, weights: Mapping[str, torch.Tensor]):
    """The program's model over ``weights`` (adopted, not copied)."""
    from repro_torch.models.model import Transformer
    model = Transformer(mcfg, device="meta")
    model.load_state_dict(dict(weights), assign=True)
    return model


def reference(cfg: Mapping):
    """The configuration's plain reference, ``bench/reference/<arch>.py``."""
    return importlib.import_module(f"bench.reference.{cfg['architecture']}")


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def tokens(seed: int, length: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=length,
                                                dtype=np.int32)


class Driver:
    """What every driver has; a driver adds ``setup``, ``window``,
    ``profile``, ``release``, ``check`` and ``limit_readings``."""

    def __init__(self, cell: Cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.mix = cell.config, cell.mix
        self.mcfg = model_config(self.cfg)
        self.marks: List[Tuple[str, float]] = []

    def mark(self, phase: str) -> None:
        """The end of a phase of set-up, on the host clock."""
        self.marks.append((phase, time.perf_counter()))

    def weights(self) -> Dict[str, torch.Tensor]:
        return make_weights(self.cfg, derive(self.seed, "weights"),
                            self.device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()


class Serving(Driver):
    """What serving drivers share: the engine and the check, which holds a
    sample of the finished requests against the reference."""

    def engine(self, batch: int, max_len: int):
        from repro_torch.serve.engine import ServeConfig, ServeEngine
        self.model = load_model(self.mcfg, self.weights())
        self.sync()
        self.mark("weights")
        return ServeEngine(self.mcfg, self.model,
                           ServeConfig(batch=batch, max_len=max_len,
                                       temperature=0.0),
                           device=self.device)

    def release(self) -> None:
        del self.eng, self.model
        free_device()

    def served(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """(prompt, served tokens) of every finished request."""
        raise NotImplementedError

    def sample(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """The mix's ``sample`` of finished requests, drawn from the seed,
        the one with the most served tokens (the longest prompt among
        those) always in it."""
        done = self.served()
        rng = np.random.default_rng(derive(self.seed, "sample"))
        order = rng.permutation(len(done))
        first = max(order, key=lambda j: (done[j][1].size, done[j][0].size))
        rest = [j for j in order if j != first]
        return [done[j] for j in [first, *rest][:self.mix["sample"]]]

    def gaps(self, precision: str = "float32"
             ) -> Tuple[List[float], List[float]]:
        """Per served token of the sample: (the gap of the served token,
        the gap of the token that ``precision`` puts first), both under
        the float32 reference's logits."""
        ref = reference(self.cfg)
        ref.exact_matmuls()
        w = self.weights()
        served_gaps, chosen_gaps = [], []
        for prompt, out in self.sample():
            p = torch.as_tensor(prompt, device=self.device)
            o = torch.as_tensor(out, device=self.device)
            exact = ref.served_logits(self.cfg, w, p, o)
            served_gaps += ref.gaps(exact, o)
            if precision != "float32":
                low = ref.served_logits(self.cfg, w, p, o, precision)
                chosen_gaps += ref.gaps(exact, low.argmax(dim=-1))
            del exact
        return served_gaps, chosen_gaps

    def check(self) -> Dict[str, float]:
        return compare.served_numbers(self.gaps()[0])

    def limit_readings(self, seconds: float) -> Dict[str, object]:
        """A short window at the cell's load, then the gap of each served
        token (the program's reading) and of the token the fp8 reference
        puts first (the control's)."""
        self.setup()
        self.window(seconds)
        self.release()
        served, chosen = self.gaps("fp8")
        return {"program": compare.served_numbers(served),
                "fp8": compare.served_numbers(chosen),
                "tokens": len(served)}
