"""A whole run, the look for a card skipped, at the rehearsal sizes on the
CPU: sound, it is correct; with the timed path broken underneath, it is
not, once for each fault a cell can have (a step that leaves its state
unchanged, half of the batch left out, a token altered where it is
produced; no cell spans chips, so no exchange can be left out).  And the
control, the reference in fp8 put in the program's place, fails a cell's
limits."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from bench import compare, control, run, spec  # noqa: E402

import repro_torch.serve.engine as engine_mod  # noqa: E402
import repro_torch.train.step as step_mod  # noqa: E402

CPU = torch.device("cpu")
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
TRAIN = [c for c in CELLS if spec.load_cell(c).mix["driver"] == "train"]
SERVE = [c for c in CELLS if c not in TRAIN]


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: one intra-op thread is faster, and leaves the cores
    to the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rehearse(cell_name, seed=5):
    cell = spec.load_cell(cell_name, rehearsal=True)
    return run.run(cell, seed, 0.3, False, CPU)


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_sound_run_is_correct(cell):
    res = rehearse(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell", TRAIN)
def test_state_left_unchanged_is_caught(cell, monkeypatch):
    def unchanged(grads, state, params, lr, cfg):
        return params, state, {"grad_norm": torch.zeros(())}
    monkeypatch.setattr(step_mod, "adamw_update", unchanged)
    res = rehearse(cell)
    assert not res["correct"]
    assert dict((n, v) for n, v, _ in res["checks"])["change_gap"] > 0.9


@pytest.mark.parametrize("cell", TRAIN)
def test_half_batch_is_caught(cell, monkeypatch):
    loss_fn = step_mod.loss_fn

    def half(model, cfg, batch, call):
        rows = batch["tokens"].shape[0] // 2
        return loss_fn(model, cfg, {k: v[:rows] for k, v in batch.items()},
                       call)
    monkeypatch.setattr(step_mod, "loss_fn", half)
    assert not rehearse(cell)["correct"]


@pytest.mark.parametrize("cell", SERVE)
def test_altered_token_is_caught(cell, monkeypatch):
    sampler = engine_mod._sampler

    def altered(temperature):
        sample = sampler(temperature)

        def wrong(logits, generator):
            return (sample(logits, generator) + 1) % logits.shape[-1]
        return wrong
    monkeypatch.setattr(engine_mod, "_sampler", altered)
    assert not rehearse(cell)["correct"]


@pytest.mark.parametrize("cell", [TRAIN[0], SERVE[0]])
def test_control_fails_the_limits(cell):
    c = spec.load_cell(cell, rehearsal=True)
    out = control.readings(c, 5, 0.3, CPU)
    assert compare.passed(compare.against(out["program"], c.limits))
    assert not compare.passed(compare.against(out["fp8"], c.limits))
    if "half_batch" in out:
        assert not compare.passed(compare.against(out["half_batch"],
                                                  c.limits))
