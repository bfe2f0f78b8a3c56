"""The readers of the program's counters and spans, held to hand-made
records and spans: each reads what it names, and nothing where the
profiled slice, the counters, the device times or the recorder itself are
missing (a parent commit without them)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from bench import spec  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import trace  # noqa: E402

DECODE = {"driver": "batch_generate",
          "stats": {"call_host_ns": 1000, "insert_host_ns": 250,
                    "step_host_ns": 500, "retire_host_ns": 100,
                    "drain_host_ns": 50, "tokens_emitted": 9}}
PROFILE = {"busy_s": 1.0, "window_s": 2.0}
#: (metric, driver, span name)
SPAN_METRICS = [("step_ms.decode", "batch_generate", "serve.step"),
                ("insert_ms.decode", "batch_generate", "serve.insert"),
                ("grads_ms.train", "train", "train.grads"),
                ("adamw_ms.train", "train", "train.adamw")]


def test_host_shares_read_the_window_counters():
    assert spec.reader("insert_host_share.decode")(DECODE) == 0.25
    assert spec.reader("sched_host_share.decode")(DECODE) == pytest.approx(
        (1000 - 250 - 500 - 100 - 50) / 1000)


@pytest.mark.parametrize("metric", ["insert_host_share.decode",
                                    "sched_host_share.decode"])
def test_host_shares_need_the_counters(metric):
    read = spec.reader(metric)
    # a program without the counters, a window without a call
    assert read({"driver": "batch_generate",
                 "stats": {"tokens_emitted": 9}}) is None
    assert read({**DECODE, "stats": {**DECODE["stats"],
                                     "call_host_ns": 0}}) is None
    assert read({**DECODE, "driver": "train"}) is None


def test_sched_share_needs_every_part():
    stats = dict(DECODE["stats"])
    del stats["retire_host_ns"]
    assert spec.reader("sched_host_share.decode")(
        {**DECODE, "stats": stats}) is None


def _spans(name, ms):
    return [trace.Span(name, 0, 1, id=i + 1, device_ms=m)
            for i, m in enumerate(ms)]


@pytest.mark.parametrize("metric,driver,name", SPAN_METRICS)
def test_span_metric_is_the_mean_device_ms(metric, driver, name,
                                           monkeypatch):
    kept = (_spans(name, [2.0, 4.0, None]) + _spans("other", [100.0])
            + _spans(name + ".part", [50.0]))
    monkeypatch.setattr(trace, "spans", lambda: kept)
    read = spec.reader(metric)
    assert read({"driver": driver, "profile": PROFILE}) == 3.0
    # the window alone, another cell's driver
    assert read({"driver": driver}) is None
    assert read({"driver": "other", "profile": PROFILE}) is None


@pytest.mark.parametrize("metric,driver,name", SPAN_METRICS)
def test_span_metric_needs_device_times(metric, driver, name, monkeypatch):
    rec = {"driver": driver, "profile": PROFILE}
    read = spec.reader(metric)
    monkeypatch.setattr(trace, "spans", lambda: _spans(name, [None, None]))
    assert read(rec) is None                 # spans off the card
    monkeypatch.setattr(trace, "spans", lambda: [])
    assert read(rec) is None
    # a program without the recorder
    monkeypatch.setattr(trace, "spans", lambda: _spans(name, [1.0]))
    assert read(rec) == 1.0
    monkeypatch.delattr(core, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.core.trace", None)
    assert read(rec) is None
