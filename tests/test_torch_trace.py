"""The span recorder (``repro_torch.core.trace``) and the spans and host
counters of the serve engine and the train step, on the CPU at a tiny
size.

* Off (no ``recording()``, no profiler): a span enters no
  ``record_function``, records no CUDA event, allocates nothing and keeps
  nothing, across a ``generate_many`` and a train step.
* Under the profiler, enabled as ``bench/devtrace.py`` enables it: each
  span is a host event of the trace, and each span's interval, read on
  ``time.time_ns()``, holds the host events of the aten operations that
  the profiler puts inside it.
* ``generate_many`` records one ``serve.insert`` and one ``serve.queue``
  per request, under the call's span; its ``*_host_ns`` counters
  grow, the parts within the whole.
* The store's bound counts what it drops; ``self_ns`` subtracts the union
  of a span's children.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import time
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch import models as T
from repro_torch.core import trace
from repro_torch.serve.engine import HOST_NS, ServeConfig, ServeEngine
from repro_torch.train import TrainConfig, train_step_fn
from repro_torch.optim import adamw_init

#: five requests into three slots, the last two queued behind the first
REQUESTS = [(5, 4), (9, 3), (3, 5), (17, 2), (2, 3)]


@pytest.fixture(autouse=True)
def empty_store():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module")
def tiny():
    cfg = T.reduced(T.get("smollm-360m"), n_layers=1, d_model=64,
                    vocab_size=128)
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    return cfg, model


def _engine(tiny):
    cfg, model = tiny
    return ServeEngine(cfg, model, ServeConfig(batch=3, max_len=32),
                       device="cpu")


def _requests(cfg):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, cfg.vocab_size, p, dtype=np.int32), n)
            for p, n in REQUESTS]


def _train_step(tiny):
    cfg, model = tiny
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(1),
                          device="cpu")
    step = train_step_fn(cfg, TrainConfig(warmup_steps=1, total_steps=4))
    x = torch.randint(0, cfg.vocab_size, (2, 17),
                      generator=torch.Generator().manual_seed(2))
    batch = {"tokens": x[:, :-1], "labels": x[:, 1:]}
    return lambda: step(model, adamw_init(model), batch, 0)


def _refuse(*_, **__):
    raise AssertionError("entered while tracing is off")


def test_off_enters_nothing_and_keeps_nothing(tiny, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    assert not trace.enabled()
    _engine(tiny).generate_many(_requests(tiny[0]))
    _train_step(tiny)()
    assert trace.spans() == [] and trace.dropped() == 0
    # one shared no-op context, and nothing allocated per span
    assert trace.span("a") is trace.span("b", req=1, device=True)
    # 30,000 spans reach the peak that 300 reach (the loop's own objects:
    # its counter past the small ints), and leave nothing behind
    few, many = _traced(300), _traced(30_000)
    assert few == many and many[0] == 0


def _traced(n):
    """(bytes left, peak bytes) that ``n`` spans and intervals allocate
    while tracing is off."""
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        _spans_off(n)
        now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return now - before, peak - before


def _spans_off(n):
    for i in range(n):
        with trace.span("serve.step", req=i, device=True):
            pass
        trace.interval("serve.queue", 0, 1, req=i)


def _profiled(fn):
    """Host events (name, start ns, end ns) of ``fn`` run under the
    profiler, enabled through the calls ``bench/devtrace.py`` makes."""
    from torch._C._profiler import ProfilerActivity, _ExperimentalConfig
    from torch.autograd.profiler import (
        ProfilerConfig, ProfilerState, _disable_profiler, _enable_profiler,
        _prepare_profiler,
    )
    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                            False, _ExperimentalConfig())
    acts = {ProfilerActivity.CPU}
    _prepare_profiler(config, acts)
    _enable_profiler(config, acts)
    try:
        assert trace.enabled()
        fn()
    finally:
        results = _disable_profiler()
    assert not trace.enabled()
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in results.events()
            if e.device_type() == torch.autograd.DeviceType.CPU]


def test_spans_lie_on_the_profiler_clock(tiny):
    eng, train = _engine(tiny), _train_step(tiny)
    events = _profiled(lambda: (eng.generate_many(_requests(tiny[0])),
                                train()))
    kept = [s for s in trace.spans() if s.name != "serve.queue"]
    names = {s.name for s in kept}
    assert {"serve.generate_many", "serve.insert", "serve.insert.prefill",
            "serve.insert.cache_write", "serve.step", "serve.retire",
            "serve.drain", "train.step", "train.grads",
            "train.adamw"} <= names
    checked = 0
    for name in names:
        # the k-th host event of a span's name is the k-th such span
        hosts = sorted(e for e in events if e[0] == name)
        mine = sorted((s for s in kept if s.name == name),
                      key=lambda s: s.start_ns)
        assert len(hosts) == len(mine), name
        for (_, h0, h1), s in zip(hosts, mine):
            assert s.start_ns <= h0 <= h1 <= s.end_ns, name
            ops = [e for e in events if e[0].startswith("aten::")
                   and h0 <= e[1] and e[2] <= h1]
            for _, a, b in ops:
                assert s.start_ns <= a <= b <= s.end_ns, (name, s)
            checked += len(ops)
    assert checked > 100


def test_generate_many_spans_each_request(tiny):
    eng = _engine(tiny)
    with trace.recording():
        outs = eng.generate_many(_requests(tiny[0]))
    assert [o.size for o in outs] == [n for _, n in REQUESTS]
    kept = trace.spans()
    by = {}
    for s in kept:
        by.setdefault(s.name, []).append(s)
    call, = by["serve.generate_many"]
    for name in ("serve.insert", "serve.queue"):
        assert sorted(s.req for s in by[name]) == list(range(len(REQUESTS)))
        assert {s.parent for s in by[name]} == {call.id}
    inserts = {s.req: s for s in by["serve.insert"]}
    for q in by["serve.queue"]:
        assert q.start_ns <= q.end_ns <= inserts[q.req].start_ns
    # the two requests that waited for a slot waited longest
    waits = {q.req: q.end_ns - q.start_ns for q in by["serve.queue"]}
    assert min(waits[3], waits[4]) > max(waits[0], waits[1], waits[2])
    ids = {s.id for s in by["serve.insert"]}
    assert {s.parent for s in by["serve.insert.prefill"]} <= ids
    assert len(by["serve.insert.prefill"]) == len(REQUESTS)
    assert len(by["serve.step"]) == eng.stats["xla_dispatches"]
    assert len(by["serve.retire"]) == len(by["serve.step"])
    assert len(by["serve.drain"]) == 1
    assert all(s.device_ms is None for s in kept)        # no card
    own = trace.self_ns(kept)
    assert 0 <= own[call.id] < call.end_ns - call.start_ns


@pytest.mark.parametrize("mode", ["step", "chunk"])
def test_generate_spans_and_counters(tiny, mode):
    """``generate`` records its call, its prefill, one ``serve.step`` a
    decode dispatch and one drain, under the call; it counts the padded
    batch's prefilled positions and its host time."""
    cfg, model = tiny
    eng = ServeEngine(cfg, model, ServeConfig(batch=3, max_len=32,
                                              decode_mode=mode,
                                              decode_chunk=2), device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 7),
                                                dtype=np.int32)
    with trace.recording():
        out = eng.generate(prompts, 6)
    assert out.shape == (2, 6)
    by = {}
    for s in trace.spans():
        by.setdefault(s.name, []).append(s)
    call, = by["serve.generate"]
    for name in ("serve.prefill", "serve.step", "serve.drain"):
        assert {s.parent for s in by[name]} == {call.id}
    assert len(by["serve.prefill"]) == len(by["serve.drain"]) == 1
    # the prefill's token is a dispatch of its own, not a replay
    assert len(by["serve.step"]) == eng.stats["xla_dispatches"] - 1
    assert eng.stats["prefill_tokens"] == 3 * 7
    assert 0 < eng.stats["generate_host_ns"]
    assert eng.stats["generate_host_ns"] >= call.end_ns - call.start_ns - (
        10 ** 6)


def test_moe_and_mla_spans_of_a_prefill():
    """An eager prefill of an MLA + MoE model records ``mla.attend`` a
    layer and ``moe.route``, ``moe.experts``, ``moe.combine`` a MoE
    layer (the dense first layer has none)."""
    import dataclasses
    cfg = T.reduced(T.get("deepseek-v2-lite-16b"), n_layers=3)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           first_dense=1))
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 5))
    call = T.CallConfig(moe_no_drop=True)
    with trace.recording():
        T.prefill(model, cfg, {"tokens": tokens}, 8, call)
    names = [s.name for s in trace.spans()]
    assert names.count("mla.attend") == 3
    for name in ("moe.route", "moe.experts", "moe.combine"):
        assert names.count(name) == 2


def test_train_step_spans(tiny):
    step = _train_step(tiny)
    with trace.recording():
        step()
    kept = {s.name: s for s in trace.spans()}
    root = kept["train.step"]
    assert root.parent is None
    assert kept["train.grads"].parent == kept["train.adamw"].parent == root.id
    assert kept["train.grads"].end_ns <= kept["train.adamw"].start_ns


def test_host_counters_grow_within_the_call(tiny):
    eng = _engine(tiny)
    assert all(eng.stats[k] == 0 for k in HOST_NS)
    eng.generate_many(_requests(tiny[0]))
    first = {k: eng.stats[k] for k in HOST_NS}
    eng.generate_many(_requests(tiny[0])[:2])
    for stats in (first, eng.stats):
        assert all(stats[k] > 0 for k in HOST_NS)
        assert sum(stats[k] for k in HOST_NS
                   if k != "call_host_ns") <= stats["call_host_ns"]
    assert all(eng.stats[k] > first[k] for k in HOST_NS)


def test_store_bound_counts_drops(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    with trace.recording():
        for i in range(4):
            with trace.span("s", req=i):
                pass
        trace.interval("w", 0, 1)
    assert [s.req for s in trace.spans()] == [0, 1, 2]
    assert trace.dropped() == 2
    assert len(trace.spans()) == 3          # reading does not clear
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0


def test_self_ns_subtracts_the_union_of_children():
    parent = trace.Span("p", 0, 100, id=1)
    kids = [trace.Span("a", 10, 40, id=2, parent=1),
            trace.Span("b", 30, 50, id=3, parent=1),     # overlaps a
            trace.Span("c", 90, 120, id=4, parent=1),    # past p's end
            trace.Span("d", 35, 38, id=5, parent=2)]     # a's child
    own = trace.self_ns([parent, *kids])
    assert own == {1: 100 - 40 - 10, 2: 30 - 3, 3: 20, 4: 30, 5: 3}


def test_recording_nests_and_ends():
    assert not trace.enabled()
    with trace.recording():
        with trace.recording():
            t0 = time.time_ns()
            with trace.span("outer"):
                with trace.span("inner", req=7):
                    pass
        assert trace.enabled()
    assert not trace.enabled()
    inner, outer = trace.spans()
    assert inner.parent == outer.id and inner.req == 7
    assert t0 <= outer.start_ns <= inner.start_ns <= inner.end_ns \
        <= outer.end_ns
