"""The port's ``OffloadStream`` and fused dispatch against the reference's.

One 8-device x64 subprocess runs the reference's stream and fused
batches (``run_subprocess``, ``tests/conftest.py``) over the call
sequences of ``_SCRIPT``, which the port replays in-process on
``device="cpu"`` with 8 logical clusters.  Results are held at
``rtol=atol=1e-9``; ``stats`` (``submitted``, ``drained``,
``window_stalls``), in-flight counts, ``PlanStats`` and compile/plan
counts exactly (mirrors ``tests/test_offload_stream.py``).  The property
test over wait orders runs the port alone, against its own sequential
results, as the reference's does; the ``cuda`` case drives the copy
stream on the card.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import json
import warnings

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro_torch.core import jobs as t_jobs
from repro_torch.core.offload import OffloadConfig, OffloadRuntime
from repro_torch.core.policy import Residency
from repro_torch.core.stream import OffloadStream

TOL = dict(rtol=1e-9, atol=1e-9)

_SCRIPT = r'''
def script(jobs, runtime, stream, cfg):
    import dataclasses
    import numpy as np
    record, arrays = {}, {}

    # the window is bounded by the completion-unit copies
    job = jobs.make_axpy(64)
    insts, _ = jobs.make_instances(job, 6, seed0=7)
    rt = runtime(n_units=2)
    s = stream(rt, job, n=8)
    handles = [s.submit(ops) for ops in insts]
    rec = [s.window, dict(s.stats), s.inflight]
    out = s.drain()
    rec += [len(out), s.inflight, dict(s.stats)]
    for i, h in enumerate(handles):
        arrays[f"window/{i}"] = np.asarray(h.wait())
    record["window"] = rec

    # resident submits stage nothing
    rt = runtime(n_units=4)
    rt.offload(job, insts[0], n=8).wait()
    s = stream(rt, job, n=8)
    puts = rt.stats.device_puts
    for i in range(5):
        arrays[f"resident/{i}"] = np.asarray(s.submit(
            resident).wait())
    record["resident"] = [rt.stats.device_puts - puts,
                          dataclasses.asdict(rt.stats)]

    # pipelined 8-cluster stream: one plan, zero rebuilds, 2 puts a job
    job = jobs.make_axpy(2048)
    insts, _ = jobs.make_instances(job, 10, seed0=3)
    rt = runtime(n_units=4)
    s = stream(rt, job, n=8)
    res = s.map(insts)
    compiled, misses = len(rt._compiled), rt.plan_misses
    res2 = s.map(list(reversed(insts)))
    for i, r in enumerate(res + res2):
        arrays[f"map/{i}"] = np.asarray(r)
    record["map"] = [len(rt._compiled) == compiled,
                     rt.plan_misses == misses, dict(s.stats),
                     dataclasses.asdict(rt.stats), rt.unit.outstanding()]

    # every job's stream under donation, then the in-order baseline
    for donate in (False, True):
        rt = runtime(n_units=4, config=cfg(donate_operands=donate))
        rt.offload(job, insts[0], n=8).wait()
        s = stream(rt, job, n=8)
        handles = [s.submit(ops) for ops in insts[:6]]
        for i in (3, 0, 5, 1, 4, 2):
            arrays[f"donate{donate}/{i}"] = np.asarray(handles[i].wait())
        arrays[f"donate{donate}/resident"] = np.asarray(
            rt.offload(job, resident, n=8).wait())
        record[f"donate{donate}"] = [dict(s.stats),
                                     dataclasses.asdict(rt.stats)]

    # fused B=4 of every paper kernel == 4 sequential offloads, bit for bit
    rt = runtime()
    fused = {}
    for name, mk in jobs.PAPER_JOBS.items():
        fjob = mk() if name != "bfs" else mk(64)
        finsts, _ = jobs.make_instances(fjob, 4, seed0=1)
        seq = [np.asarray(rt.offload(fjob, ops, n=4).wait())
               for ops in finsts]
        got = rt.offload_fused(fjob, finsts, n=4).wait_each()
        fused[name] = all(np.array_equal(a, np.asarray(b))
                          for a, b in zip(seq, got))
        for i, b in enumerate(got):
            arrays[f"fused/{name}/{i}"] = np.asarray(b)
    record["fused"] = [fused, rt.unit.outstanding(),
                       dataclasses.asdict(rt.stats)]

    # resident fused redispatch under donation self-heals
    rt = runtime(config=cfg(donate_operands=True))
    job = jobs.make_axpy(1024)
    finsts, _ = jobs.make_instances(job, 4, seed0=2)
    r0 = rt.offload_fused(job, finsts, n=8).wait()
    r1 = rt.offload_fused(job, resident, batch=4, n=8).wait()
    r2 = rt.offload_fused(job, resident, batch=4, n=8).wait()
    arrays["fused-donate"] = np.asarray(r0)
    record["fused-donate"] = [
        bool(np.array_equal(r0, r1) and np.array_equal(r1, r2)),
        rt.stats.fused_jobs, len(rt._compiled),
        dataclasses.asdict(rt.stats)]
    return record, arrays
'''

exec(_SCRIPT)   # defines ``script`` for the port's side

_REFERENCE = r'''
import json, warnings
import numpy as np
warnings.simplefilter("ignore", DeprecationWarning)
from repro.core import jobs
from repro.core.offload import OffloadConfig, OffloadRuntime
from repro.core.policy import Residency
from repro.core.stream import OffloadStream

{script}

resident = Residency.RESIDENT
record, arrays = script(jobs, lambda **kw: OffloadRuntime(**kw),
                        OffloadStream, lambda **kw: OffloadConfig(**kw))
np.savez({out!r}, **arrays)
with open({meta!r}, "w") as f:
    json.dump(record, f, default=str)
print("OK")
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("stream_ref")
    out, meta = str(d / "ref.npz"), str(d / "meta.json")
    subproc(_REFERENCE.format(script=_SCRIPT, out=out, meta=meta),
            timeout=900)
    with np.load(out) as z:
        arrays = {k: z[k] for k in z.files}
    with open(meta) as f:
        return json.load(f), arrays


@pytest.fixture(scope="module")
def port():
    globals()["resident"] = Residency.RESIDENT
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        record, arrays = script(
            t_jobs, lambda **kw: OffloadRuntime("cpu", num_clusters=8, **kw),
            OffloadStream, lambda **kw: OffloadConfig(**kw))
    return json.loads(json.dumps(record, default=str)), arrays


@pytest.mark.parametrize("part", ["window", "resident", "map",
                                  "donateFalse", "donateTrue", "fused",
                                  "fused-donate"])
def test_stream_record_equals_reference(reference, port, part):
    assert port[0][part] == reference[0][part]


def test_stream_results_match_reference(reference, port):
    want, got = reference[1], port[1]
    assert sorted(got) == sorted(want)
    for key in sorted(want):
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)


def test_stream_counts_as_in_reference_test(port):
    """The reference test's pinned numbers hold for the port."""
    record = port[0]
    window, stats, inflight, drained, after, _ = record["window"]
    assert window == 2 and stats["window_stalls"] == 6 - 2
    assert inflight <= 2 and drained == 2 and after == 0
    assert record["resident"][0] == 0
    same_compiled, same_misses, stats, rt_stats, outstanding = record["map"]
    assert same_compiled and same_misses and outstanding == {}
    assert rt_stats["device_puts"] == 2 * 20 + 1
    assert stats["submitted"] == 20
    assert all(record["fused"][0].values())
    ok, fused_jobs, compiled, _ = record["fused-donate"]
    assert ok and fused_jobs == 3 * 4 and compiled == 1


# -- the port alone ---------------------------------------------------------------

_K = 6
_JOB = t_jobs.make_axpy(64)
_INSTS, _EXPECTED = t_jobs.make_instances(_JOB, _K, seed0=7)
_RT = {d: OffloadRuntime("cpu", config=OffloadConfig(donate_operands=d),
                         n_units=4, num_clusters=8) for d in (False, True)}
with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    _STREAMS = {d: OffloadStream(_RT[d], _JOB, n=8) for d in (False, True)}
_BASELINE = {}


def _baseline(donate):
    if donate not in _BASELINE:
        rt = OffloadRuntime("cpu", num_clusters=8,
                            config=OffloadConfig(donate_operands=donate))
        _BASELINE[donate] = [rt.offload(_JOB, ops, n=8).wait()
                             for ops in _INSTS]
    return _BASELINE[donate]


@settings(max_examples=12, deadline=None)
@given(order=st.permutations(list(range(_K))),
       donate=st.sampled_from([False, True]))
def test_stream_out_of_order_wait_matches_sequential(order, donate):
    baseline = _baseline(donate)
    rt, stream = _RT[donate], _STREAMS[donate]
    rt.offload(_JOB, _INSTS[0], n=8).wait()
    handles = [stream.submit(ops) for ops in _INSTS]
    results = {i: handles[i].wait() for i in order}
    for i in range(_K):
        assert np.array_equal(results[i], baseline[i]), (i, order, donate)
        np.testing.assert_allclose(results[i], _EXPECTED[i], **TOL)
    assert rt.unit.outstanding() == {}
    res = rt.offload(_JOB, Residency.RESIDENT, n=8).wait()
    assert np.array_equal(res, baseline[0])


def test_stream_construction_warns_and_validates():
    rt = OffloadRuntime("cpu", num_clusters=8, n_units=4)
    with pytest.warns(DeprecationWarning, match="OffloadStream"):
        OffloadStream(rt, _JOB, n=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for bad in (dict(depth=0), dict(window=0), dict(window=-1)):
            with pytest.raises(ValueError):
                OffloadStream(rt, _JOB, n=1, **bad)
        assert OffloadStream(rt, _JOB, n=1, window=64).window == 4
        fresh = OffloadStream(OffloadRuntime("cpu", num_clusters=8), _JOB,
                              n=1)
        with pytest.raises(KeyError):
            fresh.submit(Residency.RESIDENT)


@pytest.mark.cuda
def test_stream_copy_stream_overlap_on_card():
    """On the card each submit stages on the stream's copy stream while
    earlier jobs compute: results stay exact with the window open, and
    every staged buffer was handed to the launch stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the copy stream exists only there")
    job = t_jobs.make_covariance(256, 512)
    insts, exps = t_jobs.make_instances(job, 8, seed0=11)
    rt = OffloadRuntime("cuda", n_units=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        stream = OffloadStream(rt, job, n=32, window=4)
    handles = [stream.submit(ops) for ops in insts]
    assert stream._copy_stream is not None
    for h, exp in zip(handles, exps):
        np.testing.assert_allclose(h.wait(), exp, **TOL)
    assert stream.stats["window_stalls"] == 8 - 4
