"""The port's session layer against the reference's.

The model side (``estimate``, ``predict_staging``, the ``Planner``'s
decisions, ``Estimate``'s per-launch terms) is pure arithmetic: both
packages run in-process on the same inputs and are held equal exactly —
the same Python float operations in the same order give the same bits.

The dispatch side runs the reference's :class:`Session` once, in one
8-device x64 subprocess (``run_subprocess``, ``tests/conftest.py``), over
the call sequences of ``_SCRIPT`` — the same code the port replays
in-process on ``Session(device="cpu", num_clusters=8)``.  Results are
held at ``rtol=atol=1e-9`` (the reference's own bar); ``PlanStats``
after every step, planner decisions, stream window stalls, handle job
counts and warning counts are held equal exactly (mirrors
``tests/test_session.py``).
"""

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

import repro_torch.api as t_api
from repro.core import jobs as r_jobs
from repro.core import session as r_session
from repro.core.policy import OffloadPolicy as ROffloadPolicy
from repro_torch.core import jobs as t_jobs
from repro_torch.core import session as t_session
from repro_torch.core.policy import AUTO, OffloadPolicy, Residency, Staging

TOL = dict(rtol=1e-9, atol=1e-9)
NS = (1, 2, 4, 8, 16, 32)

#: (name, size) of every job the model-side comparison covers
CASES = (("axpy", (1024,)), ("atax", (64, 64)), ("matmul", (16, 16, 16)),
         ("covariance", (32, 64)), ("montecarlo", (16384,)), ("bfs", (256,)),
         ("covariance", (1024, 2048)), ("axpy", (16384,)),
         ("matmul", (256, 256, 256)))


def _estimate_record(mod_session, mod_jobs, name, size, n, policy, batch):
    job = mod_jobs.PAPER_JOBS[name](*size)
    est = mod_session.estimate(job, n=n, policy=policy, batch=batch)
    d = est.decision
    return dict(phases={p.name: v for p, v in est.phases.items()},
                job_cycles=est.job_cycles, per_job=est.per_job_cycles,
                staging=dict(est.staging_cycles), rep=est.replicated_bytes,
                decision=(d.n, d.staging.value, d.fuse, d.window,
                          d.residency.value, d.reason),
                per_launch={p.name: v
                            for p, v in est.per_launch_phases.items()},
                table=est.table())


_POLICIES = {
    "auto": ({}, 1), "auto-batch8": ({}, 8),
    "baseline": (dict(info_dist="p2p_chain",
                      completion="central_counter"), 1),
    "fuse4": (dict(fuse=4), 8), "tree-window1": (dict(staging="tree",
                                                      window=1), 1),
    "resident": (dict(residency="resident"), 1),
}


@pytest.mark.parametrize("pol", sorted(_POLICIES))
@pytest.mark.parametrize("name, size", CASES,
                         ids=[f"{n}{'x'.join(map(str, s))}" for n, s in CASES])
def test_estimate_equals_reference(name, size, pol):
    kwargs, batch = _POLICIES[pol]
    for n in NS:
        got = _estimate_record(t_session, t_jobs, name, size, n,
                               OffloadPolicy(**kwargs), batch)
        want = _estimate_record(r_session, r_jobs, name, size, n,
                                ROffloadPolicy(**kwargs), batch)
        assert got == want, (n, got, want)


def test_predict_staging_and_planner_picks_equal_reference():
    for nbytes in (0, 1, 4096, 64 << 10, 1 << 20, 16 << 20, 32 << 20):
        for n in NS:
            for s in ("direct", "host_fanout", "tree", "tree_reshard"):
                assert (t_session.predict_staging(nbytes, n, Staging(s))
                        == r_session.predict_staging(nbytes, n, s))
            for tmb in (None, 0):
                tp = t_session.Planner(tree_min_bytes=tmb)
                rp = r_session.Planner(tree_min_bytes=tmb)
                assert (tp.pick_staging(nbytes, n).value
                        == rp.pick_staging(nbytes, n).value)
                assert (tp.staging_cost(nbytes, n, Staging.TREE)
                        == rp.staging_cost(nbytes, n, Staging.TREE))
    tp, rp = t_session.Planner(), r_session.Planner()
    for name, size in CASES:
        tj, rj = t_jobs.PAPER_JOBS[name](*size), r_jobs.PAPER_JOBS[name](*size)
        for n in NS:
            for batch in (1, 2, 3, 8, 32):
                assert (tp.pick_fuse(tj.spec, n, batch)
                        == rp.pick_fuse(rj.spec, n, batch))
                for fuse in (1, 2, 8):
                    assert (tp.per_job_cycles(tj.spec, n, fuse, 4)
                            == rp.per_job_cycles(rj.spec, n, fuse, 4))
        assert tp.replicated_bytes(tj) == rp.replicated_bytes(rj)
    for batch in (1, 8, 32):
        for fuse in (1, 8):
            for units in (1, 4, 8):
                assert (tp.pick_window(batch, fuse, units)
                        == rp.pick_window(batch, fuse, units))


def test_planner_decisions_pinned_as_in_reference():
    """The reference test's pinned planner facts hold in the port."""
    planner = t_session.Planner()
    assert planner.pick_staging(0, 8) is Staging.DIRECT
    assert planner.pick_staging(1 << 20, 1) is Staging.DIRECT
    for n in (4, 8, 16, 32):
        assert planner.pick_staging(64 * 1024, n) is Staging.TREE
    small = t_jobs.make_covariance(32, 64)
    big = t_jobs.make_covariance(1024, 2048)
    assert planner.decide(small, 8, 1, AUTO, 4).staging is Staging.DIRECT
    assert planner.decide(big, 8, 1, AUTO, 4).staging is Staging.TREE
    assert (t_session.Planner(tree_min_bytes=0).decide(small, 8, 1, AUTO, 4)
            .staging is Staging.TREE)
    assert planner.pick_fuse(t_jobs.make_axpy(16384).spec, 8, batch=32) == 8
    assert planner.pick_fuse(t_jobs.make_matmul(256, 256, 256).spec, 8,
                             batch=32) == 1
    d = planner.decide(t_jobs.make_axpy(1024), 8, 1,
                       AUTO.pinned(residency=Residency.RESIDENT), 4)
    assert d.fuse == 1 and d.staging is Staging.DIRECT
    with pytest.raises(ValueError):
        t_session.estimate(t_jobs.make_axpy(1024))
    with pytest.raises(ValueError):
        t_session.estimate(t_jobs.make_axpy(1024), n=8, clusters=[0, 1])
    with pytest.raises(ValueError):
        t_session.estimate(t_jobs.make_axpy(1024), n=0)
    with pytest.raises(ValueError):
        t_session.estimate(t_jobs.make_axpy(1024), n=8, batch=0)


def test_session_and_scheduler_default_to_the_card(monkeypatch):
    """``Session()`` and ``FabricScheduler()`` mean the card: without one
    they raise instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_api.Session()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_api.Session(num_clusters=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_api.FabricScheduler()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_api.FabricScheduler("cuda", num_clusters=8)
    sess = t_api.Session("cpu")
    assert sess.device == torch.device("cpu") and sess.num_clusters == 32
    assert t_api.FabricScheduler(num_clusters=8).device is None


def test_lint_raises_until_perflint_is_ported():
    """The perf linter is ported: ``Session(lint=True)``, ``submit(...,
    lint=True)`` and ``submit_graph(..., lint=True)`` raise nothing and
    return the linter's findings (``tests/test_torch_perflint.py`` holds
    them to the reference's)."""
    assert not hasattr(t_session, "_LINT_MISSING")
    job = t_jobs.make_axpy(64)
    ops, _ = job.make_instance(0)
    insts, _ = t_jobs.make_instances(job, 16)
    for sess, lint in ((t_api.Session("cpu", num_clusters=2, lint=True),
                        None),
                       (t_api.Session("cpu", num_clusters=2), True)):
        h = sess.submit(job, insts, policy=AUTO.pinned(window=1), lint=lint)
        h.wait()
        assert "OFLP103" in {f.code for f in h.findings}
        assert "perf findings" in h.explain().table()
        gh = sess.submit_graph([t_api.GraphNode(job, ops)], lint=lint)
        gh.wait()
        assert gh.findings == []
    plain = t_api.Session("cpu", num_clusters=2)
    h = plain.submit(job, insts, policy=AUTO.pinned(window=1))
    h.wait()
    assert h.findings == []


# ---------------------------------------------------------------------------
# Dispatch: one reference subprocess, the same script on both sides.
# ---------------------------------------------------------------------------

# Run verbatim by both packages.  ``api`` is ``repro.api`` or
# ``repro_torch.api``, ``jobs`` the package's ``core.jobs``,
# ``session(**kw)`` opens a session on 8 clusters and ``runtime(**kw)`` a
# runtime on them; ``record`` collects exact facts, ``arrays`` results.
_SCRIPT = r'''
def script(api, jobs, session, runtime, trace_permutes):
    import dataclasses, warnings
    import numpy as np
    record, arrays = {}, {}
    def stats(sess):
        return dataclasses.asdict(sess.stats)
    def dec(h):
        d = h.decision
        return [d.n, d.staging.value, d.fuse, d.window, d.residency.value]

    # 1. single / multi (pinned fuse) / resident / resident fused
    job = jobs.make_matmul(32, 16, 16)
    insts, _ = jobs.make_instances(job, 6, seed0=0)
    sess = session(n_units=4)
    steps = []
    h = sess.submit(job, insts[0], n=8)
    arrays["paths/single"] = np.asarray(h.wait())
    steps.append(["single", dec(h), h.jobs, stats(sess)])
    hm = sess.submit(job, insts, n=8, policy=api.OffloadPolicy(fuse=4))
    for i, r in enumerate(hm.wait()):
        arrays[f"paths/multi/{i}"] = np.asarray(r)
    steps.append(["multi", dec(hm), hm.jobs, stats(sess)])
    sess.stage(job, insts[3], n=8)
    hr = sess.submit(job, api.Residency.RESIDENT, n=8,
                     policy=api.OffloadPolicy(window=1))
    arrays["paths/resident"] = np.asarray(hr.wait())
    steps.append(["resident", dec(hr), hr.jobs, stats(sess)])
    sess.stage(job, insts[:4], n=8)
    hf = sess.submit(job, api.Residency.RESIDENT, n=8,
                     policy=api.OffloadPolicy(fuse=4, window=1))
    for i, r in enumerate(hf.wait()):
        arrays[f"paths/fused-resident/{i}"] = np.asarray(r)
    steps.append(["fused-resident", dec(hf), hf.jobs, stats(sess)])
    text = str(h.explain())
    steps.append(["explain", "phase E" in text and "measured" in text
                  and "device_puts" in text])
    record["paths"] = steps

    # 2. successive singles share a pipelined stream (window = n_units)
    job = jobs.make_axpy(2048)
    insts, _ = jobs.make_instances(job, 10, seed0=5)
    sess = session(n_units=3)
    sess.submit(job, insts[0], n=4).wait()
    rt = sess.runtime()
    before = (len(rt._plans), len(rt._compiled))
    handles = [sess.submit(job, insts[i], n=4) for i in range(10)]
    stream = next(iter(sess._streams.values()))
    inflight = stream.inflight
    for i, h in reversed(list(enumerate(handles))):
        arrays[f"stream/{i}"] = np.asarray(h.wait())
    after = (len(rt._plans), len(rt._compiled))
    sess.drain()
    hseq = sess.submit(job, insts[0], n=4,
                       policy=api.OffloadPolicy(window=1))
    arrays["stream/seq"] = np.asarray(hseq.wait())
    record["stream"] = [inflight, stream.stats, before == after,
                        dec(handles[0]), dec(hseq), stats(sess)]

    # 3. AUTO tree staging under a model-faithful planner, then baseline
    job = jobs.make_covariance(64, 128)
    sess = session(planner=api.Planner(tree_min_bytes=0))
    ops, _ = job.make_instance(0)
    h = sess.submit(job, ops, n=8)
    arrays["tree"] = np.asarray(h.wait())
    est = sess.estimate(job, n=8)
    base = api.OffloadPolicy(info_dist=api.InfoDist.P2P_CHAIN,
                             completion=api.Completion.CENTRAL_COUNTER)
    hb = sess.submit(job, ops, n=8, policy=base)
    arrays["tree/baseline"] = np.asarray(hb.wait())
    record["tree"] = [dec(h), dataclasses.asdict(h.explain().stats),
                      dict(est.staging_cycles), stats(sess),
                      trace_permutes(sess.runtime(base), job, 8)]

    # 4. a window pinned above n_units is clamped; an adopted runtime with
    #    a TREE staging default keeps its warm plan and residency
    job = jobs.make_matmul(32, 16, 16)
    insts, _ = jobs.make_instances(job, 12, seed0=0)
    sess = session(n_units=4)
    h = sess.submit(job, insts, n=8,
                    policy=api.OffloadPolicy(fuse=2, window=16))
    for i, r in enumerate(h.wait()):
        arrays[f"cap/{i}"] = np.asarray(r)
    rt = runtime(config=api.OffloadConfig(staging=api.Staging.TREE))
    rt.offload(job, insts[0], n=8).wait()
    s2 = session(runtime=rt)
    arrays["adopted"] = np.asarray(s2.submit(
        job, api.Residency.RESIDENT, n=8,
        policy=api.OffloadPolicy(window=1)).wait())
    record["cap"] = [dec(h), stats(sess), s2.runtime() is rt, stats(s2)]

    # 5. AUTO over every job: single, a list of 8, stage + resident
    sizes = {"axpy": (4096,), "montecarlo": (4096,),
             "matmul": (64, 32, 32), "atax": (64, 64),
             "covariance": (64, 128), "bfs": (64,)}
    auto = {}
    for name, size in sizes.items():
        job = jobs.PAPER_JOBS[name](*size)
        insts, _ = jobs.make_instances(job, 9, seed0=3)
        sess = session()
        rows = []
        h = sess.submit(job, insts[0])
        arrays[f"auto/{name}/single"] = np.asarray(h.wait())
        rows.append([dec(h), stats(sess)])
        hm = sess.submit(job, insts[1:])
        for i, r in enumerate(hm.wait()):
            arrays[f"auto/{name}/list/{i}"] = np.asarray(r)
        rows.append([dec(hm), hm.jobs, stats(sess)])
        d = sess.stage(job, insts[0])
        hr = sess.submit(job, api.Residency.RESIDENT)
        arrays[f"auto/{name}/resident"] = np.asarray(hr.wait())
        rows.append([[d.staging.value, d.fuse, d.window], dec(hr),
                     stats(sess)])
        auto[name] = rows
    record["auto"] = auto

    # 6. legacy spellings warn once per call; the session path is silent
    job = jobs.make_axpy(512)
    operands, _ = job.make_instance(0)
    rt = runtime()
    def count(fn):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            fn()
        return sum(issubclass(x.category, DeprecationWarning) for x in w)
    rt.offload(job, operands, n=2).wait()
    plan = rt.plan(job, operands, n=2)
    counts = [
        count(lambda: rt.offload(job, "resident", n=2).wait()),
        count(lambda: rt.offload(job, api.Residency.RESIDENT, n=2).wait()),
        count(lambda: plan.stage(operands, via="tree")),
        count(lambda: plan.stage(operands, via=api.Staging.TREE)),
    ]
    holder = []
    counts.append(count(lambda: holder.append(
        stream_cls(rt, job, n=2, staging="tree"))))
    counts.append(count(lambda: holder[0].submit("resident").wait()))
    insts, _ = jobs.make_instances(job, 2, seed0=0)
    counts.append(count(lambda: rt.offload_fused(job, insts, n=2).wait()))
    def session_path():
        sess = session()
        sess.submit(job, operands, n=2).wait()
        sess.stage(job, operands, n=2)
        sess.submit(job, api.Residency.RESIDENT, n=2).wait()
        sess.drain()
    counts.append(count(session_path))
    errors = []
    for bad in ("residnet", api.Residency.FRESH):
        try:
            rt.offload(job, bad, n=2)
        except ValueError:
            errors.append(True)
    record["legacy"] = [counts, errors]
    return record, arrays
'''

exec(_SCRIPT)   # defines ``script`` for the port's side

_REFERENCE = r'''
import json
import numpy as np
import repro.api as api
from repro.core import jobs
from repro.core.offload import OffloadRuntime, count_collectives
from repro.core.stream import OffloadStream as stream_cls

{script}

def trace_permutes(rt, job, n):
    return count_collectives(rt.lowered_text(job, n))["collective-permute"]

record, arrays = script(api, jobs, lambda **kw: api.Session(**kw),
                        lambda **kw: OffloadRuntime(**kw), trace_permutes)
np.savez({out!r}, **arrays)
with open({meta!r}, "w") as f:
    json.dump(record, f)
print("OK")
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("session_ref")
    out, meta = str(d / "ref.npz"), str(d / "meta.json")
    subproc(_REFERENCE.format(script=_SCRIPT, out=out, meta=meta),
            timeout=900)
    with np.load(out) as z:
        arrays = {k: z[k] for k in z.files}
    with open(meta) as f:
        return json.load(f), arrays


def _port_session(**kw):
    if "runtime" in kw or "lease" in kw:
        return t_api.Session(**kw)
    return t_api.Session("cpu", num_clusters=8, **kw)


def _port_runtime(**kw):
    return t_api.OffloadRuntime("cpu", num_clusters=8, **kw)


def _port_permutes(rt, job, n):
    from repro_torch.core.offload import count_collectives
    return count_collectives(rt.launch_trace(job, n))["collective-permute"]


@pytest.fixture(scope="module")
def port():
    from repro_torch.core.stream import OffloadStream
    globals()["stream_cls"] = OffloadStream
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        record, arrays = script(t_api, t_jobs, _port_session, _port_runtime,
                                _port_permutes)
    return json.loads(json.dumps(record)), arrays


@pytest.mark.parametrize("part", ["paths", "stream", "tree", "cap", "auto",
                                  "legacy"])
def test_dispatch_record_equals_reference(reference, port, part):
    """Planner decisions, ``PlanStats`` after every step, stream window
    stalls and in-flight counts, job counts and warning counts: exact."""
    want, _ = reference
    got, _ = port
    assert got[part] == want[part]


def test_dispatch_results_match_reference(reference, port):
    _, want = reference
    _, got = port
    assert sorted(got) == sorted(want)
    for key in sorted(want):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)


def test_dispatch_results_match_the_jobs_expected_values(port):
    """Independent of the reference: every session result is the job's
    ``make_instance`` value."""
    _, got = port
    job = t_jobs.make_matmul(32, 16, 16)
    _, exps = t_jobs.make_instances(job, 6, seed0=0)
    np.testing.assert_allclose(got["paths/single"], exps[0], **TOL)
    for i in range(6):
        np.testing.assert_allclose(got[f"paths/multi/{i}"], exps[i], **TOL)
    np.testing.assert_allclose(got["paths/resident"], exps[3], **TOL)
    _, exps = t_jobs.make_instances(t_jobs.make_axpy(2048), 10, seed0=5)
    for i in range(10):
        np.testing.assert_allclose(got[f"stream/{i}"], exps[i], **TOL)
    assert port[0]["stream"][1]["window_stalls"] >= 10 - 3
