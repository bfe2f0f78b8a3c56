"""The port's fabric scheduler, leases and the retry ladder against the
reference's.

Model-only scheduling (admission, placement, queueing, resize,
preemption, compaction, the pressure ladder, SLO admission) is host
bookkeeping over the §6 model: both packages run the scenarios of
``_model_scenarios`` in-process and every lease window, pending entry,
health counter and error message is held equal exactly (mirrors
``tests/test_fabric.py`` and ``tests/test_preempt.py``).

Sessions on leases, the SLO gate, the fault-injection retry ladder and
lease failover (``tests/test_faults.py``) run the reference once, in one
8-device x64 subprocess, over ``_SCRIPT``; the port replays it on
``device="cpu"`` with 8 logical clusters.  Results are held at
``rtol=atol=1e-9``; attempts, rungs (``SessionHealth``), lease windows
and ``FabricHealth`` exactly.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import json

import numpy as np
import pytest

from repro.core import fabric as r_fabric
from repro.core import jobs as r_jobs
from repro.core.params import OccamyParams as ROccamyParams
from repro.core.policy import TenantKind as RTenantKind
from repro_torch import api as t_api
from repro_torch.core import fabric as t_fabric
from repro_torch.core import jobs as t_jobs
from repro_torch.core.params import OccamyParams as TOccamyParams
from repro_torch.core.policy import TenantKind as TTenantKind

TOL = dict(rtol=1e-9, atol=1e-9)


class _Pkg:
    def __init__(self, fabric, jobs, params, kinds):
        self.f, self.jobs, self.Params, self.Kind = fabric, jobs, params, kinds


REF = _Pkg(r_fabric, r_jobs, ROccamyParams, RTenantKind)
PORT = _Pkg(t_fabric, t_jobs, TOccamyParams, TTenantKind)


def _model_scenarios(p):
    """Every model-only scenario of the reference tests; returns what a
    caller can observe, in order."""
    f, jobs = p.f, p.jobs
    out = {}

    def err(fn):
        try:
            r = fn()
            return ["ok", repr(r)]
        except (ValueError, f.LeaseError) as e:
            return [type(e).__name__, str(e)]

    def leases(s):
        return [[l.lease_id, l.tenant, list(l.clusters)] for l in s.leases]

    def health(s):
        import dataclasses
        return dataclasses.asdict(s.health())

    s = f.FabricScheduler(num_clusters=32)
    lease = s.request("t", n=8)
    out["requests"] = [len(lease.requests()), list(lease.tree().reached()),
                       lease.tree().n_edges]
    out["reject"] = [err(lambda: s.request("t", n=64)),
                     err(lambda: s.request("t", n=0)),
                     err(lambda: s.request("t", clusters=[30, 31, 32]))]
    s = f.FabricScheduler(num_clusters=32)
    a, b = s.request("A", n=8), s.request("B", n=8)
    out["overlap"] = [list(a.clusters), list(b.clusters),
                      err(lambda: s.request("C", clusters=list(a.clusters))),
                      err(lambda: s.request("C", clusters=[16, 18])),
                      err(lambda: s.request("C", n=32))]
    s = f.FabricScheduler(num_clusters=8)
    a = s.request("A", n=8)
    p1 = s.request("B", n=4, queue=True)
    p2 = s.request("C", n=2, queue=True)
    s.release(a)
    out["fifo"] = [p1.ready, p2.ready, list(p1.lease.clusters),
                   list(p2.lease.clusters), len(s.pending)]
    two = p.Params(num_quadrants=2)
    rows = []
    for placement in ("model", "first_fit"):
        s = f.FabricScheduler(num_clusters=8, params=two,
                              policy=f.SchedulerPolicy(placement=placement,
                                                       align=False))
        s.request("busy", clusters=[0, 1])
        rows.append(list(s.request("t", n=4).clusters))
    out["placement"] = rows
    s = f.FabricScheduler(num_clusters=32)
    small = s.request("a", job=jobs.make_axpy(1024), batch=16)
    big = s.request("b", job=jobs.make_matmul(64, 64, 64), batch=16)
    out["slice"] = [list(small.clusters), list(big.clusters),
                    err(lambda: s.request("c")),
                    s.predict_makespan(jobs.make_axpy(1024), small.clusters,
                                       16),
                    s.placement_cost(big.clusters)]
    s = f.FabricScheduler(num_clusters=8)
    lease = s.request("serve", n=2)
    grown = s.resize(lease, 6)
    pend = s.request("offload", n=4, queue=True)
    ready_before = pend.ready
    shrunk = s.resize(grown, 2)
    out["resize"] = [list(grown.clusters), ready_before,
                     list(shrunk.clusters), pend.ready,
                     list(pend.lease.clusters),
                     err(lambda: s.release(grown)),
                     err(lambda: s.resize(shrunk, 8))]
    s = f.FabricScheduler(num_clusters=8)
    a = s.request("A", clusters=[0, 1])
    s.request("B", clusters=[2, 3])
    pend = s.request("C", clusters=[0, 1], queue=True)
    grown = s.resize(a, 4)
    out["relocate"] = [list(grown.clusters), pend.ready,
                       list(pend.lease.clusters)]
    # backfill aging
    s = f.FabricScheduler(num_clusters=8,
                          policy=f.SchedulerPolicy(aging_grants=2))
    holds = [s.request("hold0", clusters=[0, 1, 2, 3]),
             s.request("hold1", clusters=[4, 5, 6, 7])]
    bigp = s.request(f.Tenant("big"), n=8, queue=True)
    smalls = [s.request(f.Tenant(f"s{k}"), n=4, queue=True)
              for k in range(3)]
    trace = []
    for rel in (lambda: s.release(holds[0]),
                lambda: s.release(smalls[0].lease),
                lambda: s.release(smalls[1].lease),
                lambda: s.release(holds[1]),
                lambda: s.release(bigp.lease)):
        rel()
        trace.append([bigp.ready, bigp.skipped] + [x.ready for x in smalls])
    out["aging"] = trace
    s = f.FabricScheduler(num_clusters=4)
    hold = s.request("hold", n=4)
    light = s.request(f.Tenant("light", weight=1.0), n=4, queue=True)
    heavy = s.request(f.Tenant("heavy", weight=8.0), n=4, queue=True)
    s.release(hold)
    out["weights"] = [heavy.ready, light.ready]
    s = f.FabricScheduler(num_clusters=4)
    hold = s.request("hold", n=4)
    pend = s.request(f.Tenant("t"), n=2, queue=True)
    s.cancel(pend)
    c1 = err(lambda: s.cancel(pend))
    pend2 = s.request(f.Tenant("t2"), n=2, queue=True)
    s.release(hold)
    out["cancel"] = [c1, err(lambda: s.cancel(pend2)),
                     err(lambda: s.cancel(f.PendingLease("x", 2, None,
                                                         None, 1)))]
    # SLO admission
    s = f.FabricScheduler(num_clusters=4,
                          policy=f.SchedulerPolicy(max_queue_depth=1))
    s.request("hold", n=4, job=jobs.make_axpy(1024))
    s.request(f.Tenant("q0"), n=4, queue=True)
    try:
        s.request(f.Tenant("q1"), n=4, queue=True)
        shed = None
    except f.Overloaded as e:
        shed = [str(e), e.retry_after_cycles]
    out["depth"] = [shed, health(s)]
    s = f.FabricScheduler(num_clusters=4)
    s.request("hold", n=4, job=jobs.make_axpy(1024))
    job = jobs.make_covariance(32, 64)
    try:
        s.request(f.Tenant("tight", slo=1.0), n=4, job=job, queue=True)
        shed = None
    except f.Overloaded as e:
        shed = [str(e), e.retry_after_cycles]
    ok = s.request(f.Tenant("ok", slo=1e12), n=4, job=job, queue=True)
    out["slo"] = [shed, type(ok).__name__, health(s)]
    # preemption lifecycle
    s = f.FabricScheduler(num_clusters=8)
    victim = s.request(f.Tenant("victim"), clusters=[0, 1, 2, 3],
                       job=jobs.make_axpy(1024))
    blocker = s.request("blocker", clusters=[4, 5, 6, 7])
    taker = s.request(f.Tenant("taker", weight=8.0), n=4, queue=True)
    deadline = s.drain_deadline(victim)
    pend = s.preempt(victim)
    row = [deadline, taker.ready, pend.ready, pend.resume_id,
           s.current_lease(victim) is None]
    s.release(blocker)
    out["preempt"] = row + [pend.ready, pend.lease.lease_id,
                            list(pend.lease.clusters), health(s)]
    s = f.FabricScheduler(num_clusters=8)
    lease = s.request(f.Tenant("t"), n=4, job=job, batch=3)
    out["deadline"] = [s.drain_deadline(lease),
                       s.predict_makespan(job, lease.clusters, 3)]
    s = f.FabricScheduler(num_clusters=4)
    lease = s.request(f.Tenant("t"), n=2)
    s.revoke(lease)
    out["revoke"] = [s.current_lease(lease) is None, len(s.pending),
                     err(lambda: s.preempt(lease)), health(s)]
    s = f.FabricScheduler(num_clusters=8)
    a = s.request("a", clusters=[0, 1])
    b = s.request("b", clusters=[4, 5])
    e1 = err(lambda: s.request("big", n=4))
    moves = s.compact()
    out["compact"] = [e1, moves, leases(s),
                      list(s.request("big", n=4).clusters), health(s)]
    prio = f.SchedulerPolicy(preemption="priority")
    s = f.FabricScheduler(num_clusters=8, policy=prio)
    serve = s.request(f.Tenant("serve", kind=p.Kind.SERVE), n=4)
    s.register_elastic(serve, floor=2)
    s.request(f.Tenant("other"), clusters=[4, 5, 6, 7])
    lease = s.request(f.Tenant("t", priority=1), n=2)
    out["elastic"] = [list(lease.clusters), leases(s), health(s),
                      s.elastic_floor(s.current_lease(serve))]
    s = f.FabricScheduler(num_clusters=8, policy=prio)
    serve = s.request(f.Tenant("serve", kind=p.Kind.SERVE), n=4)
    s.register_elastic(serve, floor=4)
    low = s.request(f.Tenant("low", priority=0), clusters=[4, 5, 6, 7])
    l1 = s.request(f.Tenant("hi", priority=1), n=2)
    l2 = s.request(f.Tenant("hi", priority=1), n=4)
    out["halve"] = [list(l1.clusters), list(l2.clusters), leases(s),
                    [pp.resume_id for pp in s.pending], health(s),
                    s.current_lease(low) is None]
    s = f.FabricScheduler(num_clusters=32, policy=prio)
    s.request(f.Tenant("low", priority=0), n=16, job=jobs.make_axpy(1024))
    s.request(f.Tenant("pad", priority=0), n=8)
    lease = s.request(f.Tenant("hi", priority=1), n=16, job=job, batch=4)
    out["degrade"] = [list(lease.clusters), health(s), leases(s)]
    s = f.FabricScheduler(num_clusters=8, policy=prio)
    victim = s.request(f.Tenant("victim", priority=0), n=8,
                       job=jobs.make_axpy(1024))
    hi = s.request(f.Tenant("hi", priority=1), n=8,
                   job=jobs.make_axpy(1024))
    pend = next(pp for pp in s.pending if pp.resume_id == victim.lease_id)
    s.release(hi)
    out["starve"] = [pend.ready, pend.lease.lease_id, health(s)]
    # failure handling without sessions
    s = f.FabricScheduler(num_clusters=8)
    a = s.request("a", clusters=[0, 1, 2, 3])
    replaced = s.fail_clusters([1])
    s2 = f.FabricScheduler(num_clusters=2)
    lost = s2.request("t", n=2)
    out["fail"] = [[list(l.clusters) for l in replaced],
                   list(s.unhealthy_clusters()), health(s),
                   err(lambda: s.request("x", clusters=[1])),
                   [list(l.clusters) for l in s2.fail_clusters([0, 1])],
                   s2.current_lease(lost) is None, health(s2)]
    s.restore_clusters([1])
    out["restore"] = [list(s.free_clusters())]
    return out


def test_model_only_scheduling_equals_reference():
    got = json.loads(json.dumps(_model_scenarios(PORT)))
    want = json.loads(json.dumps(_model_scenarios(REF)))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key


def test_model_only_facts_as_in_reference_tests():
    got = _model_scenarios(PORT)
    assert got["requests"][0] == 1
    assert got["placement"] == [[4, 5, 6, 7], [2, 3, 4, 5]]
    small, big = got["slice"][0], got["slice"][1]
    assert len(small) < len(big)
    assert got["aging"][2][:2] == [False, 2] and not got["aging"][2][4]
    assert got["weights"] == [True, False]
    assert got["preempt"][-3:-1] == [1, [4, 5, 6, 7]]
    assert got["compact"][1] == 1
    assert got["halve"][1] == [4, 5, 6, 7]


def test_lease_validation_and_session_conflicts():
    with pytest.raises(ValueError):
        t_fabric.ClusterLease(1, "t", ())
    with pytest.raises(ValueError):
        t_fabric.ClusterLease(1, "t", (3, 1))
    sched = t_fabric.FabricScheduler(num_clusters=4)
    lease = sched.request("t", n=2)
    with pytest.raises(ValueError, match="lease or"):
        t_api.Session("cpu", lease=lease)
    with pytest.raises(t_fabric.LeaseError, match="model-only"):
        t_api.Session(lease=lease)
    sess = t_api.Session("cpu", num_clusters=2)
    assert isinstance(sess.lease, t_fabric.ClusterLease)
    assert sess.lease.clusters == (0, 1) and sess.lease.tenant == "default"
    sess.close()
    assert sess.closed
    job = t_jobs.make_axpy(64)
    with pytest.raises(RuntimeError, match="closed session"):
        sess.submit(job, {"x": np.zeros(64), "y": np.zeros(64)})
    with pytest.raises(RuntimeError, match="closed session"):
        sess.estimate(job)
    sess.close()
    sched = t_fabric.FabricScheduler("cpu", num_clusters=4)
    lease = sched.request("t", n=2)
    assert lease.device == sched.device == sched.devices_for((0, 1))
    sess = t_api.Session(lease=lease)
    sched.release(lease)
    sess.close()
    assert sess.closed and not lease.active


# ---------------------------------------------------------------------------
# Sessions on leases, the SLO gate, faults and failover: one subprocess.
# ---------------------------------------------------------------------------

_SCRIPT = r'''
def script(api, jobs, session, fabric):
    import dataclasses
    import numpy as np
    record, arrays = {}, {}
    def health(h):
        return dataclasses.asdict(h)

    # disjoint leases in flight at once == the whole fabric, sequentially
    sched = fabric()
    A = sched.request("tenantA", clusters=[0, 1, 2, 3])
    B = sched.request("tenantB", clusters=[4, 5, 6, 7])
    sa, sb = session(lease=A), session(lease=B)
    axpy, atax = jobs.make_axpy(1024), jobs.make_atax(32, 32)
    ia, _ = jobs.make_instances(axpy, 4, seed0=0)
    it, _ = jobs.make_instances(atax, 4, seed0=10)
    handles = []
    for k in range(4):
        handles.append(("A", k, sa.submit(axpy, ia[k])))
        handles.append(("B", k, sb.submit(atax, it[k])))
    for who, k, h in handles:
        arrays[f"lease/{who}/{k}"] = np.asarray(h.wait())
    keys = [sorted(str(k[1]) for k in s.runtime()._plans)
            for s in (sa, sb)]
    sa.close(); sb.close()
    full = session()
    for k in range(4):
        arrays[f"lease/seqA/{k}"] = np.asarray(
            full.submit(axpy, ia[k], clusters=[0, 1, 2, 3]).wait())
        arrays[f"lease/seqB/{k}"] = np.asarray(
            full.submit(atax, it[k], clusters=[4, 5, 6, 7]).wait())
    record["lease"] = [keys, A.active, B.active]

    # a lease away from cluster 0 stages through its own tree
    sched = fabric()
    sched.request("pad", clusters=[0, 1, 2, 3])
    lease = sched.request("t", clusters=[4, 5, 6, 7])
    sess = session(lease=lease)
    job = jobs.make_covariance(16, 32)
    ops, _ = job.make_instance(0)
    h = sess.submit(job, ops, policy=api.OffloadPolicy(
        staging=api.Staging.TREE, fuse=1, window=1))
    arrays["tree"] = np.asarray(h.wait())
    plan = next(iter(sess.runtime()._plans.values()))
    record["tree"] = [list(plan.cluster_ids), plan._stager.tree.root,
                      dataclasses.asdict(plan.stats)]
    sess.close()

    # the session's SLO gate sheds a predictably slow submit
    job = jobs.make_covariance(32, 64)
    ops, _ = job.make_instance(0)
    slo = []
    for tight, limit in (("tight", 10.0), ("ok", 1e12)):
        sched = fabric()
        lease = sched.request(api.Tenant(tight, slo=limit), clusters=[0, 1])
        sess = session(lease=lease)
        try:
            arrays[f"slo/{tight}"] = np.asarray(
                sess.submit(job, dict(ops), n=2).wait())
            slo.append("ok")
        except api.Overloaded as e:
            slo.append([str(e), e.retry_after_cycles])
        sess.close()
    record["slo"] = slo

    # the retry ladder: transient, straggle (backup race), mild straggle,
    # cluster death (probes + disjoint window), exhaustion
    job = jobs.make_axpy(512)
    ops, _ = job.make_instance(0)
    arrays["faults/ref"] = np.asarray(session().submit(
        job, dict(ops), n=4).wait())
    F, S = api.FaultKind, api.FaultSpec
    cases = {
        "lost": ([S(F.LOST_ARRIVAL, at_dispatch=0, count=1)], {}),
        "straggle": ([S(F.STRAGGLE, at_dispatch=0, factor=10.0)], {}),
        "mild": ([S(F.STRAGGLE, at_dispatch=0, factor=0.5)], {}),
        "death": ([S(F.CLUSTER_DEATH, at_dispatch=0, clusters=(1,))], {}),
        "exhaust": ([S(F.CLUSTER_DEATH, at_dispatch=0,
                       clusters=tuple(range(8)))],
                    dict(max_attempts=2, failover=False)),
    }
    faults = {}
    for name, (specs, retry) in cases.items():
        inj = api.FaultInjector(api.FaultPlan(specs))
        sess = session(policy=api.OffloadPolicy(
            retry=api.RetryPolicy(**retry)), faults=inj)
        try:
            arrays[f"faults/{name}"] = np.asarray(sess.submit(
                job, dict(ops), n=4).wait())
            outcome = "ok"
        except api.FaultError as e:
            outcome = ["FaultError", str(e)]
        faults[name] = [outcome, health(sess.health())]
        sess.close()
    # a list submit rides the ladder job by job
    inj = api.FaultInjector(api.FaultPlan(
        [S(F.LOST_ARRIVAL, at_dispatch=1, count=2)]))
    sess = session(policy=api.OffloadPolicy(retry=api.RetryPolicy()),
                   faults=inj)
    insts, _ = jobs.make_instances(job, 3, seed0=4)
    for i, r in enumerate(sess.submit(job, insts, n=4).wait()):
        arrays[f"faults/list/{i}"] = np.asarray(r)
    faults["list"] = ["ok", health(sess.health())]
    try:
        session().submit(job, api.Residency.RESIDENT, policy=api.OffloadPolicy(
            retry=api.RetryPolicy()))
        faults["resident"] = None
    except ValueError as e:
        faults["resident"] = str(e)
    record["faults"] = faults

    # lease failover (rung 3), degradation, resident restage on failover
    fo = []
    sched = fabric()
    lease = sched.request(api.Tenant("t"), clusters=[0, 1, 2, 3])
    inj = api.FaultInjector(api.FaultPlan(
        [S(F.CLUSTER_DEATH, at_dispatch=0, clusters=(0, 1, 2, 3))]))
    sess = session(lease=lease, policy=api.OffloadPolicy(
        retry=api.RetryPolicy()), faults=inj)
    arrays["failover/lease"] = np.asarray(sess.submit(
        job, dict(ops), n=4).wait())
    fo.append([list(sess.lease.clusters), health(sess.health()),
               dataclasses.asdict(sched.health())])
    sess.close()
    fo.append(len(sched.leases))
    sched = fabric()
    lease = sched.request(api.Tenant("t"), n=8)
    inj = api.FaultInjector(api.FaultPlan(
        [S(F.CLUSTER_DEATH, at_dispatch=0, clusters=(2,))]))
    sess = session(lease=lease, policy=api.OffloadPolicy(
        retry=api.RetryPolicy(backup=False)), faults=inj)
    arrays["failover/degrade"] = np.asarray(sess.submit(
        job, dict(ops), n=8).wait())
    fo.append([list(sess.lease.clusters), health(sess.health()),
               dataclasses.asdict(sched.health())])
    sess.close()
    sched = fabric()
    lease = sched.request(api.Tenant("t"), clusters=[0, 1, 2, 3])
    inj = api.FaultInjector(api.FaultPlan(
        [S(F.CLUSTER_DEATH, at_dispatch=99, clusters=(1,))]))
    sess = session(lease=lease, faults=inj)
    sess.stage(job, dict(ops), n=4)
    arrays["failover/r1"] = np.asarray(sess.submit(
        job, api.Residency.RESIDENT, n=4).wait())
    sched.fail_clusters([1])
    arrays["failover/r2"] = np.asarray(sess.submit(
        job, api.Residency.RESIDENT, n=4).wait())
    fo.append([list(sess.lease.clusters), health(sess.health()),
               dataclasses.asdict(sched.health()),
               dataclasses.asdict(sess.stats)])
    sess.close()
    record["failover"] = fo

    # preemption with a bound session: suspend, resume, restage
    sched = fabric()
    lease = sched.request(api.Tenant("victim"), clusters=[0, 1, 2, 3])
    sess = session(lease=lease)
    mm = jobs.make_matmul(16, 16, 16)
    mops, _ = mm.make_instance(5)
    sess.stage(mm, dict(mops), n=4)
    arrays["preempt/before"] = np.asarray(sess.submit(
        mm, api.Residency.RESIDENT, n=4).wait())
    blocker = sched.request("blocker", clusters=[4, 5, 6, 7])
    taker = sched.request(api.Tenant("taker", weight=8.0), n=4, queue=True)
    pend = sched.preempt(lease)
    try:
        sess.submit(mm, api.Residency.RESIDENT, n=4)
        suspended = None
    except RuntimeError as e:
        suspended = str(e)
    waiting = [taker.ready, pend.ready]
    sched.release(blocker)
    arrays["preempt/after"] = np.asarray(sess.submit(
        mm, api.Residency.RESIDENT, n=4).wait())
    record["preempt"] = [suspended, waiting, pend.ready,
                         list(sess.lease.clusters),
                         health(sess.health()),
                         dataclasses.asdict(sched.health())]
    sess.close()
    return record, arrays
'''

exec(_SCRIPT)   # defines ``script`` for the port's side

_REFERENCE = r'''
import json
import numpy as np
import jax
import repro.api as api
from repro.core import jobs

{script}

record, arrays = script(api, jobs, lambda **kw: api.Session(**kw),
                        lambda: api.FabricScheduler(jax.devices()))
np.savez({out!r}, **arrays)
with open({meta!r}, "w") as f:
    json.dump(record, f)
print("OK")
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("fabric_ref")
    out, meta = str(d / "ref.npz"), str(d / "meta.json")
    subproc(_REFERENCE.format(script=_SCRIPT, out=out, meta=meta),
            timeout=900)
    with np.load(out) as z:
        arrays = {k: z[k] for k in z.files}
    with open(meta) as f:
        return json.load(f), arrays


def _session(**kw):
    if "runtime" in kw or "lease" in kw:
        return t_api.Session(**kw)
    return t_api.Session("cpu", num_clusters=8, **kw)


@pytest.fixture(scope="module")
def port():
    record, arrays = script(
        t_api, t_jobs, _session,
        lambda: t_api.FabricScheduler("cpu", num_clusters=8))
    return json.loads(json.dumps(record)), arrays


@pytest.mark.parametrize("part", ["lease", "tree", "slo", "faults",
                                  "failover", "preempt"])
def test_fabric_record_equals_reference(reference, port, part):
    """Lease windows, plan keys, staging counters, SLO sheds, every
    retry-ladder counter (attempts, trips, probes, backups, failovers)
    and the scheduler's health: exact."""
    assert port[0][part] == reference[0][part]


def test_fabric_results_match_reference(reference, port):
    want, got = reference[1], port[1]
    assert sorted(got) == sorted(want)
    for key in sorted(want):
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)


def test_recovery_bit_identical_in_the_port(port):
    """The reference test's contract on the port alone: recoverable
    faults leave results bit-identical to a fault-free run."""
    record, arrays = port
    ref = arrays["faults/ref"]
    for name in ("lost", "straggle", "mild", "death"):
        assert np.array_equal(arrays[f"faults/{name}"], ref), name
    h = record["faults"]["lost"][1]
    assert (h["deadline_trips"], h["retries"], h["probes"],
            h["backups"]) == (1, 1, 1, 0)
    assert record["faults"]["straggle"][1]["backups"] == 1
    assert record["faults"]["mild"][1]["deadline_trips"] == 0
    assert record["faults"]["exhaust"][0][0] == "FaultError"
    assert "host operand snapshots" in record["faults"]["resident"]
    assert np.array_equal(arrays["failover/lease"], ref)
    assert np.array_equal(arrays["failover/degrade"], ref)
    assert np.array_equal(arrays["failover/r1"], arrays["failover/r2"])
    assert np.array_equal(arrays["preempt/before"], arrays["preempt/after"])
    for who in ("A", "B"):
        for k in range(4):
            assert np.array_equal(arrays[f"lease/{who}/{k}"],
                                  arrays[f"lease/seq{who}/{k}"])
    assert record["failover"][0][0] == [4, 5, 6, 7]
    assert record["slo"][1] == "ok" and record["slo"][0][0].startswith(
        "tenant 'tight'")
