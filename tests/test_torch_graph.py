"""The port's dependent job graphs against the reference's.

``Session.submit_graph`` runs in one 8-device x64 reference subprocess
(``run_subprocess``, ``tests/conftest.py``) over the graphs of
``_SCRIPT`` — chains, diamonds across disjoint selections, ordering
edges and fetch overrides, donation renames, a graph across two fabric
leases, forwarding into replicated and sharded operands, resident nodes
and random DAGs — which the port replays in-process on
``device="cpu"`` with 8 logical clusters.  Results are held at
``rtol=atol=1e-9``; graph issue orders, ``max_inflight``, the per-edge
``forwarded`` bytes, ``PlanStats`` (``forwards``, ``forward_bytes``,
``renames``, ``d2h_bytes`` …) and the typed errors exactly (mirrors
``tests/test_graph.py``).  The graph simulator is pure numpy and runs
in-process against the reference's, exactly.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import json
import random

import numpy as np
import pytest

from repro.core import jobs as r_jobs
from repro.core import simulator as r_sim
from repro_torch import api as t_api
from repro_torch.core import jobs as t_jobs
from repro_torch.core import simulator as t_sim
from repro_torch.core.offload import _donate

TOL = dict(rtol=1e-9, atol=1e-9)

_SCRIPT = r'''
def script(api, jobs, session, runtime, fabric, delete):
    import dataclasses, random
    import numpy as np
    GraphNode, Ref = api.GraphNode, api.Ref
    record, arrays = {}, {}
    def stats(s):
        return dataclasses.asdict(s.stats)
    def fwd(gh):
        return {f"{a},{b},{c}": v for (a, b, c), v in gh.forwarded.items()}

    # 1. a K=8 chain: only the sink is fetched, intermediates alias
    job = jobs.make_axpy(2048)
    ops, _ = job.make_instance(0)
    K = 8
    s = session()
    nodes = [GraphNode(job, ops, name="n0")]
    for k in range(1, K):
        nodes.append(GraphNode(job, {"x": ops["x"], "y": Ref(f"n{k-1}")},
                               name=f"n{k}"))
    gh = s.submit_graph(nodes)
    out = gh.wait()
    arrays["chain"] = np.asarray(out[f"n{K-1}"])
    rec = [sorted(out), stats(s), gh.issue_order, fwd(gh)]
    s2 = session()
    y = dict(ops)
    for k in range(K):
        r = s2.submit(job, y).wait()
        y = {"x": ops["x"], "y": r}
    arrays["chain/sequential"] = np.asarray(r)
    again = gh.wait()
    rec += [stats(s2),
            bool(np.array_equal(np.asarray(again[f"n{K-1}"]),
                                np.asarray(gh.result(f"n{K-1}")))),
            stats(s)]
    record["chain"] = rec

    # 2. a diamond across disjoint selections
    s = session()
    nodes = [GraphNode(job, ops, name="src"),
             GraphNode(job, {"x": ops["x"], "y": Ref("src")}, name="l",
                       clusters=[0, 1, 2, 3]),
             GraphNode(job, {"x": ops["x"], "y": Ref("src")}, name="r",
                       clusters=[4, 5, 6, 7]),
             GraphNode(job, {"x": Ref("l"), "y": Ref("r")}, name="join")]
    gh = s.submit_graph(nodes)
    out = gh.wait()
    arrays["diamond"] = np.asarray(out["join"])
    record["diamond"] = [sorted(out), gh.max_inflight, gh.issue_order,
                         fwd(gh), stats(s)]

    # 3. after= ordering, fetch overrides, the typed error surface
    job = jobs.make_axpy(512)
    ops, _ = job.make_instance(0)
    s = session()
    h1 = s.submit(job, ops, clusters=[0, 1])
    h2 = s.submit(job, ops, clusters=[4, 5], after=[h1])
    arrays["after"] = np.asarray(h2.wait())
    h1.wait()
    nodes = [GraphNode(job, ops, name="a"),
             GraphNode(job, {"x": ops["x"], "y": Ref("a")}, name="b",
                       fetch=True),
             GraphNode(job, {"x": ops["x"], "y": Ref("b")}, name="c",
                       after=["a"], fetch=False)]
    gh = s.submit_graph(nodes)
    out = gh.wait()
    arrays["fetch/b"] = np.asarray(out["b"])
    arrays["fetch/c"] = np.asarray(gh.result("c"))
    errors = []
    bad = [lambda: s.submit_graph([]),
           lambda: s.submit_graph(["not a node"]),
           lambda: s.submit_graph(
               [GraphNode(job, {"x": ops["x"], "y": Ref("ghost")})]),
           lambda: s.submit_graph(
               [GraphNode(job, ops, name="a", after=["b"]),
                GraphNode(job, ops, name="b", after=["a"])]),
           lambda: s.submit_graph(
               [GraphNode(job, ops)],
               policy=api.OffloadPolicy(
                   retry=api.RetryPolicy(max_attempts=2)))]
    for fn in bad:
        try:
            fn()
            errors.append(None)
        except api.GraphError as e:
            errors.append([type(e).__name__, str(e)])
    record["after"] = [sorted(out), gh.issue_order, errors, stats(s)]

    # 4. donation: forwarded buffers renamed, never consumed in place
    job = jobs.make_axpy(2048)
    ops, _ = job.make_instance(0)
    pol = api.OffloadPolicy(donate_operands=True)
    donating = lambda: runtime(config=api.OffloadConfig(
        donate_operands=True))
    s = session(runtime=donating())
    nodes = [GraphNode(job, ops, name="n0"),
             GraphNode(job, {"x": Ref("n0"), "y": Ref("n0")}, name="n1"),
             GraphNode(job, {"x": ops["x"], "y": Ref("n1")}, name="n2")]
    gh = s.submit_graph(nodes, policy=pol)
    arrays["donate"] = np.asarray(gh.wait()["n2"])
    s2 = session(runtime=donating())
    r0 = s2.submit(job, ops, policy=pol).wait()
    r1 = s2.submit(job, {"x": r0, "y": r0}, policy=pol).wait()
    r2 = s2.submit(job, {"x": ops["x"], "y": r1}, policy=pol).wait()
    arrays["donate/sequential"] = np.asarray(r2)
    s3 = session(runtime=donating())
    ha = s3.submit(job, ops, policy=pol)
    delete([p for _, p in ha._parts][0].result)
    raised = []
    for _ in range(2):
        try:
            ha.wait()
            raised.append(None)
        except api.DonatedOperandError as e:
            raised.append(e.code)
    record["donate"] = [stats(s), fwd(gh), stats(s2), raised]

    # 5. a graph across two fabric leases
    sched = fabric()
    sa = sched.session("a", 4)
    sb = sched.session("b", 4)
    nodes = [GraphNode(job, ops, name="src", session=sa),
             GraphNode(job, {"x": ops["x"], "y": Ref("src")},
                       name="consume", session=sb)]
    gh = sched.submit_graph(nodes)
    out = gh.wait()
    arrays["lease"] = np.asarray(out["consume"])
    try:
        sched.submit_graph([GraphNode(job, ops)])
        lease_err = None
    except api.GraphError as e:
        lease_err = str(e)
    record["lease"] = [stats(sa), stats(sb), fwd(gh), lease_err,
                       list(sa.lease.clusters), list(sb.lease.clusters)]
    sa.close(); sb.close()

    # 6. forwarding into replicated and sharded operands, tree staging
    #    and a resident node
    atax = jobs.make_atax(16, 16)
    mm = jobs.make_matmul(16, 16, 16)
    cov = jobs.make_covariance(32, 32)
    aops, _ = atax.make_instance(1)
    mops, _ = mm.make_instance(2)
    cops, _ = cov.make_instance(3)
    s = session()
    s.stage(mm, mops, n=4)
    nodes = [GraphNode(atax, aops, name="a0"),
             GraphNode(atax, {"A": aops["A"], "x": Ref("a0")}, name="a1"),
             GraphNode(atax, {"A": aops["A"], "x": Ref("a1")}, name="a2",
                       n=2),
             GraphNode(mm, mops, name="m0"),
             GraphNode(mm, {"A": Ref("m0"), "B": Ref("m0")}, name="m1"),
             GraphNode(mm, {"A": mops["A"], "B": Ref("m1")}, name="m2",
                       clusters=[2, 3]),
             GraphNode(mm, api.Residency.RESIDENT, name="mr", n=4),
             GraphNode(cov, cops, name="c0"),
             GraphNode(cov, {"data": Ref("c0")}, name="c1"),
             GraphNode(cov, {"data": Ref("c1")}, name="c2", n=4)]
    gh = s.submit_graph(nodes, policy=api.OffloadPolicy(
        staging=api.Staging.TREE))
    out = gh.wait()
    for k, v in out.items():
        arrays[f"mixed/{k}"] = np.asarray(v)
    record["mixed"] = [sorted(out), gh.issue_order, gh.max_inflight,
                       gh.window_stalls, fwd(gh), stats(s)]

    # 7. random DAGs: bit-equal to sequential submit/wait
    job = jobs.make_axpy(512)
    rand = []
    for seed in range(4):
        rng = random.Random(seed)
        ops, _ = job.make_instance(seed)
        n_nodes = rng.randint(3, 9)
        nodes, sels = [], []
        for i in range(n_nodes):
            w = rng.choice([1, 2, 4, 8])
            s0 = rng.randint(0, 8 - w)
            sel = list(range(s0, s0 + w))
            pick = lambda: (Ref(rng.randrange(i)) if i and rng.random() < 0.6
                            else None)
            x, y = pick(), pick()
            nodes.append(GraphNode(
                job, {"x": x if x is not None else ops["x"],
                      "y": y if y is not None else ops["y"]},
                clusters=sel, fetch=True))
            sels.append(sel)
        s = session()
        gh = s.submit_graph(nodes)
        out = gh.wait()
        s2 = session()
        seq = []
        for i, nd in enumerate(nodes):
            operands = {k: (np.asarray(seq[v.node]) if isinstance(v, Ref)
                            else v) for k, v in nd.operands.items()}
            seq.append(s2.submit(job, operands, clusters=sels[i]).wait())
        for i in range(n_nodes):
            arrays[f"random/{seed}/{i}"] = np.asarray(out[i])
            arrays[f"random/{seed}/{i}/sequential"] = np.asarray(seq[i])
        rand.append([gh.issue_order, gh.max_inflight, fwd(gh), stats(s),
                     stats(s2)])
        s.drain(); s2.drain()
    record["random"] = rand
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
                        lambda **kw: api.OffloadRuntime(**kw),
                        lambda: api.FabricScheduler(),
                        lambda v: v.delete())
np.savez({out!r}, **arrays)
with open({meta!r}, "w") as f:
    json.dump(record, f)
print("OK")
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("graph_ref")
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
        lambda **kw: t_api.OffloadRuntime("cpu", num_clusters=8, **kw),
        lambda: t_api.FabricScheduler("cpu", num_clusters=8), _donate)
    return json.loads(json.dumps(record)), arrays


@pytest.mark.parametrize("part", ["chain", "diamond", "after", "donate",
                                  "lease", "mixed", "random"])
def test_graph_record_equals_reference(reference, port, part):
    """Issue orders, in-flight peaks, per-edge forwarded bytes, every
    ``PlanStats`` counter and the typed errors: exact."""
    assert port[0][part] == reference[0][part]


def test_graph_results_match_reference(reference, port):
    want, got = reference[1], port[1]
    assert sorted(got) == sorted(want)
    for key in sorted(want):
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)


def test_graph_results_bit_identical_to_sequential(port):
    """The port's own graph path against its own submit/wait path: the
    same bits, and intermediates never cross to the host."""
    record, arrays = port
    for a, b in (("chain", "chain/sequential"),
                 ("donate", "donate/sequential")):
        assert np.array_equal(arrays[a], arrays[b]), a
    for key in arrays:
        if key.startswith("random/") and not key.endswith("sequential"):
            assert np.array_equal(arrays[key], arrays[key + "/sequential"])
    out, stats, _, fwd, seq_stats, idem, stats_after = record["chain"]
    assert out == ["n7"]
    assert stats["d2h_bytes"] == arrays["chain"].nbytes
    assert stats["forwards"] == 7 and stats["forward_bytes"] == 0
    assert seq_stats["d2h_bytes"] == 8 * arrays["chain"].nbytes
    assert idem and stats_after["d2h_bytes"] == stats["d2h_bytes"]
    nbytes = 2048 * 8
    diamond = record["diamond"][3]
    assert diamond == {"0,1,y": nbytes, "0,2,y": nbytes, "1,3,x": nbytes,
                       "2,3,y": nbytes}
    assert record["lease"][0]["d2h_bytes"] == 0
    assert record["donate"][0]["renames"] >= 3
    assert record["donate"][3] == ["OFL003", "OFL003"]
    mixed = record["mixed"][4]
    assert mixed["0,1,x"] == 0                    # replicated -> alias
    assert mixed["3,4,B"] == 8 * 16 * 16 * 8      # sharded -> fan-out
    assert mixed["4,5,B"] == 2 * 16 * 16 * 8      # fan-out onto 2
    assert mixed["1,2,x"] == 2 * 16 * 8           # other selection


# ---------------------------------------------------------------------------
# The graph simulator (pure numpy, in-process).
# ---------------------------------------------------------------------------


def _graph(sim, jobs_mod, seed):
    rng = random.Random(seed)
    specs = [jobs_mod.make_axpy(1024).spec, jobs_mod.make_atax(64, 64).spec,
             jobs_mod.make_covariance(32, 64).spec,
             jobs_mod.make_matmul(16, 16, 16).spec]
    nodes = []
    for i in range(rng.randint(1, 12)):
        w = rng.choice([1, 2, 4, 8])
        s0 = rng.choice(range(0, 32 - w + 1, w))
        deps = tuple(rng.randrange(i) for _ in range(rng.randint(0, 2))
                     if i)
        nodes.append(sim.GraphJob(
            spec=rng.choice(specs), clusters=tuple(range(s0, s0 + w)),
            deps=deps, out_bytes=float(rng.choice([0, 512, 8192, 65536])),
            replicate_in=rng.random() < 0.5))
    return nodes, rng.randint(1, 6)


@pytest.mark.parametrize("seed", range(12))
def test_graph_simulator_equals_reference(seed):
    t_nodes, window = _graph(t_sim, t_jobs, seed)
    r_nodes, _ = _graph(r_sim, r_jobs, seed)
    got = t_sim.simulate_graph(t_nodes, window=window)
    want = r_sim.simulate_graph(r_nodes, window=window)
    assert (got.makespan, got.node_finish, got.host_busy,
            got.issue_order) == (want.makespan, want.node_finish,
                                 want.host_busy, want.issue_order)
    assert (t_sim.graph_critical_path(t_nodes)
            == r_sim.graph_critical_path(r_nodes))
    assert (t_sim.isolated_graph_cycles(t_nodes)
            == r_sim.isolated_graph_cycles(r_nodes))


def test_graph_simulator_errors_as_in_reference():
    for fn in (t_sim.simulate_graph, t_sim.graph_critical_path,
               t_sim.isolated_graph_cycles):
        with pytest.raises(ValueError, match="empty graph"):
            fn([])
    node = t_sim.GraphJob(t_jobs.make_axpy(64).spec, (0,))
    with pytest.raises(ValueError, match="window"):
        t_sim.simulate_graph([node], window=0)
    with pytest.raises(ValueError, match="at least one cluster"):
        t_sim.GraphJob(t_jobs.make_axpy(64).spec, ())
