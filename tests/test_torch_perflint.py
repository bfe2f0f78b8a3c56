"""The port's perf linter against the reference's (mirrors
``tests/test_perflint.py``, one test each; its bench-registry test has no
counterpart until the port has a bench runner).

The linter is pure model arithmetic over numpy: both packages run
in-process on the same fixtures and their findings are held equal
exactly — code, message, ``key()``, payload, predicted and optimal
cycles, fix — and so are ``apply``'s patched policies, nodes and
selections.  The session passes (``submit(lint=True)``, ``explain()``,
``lint_session``, ``diag_limit``, autofixed graphs executed) run the
port on ``Session(device="cpu", num_clusters=8)`` and the reference once,
in one 8-device x64 subprocess (``run_subprocess``), over the same script
(``_SCRIPT``); findings payloads and counters are held equal exactly,
results at ``rtol=atol=1e-9`` (the reference's bar).  The CLI runs both
packages over their checked-in corpora (the port's copies keep the
reference's graph names) and holds JSON, SARIF, the regret table and the
gate's report equal.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import json
import os
import re
from pathlib import Path

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from repro import lint as r_cli
from repro.analysis import perflint as r_perflint
from repro.core import jobs as r_jobs
from repro.core.policy import AUTO as R_AUTO
from repro.core.scoreboard import GraphNode as RNode
from repro.core.scoreboard import Ref as RRef
from repro_torch import lint as lint_cli
from repro_torch.analysis import (
    CODES, Severity, perflint, verify, verify_graph,
)
from repro_torch.analysis.diagnostics import DiagnosticsLog
from repro_torch.core import jobs, simulator
from repro_torch.core.policy import AUTO, Staging
from repro_torch.core.scoreboard import GraphNode, Ref

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-9, atol=1e-9)

_JOB = jobs.make_axpy(2048)
_OPS = {k: np.asarray(v) for k, v in _JOB.make_instance(0)[0].items()}
_R_JOB = r_jobs.make_axpy(2048)


def codes_of(findings):
    return sorted({f.code for f in findings})


def payloads(findings):
    return [f.to_payload() for f in findings]


def _serial_reshard(job=_JOB, node=GraphNode, ref=Ref):
    return [
        node(job, _OPS, name="wide"),
        node(job, {"x": _OPS["x"], "y": ref("wide")}, name="narrow",
             clusters=[0, 1, 2, 3]),
        node(job, {"x": _OPS["x"], "y": ref("narrow")}, name="tail"),
    ]


def _policy_fields(pol):
    return {k: getattr(v, "value", v) for k, v in vars(pol).items()
            if k != "retry"}


def _same_lint(port_fs, ref_fs):
    assert payloads(port_fs) == payloads(ref_fs)
    assert [f.key() for f in port_fs] == [f.key() for f in ref_fs]
    assert [str(f) for f in port_fs] == [str(f) for f in ref_fs]


# ---------------------------------------------------------------------------
# per-code fixtures (each also verifier-clean), held to the reference
# ---------------------------------------------------------------------------


def test_oflp101_suboptimal_staging():
    job, r_job = jobs.make_atax(64, 4096), r_jobs.make_atax(64, 4096)
    ops, _ = job.make_instance(0)
    pol = AUTO.pinned(staging=Staging.HOST_FANOUT)
    assert verify(job, policy=pol, operands=ops, n=8) == []
    fs = perflint.lint(job, ops, policy=pol, clusters=list(range(8)))
    r_pol = R_AUTO.pinned(staging="host_fanout")
    _same_lint(fs, r_perflint.lint(r_job, ops, policy=r_pol,
                                   clusters=list(range(8))))
    assert "OFLP101" in codes_of(fs)
    f = next(f for f in fs if f.code == "OFLP101")
    assert f.delta > 0
    assert f.fix.target == "policy" and f.fix.field == "staging"
    fixed = perflint.suggested_policy(fs, pol)
    assert fixed.staging in (Staging.TREE, Staging.TREE_RESHARD)
    assert pol.diff(fixed) == {"staging": (pol.staging, fixed.staging)}
    r_fixed = r_perflint.suggested_policy(
        r_perflint.lint(r_job, ops, policy=r_pol, clusters=list(range(8))),
        r_pol)
    assert _policy_fields(fixed) == _policy_fields(r_fixed)


def test_oflp102_missed_fusion():
    pol = AUTO.pinned(fuse=1)
    assert verify(_JOB, policy=pol, operands=_OPS, n=8) == []
    fs = perflint.lint(jobs.make_axpy(256), policy=pol, batch=16, n=8)
    _same_lint(fs, r_perflint.lint(r_jobs.make_axpy(256),
                                   policy=R_AUTO.pinned(fuse=1), batch=16,
                                   n=8))
    assert "OFLP102" in codes_of(fs)
    f = next(f for f in fs if f.code == "OFLP102")
    assert f.fix.field == "fuse" and f.fix.value > 1
    fixed = perflint.suggested_policy(fs, pol)
    assert fixed.fuse == f.fix.value
    # unpinned fuse: the planner already decides, nothing to report
    fs = perflint.lint(jobs.make_axpy(256), policy=AUTO.pinned(
        donate_operands=True), batch=16, n=8)
    assert "OFLP102" not in codes_of(fs)
    _same_lint(fs, r_perflint.lint(r_jobs.make_axpy(256),
                                   policy=R_AUTO.pinned(
                                       donate_operands=True),
                                   batch=16, n=8))


def test_oflp103_window_below_optimal():
    pol = AUTO.pinned(window=1)
    assert verify(_JOB, policy=pol, operands=_OPS, n=8) == []
    fs = perflint.lint(jobs.make_axpy(256), policy=pol, batch=16, n=8)
    _same_lint(fs, r_perflint.lint(r_jobs.make_axpy(256),
                                   policy=R_AUTO.pinned(window=1), batch=16,
                                   n=8))
    # the same fixture legitimately also trips OFLP107 (donation off on
    # a fused batch) — assert membership, not the exact set
    assert "OFLP103" in codes_of(fs)
    f = next(f for f in fs if f.code == "OFLP103")
    assert f.fix.field == "window" and f.fix.value > 1
    assert perflint.suggested_policy(fs, pol).window == f.fix.value


def test_oflp104_reshard_on_critical_path():
    nodes = _serial_reshard()
    r_nodes = _serial_reshard(_R_JOB, RNode, RRef)
    assert verify_graph(nodes, default_width=8) == []
    fs = perflint.lint_graph(nodes, default_width=8)
    _same_lint(fs, r_perflint.lint_graph(r_nodes, default_width=8))
    assert codes_of(fs) == ["OFLP104"]
    for f in fs:
        assert f.fix.target == "node"
        assert f.delta > 0
    # applying to a fixpoint converges to a lint-clean graph, through the
    # reference's sequence of rewrites
    cur, r_cur = nodes, r_nodes
    for _ in range(8):
        fs = perflint.lint_graph(cur, default_width=8)
        r_fs = r_perflint.lint_graph(r_cur, default_width=8)
        _same_lint(fs, r_fs)
        if not fs:
            break
        cur = perflint.apply(fs, nodes=cur).nodes
        r_cur = r_perflint.apply(r_fs, nodes=r_cur).nodes
        assert [n.clusters for n in cur] == [n.clusters for n in r_cur]
    assert perflint.lint_graph(cur, default_width=8) == []
    assert verify_graph(cur, default_width=8) == []
    # and the fix is a real cycle win in the discrete-event domain
    before, _ = perflint.graph_jobs(nodes, default_width=8)
    after, meta = perflint.graph_jobs(cur, default_width=8)
    r_after, r_meta = r_perflint.graph_jobs(r_cur, default_width=8)
    assert meta == r_meta
    assert (simulator.simulate_graph(after).makespan
            < simulator.simulate_graph(before).makespan)
    assert (simulator.graph_critical_path(after)
            == r_perflint.simulator.graph_critical_path(r_after))


def test_oflp105_misaligned_selection():
    mis = list(range(1, 9))
    assert verify(_JOB, operands=_OPS, clusters=mis) == []
    assert simulator.selection_requests(mis) > 1
    fs = perflint.lint(_JOB, _OPS, clusters=mis)
    _same_lint(fs, r_perflint.lint(_R_JOB, _OPS, clusters=mis))
    assert "OFLP105" in codes_of(fs)
    fixed = perflint.apply(fs, clusters=mis).clusters
    assert fixed == r_perflint.apply(
        r_perflint.lint(_R_JOB, _OPS, clusters=mis), clusters=mis).clusters
    assert simulator.selection_requests(fixed) == 1
    assert len(fixed) >= 2
    # an aligned pow2 window is already single-request: quiet
    assert "OFLP105" not in codes_of(
        perflint.lint(_JOB, _OPS, clusters=list(range(8))))


def test_oflp107_donation_off_on_dead_buffer():
    fs = perflint.lint(jobs.make_axpy(256), batch=16, n=8)
    _same_lint(fs, r_perflint.lint(r_jobs.make_axpy(256), batch=16, n=8))
    assert "OFLP107" in codes_of(fs)
    f = next(f for f in fs if f.code == "OFLP107")
    assert f.fix.field == "donate_operands" and f.fix.value is True
    # donation already on, or an unfused dispatch: quiet
    fs = perflint.lint(jobs.make_axpy(256),
                       policy=AUTO.pinned(donate_operands=True),
                       batch=16, n=8)
    assert "OFLP107" not in codes_of(fs)
    fs = perflint.lint(jobs.make_axpy(256), batch=1, n=8)
    assert "OFLP107" not in codes_of(fs)


def test_clean_auto_submit_has_no_findings():
    assert perflint.lint(_JOB, _OPS, n=8) == []
    assert r_perflint.lint(_R_JOB, _OPS, n=8) == []
    # and a clean graph stays clean
    nodes = [GraphNode(_JOB, _OPS, name="a"),
             GraphNode(_JOB, {"x": _OPS["x"], "y": Ref("a")}, name="b")]
    assert perflint.lint_graph(nodes, default_width=8) == []


def test_invalid_submission_returns_no_perf_findings():
    # perf advice about a submission the verifier rejects is noise
    bad = [GraphNode(_JOB, {"x": _OPS["x"], "y": Ref("zz")}, name="a")]
    assert verify_graph(bad, default_width=8) != []
    assert perflint.lint_graph(bad, default_width=8) == []


def test_operands_may_be_tensors_on_any_device():
    """Shapes, dtypes and byte counts are read from tensors as from numpy
    arrays — CPU and meta tensors give the numpy fixture's findings (a
    live tensor, like the reference's device array, skips OFLP107)."""
    import torch

    job, r_job = jobs.make_atax(64, 4096), r_jobs.make_atax(64, 4096)
    ops, _ = job.make_instance(0)
    pol = AUTO.pinned(staging=Staging.HOST_FANOUT)
    want = payloads(r_perflint.lint(
        r_job, ops, policy=R_AUTO.pinned(staging="host_fanout"),
        clusters=list(range(1, 9))))
    for device in ("cpu", "meta"):
        t_ops = {k: torch.as_tensor(v).to(device) for k, v in ops.items()}
        got = perflint.lint(job, t_ops, policy=pol,
                            clusters=list(range(1, 9)))
        assert payloads(got) == want, device
        nodes = [GraphNode(job, t_ops, name="a"),
                 GraphNode(job, {"A": t_ops["A"], "x": Ref("a")},
                           name="b", clusters=[0, 1, 2, 3])]
        r_nodes = [RNode(r_job, ops, name="a"),
                   RNode(r_job, {"A": ops["A"], "x": RRef("a")},
                         name="b", clusters=[0, 1, 2, 3])]
        assert (perflint.graph_jobs(nodes, default_width=8)[1]
                == r_perflint.graph_jobs(r_nodes, default_width=8)[1])
    t_ops = {k: torch.as_tensor(v) for k, v in
             jobs.make_axpy(256).make_instance(0)[0].items()}
    assert "OFLP107" not in codes_of(perflint.lint(
        jobs.make_axpy(256), t_ops, batch=16, n=8))


# ---------------------------------------------------------------------------
# findings + apply mechanics
# ---------------------------------------------------------------------------


def test_finding_payload_round_trip_and_stable_key():
    fs = perflint.lint_graph(_serial_reshard(), default_width=8)
    f = fs[0]
    restored = perflint.PerfFinding.from_payload(f.to_payload())
    assert restored == f
    # the reference reads the port's payload back to the same finding
    r_restored = r_perflint.PerfFinding.from_payload(f.to_payload())
    assert r_restored.to_payload() == f.to_payload()
    # keys are stable across model recalibration: no cycle counts
    assert f.key().startswith("OFLP104:")
    assert not re.search(r"\d{3,}", f.key().split(":", 1)[1])


def test_apply_routes_fixes_and_reports_skips():
    nodes = _serial_reshard()
    fs = perflint.lint_graph(nodes, default_width=8)
    applied = perflint.apply(fs, nodes=nodes)
    assert applied.applied and not applied.skipped
    assert applied.nodes is not nodes
    assert nodes[1].clusters == [0, 1, 2, 3]      # input untouched
    r_nodes = _serial_reshard(_R_JOB, RNode, RRef)
    r_applied = r_perflint.apply(
        r_perflint.lint_graph(r_nodes, default_width=8), nodes=r_nodes)
    assert ([n.clusters for n in applied.nodes]
            == [n.clusters for n in r_applied.nodes])
    # a fix with no matching artifact lands in skipped, loudly
    applied = perflint.apply(fs, policy=AUTO)
    assert not applied.applied and len(applied.skipped) == len(fs)


def test_significance_threshold_suppresses_noise():
    # a single-cluster dispatch has nothing to restage or realign
    assert perflint.lint(_JOB, _OPS, clusters=[0]) == []
    # the gate itself: sub-2% "wins" are inside the model's error bar
    assert not perflint._significant(1000.0, 985.0)
    assert not perflint._significant(10.0, 9.5)   # abs floor of 1 cycle
    assert perflint._significant(1000.0, 900.0)
    assert perflint.MIN_DELTA_FRAC == r_perflint.MIN_DELTA_FRAC == 0.02
    for cur, opt in ((1000.0, 980.0), (50.0, 48.9), (0.5, 0.0)):
        assert (perflint._significant(cur, opt)
                == r_perflint._significant(cur, opt))
    spec, r_spec = _JOB.spec, _R_JOB.spec
    for n in (1, 2, 8, 32):
        assert (perflint.dispatch_replay_cycles(spec, n)
                == r_perflint.dispatch_replay_cycles(r_spec, n))
    for nbytes in (0, 64, 16384, 1 << 20):
        assert (perflint.donation_copy_cycles(nbytes)
                == r_perflint.donation_copy_cycles(nbytes))


# ---------------------------------------------------------------------------
# property: the port's lint_graph is the reference's on random DAGs, and
# autofix preserves verifier-cleanliness
# ---------------------------------------------------------------------------


def _random_dag(rng, n_nodes, job=_JOB, node=GraphNode, ref=Ref):
    widths = ([0, 1, 2, 3], [4, 5, 6, 7], [2, 3, 4, 5], None)
    nodes = []
    for i in range(n_nodes):
        ops = {"x": _OPS["x"], "y": _OPS["y"]}
        if i and rng.random() < 0.7:
            ops["y"] = ref(int(rng.integers(0, i)))
        nodes.append(node(job, ops, name=f"n{i}",
                          clusters=widths[int(rng.integers(0, 4))]))
    return nodes


@given(st.integers(0, 2**32 - 1), st.integers(2, 8))
@settings(max_examples=25, deadline=None)
def test_autofixed_random_dags_stay_verify_clean(seed, n_nodes):
    nodes = _random_dag(np.random.default_rng(seed), n_nodes)
    r_nodes = _random_dag(np.random.default_rng(seed), n_nodes, _R_JOB,
                          RNode, RRef)
    fs = perflint.lint_graph(nodes, default_width=8)
    _same_lint(fs, r_perflint.lint_graph(r_nodes, default_width=8))
    if [d for d in verify_graph(nodes, default_width=8)
            if d.severity is Severity.ERROR]:
        return                                    # not a valid fixture
    fixed = perflint.apply(fs, nodes=nodes).nodes
    assert [d for d in verify_graph(fixed, default_width=8)
            if d.severity is Severity.ERROR] == []


# ---------------------------------------------------------------------------
# DiagnosticsLog ring buffer
# ---------------------------------------------------------------------------


def test_diaglog_10k_records_memory_flat():
    from repro_torch.analysis import Diagnostic

    log = DiagnosticsLog(limit=256)
    d = Diagnostic("OFLP103", "synthetic", severity=Severity.PERF)
    for _ in range(10_000):
        log.record([d])
    assert len(log) == 256                        # ring bound holds
    assert log.total == 10_000
    assert log.dropped == 9_744
    assert log.counts() == {"OFLP103": 256}
    log.clear()
    assert len(log) == 0 and log.total == 0 and log.dropped == 0
    # limit=0: count-only mode, nothing retained
    log0 = DiagnosticsLog(limit=0)
    log0.record([d, d])
    assert len(log0) == 0 and log0.total == 2 and log0.dropped == 2


# ---------------------------------------------------------------------------
# session integration: one script, both packages
# ---------------------------------------------------------------------------

#: run with ``PKG`` and ``session(**kw)`` bound per side; fills ``rec``
#: (JSON-able) and ``arrays`` (name -> result)
_SCRIPT = '''
import importlib
import numpy as np
api = importlib.import_module(PKG + ".api")
jobs = importlib.import_module(PKG + ".core.jobs")
perflint = importlib.import_module(PKG + ".analysis.perflint")

def payloads(fs):
    return [f.to_payload() for f in fs]

# diag_limit through the submit path: distinct pinned policies ->
# distinct lint cache keys -> a recording per submit; a batch-1 fuse pin
# is clamped to 1 so execution is identical while window=1 keeps OFLP103
# firing
job = jobs.make_axpy(2048)
ops, _ = job.make_instance(0)
sess = session(diag_limit=16)
totals = []
for f in range(1, 41):
    pol = api.AUTO.pinned(window=1, fuse=f)
    sess.submit(job, ops, policy=pol, lint=True).wait()
    totals.append(sess.diagnostics.total)
rec["diag"] = dict(totals=totals, len=len(sess.diagnostics),
                   dropped=sess.diagnostics.dropped,
                   counts=sess.diagnostics.counts())
sess.submit(job, ops, policy=api.AUTO.pinned(window=1, fuse=1),
            lint=True).wait()
rec["diag"]["after_hit"] = sess.diagnostics.total
sess.close()

# submit(lint=True): findings on the handle and in explain()
job = jobs.make_axpy(256)
inst, _ = jobs.make_instances(job, 16)
sess = session()
h = sess.submit(job, inst, policy=api.AUTO.pinned(window=1), lint=True)
arrays["explain"] = np.stack([np.asarray(r) for r in h.wait()])
table = h.explain().table()
rec["explain"] = dict(findings=payloads(h.findings),
                      block=table[table.index("perf findings"):])
h2 = sess.submit(job, inst, policy=api.AUTO.pinned(window=1))
h2.wait()
rec["explain"]["lint_off"] = payloads(h2.findings)
lsess = session(lint=True)
h3 = lsess.submit(job, inst, policy=api.AUTO.pinned(window=1))
h3.wait()
rec["explain"]["session_lint"] = payloads(h3.findings)
rec["explain"]["session_diags"] = lsess.diagnostics.counts()
sess.close()
lsess.close()

# lint_session: a dead stage() residency, then redispatched
job = jobs.make_axpy(2048)
ops, _ = job.make_instance(0)
sess = session()
sess.stage(job, ops, n=8)
rec["residency"] = dict(dead=payloads(perflint.lint_session(sess)))
arrays["resident"] = np.asarray(
    sess.submit(job, api.Residency.RESIDENT, n=8).wait())
rec["residency"]["alive"] = payloads(perflint.lint_session(sess))
sess.close()

# autofixed graphs execute bit-identically to the originals
base_ops, _ = job.make_instance(0)
base_ops = {k: np.asarray(v) for k, v in base_ops.items()}
widths = ([0, 1, 2, 3], [4, 5, 6, 7], [2, 3, 4, 5], None)
sess = session()
rec["graphs"] = []
for seed in range(5):
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(int(rng.integers(2, 6))):
        g_ops = dict(base_ops)
        if i and rng.random() < 0.7:
            g_ops["y"] = api.Ref(int(rng.integers(0, i)))
        nodes.append(api.GraphNode(job, g_ops, name=f"n{i}",
                                   clusters=widths[int(rng.integers(0, 4))]))
    fs = perflint.lint_graph(nodes, default_width=sess.num_clusters
                             if hasattr(sess, "num_clusters")
                             else len(sess.devices))
    fixed = perflint.apply(fs, nodes=nodes).nodes
    out_a = sess.submit_graph(nodes).wait()
    out_b = sess.submit_graph(fixed).wait()
    same = all(np.asarray(out_a[k]).tobytes() == np.asarray(out_b[k]).tobytes()
               for k in out_a)
    gl = sess.submit_graph(nodes, lint=True)
    gl.wait()
    rec["graphs"].append(dict(findings=payloads(fs), same=same,
                              keys=sorted(out_a),
                              graph_lint=payloads(gl.findings),
                              fixed=[n.clusters and list(n.clusters)
                                     for n in fixed]))
    for k in out_a:
        arrays[f"graph{seed}_{k}"] = np.asarray(out_a[k])
sess.close()
'''

_REFERENCE = '''
import json
import numpy as np
from repro.api import Session
PKG = "repro"
session = lambda **kw: Session(**kw)
rec, arrays = {}, {}
''' + _SCRIPT + '''
print("REC " + json.dumps(rec, sort_keys=True))
print("ARR " + json.dumps({k: v.tolist() for k, v in arrays.items()}))
'''


@pytest.fixture(scope="module")
def reference(subproc):
    out = subproc(_REFERENCE)
    lines = {ln[:3]: ln[4:] for ln in out.splitlines()
             if ln.startswith(("REC ", "ARR "))}
    arrays = {k: np.asarray(v) for k, v in json.loads(lines["ARR"]).items()}
    return json.loads(lines["REC"]), arrays


@pytest.fixture(scope="module")
def port():
    from repro_torch.api import Session
    scope = dict(PKG="repro_torch", rec={}, arrays={},
                 session=lambda **kw: Session(device="cpu", num_clusters=8,
                                              **kw))
    exec(_SCRIPT, scope)
    return json.loads(json.dumps(scope["rec"], sort_keys=True)), \
        scope["arrays"]


def test_session_diag_limit_through_submit_path(reference, port):
    rec, _ = port
    d = rec["diag"]
    assert d == reference[0]["diag"]
    assert d["len"] == 16 and d["totals"][-1] > 16
    assert d["dropped"] == d["totals"][-1] - 16
    assert d["after_hit"] == d["totals"][-1]      # cache hit: flat


def test_submit_lint_findings_and_explain(reference, port):
    rec, arrays = port
    e = rec["explain"]
    assert e == reference[0]["explain"]
    assert "OFLP103" in {f["diagnostic"]["code"] for f in e["findings"]}
    assert "OFLP103" in e["block"]
    assert e["lint_off"] == []                    # lint off: no findings
    assert e["session_lint"] == e["findings"]     # Session(lint=True)
    np.testing.assert_allclose(arrays["explain"], reference[1]["explain"],
                               **TOL)


def test_lint_session_dead_residency(reference, port):
    rec, arrays = port
    r = rec["residency"]
    assert r == reference[0]["residency"]
    assert [f["diagnostic"]["code"] for f in r["dead"]] == ["OFLP106"]
    assert r["dead"][0]["fix"]["target"] == "stage"
    assert r["alive"] == []                       # redispatched: alive
    np.testing.assert_allclose(arrays["resident"], reference[1]["resident"],
                               **TOL)


def test_autofixed_graphs_execute_bit_identical(reference, port):
    rec, arrays = port
    assert rec["graphs"] == reference[0]["graphs"]
    assert all(g["same"] for g in rec["graphs"])
    assert sum(len(g["findings"]) for g in rec["graphs"]) > 0, \
        "no finding ever fired; fixture too tame"
    for name, want in reference[1].items():
        if name.startswith("graph"):
            np.testing.assert_allclose(arrays[name], want, **TOL)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

_TMP_GRAPH = '''
import numpy as np
from {pkg}.core import jobs
from {pkg}.core.scoreboard import GraphNode, Ref

{allow}
def build():
    job = jobs.make_axpy(2048)
    ops, _ = job.make_instance(0)
    ops = {{k: np.asarray(v) for k, v in ops.items()}}
    return {{"serial": [
        GraphNode(job, ops, name="wide"),
        GraphNode(job, {{"x": ops["x"], "y": Ref("wide")}}, name="narrow",
                  clusters=[0, 1, 2, 3]),
        GraphNode(job, {{"x": ops["x"], "y": Ref("narrow")}}, name="tail"),
    ]}}
'''


def _write_corpus(tmp_path, allow="", pkg="repro_torch", name="g.py"):
    g = tmp_path / name
    g.write_text(_TMP_GRAPH.format(allow=allow, pkg=pkg))
    return g


def test_cli_gate_baseline_round_trip(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _write_corpus(tmp_path)
    argv = ["--graphs", "g.py:build", "--baseline", "bl.json"]
    assert lint_cli.main(argv) == 1               # new findings fail
    assert "[NEW] OFLP104" in capsys.readouterr().out
    assert lint_cli.main(argv + ["--update-baseline"]) == 0
    bl = json.loads((tmp_path / "bl.json").read_text())
    assert sum(bl["findings"].values()) == 2
    # the reference writes the same baseline for its twin corpus
    _write_corpus(tmp_path, pkg="repro", name="r.py")
    assert r_cli.main(["--graphs", "r.py:build", "--baseline", "rbl.json",
                       "--update-baseline"]) == 0
    rbl = json.loads((tmp_path / "rbl.json").read_text())
    assert ({k.replace("r:", "g:", 1): v for k, v in rbl["findings"].items()}
            == bl["findings"])
    capsys.readouterr()
    assert lint_cli.main(argv) == 0               # baselined now
    assert "[baseline] OFLP104" in capsys.readouterr().out


def test_cli_allow_comment_suppresses(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _write_corpus(tmp_path, allow="# repro: allow(OFLP104, OFLP105)\n")
    assert lint_cli.main(["--graphs", "g.py:build",
                          "--baseline", "bl.json"]) == 0
    out = capsys.readouterr().out
    assert "[allowed] OFLP104" in out
    assert "2 allowed" in out
    assert not (tmp_path / "bl.json").exists()    # read, never written


def _sarif_for_compare(s, codes):
    """SARIF with each rule's fullDescription checked against ``codes``
    and dropped: it quotes the package's own module names."""
    for rule in s["runs"][0]["tool"]["driver"]["rules"]:
        assert rule.pop("fullDescription") == {
            "text": codes[rule["id"]].explain}
    return s


def test_cli_json_and_sarif_shape(tmp_path, monkeypatch, capsys):
    from repro.analysis import CODES as R_CODES

    monkeypatch.chdir(tmp_path)
    _write_corpus(tmp_path)
    lint_cli.main(["--graphs", "g.py:build", "--baseline", "bl.json",
                   "--json", "out.json", "--sarif", "out.sarif"])
    capsys.readouterr()
    j = json.loads((tmp_path / "out.json").read_text())
    assert j["schema"] == 1
    (findings,) = [f for g, f in j["graphs"].items() if g == "g:serial"]
    assert {f["diagnostic"]["code"] for f in findings} == {"OFLP104"}
    s = json.loads((tmp_path / "out.sarif").read_text())
    assert s["version"] == "2.1.0"
    run = s["runs"][0]
    assert {r["id"] for r in run["tool"]["driver"]["rules"]} == set(CODES)
    assert all(r["level"] == "note" for r in run["results"])
    assert all(r["ruleId"] == "OFLP104" for r in run["results"])
    assert run["results"][0]["properties"]["fix"]["field"] == "clusters"
    # over the checked-in corpora, both packages write the same reports
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    outs = {}
    for tag, cli in (("port", lint_cli), ("ref", r_cli)):
        cli.main(["--json", str(tmp_path / f"{tag}.json"),
                  "--sarif", str(tmp_path / f"{tag}.sarif")])
        outs[tag] = capsys.readouterr().out
    assert outs["port"] == outs["ref"]
    assert ((tmp_path / "port.json").read_text()
            == (tmp_path / "ref.json").read_text())
    port_s = json.loads((tmp_path / "port.sarif").read_text())
    ref_s = json.loads((tmp_path / "ref.sarif").read_text())
    assert port_s["runs"][0]["results"], "the corpus has findings"
    assert (_sarif_for_compare(port_s, CODES)
            == _sarif_for_compare(ref_s, R_CODES))


def test_cli_explain_regret_equals_reference(capsys, monkeypatch):
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    assert lint_cli.main(["--explain-regret"]) == 0
    port_out = capsys.readouterr().out
    assert r_cli.main(["--explain-regret"]) == 0
    assert port_out == capsys.readouterr().out
    assert "benchmarks/dag_bench:dag/serial" in port_out


def test_cli_missing_corpus_skips(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert lint_cli.main(["--graphs", "nope.py:build",
                          "--baseline", "bl.json"]) == 0
    assert "0 graphs" in capsys.readouterr().out


def test_checked_in_corpus_is_gate_clean(capsys, monkeypatch):
    monkeypatch.chdir(REPO)
    baseline = (REPO / "LINT_baseline.json").read_bytes()
    assert lint_cli.main([]) == 0
    out = capsys.readouterr().out
    assert "0 new" in out
    # both accepted-debt mechanisms are exercised by the real corpus,
    # under the reference's graph names
    assert "[allowed] OFLP104" in out
    assert "[baseline] OFLP104" in out
    assert "benchmarks/dag_bench:dag/serial" in out
    assert "examples/job_graph:reshard" in out
    assert (REPO / "LINT_baseline.json").read_bytes() == baseline


# ---------------------------------------------------------------------------
# generated docs
# ---------------------------------------------------------------------------


def test_codes_markdown_matches_registry(capsys):
    assert lint_cli.main(["--codes-md"]) == 0
    out = capsys.readouterr().out
    for code, info in CODES.items():
        assert f"`{code}`" in out
        assert info.title in out
    assert out.strip() == r_cli.codes_markdown().strip()


def test_readme_code_table_not_drifted():
    readme = (REPO / "README.md").read_text()
    m = re.search(r"<!-- diagnostic-codes:begin -->\n(.*?)\n"
                  r"<!-- diagnostic-codes:end -->", readme, re.S)
    assert m, "README lost its generated diagnostic-codes block"
    assert m.group(1).strip() == lint_cli.codes_markdown().strip()
