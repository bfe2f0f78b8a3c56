"""The port's static verifier against the reference's, in-process.

The verifier is host bookkeeping plus one shape pass: both packages run
``verify`` / ``verify_graph`` / ``verify_policy`` on the same descriptors
(``OFL001``–``OFL011`` triggers, seeded-defect random DAGs) and the
diagnostic codes, severities, node indices and messages are held equal
(a failed shape pass quotes the library's own exception, which differs).
The shape pass is where the port differs in mechanism — meta tensors
for the reference's ``jax.eval_shape``, with a CPU run on zeros for
control flow that reads its data — so its outcome (``ok``/``fail``/
``skip`` and the output shape) is held equal for each of the six jobs.
The session gate runs both packages' sessions (mirrors
``tests/test_analysis.py``).
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro.analysis import verifier as r_ver
from repro.core import jobs as r_jobs
from repro.core import policy as r_policy
from repro.core import scoreboard as r_sb
from repro_torch import api as t_api
from repro_torch.analysis import diagnostics as t_diag
from repro_torch.analysis import verifier as t_ver
from repro_torch.core import jobs as t_jobs
from repro_torch.core import policy as t_policy
from repro_torch.core import scoreboard as t_sb
from repro_torch.core.offload import _donate


class _Pkg:
    def __init__(self, ver, jobs, policy, sb, deleted):
        self.ver, self.jobs, self.policy, self.sb = ver, jobs, policy, sb
        self.deleted = deleted


class _DeletedBuf:
    """The reference test's duck type of a donated jax array."""

    shape = (64,)

    def is_deleted(self):
        return True


def _released():
    """A tensor a donating dispatch consumed (its storage released)."""
    t = torch.zeros(64, dtype=torch.float64)
    _donate(t)
    return t


REF = _Pkg(r_ver, r_jobs, r_policy, r_sb, _DeletedBuf)
PORT = _Pkg(t_ver, t_jobs, t_policy, t_sb, _released)


def _diags(diags):
    """Comparable diagnostics.  A failed shape pass ends its message with
    the library's own exception text (torch's, not JAX's): that tail is
    cut, the rest of the message is held equal."""
    out = []
    for d in diags:
        msg = d.message
        if "are not shape-consistent" in msg:
            msg = msg[:msg.index(": ", msg.index(" for job "))]
        out.append((d.code, d.severity.value, d.node, d.name, msg))
    return out


def _ops(p, n=64):
    job = p.jobs.make_axpy(n)
    return job, {k: np.asarray(v, dtype="float32")
                 for k, v in job.make_instance(0)[0].items()}


class _S:
    """Stand-in sessions: identity is all the OFL005 pass reads."""


_SESSIONS = (_S(), _S())


class _Lease:
    lease_id = 7
    clusters = (0, 1)

    def __init__(self, active):
        self.active = active


def _cases(p):
    """Every per-code trigger of the reference test, as (name, diags)."""
    G, R = p.sb.GraphNode, p.sb.Ref
    job, ops = _ops(p)
    pol = p.policy.OffloadPolicy
    out = {}
    out["OFL001/cycle"] = p.ver.verify_graph([
        G(job, {"x": ops["x"], "y": R("b")}, name="a"),
        G(job, {"x": ops["x"], "y": R("a")}, name="b")])
    out["OFL001/self"] = p.ver.verify_graph(
        [G(job, {"x": ops["x"], "y": R(0)})])
    out["OFL002/dangling"] = p.ver.verify_graph(
        [G(job, {"x": ops["x"], "y": R("ghost")})])
    out["OFL002/empty"] = p.ver.verify_graph([])
    out["OFL002/not-a-node"] = p.ver.verify_graph([G(job, ops),
                                                   "not a node"])
    out["OFL002/dup"] = p.ver.verify_graph([G(job, ops, name="dup"),
                                            G(job, ops, name="dup")])
    out["OFL002/operands"] = p.ver.verify_graph(
        [G(job, "resident-typo-string")])
    out["OFL003/graph"] = p.ver.verify_graph(
        [G(job, {"x": p.deleted(), "y": ops["y"]})])
    out["OFL003/submit"] = p.ver.verify(
        job, operands={"x": p.deleted(), "y": ops["y"]})
    chain = [G(job, ops, name="p"),
             G(job, {"x": ops["x"], "y": R("p")})]
    out["OFL004"] = p.ver.verify_graph(chain,
                                       policy=pol(donate_operands=True))
    out["OFL004/none"] = p.ver.verify_graph(chain)
    s1, s2 = _SESSIONS
    cross = [G(job, ops, name="a", session=s1),
             G(job, {"x": ops["x"], "y": R("a")}, name="b", session=s2),
             G(job, {"x": ops["x"], "y": R("b")}, name="c", session=s1),
             G(job, {"x": ops["x"], "y": R("c")}, name="d", session=s2)]
    out["OFL005"] = p.ver.verify_graph(cross)
    out["OFL005/one-way"] = p.ver.verify_graph(cross[:2])
    odd = p.jobs.make_axpy(63)
    oops = {k: np.asarray(v) for k, v in odd.make_instance(0)[0].items()}
    out["OFL006/divisible"] = p.ver.verify_graph([G(odd, oops, n=8)])
    out["OFL006/names"] = p.ver.verify_graph(
        [G(job, {"x": ops["x"], "z": ops["y"]})])
    out["OFL006/submit"] = p.ver.verify(job, operands={"x": ops["x"]})
    atax = p.jobs.make_atax(16, 16)
    aops = {k: np.asarray(v) for k, v in atax.make_instance(0)[0].items()}
    out["OFL006/forward"] = p.ver.verify_graph(
        [G(atax, aops, name="p"),
         G(atax, {"A": np.zeros((8, 24)), "x": R("p")})])
    out["OFL006/forward-ok"] = p.ver.verify_graph(
        [G(atax, aops, name="p"),
         G(atax, {"A": np.zeros((8, 16)), "x": R("p")}, n=8)])
    src = G(job, ops, name="src")
    fan = [G(job, {"x": ops["x"], "y": R("src")}) for _ in range(5)]
    out["OFL007"] = p.ver.verify_graph([src] + fan, policy=pol(window=2),
                                       n_units=4)
    out["OFL007/none"] = p.ver.verify_graph([src] + fan[:2],
                                            policy=pol(window=2), n_units=4)
    out["OFL008"] = p.ver.verify_policy(staging="bogus")
    out["OFL009/fuse"] = p.ver.verify_policy(fuse=0)
    out["OFL009/retry"] = p.ver.verify_policy(retry="not-a-retry")
    out["OFL010"] = p.ver.verify_policy(residency="resident",
                                        staging="tree")
    out["OFL010/graph"] = p.ver.verify_graph(
        [G(job, ops)], policy=pol(retry=p.policy.RetryPolicy()))
    out["clean-policy"] = p.ver.verify_policy(pol())
    out["OFL011"] = p.ver.verify(job, lease=_Lease(False))
    out["OFL011/active"] = p.ver.verify(job, lease=_Lease(True))
    return out


def test_every_code_trigger_equals_reference():
    got, want = _cases(PORT), _cases(REF)
    assert sorted(got) == sorted(want)
    for key in want:
        assert _diags(got[key]) == _diags(want[key]), key
    # and each trigger fires its own code, as the reference test pins
    for key, diags in got.items():
        code = key.split("/")[0]
        if code.startswith("OFL") and not key.endswith(("/none", "/one-way",
                                                        "-ok", "/active")):
            assert code in {d.code for d in diags}, key


@pytest.mark.parametrize("name, size", [
    ("axpy", (1024,)), ("montecarlo", (4096,)), ("matmul", (16, 16, 16)),
    ("atax", (64, 64)), ("covariance", (32, 64)), ("bfs", (64,)),
    ("covariance", (1024, 2048)), ("bfs", (1024,))])
def test_shape_pass_outcome_equals_reference(name, size):
    """The meta-tensor shape pass gives the reference's ``eval_shape``
    outcome for every job; the BFS loop reads its data, so the port
    reaches ``ok`` through the CPU run on zeros (never a silent skip)."""
    tj, rj = t_jobs.PAPER_JOBS[name](*size), r_jobs.PAPER_JOBS[name](*size)
    shapes = {k: np.asarray(v).shape
              for k, v in tj.make_instance(0)[0].items()}
    got = t_ver._eval_out_shape(tj, shapes)
    want = r_ver._eval_out_shape(rj, shapes)
    assert got[0] == want[0] == "ok"
    assert got[1] == want[1]


def test_shape_pass_failure_equals_reference():
    tj, rj = t_jobs.make_atax(16, 16), r_jobs.make_atax(16, 16)
    bad = {"A": (8, 24), "x": (16,)}
    assert t_ver._eval_out_shape(tj, bad)[0] == "fail"
    assert r_ver._eval_out_shape(rj, bad)[0] == "fail"
    tm, rm = t_jobs.make_matmul(16, 16, 16), r_jobs.make_matmul(16, 16, 16)
    bad = {"A": (16, 8), "B": (16, 16)}
    assert (t_ver._eval_out_shape(tm, bad)[0]
            == r_ver._eval_out_shape(rm, bad)[0] == "fail")


def _random_dag(p, rng, n_nodes):
    G, R = p.sb.GraphNode, p.sb.Ref
    job, ops = _ops(p)
    nodes = []
    for i in range(n_nodes):
        o = {"x": ops["x"], "y": ops["y"]}
        if i and rng.random() < 0.7:
            o["y"] = R(int(rng.integers(0, i)))
        after = []
        if i and rng.random() < 0.3:
            after.append(int(rng.integers(0, i)))
        nodes.append(G(job, o, name=f"n{i}", after=after))
    return nodes


def _seeded(p, seed, n_nodes, defect):
    rng = np.random.default_rng(seed)
    nodes = _random_dag(p, rng, n_nodes)
    victim = int(rng.integers(1, n_nodes))
    R, G = p.sb.Ref, p.sb.GraphNode
    _, ops = _ops(p)
    if defect == "cycle":
        nodes[victim - 1].operands = dict(nodes[victim - 1].operands)
        nodes[victim - 1].operands["y"] = R(f"n{victim}")
        nodes[victim].operands = dict(nodes[victim].operands)
        nodes[victim].operands["y"] = R(f"n{victim - 1}")
        nodes[victim].after = ()
        nodes[victim - 1].after = ()
    elif defect == "dangling":
        nodes[victim].operands = dict(nodes[victim].operands)
        nodes[victim].operands["y"] = R("no-such-node")
    elif defect == "donated":
        nodes[victim].operands = {"x": p.deleted(), "y": ops["y"]}
    elif defect == "mismatch":
        odd = p.jobs.make_axpy(63)
        oops = {k: np.asarray(v) for k, v in odd.make_instance(0)[0].items()}
        nodes[victim] = G(odd, oops, name=f"n{victim}", n=8)
    return p.ver.verify_graph(nodes, default_width=1)


@given(st.integers(0, 2**32 - 1), st.integers(3, 10),
       st.sampled_from(["none", "cycle", "dangling", "donated", "mismatch"]))
@settings(max_examples=60, deadline=None)
def test_seeded_defect_dags_equal_reference(seed, n_nodes, defect):
    got = _seeded(PORT, seed, n_nodes, defect)
    want = _seeded(REF, seed, n_nodes, defect)
    assert _diags(got) == _diags(want)
    errors = sorted({d.code for d in got
                     if d.severity is t_diag.Severity.ERROR})
    expected = {"none": [], "cycle": ["OFL001"], "dangling": ["OFL002"],
                "donated": ["OFL003"], "mismatch": ["OFL006"]}[defect]
    assert errors == expected


def test_session_gate_raises_before_dispatch():
    """``submit_graph`` raises ``VerificationError`` (still a
    ``GraphError``) for a cyclic graph; ``verify=False`` leaves it to the
    runtime; ``submit`` raises the typed donation error before staging."""
    job = t_jobs.make_axpy(2048)
    ops, _ = job.make_instance(0)
    sess = t_api.Session("cpu", num_clusters=8)
    bad = [t_api.GraphNode(job, {"x": ops["x"], "y": t_api.Ref("b")},
                           name="a"),
           t_api.GraphNode(job, {"x": ops["x"], "y": t_api.Ref("a")},
                           name="b")]
    with pytest.raises(t_api.VerificationError) as e:
        sess.submit_graph(bad)
    assert e.value.codes == ("OFL001",)
    assert isinstance(e.value, t_api.GraphError)
    loose = t_api.Session("cpu", num_clusters=8, verify=False)
    with pytest.raises(t_api.GraphError) as e:
        loose.submit_graph(bad)
    assert not isinstance(e.value, t_api.VerificationError)
    x = torch.tensor(ops["x"])
    _donate(x)
    with pytest.raises(t_api.DonatedOperandError) as e:
        sess.submit(job, {"x": x, "y": ops["y"]})
    assert e.value.code == "OFL003"
    assert sess.stats.device_puts == 0
    assert any(d.code == "OFL001" for d in sess.diagnostics)


def test_verified_graph_runs_bit_identical():
    job = t_jobs.make_axpy(2048)
    ops, _ = job.make_instance(0)

    def chain(sess):
        nodes = [t_api.GraphNode(job, ops, name="n0")]
        for k in range(1, 6):
            nodes.append(t_api.GraphNode(
                job, {"x": ops["x"], "y": t_api.Ref(f"n{k - 1}")},
                name=f"n{k}"))
        return sess.submit_graph(nodes).wait()["n5"]

    a = chain(t_api.Session("cpu", num_clusters=8, verify=True))
    b = chain(t_api.Session("cpu", num_clusters=8, verify=False))
    assert np.array_equal(a, b)
