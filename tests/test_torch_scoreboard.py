"""The port's scoreboard against the reference's, in-process.

``repro_torch.core.scoreboard`` is pure host bookkeeping, so both
packages run side by side on the same inputs: graph resolution, the
issue/retire protocol and its typed errors, the in-flight window, and
random DAGs driven by identically seeded decision streams — issue
orders, retire orders, ready sets and in-flight peaks are held equal
exactly (mirrors ``tests/test_scoreboard.py``).
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import collections
import random

import pytest

from repro.core import scoreboard as r_sb
from repro_torch.core import scoreboard as t_sb
from repro_torch.core.completion import CompletionUnit


def _random_deps(rng, n, max_deps=3):
    return [sorted(rng.sample(range(i), k=rng.randint(0, min(i, max_deps))))
            for i in range(n)]


def _nodes(mod):
    """The resolve_graph fixture of the reference test, in ``mod``'s
    vocabulary."""
    G, R = mod.GraphNode, mod.Ref
    return [
        G(job=None, operands={"x": 1.0, "y": 2.0}, name="a"),
        G(job=None, operands={"x": R("a"), "y": 3.0}, name="b"),
        G(job=None, operands={"x": R(0), "y": R("b")}, after=["a"]),
        G(job=None, operands={"x": R(2), "y": R(2)}),
    ]


def test_resolve_graph_matches_reference():
    want = r_sb.resolve_graph(_nodes(r_sb))
    got = t_sb.resolve_graph(_nodes(t_sb))
    assert got == want
    assert got == ([[], [0], [0, 1], [2]],
                   [[], [(0, "x")], [(0, "x"), (1, "y")],
                    [(2, "x"), (2, "y")]])


_BAD = [
    ("empty graph", lambda m: []),
    ("duplicate node name",
     lambda m: [m.GraphNode(None, {}, name="a"),
                m.GraphNode(None, {}, name="a")]),
    ("unknown node name",
     lambda m: [m.GraphNode(None, {"x": m.Ref("ghost")})]),
    ("outside", lambda m: [m.GraphNode(None, {"x": m.Ref(5)})]),
    ("depends on itself", lambda m: [m.GraphNode(None, {"x": m.Ref(0)})]),
    ("depends on itself", lambda m: [m.GraphNode(None, {}, after=[0])]),
]


@pytest.mark.parametrize("match, build", _BAD,
                         ids=[f"{i}-{m}" for i, (m, _) in enumerate(_BAD)])
def test_resolve_graph_errors_match_reference(match, build):
    with pytest.raises(r_sb.GraphError, match=match) as want:
        r_sb.resolve_graph(build(r_sb))
    with pytest.raises(t_sb.GraphError, match=match) as got:
        t_sb.resolve_graph(build(t_sb))
    assert str(got.value) == str(want.value)
    assert issubclass(t_sb.GraphError, ValueError)


@pytest.mark.parametrize("deps, match", [
    ([[1], [0]], "cycle"), ([[2], [0], [1]], "cycle"),
    ([[3]], "out-of-range"), ([[0]], "itself")])
def test_scoreboard_construction_errors_match_reference(deps, match):
    with pytest.raises(r_sb.GraphError, match=match) as want:
        r_sb.Scoreboard(deps)
    with pytest.raises(t_sb.GraphError, match=match) as got:
        t_sb.Scoreboard(deps)
    assert str(got.value) == str(want.value)


def _protocol(mod):
    """The reference test's protocol-violation script; returns the error
    messages in order."""
    sb = mod.Scoreboard([[], [0]])
    msgs = []

    def expect(fn):
        try:
            fn()
        except mod.GraphError as e:
            msgs.append(str(e))
        else:
            raise AssertionError("expected GraphError")

    expect(lambda: sb.issue(1))
    expect(lambda: sb.retire(0))
    sb.issue(0)
    expect(lambda: sb.issue(0))
    sb.retire(0)
    expect(lambda: sb.retire(0))
    expect(lambda: sb.issue(0))
    return msgs


def test_issue_protocol_violations_match_reference():
    got, want = _protocol(t_sb), _protocol(r_sb)
    assert got == want
    for msg, key in zip(got, ("not ready", "cannot retire", "already issued",
                              "cannot retire", "already retired")):
        assert key in msg


def test_dispatch_based_readiness_and_rename_query():
    sb = t_sb.Scoreboard([[], [0]])
    assert sb.ready() == [0]
    sb.issue(0)
    assert sb.state[0] == t_sb.ISSUED and sb.ready() == [1]
    sb.issue(1)
    assert sb.inflight == 2 and sb.all_issued and not sb.all_retired
    sb.retire(1)
    sb.retire(0)
    assert sb.all_retired and sb.retire_order == [1, 0]
    sb = t_sb.Scoreboard([[], [0], [0], [1, 2]])
    sb.issue(0)
    seen = [sb.pending_readers(0)]
    sb.issue(1)
    seen.append(sb.pending_readers(0))
    sb.issue(2)
    seen.append(sb.pending_readers(0))
    sb.issue(3)
    assert seen == [2, 1, 0] and sb.sinks() == [3]


def _drive(mod, seed):
    """One random DAG driven by a seeded decision stream; returns every
    observable of the scoreboard."""
    rng = random.Random(seed)
    deps = _random_deps(rng, rng.randint(1, 40))
    sb = mod.Scoreboard(deps)
    window = rng.randint(1, 6)
    inflight = collections.deque()
    readies = []
    while not sb.all_retired:
        ready = sb.ready()
        readies.append(tuple(ready))
        if ready and len(inflight) < window and rng.random() < 0.7:
            i = rng.choice(ready)
            sb.issue(i)
            inflight.append(i)
        elif inflight:
            sb.retire(inflight.popleft())
    return deps, dict(issue=list(sb.issue_order),
                      retire=list(sb.retire_order),
                      max_inflight=sb.max_inflight, readies=readies,
                      sinks=sb.sinks(), window=window)


@pytest.mark.parametrize("seed", range(30))
def test_random_dags_issue_order_equals_reference(seed):
    deps, got = _drive(t_sb, seed)
    _, want = _drive(r_sb, seed)
    assert got == want
    pos = {i: k for k, i in enumerate(got["issue"])}
    for i, d in enumerate(deps):
        for p in d:
            assert pos[p] < pos[i]
    assert got["max_inflight"] <= got["window"]


def _window(mod):
    win = mod.InflightWindow(2)
    drained = []
    win.push("a"), win.push("b")
    win.make_room(drained.append)
    win.push("c")
    win.make_room(drained.append)
    tail = win.drain_all(lambda h: h)
    win.make_room(drained.append)
    return drained, win.stalls, tail, len(win)


def test_inflight_window_matches_reference():
    assert _window(t_sb) == _window(r_sb) == (["a", "b"], 2, ["c"], 0)
    with pytest.raises(ValueError, match="window limit"):
        t_sb.InflightWindow(0)


@pytest.mark.parametrize("seed", range(10))
def test_completion_unit_cancel_replay_through_the_scoreboard(seed):
    """The reference's property test over the port's scoreboard and
    completion unit: out-of-order arrival, deferred replay and cancel
    leave every register drained and no stale cause."""
    rng = random.Random(1000 + seed)
    deps = _random_deps(rng, rng.randint(2, 24))
    sb = t_sb.Scoreboard(deps)
    unit = CompletionUnit(n_units=rng.randint(1, 4))
    win = collections.deque()
    next_job = 0
    arrived = set()
    while not sb.all_retired:
        ready = sb.ready()
        if ready and len(win) < unit.n_units and rng.random() < 0.7:
            i = rng.choice(ready)
            jid, next_job = next_job, next_job + 1
            nc = rng.randint(1, 8)
            unit.program(nc, jid)
            if nc > 1 and rng.random() < 0.25:
                unit.arrive(jid, nc - 1)
                assert unit.cancel(jid) == 1
                unit.program(nc, jid)
            sb.issue(i)
            win.append((i, jid, nc))
        elif win:
            for (_, jj, nn) in rng.sample(list(win),
                                          rng.randint(1, len(win))):
                if jj not in arrived:
                    unit.arrive(jj, nn)
                    arrived.add(jj)
            i, jid, nc = win.popleft()
            if jid not in arrived:
                unit.arrive(jid, nc)
                arrived.add(jid)
            unit.collect(jid)
            sb.retire(i)
    assert unit.outstanding() == {}
    assert unit._collected == set()
    assert unit.pending_cause() is None
