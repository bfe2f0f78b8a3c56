"""The port's completion unit: fig. 6 register semantics (mirroring
tests/test_completion.py) and the two device-side synchronizations over a
logical cluster's arrival vector, on the CPU."""

import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core.completion import CompletionUnit as RefUnit
from repro_torch.core.completion import (
    CompletionUnit,
    central_counter_arrivals,
    completion_unit_arrivals,
)
from repro_torch.core.offload import count_collectives


def test_basic_fire_and_reset():
    u = CompletionUnit()
    u.program(4, job_id=0)
    for _ in range(3):
        u.arrive(0)
        assert u.pending_cause() is None
    u.arrive(0)
    assert u.pending_cause() == 0          # fired at arrivals == offload
    assert u.clear() == 0
    assert u.pending_cause() is None
    u.program(2, job_id=0)                 # auto-reset allows reuse
    u.arrive(0, count=2)
    assert u.clear() == 0


def test_deferred_interrupt():
    """Fig. 6: a completion while another IPI is pending fires only after
    the pending one is cleared."""
    u = CompletionUnit(n_units=2)
    u.program(1, job_id=0)
    u.program(1, job_id=1)
    u.arrive(0)
    u.arrive(1)                            # completes while job 0 pending
    assert u.pending_cause() == 0
    assert u.clear() == 0
    assert u.pending_cause() == 1          # deferred IPI fires now
    assert u.clear() == 1


def test_outstanding_tracking():
    u = CompletionUnit(n_units=4)
    u.program(3, job_id=0)
    u.program(5, job_id=1)
    u.arrive(0)
    assert u.outstanding() == {0: 2, 1: 5}


def test_double_program_rejected():
    u = CompletionUnit()
    u.program(2, 0)
    with pytest.raises(RuntimeError):
        u.program(3, 0)


def test_arrival_without_program_rejected():
    u = CompletionUnit()
    with pytest.raises(RuntimeError):
        u.arrive(0)


def test_collect_out_of_order_and_cancel():
    u = CompletionUnit(n_units=4)
    for j in range(3):
        u.program(2, j)
    u.arrive(2, count=2)
    u.arrive(0, count=2)
    u.collect(0)                           # parks job 2's earlier cause
    u.collect(2)
    u.arrive(1)
    assert u.cancel(1) == 1                # one arrival still missing
    assert u.outstanding() == {}
    with pytest.raises(RuntimeError):
        u.collect(1)


@given(st.lists(st.integers(1, 6), min_size=1, max_size=20))
@settings(max_examples=100)
def test_every_programmed_job_eventually_fires(counts):
    """Property: N jobs through one unit, arrivals delivered in order ->
    every job fires exactly once, in order, regardless of arrival batching."""
    u = CompletionUnit(n_units=1)
    fired = []
    for jid, n in enumerate(counts):
        u.program(n, 0)
        left = n
        while left:
            step = min(left, 2)
            u.arrive(0, count=step)
            left -= step
        fired.append(u.clear())
    assert fired == [0] * len(counts)


@given(order=st.permutations(list(range(4))))
@settings(max_examples=40)
def test_out_of_order_completion_matches_reference(order):
    """Causes are delivered in completion order, exactly as the
    reference's unit delivers them."""
    units = (CompletionUnit(n_units=4), RefUnit(n_units=4))
    for u in units:
        for j in range(4):
            u.program(1, j)
        for j in order:
            u.arrive(j)
    got, want = ([u.clear() for _ in range(4)] for u in units)
    assert got == want == list(order)


@pytest.mark.parametrize("n", [1, 2, 8, 32])
def test_device_side_arrivals_count_every_cluster(n):
    done = torch.ones(n, dtype=torch.float32)
    unit_trace, chain_trace = [], []
    assert completion_unit_arrivals(done, unit_trace).item() == n
    assert central_counter_arrivals(done, chain_trace).item() == n
    assert count_collectives(unit_trace)["all-reduce"] == 1
    assert count_collectives(unit_trace)["collective-permute"] == 0
    # the central counter: n-1 dependent hops, no reduction
    assert count_collectives(chain_trace)["collective-permute"] == n - 1
    assert count_collectives(chain_trace)["all-reduce"] == 0
    assert torch.equal(done, torch.ones(n))  # the arrival vector is intact


def test_central_counter_chain_is_live():
    """A cluster whose arrival is missing leaves the count short: every
    cluster's flag really rides the hops into cluster 0."""
    done = torch.ones(8, dtype=torch.float32)
    done[5] = 0.0
    assert central_counter_arrivals(done, []).item() == 7
