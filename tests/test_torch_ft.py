"""The port's wall-clock fault tolerance (``repro_torch.ft``) against the
reference's (mirrors the watchdog and backup tests of
``tests/test_faults.py``).

The watchdog is host arithmetic: both packages run in-process on the same
observations and their deadlines are held equal exactly.
``BackupOffload`` runs the port on ``OffloadRuntime("cpu",
num_clusters=8)`` and the reference once, in one 8-device x64 subprocess,
over the same delay-hook sequences; reissue counts, completion-unit state
and ``PlanStats`` are held equal exactly, results at ``rtol=atol=1e-9``
(the reference's bar) and bit-equal between a backup and a primary run.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import dataclasses
import json

import numpy as np
import pytest

from repro.ft import straggler as r_straggler
from repro_torch.core import jobs
from repro_torch.core.offload import OffloadRuntime
from repro_torch.ft import BackupOffload, StepWatchdog, WatchdogConfig

TOL = dict(rtol=1e-9, atol=1e-9)


# -- the watchdog (shared-default bug + model-seeded cold start) ------------


def test_watchdog_config_not_shared_across_instances():
    w1, w2 = StepWatchdog(), StepWatchdog()
    assert w1.cfg is not w2.cfg
    w1.cfg.deadline_factor = 99.0                   # the old aliasing bug
    assert w2.cfg.deadline_factor == 3.0
    assert (dataclasses.asdict(WatchdogConfig())
            == dataclasses.asdict(r_straggler.WatchdogConfig()))


def test_watchdog_cold_start_seeded_by_estimate():
    cold = StepWatchdog()
    assert cold.deadline() == float("inf")          # undecidable: never trips
    assert not cold.is_late(started_at=0.0, now=1e9)
    seeded = StepWatchdog(WatchdogConfig(min_deadline_s=0.01), estimate=0.2)
    assert seeded.deadline() == pytest.approx(3.0 * 0.2)
    assert seeded.is_late(started_at=0.0, now=0.7)
    # history takes over once observed (the rolling-p50 warm path)
    for lat in (0.05, 0.06, 0.07):
        seeded.observe(lat)
    assert seeded.deadline() == pytest.approx(3.0 * 0.06)


def test_watchdog_deadlines_equal_reference():
    """The same observations give the reference's deadlines and verdicts,
    through the rolling history's overflow."""
    rng = np.random.default_rng(0)
    lats = rng.exponential(0.05, size=80).tolist()
    for cfg, est in ((dict(), None), (dict(min_deadline_s=0.01), 0.2),
                     (dict(deadline_factor=2.0, history=8), 0.001)):
        port = StepWatchdog(WatchdogConfig(**cfg), estimate=est)
        ref = r_straggler.StepWatchdog(r_straggler.WatchdogConfig(**cfg),
                                       estimate=est)
        for lat in lats:
            assert port.deadline() == ref.deadline()
            assert (port.is_late(0.0, now=lat * 4)
                    == ref.is_late(0.0, now=lat * 4))
            port.observe(lat)
            ref.observe(lat)
        assert port._lat == ref._lat


# -- BackupOffload: one script, both packages --------------------------------

#: run with ``rt(**kw)`` (a runtime on 8 clusters), ``BackupOffload``,
#: ``StepWatchdog`` and ``WatchdogConfig`` bound per side; fills ``rec``
#: and ``arrays``
_SCRIPT = '''
import dataclasses
import numpy as np

job = jobs.make_axpy(512)

# the reference test: a straggling primary reissues to the backup set,
# a healthy one does not, and the two results are the same bits
slow_rt = rt()
slow = BackupOffload(slow_rt, StepWatchdog(
    WatchdogConfig(min_deadline_s=0.01), estimate=0.02),
    delay_hook=lambda h: 10.0)
r_backup, expected = slow.run(job, 3, primary=[0, 1], backup=[2, 3])
fast = BackupOffload(rt(), StepWatchdog(estimate=1e9),
                     delay_hook=lambda h: 0.0)
r_primary, _ = fast.run(job, 3, primary=[0, 1], backup=[2, 3])
try:
    fast.run(job, 3, primary=[0, 1], backup=[1, 2])
    overlap = "no error"
except ValueError as e:
    overlap = str(e)
arrays["backup"] = np.asarray(r_backup)
arrays["primary"] = np.asarray(r_primary)
arrays["expected"] = np.asarray(expected)
rec["race"] = dict(slow=slow.reissues, fast=fast.reissues, overlap=overlap,
                   outstanding=sorted(slow_rt.unit.outstanding().items()),
                   stats=dataclasses.asdict(slow_rt.stats))

# a sequence: every other observation straggles (the deadline floor keeps
# a healthy dispatch far inside it); each job on its own windows
seq_rt = rt()
delays = iter([10.0, 0.0, 10.0, 0.0, 10.0, 0.0])
seq = BackupOffload(seq_rt, StepWatchdog(
    WatchdogConfig(min_deadline_s=5.0), estimate=0.02),
    delay_hook=lambda h: next(delays))
counts = []
for i, (name, size, prim, back) in enumerate((
        ("axpy", (1024,), [0, 1, 2, 3], [4, 5, 6, 7]),
        ("matmul", (16, 16, 16), [0, 1], [2, 3]),
        ("covariance", (32, 64), [4, 5, 6, 7], [0, 1, 2, 3]),
        ("atax", (64, 64), [0, 1], [4, 5]),
        ("axpy", (1024,), [6, 7], [0, 1]),
        ("covariance", (32, 64), [0, 1, 2, 3], [4, 5, 6, 7]))):
    res, exp = seq.run(jobs.PAPER_JOBS[name](*size), i, primary=prim,
                       backup=back)
    arrays[f"seq{i}"] = np.asarray(res)
    arrays[f"seq{i}_expected"] = np.asarray(exp)
    counts.append(seq.reissues)
rec["seq"] = dict(reissues=counts,
                  outstanding=sorted(seq_rt.unit.outstanding().items()),
                  stats=dataclasses.asdict(seq_rt.stats),
                  history=len(seq.watchdog._lat))
'''

_REFERENCE = '''
import json
import jax
import numpy as np
from repro.api import OffloadRuntime, StepWatchdog, WatchdogConfig
from repro.core import jobs
from repro.ft import BackupOffload
rt = lambda: OffloadRuntime(jax.devices())
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
    scope = dict(rec={}, arrays={}, jobs=jobs, BackupOffload=BackupOffload,
                 StepWatchdog=StepWatchdog, WatchdogConfig=WatchdogConfig,
                 rt=lambda: OffloadRuntime("cpu", num_clusters=8))
    exec(_SCRIPT, scope)
    return json.loads(json.dumps(scope["rec"], sort_keys=True)), \
        scope["arrays"]


def test_backup_offload_delay_hook_race(reference, port):
    """A deterministic delay hook reissues to the disjoint backup set; the
    winner's result is bit-equal to the healthy primary's, and both equal
    the reference's."""
    rec, arrays = port
    race = rec["race"]
    assert race["slow"] == 1 and race["fast"] == 0
    assert "disjoint" in race["overlap"]
    assert race == reference[0]["race"]
    np.testing.assert_array_equal(arrays["backup"], arrays["primary"])
    np.testing.assert_allclose(arrays["primary"], arrays["expected"],
                               rtol=1e-12)
    for name in ("backup", "primary"):
        np.testing.assert_allclose(arrays[name], reference[1][name], **TOL)


def test_backup_offload_reissue_sequence_equals_reference(reference, port):
    """Over a sequence of jobs the watchdog's history and the reissues
    follow the reference's, the primaries' late arrivals leave the
    completion unit clean, and every result is the reference's."""
    rec, arrays = port
    seq = rec["seq"]
    assert seq["reissues"] == [1, 1, 2, 2, 3, 3]
    assert seq["outstanding"] == []
    assert seq == reference[0]["seq"]
    for i in range(6):
        np.testing.assert_allclose(arrays[f"seq{i}"],
                                   arrays[f"seq{i}_expected"], **TOL)
        np.testing.assert_allclose(arrays[f"seq{i}"],
                                   reference[1][f"seq{i}"], **TOL)


def test_backup_offload_rejects_overlapping_sets():
    bo = BackupOffload(OffloadRuntime("cpu", num_clusters=4))
    for primary, backup in (([0, 1], [1, 2]), ([0], [0]), ([2, 3], [3])):
        with pytest.raises(ValueError, match="disjoint"):
            bo.run(jobs.make_axpy(512), 0, primary=primary, backup=backup)
    assert bo.reissues == 0
