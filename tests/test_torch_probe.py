"""The retry ladder's bisection probe on 8, 16 and 32 clusters.

The probe is an axpy that each probed group of clusters shards.  The
reference's is ``PROBE_N`` = 840 elements, which splits over at most 8
clusters, so its retry submit on 16 or 32 clusters raises ``ValueError``
from the probe's plan instead of recovering.  The port sizes the probe by
``faults.probe_size``: 840 wherever that divides (every group of up to 8
clusters), else lcm(840, k).

One 32-device x64 subprocess runs ``_SCRIPT`` on the reference (a lost
arrival and a dead cluster, each at n = 8, 16 and 32); the port replays it
with 32 logical clusters on the CPU.  At n = 8 the records (outcome and
every ``SessionHealth`` counter) are equal and the results within 1e-9;
at 16 and 32 the reference raises and the port recovers, with results
bit-identical to a fault-free run.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import json

import numpy as np
import pytest

from repro_torch import api as t_api
from repro_torch.core import faults as t_faults
from repro_torch.core import jobs as t_jobs

TOL = dict(rtol=1e-9, atol=1e-9)
NS = (8, 16, 32)
KINDS = ("lost", "death")

_SCRIPT = r'''
import dataclasses


def script(api, jobs, session):
    record, arrays = {}, {}
    job = jobs.make_axpy(1024)
    ops, _ = job.make_instance(0)
    F, S = api.FaultKind, api.FaultSpec
    for n in (8, 16, 32):
        arrays[f"ref/{n}"] = np.asarray(
            session().submit(job, dict(ops), n=n).wait())
        for kind, spec in (
                ("lost", S(F.LOST_ARRIVAL, at_dispatch=0, count=1)),
                ("death", S(F.CLUSTER_DEATH, at_dispatch=0, clusters=(5,)))):
            inj = api.FaultInjector(api.FaultPlan([spec]))
            sess = session(policy=api.OffloadPolicy(
                retry=api.RetryPolicy()), faults=inj)
            try:
                arrays[f"{kind}/{n}"] = np.asarray(
                    sess.submit(job, dict(ops), n=n).wait())
                outcome = "ok"
            except ValueError as e:
                outcome = ["ValueError", str(e)]
            record[f"{kind}/{n}"] = [outcome,
                                     dataclasses.asdict(sess.health())]
            sess.close()
    return record, arrays
'''

exec("import numpy as np\n" + _SCRIPT)   # defines ``script`` for the port

_REFERENCE = r'''
import json
import numpy as np
import repro.api as api
from repro.core import jobs

{script}

record, arrays = script(api, jobs, lambda **kw: api.Session(**kw))
np.savez({out!r}, **arrays)
with open({meta!r}, "w") as f:
    json.dump(record, f)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("probe_ref")
    out, meta = str(d / "ref.npz"), str(d / "meta.json")
    subproc(_REFERENCE.format(script=_SCRIPT, out=out, meta=meta),
            devices=32, timeout=900)
    with np.load(out) as z:
        arrays = {k: z[k] for k in z.files}
    with open(meta) as f:
        return json.load(f), arrays


@pytest.fixture(scope="module")
def port():
    record, arrays = script(
        t_api, t_jobs,
        lambda **kw: t_api.Session("cpu", num_clusters=32, **kw))
    return json.loads(json.dumps(record)), arrays


def test_probe_size_keeps_the_references_probe_up_to_8_clusters():
    assert [t_faults.probe_size(k) for k in range(1, 9)] == [840] * 8
    assert t_faults.probe_size(16) == 1680
    assert t_faults.probe_size(32) == 3360
    for k in (12, 16, 24, 32):
        assert t_faults.probe_size(k) % k == 0


@pytest.mark.parametrize("kind", KINDS)
def test_probe_at_8_clusters_equals_reference(reference, port, kind):
    key = f"{kind}/8"
    assert reference[0][key][0] == "ok"
    assert port[0][key] == reference[0][key]
    np.testing.assert_allclose(port[1][key], reference[1][key], **TOL)


@pytest.mark.parametrize("n", NS[1:])
@pytest.mark.parametrize("kind", KINDS)
def test_probe_recovers_where_the_reference_raises(reference, port, kind, n):
    """The divergence: the reference's 840-element probe cannot be planned
    on 16 or 32 clusters; the port's recovers, bit-identical to a
    fault-free run, with the rungs the 8-cluster run takes."""
    key = f"{kind}/{n}"
    outcome, _ = reference[0][key]
    assert outcome[0] == "ValueError" and "divisible" in outcome[1]
    outcome, health = port[0][key]
    assert outcome == "ok"
    np.testing.assert_array_equal(port[1][key], port[1][f"ref/{n}"])
    assert health["jobs_ok"] == 1 and health["jobs_failed"] == 0
    assert health["deadline_trips"] == 1 and health["retries"] == 1
    if kind == "lost":
        # one clean probe of the whole selection, as at n = 8
        assert health["probes"] == 1
    else:
        # bisection down to the dead cluster: two probes a level
        assert health["probes"] == 1 + 2 * int(np.log2(n))
        assert health["probes"] > port[0]["death/8"][1]["probes"]
