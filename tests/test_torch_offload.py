"""The port's offload runtime against the reference's, on the CPU.

One subprocess runs ``repro``'s :class:`OffloadRuntime` on a forced
8-device CPU mesh at float64 (``run_subprocess``, ``tests/conftest.py``)
and writes what it saw: every job's result under both configurations on
n ∈ {1, 2, 8} clusters, mask and explicit selections, the
:class:`PlanStats` counters after each step of scripted call sequences
(cold, warm, resident, job-args cache, each staging mode, fused B=4,
donation), and the HLO collective counts.  The port replays the same
calls in-process on ``device="cpu"`` with 8 logical clusters and is held
to them: results at ``rtol=atol=1e-9`` (the reference's own bar,
``tests/test_offload_runtime.py:17``), counters and collective counts
exactly.  The tests after those run the port alone, at Occamy's 32
clusters.
"""

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import jobs as t_jobs
from repro_torch.core import multicast as t_mc
from repro_torch.core.offload import (
    DonatedOperandError,
    OffloadConfig,
    OffloadRuntime,
    STAGING_MODES,
    count_collectives,
)
from repro_torch.core.policy import Residency, Staging

JOBS = tuple(t_jobs.PAPER_JOBS)
CONFIGS = ("baseline", "extended")
NS = (1, 2, 8)
TOL = dict(rtol=1e-9, atol=1e-9)

# Sizes shared by both sides; every sharded axis divides 1, 2, 4 and 8.
SIZES = {"axpy": (1024,), "montecarlo": (4096,), "matmul": (16, 16, 16),
         "atax": (64, 64), "covariance": (32, 64), "bfs": (64,)}

# The call sequences whose counters are compared step by step.  Each entry
# is (runtime config kwargs, job name, job size); the steps are
# ``_SCRIPT_CODE``, which both sides run.
SCRIPTS = {
    "baseline-matmul": (dict(info_dist="p2p_chain",
                             completion="central_counter"), "matmul",
                        (32, 16, 8)),
    "extended-matmul": ({}, "matmul", (32, 16, 8)),
    "extended-covariance-tree": (dict(staging="tree"), "covariance",
                                 (16, 32)),
    "donate-axpy": (dict(donate_operands=True), "axpy", (1024,)),
    "donate-covariance-tree": (dict(donate_operands=True, staging="tree"),
                               "covariance", (16, 32)),
}

_REFERENCE_CODE = r'''
import dataclasses, json, warnings
import numpy as np
warnings.simplefilter("ignore", DeprecationWarning)
from repro.core import jobs
from repro.core import multicast as mc
from repro.core.offload import (OffloadConfig, OffloadRuntime, STAGING_MODES,
                                count_collectives)
from repro.core.policy import Residency, Staging

SIZES = {sizes!r}
SCRIPTS = {scripts!r}
arrays, meta = {{}}, {{"stats": {{}}, "collectives": {{}}}}
CFGS = {{"baseline": OffloadConfig.baseline(),
        "extended": OffloadConfig.extended()}}

def make(name, size):
    return jobs.PAPER_JOBS[name](*size)

for cname, cfg in CFGS.items():
    rt = OffloadRuntime(config=cfg)
    for name in jobs.PAPER_JOBS:
        job = make(name, SIZES[name])
        for n in {ns!r}:
            got, _ = rt.run(job, seed=1, n=n)
            arrays[f"run/{{cname}}/{{name}}/{{n}}"] = np.asarray(got)
    for name in ("axpy", "atax"):
        job = make(name, SIZES[name])
        req = mc.encode_cluster_selection([1, 3, 5, 7], num_clusters=8)
        arrays[f"request/{{cname}}/{{name}}"] = rt.run(job, seed=2,
                                                    request=req)[0]
        arrays[f"clusters/{{cname}}/{{name}}"] = rt.run(
            job, seed=3, clusters=[0, 1, 2, 5])[0]
        for fuse in (None, 4):
            meta["collectives"][f"{{cname}}/{{name}}/{{fuse}}"] = (
                count_collectives(rt.lowered_text(job, 8, fuse=fuse)))

{script_code}

for key, (kwargs, name, size) in SCRIPTS.items():
    rt = OffloadRuntime(config=OffloadConfig(**kwargs))
    steps = script(rt, make(name, size))
    meta["stats"][key] = [(tag, st, hits, misses)
                          for tag, st, hits, misses, _ in steps]
    for i, (tag, *_, got) in enumerate(steps):
        arrays[f"script/{{key}}/{{i}}"] = np.asarray(got)

np.savez({out!r}, **arrays)
with open({meta_out!r}, "w") as f:
    json.dump(meta, f)
print("OK")
'''

# One call sequence, run verbatim by both packages (``Staging``,
# ``Residency``, ``STAGING_MODES`` and ``dataclasses`` are in scope on
# both sides).
_SCRIPT_CODE = r'''
def script(rt, job):
    steps = []
    def snap(tag, got):
        steps.append((tag, dataclasses.asdict(rt.stats), rt.plan_hits,
                      rt.plan_misses, got))
    o0, o1 = job.make_instance(0)[0], job.make_instance(1)[0]
    snap("cold", rt.offload(job, o0, n=8).wait())
    snap("warm", rt.offload(job, o1, n=8).wait())
    snap("resident", rt.offload(job, Residency.RESIDENT, n=8).wait())
    snap("resident-again", rt.offload(job, Residency.RESIDENT, n=8).wait())
    snap("args-changed", rt.offload(job, Residency.RESIDENT,
                                    job_args=np.full((8,), 2.0), n=8).wait())
    plan = rt.plan(job, n=8)
    for mode in STAGING_MODES:
        plan.stage(o0, via=Staging(mode))
        snap(f"staged-{mode}", rt.offload(job, Residency.RESIDENT, n=8).wait())
    insts = [job.make_instance(s)[0] for s in range(4)]
    snap("fused", rt._offload_fused(job, insts, n=8,
                                    staging=Staging.TREE).wait())
    snap("fused-resident", rt._offload_fused(job, Residency.RESIDENT, n=8,
                                             batch=4).wait())
    plan.invalidate()
    snap("restaged-n4", rt.offload(job, o1, n=4).wait())
    snap("restaged-n8", rt.offload(job, o1, n=8).wait())
    return steps
'''
exec(_SCRIPT_CODE)   # defines ``script`` for the port's side


@pytest.fixture(scope="module")
def reference(tmp_path_factory, subproc):
    """Everything the reference runtime produced, from ONE subprocess."""
    d = tmp_path_factory.mktemp("offload_ref")
    out, meta_out = str(d / "ref.npz"), str(d / "meta.json")
    subproc(_REFERENCE_CODE.format(
        sizes=SIZES, scripts=SCRIPTS, ns=NS, script_code=_SCRIPT_CODE,
        out=out, meta_out=meta_out), timeout=900)
    with np.load(out) as z:
        arrays = {k: z[k] for k in z.files}
    with open(meta_out) as f:
        meta = json.load(f)
    return arrays, meta


def _config(name):
    return OffloadConfig.baseline() if name == "baseline" \
        else OffloadConfig.extended()


def _runtime(config, **kw):
    return OffloadRuntime(device="cpu", config=config, num_clusters=8, **kw)


def _make(name, size=None):
    return t_jobs.PAPER_JOBS[name](*(SIZES[name] if size is None else size))


@pytest.mark.parametrize("cname", CONFIGS)
@pytest.mark.parametrize("name", JOBS)
def test_jobs_match_reference(reference, name, cname):
    arrays, _ = reference
    rt = _runtime(_config(cname))
    job = _make(name)
    for n in NS:
        got, expected = rt.run(job, seed=1, n=n)
        want = arrays[f"run/{cname}/{name}/{n}"]
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"n={n}")
        np.testing.assert_allclose(got, expected, **TOL, err_msg=f"n={n}")


@pytest.mark.parametrize("cname", CONFIGS)
@pytest.mark.parametrize("name", ("axpy", "atax"))
def test_selections_match_reference(reference, name, cname):
    arrays, _ = reference
    rt = _runtime(_config(cname))
    job = _make(name)
    req = t_mc.encode_cluster_selection([1, 3, 5, 7], num_clusters=8)
    assert rt.select_clusters(request=req)[1] == [1, 3, 5, 7]
    np.testing.assert_allclose(rt.run(job, seed=2, request=req)[0],
                               arrays[f"request/{cname}/{name}"], **TOL)
    assert sorted(rt.select_clusters(clusters=[0, 1, 2, 5])[1]) == [0, 1, 2, 5]
    np.testing.assert_allclose(rt.run(job, seed=3, clusters=[0, 1, 2, 5])[0],
                               arrays[f"clusters/{cname}/{name}"], **TOL)


@pytest.mark.parametrize("key", sorted(SCRIPTS))
def test_plan_stats_match_reference_step_by_step(reference, key):
    arrays, meta = reference
    kwargs, name, size = SCRIPTS[key]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        config = OffloadConfig(**kwargs)
    steps = script(_runtime(config), _make(name, size))
    want = meta["stats"][key]
    assert [s[0] for s in steps] == [w[0] for w in want]
    for i, ((tag, stats, hits, misses, got), w) in enumerate(zip(steps, want)):
        assert stats == w[1], (tag, stats, w[1])
        assert (hits, misses) == (w[2], w[3]), tag
        np.testing.assert_allclose(got, arrays[f"script/{key}/{i}"], **TOL,
                                   err_msg=tag)


@pytest.mark.parametrize("fuse", (None, 4))
@pytest.mark.parametrize("cname", CONFIGS)
@pytest.mark.parametrize("name", ("axpy", "atax"))
def test_collective_counts_match_reference(reference, name, cname, fuse):
    _, meta = reference
    rt = _runtime(_config(cname))
    got = count_collectives(rt.launch_trace(_make(name), 8, fuse=fuse))
    assert got == meta["collectives"][f"{cname}/{name}/{fuse}"]


# ---------------------------------------------------------------------------
# The port alone.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cname", CONFIGS)
@pytest.mark.parametrize("name", JOBS)
def test_occamy_32_clusters(name, cname):
    """All 32 of Occamy's clusters: exact results, and the launch trace
    has the paper's structure — 2(n−1) hops for the baseline, none and at
    most two reductions for the extension."""
    rt = OffloadRuntime(device="cpu", config=_config(cname))
    assert rt.num_clusters == 32
    size = (64, 16, 16) if name == "matmul" else None
    job = _make(name, size)
    got, expected = rt.run(job, seed=4, n=32)
    np.testing.assert_allclose(got, expected, **TOL)
    counts = count_collectives(rt.plan(job, n=32).fn.trace)
    if cname == "baseline":
        assert counts["collective-permute"] == 2 * (32 - 1)
    else:
        assert counts["collective-permute"] == 0
        assert counts["all-reduce"] <= 2


def test_indivisible_shard_raises_as_in_reference():
    rt = OffloadRuntime(device="cpu")
    job = t_jobs.make_matmul(16, 16, 16)
    with pytest.raises(ValueError, match="not divisible by 32 clusters"):
        rt.run(job, n=32)


def test_broken_chain_corrupts_the_result():
    """The job-info scale rides through phase F: a chain hop that does not
    deliver leaves the clusters past it with a zero scale."""
    rt = _runtime(OffloadConfig.baseline())
    job = _make("axpy")
    ops, expected = job.make_instance(0)
    plan = rt.plan(job, ops, n=8)
    args = torch.zeros((8, 8), dtype=torch.float64)
    args[0] = 1.0
    staged = plan.stage(ops)
    out, arrivals = plan.fn(args, *(staged[k] for k in sorted(staged)))
    np.testing.assert_allclose(out.numpy(), expected, **TOL)
    assert arrivals.item() == 8
    broken = args.clone()
    broken[0] = 0.0          # cluster 0 never received the job info
    out, _ = plan.fn(broken, *(staged[k] for k in sorted(staged)))
    assert np.all(out.numpy() == 0.0)


def test_staging_modes_bit_identical_and_counted():
    job = _make("covariance")
    ops, expected = job.make_instance(5)
    size = ops["data"].nbytes
    ref = None
    for mode in STAGING_MODES:
        rt = OffloadRuntime(device="cpu", config=OffloadConfig(
            staging=Staging(mode)))
        got = rt.offload(job, ops, n=32).wait()
        np.testing.assert_allclose(got, expected, **TOL)
        ref = got if ref is None else ref
        assert np.array_equal(got, ref), mode
        args = 8 * 8
        if mode in ("tree", "tree_reshard"):
            assert rt.stats.h2d_bytes == size + args
            assert rt.stats.d2d_bytes == (size + args) * 31
            assert rt.stats.tree_stages == 2
        else:
            assert rt.stats.h2d_bytes == (size + args) * 32
            assert rt.stats.d2d_bytes == 0


def test_donated_buffers_are_released_and_reuse_raises():
    rt = _runtime(OffloadConfig(donate_operands=True))
    job = _make("axpy")
    ops, expected = job.make_instance(1)
    plan = rt.plan(job, ops, n=8)
    staged = dict(plan.stage(ops))   # the plan clears its own dict
    rt.offload(job, Residency.RESIDENT, n=8).wait()
    for buf in staged.values():
        assert buf.untyped_storage().nbytes() == 0
    with pytest.raises(DonatedOperandError) as info:
        plan.stage(staged)
    assert info.value.code == "OFL003"
    np.testing.assert_allclose(rt.offload(job, Residency.RESIDENT, n=8).wait(),
                               expected, **TOL)
    assert rt.stats.donation_restages == 2


def test_out_of_order_wait_and_retire():
    rt = _runtime(OffloadConfig.extended())
    js = [_make("axpy", (256,)), _make("matmul"), _make("axpy", (128,))]
    insts = [j.make_instance(i) for i, j in enumerate(js)]
    hs = [rt.offload(j, ops, n=k) for j, (ops, _), k in zip(js, insts,
                                                           (4, 2, 8))]
    assert set(rt.unit.outstanding()) == {0, 1, 2}
    hs[1].retire()
    assert hs[1].plan.stats.d2h_bytes == 0
    for h in (hs[2], hs[0], hs[1]):
        h.wait()
    for h, (_, exp) in zip(hs, insts):
        np.testing.assert_allclose(h.wait(), exp, **TOL)   # idempotent
    assert rt.unit.outstanding() == {}


def test_fused_per_job_args_scale_each_job():
    rt = _runtime(OffloadConfig.baseline())
    job = _make("atax")
    insts, exps = t_jobs.make_instances(job, 3)
    scales = np.array([1.0, 2.0, -0.5])
    args = np.ones((3, 8)) * scales[:, None]
    outs = rt.offload_fused(job, insts, job_args=args, n=8).wait_each()
    for got, exp, s in zip(outs, exps, scales):
        np.testing.assert_allclose(got, s * exp, **TOL)
