"""The port's device-free modules against the reference, exactly.

``repro_torch``'s params, phases, multicast, policy, broadcast tree,
simulator, analytical model and fault plans are copies of ``repro``'s; these
tests hold them to the reference in-process on the same inputs: simulator
and model totals for all six jobs, multicast encode/decode, fan-out trees
and staging costs, all compared with ``==``.  The last tests scan the
port's sources: no module imports JAX or ``repro``, and every entry point
that defaults to the card raises without one.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.core import broadcast as r_bc
from repro.core import faults as r_faults
from repro.core import jobs as r_jobs
from repro.core import model as r_model
from repro.core import multicast as r_mc
from repro.core import params as r_params
from repro.core import policy as r_policy
from repro.core import simulator as r_sim
from repro_torch import convert
from repro_torch.core import broadcast as t_bc
from repro_torch.core import faults as t_faults
from repro_torch.core import jobs as t_jobs
from repro_torch.core import model as t_model
from repro_torch.core import multicast as t_mc
from repro_torch.core import params as t_params
from repro_torch.core import policy as t_policy
from repro_torch.core import simulator as t_sim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOBS = tuple(r_jobs.PAPER_JOBS)
NS = (1, 2, 8, 32)
MODES = ("baseline", "multicast")


def _specs(name):
    return r_jobs.PAPER_JOBS[name]().spec, t_jobs.PAPER_JOBS[name]().spec


def _phase_table(result):
    return {p.name: (s.min, s.avg, s.max)
            for p, s in result.phase_stats().items()}


def test_params_identical_and_convert_roundtrip():
    ref = dataclasses.asdict(r_params.DEFAULT_PARAMS)
    assert dataclasses.asdict(t_params.DEFAULT_PARAMS) == ref
    assert t_params.DEFAULT_PARAMS.num_clusters == 32
    assert convert.occamy_params_from_dict(ref) == t_params.DEFAULT_PARAMS
    tweaked = dict(ref, host_store_next=30.0)
    assert (convert.occamy_params_from_dict(tweaked).host_store_next
            == 30.0)
    with pytest.raises(ValueError):
        convert.occamy_params_from_dict(dict(ref, bogus=1))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", JOBS)
def test_simulate_and_model_totals_equal(name, n, mode):
    r_spec, t_spec = _specs(name)
    r_res = r_sim.simulate(r_spec, n, mode)
    t_res = t_sim.simulate(t_spec, n, mode)
    assert t_res.total == r_res.total
    assert t_res.cluster_done == r_res.cluster_done
    assert _phase_table(t_res) == _phase_table(r_res)
    assert (t_sim.offload_overhead(t_spec, n, mode)
            == r_sim.offload_overhead(r_spec, n, mode))
    assert t_model.predict_total(t_spec, n) == r_model.predict_total(r_spec, n)
    assert (t_model.predict_total_v2(t_spec, n)
            == r_model.predict_total_v2(r_spec, n))


@pytest.mark.parametrize("name", JOBS)
def test_optimal_clusters_and_speedups_equal(name):
    r_spec, t_spec = _specs(name)
    assert (t_model.optimal_clusters(lambda: t_spec)
            == r_model.optimal_clusters(lambda: r_spec))
    assert (t_model.should_offload(t_spec, 1e5)
            == r_model.should_offload(r_spec, 1e5))
    for n in NS:
        assert t_sim.speedups(t_spec, n) == r_sim.speedups(r_spec, n)


def test_closed_forms_equal():
    for n in NS:
        assert (t_model.axpy_closed_form(n, 1024)
                == r_model.axpy_closed_form(n, 1024))
        assert (t_model.atax_closed_form_paper(n, 64, 64)
                == r_model.atax_closed_form_paper(n, 64, 64))


def _selections(seed, count):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        k = int(rng.integers(1, 33))
        out.append(sorted(rng.choice(32, size=k, replace=False).tolist()))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_multicast_encode_decode_equal(seed):
    for sel in _selections(seed, 16):
        r_reqs = r_mc.encode_cluster_selection_multi(sel)
        t_reqs = t_mc.encode_cluster_selection_multi(sel)
        assert ([(q.addr, q.mask) for q in t_reqs]
                == [(q.addr, q.mask) for q in r_reqs])
        for rq, tq in zip(r_reqs, t_reqs):
            assert (t_mc.decode_cluster_selection(tq)
                    == r_mc.decode_cluster_selection(rq))
        try:
            want = r_mc.encode_cluster_selection(sel)
        except ValueError:
            with pytest.raises(ValueError):
                t_mc.encode_cluster_selection(sel)
        else:
            got = t_mc.encode_cluster_selection(sel)
            assert (got.addr, got.mask) == (want.addr, want.mask)


@pytest.mark.parametrize("seed", range(4))
def test_build_tree_and_depth_bound_equal(seed):
    for sel in _selections(100 + seed, 16):
        r_tree, t_tree = r_bc.build_tree(sel), t_bc.build_tree(sel)
        assert (t_tree.clusters, t_tree.root, t_tree.levels) == (
            r_tree.clusters, r_tree.root, r_tree.levels)
        assert t_tree.cross_quadrant_edges() == r_tree.cross_quadrant_edges()
        assert t_bc.depth_bound(sel) == r_bc.depth_bound(sel)
        assert t_tree.depth <= t_bc.depth_bound(sel)


@pytest.mark.parametrize("mode", ("host_fanout", "tree"))
def test_staging_cost_models_equal(mode):
    for sel in [1, 2, 8, 32] + _selections(7, 6):
        for nbytes in (64.0, 8192.0, 1 << 20):
            assert (t_sim.simulate_staging(nbytes, sel, mode)
                    == r_sim.simulate_staging(nbytes, sel, mode))
            assert (t_sim.staging_model(nbytes, sel, mode)
                    == r_sim.staging_model(nbytes, sel, mode))


def test_policy_enums_and_validation_equal():
    for r_cls, t_cls in ((r_policy.Staging, t_policy.Staging),
                         (r_policy.InfoDist, t_policy.InfoDist),
                         (r_policy.Completion, t_policy.Completion),
                         (r_policy.Residency, t_policy.Residency)):
        assert [m.value for m in t_cls] == [m.value for m in r_cls]
    with pytest.raises(ValueError):
        t_policy.coerce_enum(t_policy.InfoDist, "mulicast", "info_dist")


def test_fault_plans_and_recovery_equal():
    for seed in range(3):
        r_plan = r_faults.FaultPlan.random(seed)
        t_plan = t_faults.FaultPlan.random(seed)
        assert ([(f.kind.value, f.at_dispatch, tuple(f.clusters), f.factor,
                  f.count) for f in t_plan]
                == [(f.kind.value, f.at_dispatch, tuple(f.clusters),
                     f.factor, f.count) for f in r_plan])
        r_job, t_job = r_jobs.make_axpy(1024), t_jobs.make_axpy(1024)
        assert (t_faults.predict_recovery(t_job, 8, t_plan,
                                          t_policy.RetryPolicy())
                == r_faults.predict_recovery(r_job, 8, r_plan,
                                             r_policy.RetryPolicy()))


@pytest.mark.parametrize("name", JOBS)
def test_job_instances_bit_identical(name):
    r_job = r_jobs.PAPER_JOBS[name]()
    t_job = t_jobs.PAPER_JOBS[name]()
    assert t_job.shard_axes == r_job.shard_axes
    assert (t_job.out_axis, t_job.reduce) == (r_job.out_axis, r_job.reduce)
    r_ops, r_exp = r_job.make_instance(3)
    t_ops, t_exp = t_job.make_instance(3)
    assert sorted(t_ops) == sorted(r_ops)
    for k in r_ops:
        assert np.array_equal(t_ops[k], r_ops[k])
    assert np.array_equal(t_exp, r_exp)


@pytest.mark.parametrize("axis", (None, 0, 1))
def test_placement_matches_partition_spec_blocks(axis):
    arr = np.arange(8 * 12, dtype=np.float64).reshape(8, 12)
    p = t_bc.Placement(4, axis)
    rows = p.to_clusters(arr)
    for c in range(4):
        want = (arr if axis is None
                else np.split(arr, 4, axis=axis)[c])
        assert np.array_equal(rows[c], want)
    back = p.from_clusters(torch.from_numpy(np.ascontiguousarray(rows)))
    assert np.array_equal(back.numpy(), arr)
    if axis is not None:
        with pytest.raises(ValueError):
            t_bc.Placement(5, axis).shard_shape(arr.shape)


# ---------------------------------------------------------------------------
# Source scans: the port stands alone.
# ---------------------------------------------------------------------------


def _port_sources():
    root = os.path.join(REPO, "src", "repro_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_neither_jax_nor_reference():
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path}: {m}")
    assert not bad, bad


def test_cuda_requests_raise_without_a_card(monkeypatch):
    from repro_torch.core.offload import OffloadRuntime
    from repro_torch.kernels import ops
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OffloadRuntime()
    with pytest.raises(RuntimeError):
        OffloadRuntime(device="cuda")
    x = torch.zeros(4, dtype=torch.float64)
    a = torch.zeros(4, 4, dtype=torch.float64)
    for call in (lambda: ops.axpy(x, x, 1.0, impl="kernel"),
                 lambda: ops.matmul(a, a, impl="kernel"),
                 lambda: ops.atax(a, x, impl="kernel"),
                 lambda: ops.covariance(a, impl="kernel")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
