"""The port's lease-holding serve tenant (``ServeTenant``) and the serve
CLI's ``--fabric`` against the reference's (mirrors
``tests/test_fabric.py``'s serve-tenant cases and
``tests/test_faults.py``'s serve-tenant failover).

The fragmented-fabric grow is model-only bookkeeping: both packages run
in-process and their lease windows are held equal.  The bursts run the
reference once, in one 4-device 32-bit subprocess (the serving stack breaks
under x64), for ``reduced(smollm-360m)`` in float32 compute over
``_SCRIPT``; the port replays it on ``FabricScheduler("cpu",
num_clusters=4)`` with the reference's weights.  Greedy tokens, lease
windows, engine counts, free clusters, ``failovers`` and every window
engine's ``stats`` (under ``direct``, ``tree`` and ``tree_reshard``
staging) are held equal exactly.  On one device the windows share one
copy of the weights; ``stats`` counts the link bytes the reference's
per-device replicas move.
"""

import dataclasses
import json

import numpy as np
import pytest

from repro.core.fabric import FabricScheduler as RFabricScheduler
from repro.serve.engine import ServeTenant as RServeTenant
from repro_torch import convert
from repro_torch import models as T
from repro_torch.core.fabric import FabricScheduler
from repro_torch.core.policy import Staging
from repro_torch.launch import serve as t_cli
from repro_torch.models import model as TM
from repro_torch.serve import ServeConfig, ServeEngine, ServeTenant

ARCH = "smollm-360m"


def _grow_fragmented(sched_cls, tenant_cls):
    # free count 6 but the largest contiguous window is 4: the burst
    # must land on the widest window that fits, not raise
    sched = sched_cls(num_clusters=8)
    tenant = tenant_cls(sched, cfg=None, host_params=None, scfg=None,
                        floor=1, burst=8)
    seen = [tenant.lease.clusters]
    sched.request("offload", clusters=[3])
    tenant._grow()
    seen.append(tenant.lease.clusters)
    tenant._shrink()
    seen.append(tenant.lease.clusters)
    tenant.close()
    seen.append(tuple(sched.free_clusters()))
    return seen


def test_serve_tenant_grow_survives_fragmented_fabric():
    seen = _grow_fragmented(FabricScheduler, ServeTenant)
    assert seen[0] == (0,)
    assert len(seen[1]) == 4              # the largest free window
    assert len(seen[2]) == 1
    assert seen == _grow_fragmented(RFabricScheduler, RServeTenant)


def test_serve_tenant_floor_and_burst_validation():
    sched = FabricScheduler(num_clusters=4)
    with pytest.raises(ValueError, match="floor"):
        ServeTenant(sched, None, None, None, floor=0)
    with pytest.raises(ValueError, match="burst"):
        ServeTenant(sched, None, None, None, floor=3, burst=2)
    tenant = ServeTenant(sched, None, None, None, floor=2)
    assert tenant.burst == 4 and tenant.lease.clusters == (0, 1)
    assert tenant.peak_burst == 2 and tenant.windows == ()
    tenant.close()
    assert sched.leases == ()


#: run with ``sched()`` (a 4-cluster fabric), ``ServeTenant``,
#: ``ServeConfig``, ``Staging``, ``cfg``, ``params`` and ``engine1()`` (a
#: one-cluster engine with the weights placed) bound per side
_SCRIPT = '''
import numpy as np

prompts = np.random.default_rng(0).integers(
    0, cfg.vocab_size, (4, 8)).astype(np.int32)
arrays["engine1"] = engine1().generate(prompts, 6)

# the elastic lease: grow to the free fabric for a burst, shrink back to
# the floor, reuse the warm engine, cap a burst to what is free
s = sched()
tenant = ServeTenant(s, cfg, params, ServeConfig(batch=4, max_len=24),
                     floor=1, burst=4)
el = dict(start=[tenant.lease.n, len(s.free_clusters())])
arrays["elastic1"] = tenant.generate(prompts, 6)
el["after1"] = [tenant.lease.n, len(s.free_clusters())]
arrays["elastic2"] = tenant.generate(prompts, 6)
el["engines2"] = len(tenant._engines)
lease = s.request("offload", n=3)
el["offload"] = list(lease.clusters)
arrays["elastic3"] = tenant.generate(prompts, 6)
el["after3"] = [tenant.lease.n, len(tenant._engines)]
el["windows"] = [list(w) for w in tenant.windows]
el["peak"] = tenant.peak_burst
el["stats"] = tenant.stats
lease.release()
tenant.close()
el["free"] = len(s.free_clusters())
rec["elastic"] = el

# failover: the floor window dies between bursts
s = sched()
tenant = ServeTenant(s, cfg, params, ServeConfig(batch=4, max_len=24),
                     floor=2, burst=2)
fo = dict(start=list(tenant.lease.clusters))
arrays["fail1"] = tenant.generate(prompts, 5)
s.fail_clusters([0])
arrays["fail2"] = tenant.generate(prompts, 5)
fo["lease"] = list(tenant.lease.clusters)
fo["failovers"] = s.health().failovers
fo["windows"] = [list(w) for w in tenant.windows]
tenant.close()
fo["leases"] = len(s.leases)
rec["failover"] = fo

# every window engine's counters under each staging, through generate
# and generate_many
rng = np.random.default_rng(3)
reqs = [(rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32), 4)
        for n in (3, 9, 5, 12, 2)]
for staging in (Staging.DIRECT, Staging.TREE, Staging.TREE_RESHARD):
    s = sched()
    tenant = ServeTenant(s, cfg, params, ServeConfig(
        batch=4, max_len=24, staging=staging, prefill_bucket=4),
        floor=1, burst=4)
    arrays[f"st_{staging.value}_gen"] = tenant.generate(prompts, 4)
    outs = tenant.generate_many(reqs, arrival_steps=[0, 0, 1, 2, 6])
    blocker = s.request("offload", n=2)
    arrays[f"st_{staging.value}_gen2"] = tenant.generate(prompts[:3], 4)
    for i, o in enumerate(outs):
        arrays[f"st_{staging.value}_many{i}"] = o
    rec[f"stats_{staging.value}"] = dict(
        total=tenant.stats, windows=[list(w) for w in tenant.windows],
        per_window={",".join(map(str, w)): e.stats
                    for w, e in sorted(tenant._engines.items())})
    blocker.release()
    tenant.close()
'''

_REFERENCE = '''
import dataclasses, json
import numpy as np
import jax
from repro import models as M
from repro.api import FabricScheduler
from repro.core.policy import Staging
from repro.launch.mesh import make_mesh
from repro.serve import ServeConfig, ServeEngine, ServeTenant

cfg = dataclasses.replace(M.reduced(M.get({arch!r})), compute_dtype="float32")
params = jax.device_get(M.init_params(jax.random.key(0), cfg))
weights = {{}}
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    weights["/".join(p.key for p in path)] = np.asarray(leaf)
np.savez({weights_path!r}, **weights)
sched = lambda: FabricScheduler(jax.devices())

def engine1():
    eng = ServeEngine(cfg, params, make_mesh((1, 1), ("data", "model")),
                      ServeConfig(batch=4, max_len=24))
    eng.place_params(params)
    return eng

rec, arrays = {{}}, {{}}
''' + _SCRIPT.replace("{", "{{").replace("}", "}}") + '''
np.savez({arrays_path!r}, **arrays)
print("REC " + json.dumps(rec, sort_keys=True))
'''


def _cfg():
    return dataclasses.replace(T.reduced(T.get(ARCH)), compute_dtype="float32")


def _port_model(weights):
    tree = {}
    for name, arr in weights.items():
        node = tree
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    model = TM.Transformer(_cfg(), device="meta")
    model.load_state_dict(convert.model_params_from_numpy(tree, _cfg()),
                          assign=True)
    return model


@pytest.fixture(scope="module")
def reference(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("tenant_ref")
    wpath, apath = str(d / "w.npz"), str(d / "a.npz")
    out = subproc(_REFERENCE.format(arch=ARCH, weights_path=wpath,
                                    arrays_path=apath),
                  devices=4, x64=False, timeout=900)
    rec = json.loads(next(ln[4:] for ln in out.splitlines()
                          if ln.startswith("REC ")))
    with np.load(wpath) as z:
        weights = {k: z[k] for k in z.files}
    with np.load(apath) as z:
        arrays = {k: z[k] for k in z.files}
    return rec, arrays, weights


@pytest.fixture(scope="module")
def port(reference):
    cfg, host = _cfg(), _port_model(reference[2])

    def engine1():
        eng = ServeEngine(cfg, host, ServeConfig(batch=4, max_len=24),
                          device="cpu")
        eng.place_params(host)
        return eng

    scope = dict(rec={}, arrays={}, cfg=cfg, params=host,
                 ServeTenant=ServeTenant, ServeConfig=ServeConfig,
                 Staging=Staging, engine1=engine1,
                 sched=lambda: FabricScheduler("cpu", num_clusters=4))
    exec(_SCRIPT, scope)
    return json.loads(json.dumps(scope["rec"], sort_keys=True)), \
        scope["arrays"]


def test_serve_tenant_elastic_lease(reference, port):
    """The tenant grows to the free fabric for a burst, shrinks to its
    floor between bursts, and repeated bursts reuse the warm engine."""
    rec, arrays = port
    el = rec["elastic"]
    assert el["start"] == [1, 3]
    assert el["after1"] == [1, 3]                  # shrunk back after burst
    assert el["engines2"] == 1                     # the burst window, reused
    assert el["offload"] == [1, 2, 3]
    assert el["after3"] == [1, 2]                  # + the floor-window engine
    assert el["free"] == 4
    assert el == reference[0]["elastic"]
    for k in ("elastic1", "elastic2", "elastic3"):
        np.testing.assert_array_equal(arrays[k], reference[1][k])
    np.testing.assert_array_equal(arrays["elastic1"], arrays["elastic2"])


def test_serve_tenant_survives_failover_greedy_identical(reference, port):
    """A tenant whose floor window fails keeps serving on the scheduler's
    replacement window, with identical greedy tokens."""
    rec, arrays = port
    fo = rec["failover"]
    assert fo["start"] == [0, 1] and fo["lease"] != [0, 1]
    assert fo["failovers"] == 1
    assert fo["leases"] == 0                       # sched.leases == ()
    assert fo == reference[0]["failover"]
    np.testing.assert_array_equal(arrays["fail1"], arrays["fail2"])
    for k in ("fail1", "fail2"):
        np.testing.assert_array_equal(arrays[k], reference[1][k])


def test_tenant_tokens_equal_the_one_device_engine(reference, port):
    """Greedy tokens of every burst equal the reference's ``ServeEngine``
    on one CPU device, whatever the window."""
    _, arrays = port
    want = reference[1]["engine1"]
    np.testing.assert_array_equal(arrays["engine1"], want)
    for k in ("elastic1", "elastic3"):
        np.testing.assert_array_equal(arrays[k], want)
    np.testing.assert_array_equal(arrays["fail1"], want[:, :5])


@pytest.mark.parametrize("staging", ["direct", "tree", "tree_reshard"])
def test_window_stats_equal_reference(reference, port, staging):
    """Each window engine counts the link bytes of its own window's
    placement, as the reference's per-device replicas move them."""
    rec, arrays = port
    got, want = rec[f"stats_{staging}"], reference[0][f"stats_{staging}"]
    assert got == want
    assert len(got["windows"]) == 2
    for name in sorted(reference[1]):
        if name.startswith(f"st_{staging}_"):
            np.testing.assert_array_equal(arrays[name], reference[1][name])


def test_window_engines_share_one_copy_of_the_weights(reference):
    """Every window engine adopts the tenant's placed weights: one set of
    parameter tensors, whatever the number of windows."""
    cfg, host = _cfg(), _port_model(reference[2])
    sched = FabricScheduler("cpu", num_clusters=4)
    tenant = ServeTenant(sched, cfg, host, ServeConfig(batch=4, max_len=24),
                         floor=1, burst=4)
    prompts = np.zeros((2, 4), np.int32)
    tenant.generate(prompts, 2)
    blocker = sched.request("offload", n=2)
    tenant.generate(prompts, 2)
    engines = list(tenant._engines.values())
    assert len(engines) == 2
    assert all(e.params is tenant.params for e in engines)
    ptrs = {p.data_ptr() for p in tenant.params.parameters()}
    assert ptrs == {p.data_ptr() for p in host.parameters()}
    blocker.release()
    tenant.close()


def test_serve_cli_fabric_on_cpu(capsys):
    t_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--batch", "4", "--prompt-len", "8", "--new-tokens", "4",
                "--fabric", "--serve-floor", "1"])
    out = capsys.readouterr().out
    assert "[serve] fabric tenant (batch 4): 16 tokens in" in out
    assert ("lease floor 1/32 clusters, burst window 32, free between "
            "bursts: 31") in out
    assert out.count("slot ") == 2
    t_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "6", "--new-tokens", "3",
                "--fabric", "--floor", "2", "--continuous",
                "--requests", "3"])
    out = capsys.readouterr().out
    assert "fabric tenant (continuous, 3 requests): 9 tokens in" in out
    assert "lease floor 2/32 clusters, burst window 32, free between " \
        "bursts: 30" in out
