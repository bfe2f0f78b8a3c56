"""The port's captured programs (``repro_torch.core.graphs``), on the CPU.

On the card the port replays its resident offload dispatch and its decode
programs as CUDA graphs.  What a capture needs can be held here:

* the decode body that gets captured — the position a device int32
  scalar, the new K/V row written by a device-side index op, attention
  over the whole cache under ``arange(Smax) <= pos`` — against the
  reference's ``prefill``/``decode_step`` logits for a dense (MHA), a GQA,
  an SSM, a hybrid and the audio-stub model (musicgen's sinusoidal
  positions; ``reduced`` configs in float32 compute, the
  reference's weights; one 1-device 32-bit subprocess), and the engine's
  greedy tokens in ``host``/``step``/``chunk`` and through
  ``generate_many`` against the reference engine's;
* that the decode step and a resident ``_Program`` run end to end on the
  ``meta`` device: neither reads a tensor value on the host;
* with the capturer replaced by a recording stub whose "replays" rewrite
  the outputs of its first call (a graph's static buffers), the graph
  caches' keys (the offload runtime's are ``_build``'s), what drops an
  entry, what never builds one, and that every replay's results are
  tensors of their own.

The ``cuda`` tests capture for real and skip without a card.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch import models as T
from repro_torch.core import graphs, jobs
from repro_torch.core.offload import (
    OffloadConfig, OffloadRuntime, _Program, count_collectives,
)
from repro_torch.core.policy import Residency
from repro_torch.kernels import build
from repro_torch.models import model as TM
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve.engine import build_ragged_step, build_sampling_step

F32_TOL = dict(rtol=1e-4, atol=1e-4)        # tests/test_models_smoke.py:65
JOB_TOL = dict(rtol=1e-9, atol=1e-9)        # tests/test_offload_runtime.py:17
ARCHS = {"dense": ("smollm-360m", {"n_kv_heads": 4}),
         "gqa": ("yi-9b", {}),
         "ssm": ("falcon-mamba-7b", {}),
         "hybrid": ("zamba2-2.7b", {}),
         "audio": ("musicgen-large", {})}
B, S, MAXLEN, STEPS, NEW, CHUNK = 4, 8, 24, 6, 10, 4
MANY = dict(batch=2, max_len=24, arrivals=[0, 0, 1, 4])
CONFIGS = {"baseline": OffloadConfig.baseline(),
           "extended": OffloadConfig.extended()}

_REFERENCE_CODE = '''
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
from repro import models as M
from repro.launch.mesh import make_mesh
from repro.serve import ServeConfig, ServeEngine

mesh = make_mesh((1, 1), ("data", "model"))
rng = np.random.default_rng(5)
out, meta = {{}}, {{}}
for tag, (arch, kw) in {archs}.items():
    cfg = dataclasses.replace(M.reduced(M.get(arch)), compute_dtype="float32",
                              **kw)
    params = jax.device_get(M.init_params(jax.random.key(0), cfg))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[f"w_{{tag}}_" + "/".join(p.key for p in path)] = np.asarray(leaf)
    toks = rng.integers(0, cfg.vocab_size, ({b}, {s})).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, ({steps}, {b}, 1)).astype(np.int32)
    out[f"toks_{{tag}}"], out[f"nxt_{{tag}}"] = toks, nxt
    lp, cache = M.prefill(params, cfg, {{"tokens": toks}}, {maxlen})
    out[f"pre_{{tag}}"] = np.asarray(lp)
    for i in range({steps}):
        ld, cache = M.decode_step(params, cfg, cache, jnp.asarray(nxt[i]))
        out[f"dec_{{tag}}_{{i}}"] = np.asarray(ld)
    meta[f"pos_{{tag}}"] = int(cache["pos"])
    eng = ServeEngine(cfg, params, mesh, ServeConfig(batch={b},
                                                     max_len={maxlen}))
    eng.place_params(params)
    out[f"gen_{{tag}}"] = eng.generate(toks, {new})
    if cfg.family in ("ssm", "hybrid") or cfg.frontend:
        continue
    many = {many}
    reqs = [(toks[i, :3 + i], 3 + i) for i in range({b})]
    eng = ServeEngine(cfg, params, mesh, ServeConfig(
        batch=many["batch"], max_len=many["max_len"], prefill_bucket=4))
    eng.place_params(params)
    for i, o in enumerate(eng.generate_many(
            reqs, arrival_steps=many["arrivals"])):
        out[f"many_{{tag}}_{{i}}"] = o
np.savez({path!r}, **out)
with open({meta_path!r}, "w") as f:
    json.dump(meta, f)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("graphs_ref")
    path, meta_path = str(d / "ref.npz"), str(d / "meta.json")
    subproc(_REFERENCE_CODE.format(
        archs=ARCHS, b=B, s=S, steps=STEPS, maxlen=MAXLEN, new=NEW,
        many=MANY, path=path, meta_path=meta_path),
        devices=1, x64=False, timeout=900)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    with open(meta_path) as f:
        return arrays, json.load(f)


def _cfg(tag):
    arch, kw = ARCHS[tag]
    return dataclasses.replace(T.reduced(T.get(arch)),
                               compute_dtype="float32", **kw)


def _model(arrays, tag):
    """The reference's weights in a port model on the host."""
    prefix = f"w_{tag}_"
    tree = {}
    for name, arr in arrays.items():
        if name.startswith(prefix):
            node = tree
            *parents, leaf = name[len(prefix):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arr
    cfg = _cfg(tag)
    model = TM.Transformer(cfg, device="meta")
    model.load_state_dict(convert.model_params_from_numpy(tree, cfg),
                          assign=True)
    return cfg, model


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the decode body against the reference ----------------------------------------


@pytest.mark.parametrize("tag", list(ARCHS))
def test_decode_body_matches_reference(reference, tag):
    arrays, meta = reference
    cfg, model = _model(arrays, tag)
    logits, cache = T.prefill(model, cfg,
                              {"tokens": _t(arrays[f"toks_{tag}"])}, MAXLEN)
    torch.testing.assert_close(logits, _t(arrays[f"pre_{tag}"]), **F32_TOL)
    pos = cache["pos"]
    assert pos.shape == () and pos.dtype == torch.int32 and int(pos) == S
    for i in range(STEPS):
        logits, cache = T.decode_step(model, cfg, cache,
                                      _t(arrays[f"nxt_{tag}"][i]))
        torch.testing.assert_close(logits, _t(arrays[f"dec_{tag}_{i}"]),
                                   **F32_TOL)
    assert cache["pos"].dtype == torch.int32
    assert int(cache["pos"]) == meta[f"pos_{tag}"] == S + STEPS


def test_decode_writes_its_row_and_masks_the_rest():
    """A position past the live prefix, written in place; whatever lies
    past ``pos`` (here: huge values) has no weight, as the reference's
    mask gives it."""
    cfg = _cfg("gqa")
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(3))
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(4))
    _, cache = T.prefill(model, cfg, {"tokens": toks}, MAXLEN)
    want, _ = T.decode_step(model, cfg, {k: v.clone() for k, v in
                                         cache.items()}, toks[:, -1:])
    for name in ("k", "v"):
        cache[name][:, :, S + 1:] = 1e4
    k_before = cache["k"].clone()
    got, new = T.decode_step(model, cfg, cache, toks[:, -1:])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert new["k"] is cache["k"] and int(new["pos"]) == S + 1
    changed = (cache["k"] != k_before).any(dim=(0, 1, 3))
    assert changed.nonzero().flatten().tolist() == [S]


@pytest.mark.parametrize("mode", ["host", "step", "chunk"])
@pytest.mark.parametrize("tag", list(ARCHS))
def test_engine_modes_match_reference(reference, tag, mode):
    arrays, _ = reference
    cfg, model = _model(arrays, tag)
    eng = ServeEngine(cfg, model, ServeConfig(
        batch=B, max_len=MAXLEN, decode_mode=mode, decode_chunk=CHUNK),
        device="cpu")
    for _ in range(2):       # the second call reuses the engine's state
        out = eng.generate(arrays[f"toks_{tag}"], NEW)
        np.testing.assert_array_equal(out, arrays[f"gen_{tag}"])


@pytest.mark.parametrize("tag", ["dense", "gqa"])
def test_generate_many_matches_reference(reference, tag):
    arrays, _ = reference
    cfg, model = _model(arrays, tag)
    toks = arrays[f"toks_{tag}"]
    reqs = [(toks[i, :3 + i], 3 + i) for i in range(B)]
    eng = ServeEngine(cfg, model, ServeConfig(
        batch=MANY["batch"], max_len=MANY["max_len"], prefill_bucket=4),
        device="cpu")
    for _ in range(2):
        outs = eng.generate_many(reqs, arrival_steps=MANY["arrivals"])
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o, arrays[f"many_{tag}_{i}"])


# -- no host reads: the bodies on the meta device ---------------------------------


@pytest.mark.parametrize("tag", list(ARCHS))
def test_decode_programs_run_on_meta(tag):
    cfg = _cfg(tag)
    model = TM.Transformer(cfg, device="meta")
    cache = T.init_cache(cfg, B, MAXLEN, device="meta")
    tok = torch.zeros((B, 1), dtype=torch.int32, device="meta")
    logits, new = T.decode_step(model, cfg, cache, tok)
    assert logits.device.type == "meta"
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert new["pos"].shape == () and new["pos"].device.type == "meta"
    nxt, _ = build_sampling_step(model, cfg, 0.0)(cache, tok, None)
    assert nxt.shape == (B, 1) and nxt.dtype == torch.int32
    if cfg.family in ("ssm", "hybrid") or cfg.frontend:
        return
    pos_b = torch.zeros((B,), dtype=torch.int32, device="meta")
    nxt, pos_b2, _ = build_ragged_step(model, cfg, 0.0)(
        cache, tok, pos_b, pos_b, None)
    assert nxt.shape == (B, 1) and pos_b2.shape == (B,)


def _meta_args(job, n):
    """Per-cluster args and cluster-major operands of ``job`` on n
    clusters, as meta tensors."""
    operands = job.make_instance(0)[0]
    ops = []
    for name in sorted(operands):
        shape = operands[name].shape
        ax = job.shard_axes[name]
        if ax is not None:
            shape = shape[:ax] + (shape[ax] // n,) + shape[ax + 1:]
        ops.append(torch.empty((n,) + shape, dtype=torch.float64,
                               device="meta"))
    return torch.empty((n, 8), dtype=torch.float64, device="meta"), ops


@pytest.mark.parametrize("cname", list(CONFIGS))
@pytest.mark.parametrize("name", list(jobs.PAPER_JOBS))
def test_resident_program_runs_on_meta(cname, name):
    job = jobs.PAPER_JOBS[name]()
    n = 8
    prog = _Program(job, CONFIGS[cname], n, None, torch.device("meta"))
    args, ops = _meta_args(job, n)
    if job.loop_trips is None:
        result, arrivals = prog.bind(args, ops)()
    else:
        # the trip count comes from the data (off the meta device); with
        # it the loop reads nothing on the host, and without it it does
        result, arrivals = prog(args, *ops, trips=3)
        with pytest.raises((RuntimeError, NotImplementedError)):
            prog(args, *ops)
    expected = job.make_instance(0)[1]
    assert result.device.type == "meta" and arrivals.device.type == "meta"
    assert tuple(result.shape) == np.asarray(expected).shape
    counts = count_collectives(prog.trace)
    if cname == "baseline":
        assert counts["collective-permute"] == 2 * (n - 1)


def test_bfs_fixed_trips_equal_its_loop():
    job = jobs.make_bfs(64)
    adj = torch.from_numpy(job.make_instance(0)[0]["adj"])
    trips = job.loop_trips(adj)
    assert trips > 1
    want = job.compute(adj)
    assert torch.equal(job.compute(adj, trips=trips), want)
    assert torch.equal(job.compute(adj, trips=trips + 2), want)
    assert not torch.equal(job.compute(adj, trips=trips - 2), want)


# -- the graph caches, with the capturer replaced by a recording stub -------------


class StubGraph:
    """A graph whose first call runs the body and keeps its outputs (the
    static buffers), and whose every later call runs the body again and
    copies the results into them, as a replay rewrites a graph's
    outputs."""

    made = []

    def __init__(self, body, *, bound=(), generators=()):
        self.body, self.bound = body, tuple(bound)
        self.generators = tuple(generators)
        self.out, self.calls = None, 0
        StubGraph.made.append(self)

    def __call__(self, copy=False):
        self.calls += 1
        if self.out is None:
            self.out = self.body()
            return graphs._clone(self.out)
        for a, b in zip(graphs._tensors(self.out),
                        graphs._tensors(self.body())):
            a.copy_(b)
        return graphs._clone(self.out) if copy else self.out


@pytest.fixture
def stub(monkeypatch):
    StubGraph.made = []
    monkeypatch.setattr(graphs, "captures", lambda device: True)
    monkeypatch.setattr(graphs, "capture", StubGraph)
    return StubGraph


def _runtime(cname, **kw):
    return OffloadRuntime(device="cpu", config=CONFIGS[cname],
                          num_clusters=8, **kw)


@pytest.mark.parametrize("cname", list(CONFIGS))
def test_offload_graphs_are_keyed_like_build(stub, cname):
    rt = _runtime(cname)
    for name, make in jobs.PAPER_JOBS.items():
        job = make()
        ops, expected = job.make_instance(1)
        rt.offload(job, ops, n=8).wait()
        for _ in range(3):
            got = rt.offload(job, Residency.RESIDENT, n=8).wait()
            np.testing.assert_allclose(got, expected, **JOB_TOL)
        plan = rt.plan(job, n=8)
        key = rt._build_key(job, plan.cluster_ids, 8,
                            tuple(n for n, _, _ in plan.op_meta), (8,))
        assert plan.build_key == key and key in rt._compiled
        assert rt._compiled[key] is plan.fn
        g = rt._graphs.get(key)
        assert g.calls == 3 and g.bound[0] is plan._args_dev
        assert [t for t in g.bound[1:]] == [plan._resident[n] for n, _, _
                                            in plan.op_meta]
    assert set(rt._graphs.keys()) <= set(rt._compiled)
    assert len(rt._graphs) == len(jobs.PAPER_JOBS) == len(stub.made)
    # the fused resident plan is keyed with its batch
    job = jobs.make_axpy(1024)
    insts, exps = jobs.make_instances(job, 4)
    rt._offload_fused(job, insts, n=8).wait()
    outs = rt._offload_fused(job, Residency.RESIDENT, n=8,
                             batch=4).wait_each()
    for o, e in zip(outs, exps):
        np.testing.assert_allclose(o, e, **JOB_TOL)
    fused = rt.plan(job, n=8, fuse=4, args_shape=(4, 8))
    assert fused.build_key[-1] == 4 and fused.build_key in rt._graphs


def test_graph_dropped_on_invalidate_restage_and_donation(stub):
    rt = _runtime("extended")
    job = jobs.make_axpy(1024)
    ops, expected = job.make_instance(0)
    rt.offload(job, ops, n=8).wait()
    rt.offload(job, Residency.RESIDENT, n=8).wait()
    plan = rt.plan(job, n=8)
    assert plan.build_key in rt._graphs
    plan.invalidate()
    assert plan.build_key not in rt._graphs
    rt.offload(job, ops, n=8).wait()                      # restage
    rt.offload(job, Residency.RESIDENT, n=8).wait()
    first = rt._graphs.get(plan.build_key)
    ops2, expected2 = job.make_instance(5)
    rt.offload(job, ops2, n=8).wait()                     # restage
    assert plan.build_key not in rt._graphs
    got = rt.offload(job, Residency.RESIDENT, n=8).wait()
    np.testing.assert_allclose(got, expected2, **JOB_TOL)
    assert rt._graphs.get(plan.build_key) is not first
    plan.stage(ops)                                       # restage
    assert plan.build_key not in rt._graphs
    # a donating config never captures, so it never leaves an entry
    made = len(stub.made)
    donor = OffloadRuntime(device="cpu", num_clusters=8,
                           config=OffloadConfig(donate_operands=True))
    donor.offload(job, ops, n=8).wait()
    for _ in range(2):
        got = donor.offload(job, Residency.RESIDENT, n=8).wait()
        np.testing.assert_allclose(got, expected, **JOB_TOL)
    assert len(donor._graphs) == 0 and len(stub.made) == made


def test_no_graph_for_staged_dispatches(stub):
    from repro_torch.api import GraphNode, Ref, Session
    rt = _runtime("baseline")
    job = jobs.make_axpy(1024)
    ops, expected = job.make_instance(0)
    for _ in range(3):                                    # cold, warm
        np.testing.assert_allclose(rt.offload(job, ops, n=8).wait(),
                                   expected, **JOB_TOL)
    assert len(rt._graphs) == 0
    sess = Session(device="cpu", num_clusters=8)
    for _ in range(3):                                    # stream, staged
        np.testing.assert_allclose(sess.submit(job, ops).wait(), expected,
                                   **JOB_TOL)
    gh = sess.submit_graph([GraphNode(job, ops, name="a"),
                            GraphNode(job, {"x": ops["x"], "y": Ref("a")},
                                      name="b")])
    gh.wait()
    assert all(len(r._graphs) == 0 for r in sess._runtimes.values())
    assert not stub.made
    # the session's resident submits replay a graph
    sess.stage(job, ops)
    for _ in range(2):
        np.testing.assert_allclose(
            sess.submit(job, Residency.RESIDENT).wait(), expected,
            **JOB_TOL)
    assert sum(len(r._graphs) for r in sess._runtimes.values()) == 1
    sess.close()


@pytest.mark.parametrize("cname", list(CONFIGS))
def test_replays_are_tensors_of_their_own(stub, cname):
    """Dispatches waited in reverse order, each with other job args (the
    new value copied into the buffer the graph reads), give their own
    results; no handle holds the graph's static outputs."""
    rt = _runtime(cname)
    for name in ("axpy", "covariance", "bfs"):
        job = jobs.PAPER_JOBS[name]()
        ops, expected = job.make_instance(2)
        rt.offload(job, ops, n=8).wait()
        hs = [rt.offload(job, Residency.RESIDENT, n=8,
                         job_args=np.full(8, float(k + 1)))
              for k in range(4)]
        plan = rt.plan(job, n=8)
        g = rt._graphs.get(plan.build_key)
        assert g.bound[0] is plan._args_dev
        assert all(h.result is not g.out[0] for h in hs)
        assert len({id(h.result) for h in hs}) == len(hs)
        got = [h.wait() for h in reversed(hs)][::-1]
        for k, r in enumerate(got):
            np.testing.assert_allclose(r, expected * (k + 1), **JOB_TOL)
        # the operands once, the args at the cold dispatch and three new
        # values (1.0 is the cold dispatch's)
        assert plan.stats.device_puts == len(plan.op_meta) + 1 + 3


def test_args_counters_match_eager_dispatch(stub, monkeypatch):
    """``PlanStats`` counts what it counts without capture."""
    job = jobs.make_matmul()
    ops, _ = job.make_instance(0)
    seen = []
    for capture in (True, False):
        monkeypatch.setattr(graphs, "captures", lambda device: capture)
        rt = _runtime("baseline")
        rt.offload(job, ops, n=8).wait()
        for a in (1.0, 1.0, 2.0, 2.0, 3.0):
            rt.offload(job, Residency.RESIDENT, n=8,
                       job_args=np.full(8, a)).wait()
        seen.append(dataclasses.asdict(rt.stats))
        assert len(rt._graphs) == int(capture)
    assert seen[0] == seen[1]


def test_cpu_runs_every_program_eagerly():
    cache = graphs.GraphCache(torch.device("cpu"))
    calls = []
    for _ in range(3):
        assert cache.run("k", lambda: (lambda: calls.append(1) or 7)) == 7
    assert len(calls) == 3 and len(cache) == 0
    assert graphs.captures(torch.device("cuda")) and not graphs.captures(
        torch.device("cpu"))
    rt = _runtime("extended")
    job = jobs.make_axpy(1024)
    ops, _ = job.make_instance(0)
    rt.offload(job, ops, n=8).wait()
    rt.offload(job, Residency.RESIDENT, n=8).wait()
    assert len(rt._graphs) == 0


def _engine_cfg():
    cfg = _cfg("gqa")
    return cfg, T.init_params(cfg, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("temperature", [0.0, 1.5])
def test_engine_programs_keyed_and_replayed(stub, monkeypatch, temperature):
    cfg, model = _engine_cfg()
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    want = {}
    for capture in (False, True):
        monkeypatch.setattr(graphs, "captures", lambda device: capture)
        stub.made = []
        for mode in ("host", "step", "chunk"):
            if mode == "host" and temperature:
                continue
            eng = ServeEngine(cfg, model, ServeConfig(
                batch=B, max_len=MAXLEN, decode_mode=mode,
                decode_chunk=CHUNK, temperature=temperature, seed=9),
                device="cpu")
            outs = [eng.generate(prompts, NEW) for _ in range(2)]
            np.testing.assert_array_equal(outs[0], outs[1])
            want.setdefault(mode, outs[0])
            np.testing.assert_array_equal(outs[0], want[mode])
            if not capture:
                assert len(eng.graphs) == 0
                continue
            key = lambda m, c: (m, B, MAXLEN, c, temperature)  # noqa: E731
            if mode == "chunk":
                chunks, rest = divmod(NEW - 1, CHUNK)
                assert set(eng.graphs.keys()) == {key("chunk", CHUNK),
                                                  key("step", 1)}
                assert eng.graphs.get(key("chunk", CHUNK)).calls == 2 * chunks
                assert eng.graphs.get(key("step", 1)).calls == 2 * rest
                assert eng.stats["xla_dispatches"] == 2 * (1 + chunks + rest)
            else:
                g = eng.graphs.get(key(mode, 1))
                assert set(eng.graphs.keys()) == {key(mode, 1)}
                assert g.calls == 2 * (NEW if mode == "host" else NEW - 1)
            # one capture per key across both generate calls, and the
            # engine's generator registered with the resident programs
            assert len(stub.made) == len(eng.graphs)
            if mode != "host":
                assert all(g.generators == (eng._gen,) for g in stub.made)
            stub.made = []
        if temperature:
            np.testing.assert_array_equal(want["chunk"], want["step"])


def test_place_params_drops_the_engine_graphs(stub):
    """Programs captured on one model's weights are not replayed on
    another's."""
    cfg, model = _engine_cfg()
    other = T.init_params(cfg, generator=torch.Generator().manual_seed(8))
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    eng = ServeEngine(cfg, model, ServeConfig(batch=B, max_len=MAXLEN),
                      device="cpu")
    eng.generate(prompts, NEW)
    assert len(eng.graphs) == 1
    eng.place_params(other)
    assert len(eng.graphs) == 0
    fresh = ServeEngine(cfg, other, ServeConfig(batch=B, max_len=MAXLEN),
                        device="cpu")
    np.testing.assert_array_equal(eng.generate(prompts, NEW),
                                  fresh.generate(prompts, NEW))


def test_ragged_program_keyed_and_replayed(stub):
    cfg, model = _engine_cfg()
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    static = ServeEngine(cfg, model, ServeConfig(batch=B, max_len=MAXLEN),
                         device="cpu").generate(prompts, 6)
    eng = ServeEngine(cfg, model, ServeConfig(batch=2, max_len=MAXLEN,
                                              prefill_bucket=4),
                      device="cpu")
    for _ in range(2):
        outs = eng.generate_many([(p, 6) for p in prompts],
                                 arrival_steps=[0, 2, 2, 5])
        for row, o in zip(static, outs):
            np.testing.assert_array_equal(o, row)
    assert set(eng.graphs.keys()) == {("ragged", 2, MAXLEN, 1, 0.0)}
    assert len(stub.made) == 2      # the static engine's step, the ragged


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs are captured on the card")
    return torch.device("cuda")


def _eager(device):
    class Eager(graphs.GraphCache):
        def run(self, key, make_body, **kw):
            return make_body()()
    return Eager(device)


@pytest.mark.cuda
@pytest.mark.parametrize("cname", list(CONFIGS))
def test_resident_dispatch_captured_on_card(cuda, cname):
    rt = OffloadRuntime(config=CONFIGS[cname], num_clusters=8)
    eager = OffloadRuntime(config=CONFIGS[cname], num_clusters=8)
    eager._graphs = _eager(eager.device)
    for name, make in jobs.PAPER_JOBS.items():
        job = make()
        ops, expected = job.make_instance(1)
        got = {}
        for side, r in (("captured", rt), ("eager", eager)):
            r.offload(job, ops, n=8).wait()
            before = build.launch_counts()
            hs = [r.offload(job, Residency.RESIDENT, n=8,
                            job_args=np.full(8, float(k + 1)))
                  for k in range(3)]
            got[side] = [h.wait() for h in reversed(hs)][::-1]
            after = build.launch_counts()
            if name in ("axpy", "matmul", "atax", "covariance"):
                assert after[name] - before[name] == 3
        for k, (c, e) in enumerate(zip(got["captured"], got["eager"])):
            np.testing.assert_allclose(c, expected * (k + 1), **JOB_TOL)
            np.testing.assert_array_equal(c, e)
        g = rt._graphs.get(rt.plan(job, n=8).build_key)
        assert g.replays == 2
        census = graphs.census(g)
        assert census["depth"] == census["nodes"]


@pytest.mark.cuda
@pytest.mark.parametrize("tag", list(ARCHS))
def test_decode_captured_on_card(cuda, tag):
    cfg = _cfg(tag)
    model = T.init_params(cfg, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    for temperature in (0.0, 1.5):
        outs = {}
        for mode, captured in (("step", False), ("step", True),
                               ("chunk", True)):
            eng = ServeEngine(cfg, model, ServeConfig(
                batch=B, max_len=MAXLEN, decode_mode=mode,
                decode_chunk=CHUNK, temperature=temperature, seed=4))
            if not captured:
                eng.graphs = _eager(eng.device)
            outs[(mode, captured)] = [eng.generate(prompts, NEW)
                                      for _ in range(2)]
        for got in outs.values():
            for o in got:
                np.testing.assert_array_equal(o, outs[("step", False)][0])


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_moe_decode_captured_on_card(cuda, cdt):
    """The reduced DeepSeek-V2-Lite's decode step, its drop-less MoE on the
    grouped products (bf16) or on the (E·T, D) buffer (f32, where
    ``torch._grouped_mm`` would read its offsets on the host), captured:
    the greedy tokens of the eager bodies."""
    cfg = dataclasses.replace(T.reduced(T.get("deepseek-v2-lite-16b")),
                              compute_dtype=cdt)
    model = T.init_params(cfg, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    outs = {}
    for mode, captured in (("step", False), ("step", True), ("chunk", True)):
        eng = ServeEngine(cfg, model, ServeConfig(
            batch=B, max_len=MAXLEN, decode_mode=mode, decode_chunk=CHUNK))
        if not captured:
            eng.graphs = _eager(eng.device)
        outs[(mode, captured)] = eng.generate(prompts, NEW)
    for o in outs.values():
        np.testing.assert_array_equal(o, outs[("step", False)])
