"""The port's serve engine against the reference's, on the CPU.

One subprocess (``run_subprocess``, one device, 32-bit: the serving stack
breaks under x64) runs ``repro``'s :class:`ServeEngine` on a 1×1 mesh for
``reduced(smollm-360m)`` and ``reduced(yi-9b)`` in float32 compute and
writes what it saw: the weights, greedy ``generate`` tokens in the
``host``, ``step`` and ``chunk`` modes (with a chunk remainder), a padded
sub-batch, ``generate_many`` over an arrival trace, every engine's
``stats`` and the link bytes of ``place_params`` under ``direct`` and
``tree`` staging; and the same, but ``generate_many`` (which raises for the
``ssm`` family in both packages), for ``reduced(falcon-mamba-7b)``.  The port replays the same calls on ``device="cpu"``
with the same weights (``convert.model_params_from_numpy``) and is held to
them exactly: tokens and ``stats`` dicts equal.  Float32 compute keeps the
greedy argmax away from ties (the logits agree to ~1e-6).

Temperature sampling is held within the port only: the port draws from a
``torch.Generator``, which cannot reproduce ``jax.random``.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

from torch_counters import reference_counters
from repro_torch import convert
from repro_torch import models as T
from repro_torch.core.policy import Staging
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.launch import serve as t_cli
from repro_torch.models import model as TM
from repro_torch.serve import ServeConfig, ServeEngine

ARCHS = ["smollm-360m", "yi-9b"]
SSM_ARCH = "falcon-mamba-7b"
BATCH, PROMPT, NEW, CHUNK = 4, 8, 12, 5
MAXLEN = PROMPT + NEW + 1
MANY = dict(requests=6, batch=4, max_len=32, seed=3)

_REFERENCE_CODE = '''
import dataclasses, json
import numpy as np
import jax
from repro import models as M
from repro.core.policy import Staging
from repro.data import DataConfig, SyntheticStream
from repro.launch.mesh import make_mesh
from repro.serve import ServeConfig, ServeEngine

mesh = make_mesh((1, 1), ("data", "model"))
out, meta = {{}}, {{}}
for arch in {archs} + [{ssm_arch!r}]:
    cfg = dataclasses.replace(M.reduced(M.get(arch)), compute_dtype="float32")
    params = jax.device_get(M.init_params(jax.random.key(0), cfg))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[f"w_{{arch}}_" + "/".join(p.key for p in path)] = np.asarray(leaf)
    prompts = SyntheticStream(DataConfig(
        vocab_size=cfg.vocab_size, batch_size={batch}, seq_len={prompt},
        seed=0), cfg).batch(0)["tokens"]

    def engine(**kw):
        scfg = ServeConfig(**dict(dict(batch={batch}, max_len={maxlen},
                                       decode_chunk={chunk}), **kw))
        eng = ServeEngine(cfg, params, mesh, scfg)
        eng.place_params(params)
        return eng

    for mode in ("host", "step", "chunk"):
        eng = engine(decode_mode=mode)
        out[f"gen_{{arch}}_{{mode}}"] = eng.generate(prompts, {new})
        meta[f"stats_{{arch}}_{{mode}}"] = eng.stats
    eng = engine(decode_mode="chunk")
    out[f"sub_{{arch}}"] = eng.generate(prompts[:3], {new})
    meta[f"stats_{{arch}}_sub"] = eng.stats
    for staging in (Staging.DIRECT, Staging.TREE):
        meta[f"place_{{arch}}_{{staging.value}}"] = engine(
            staging=staging).stats
    if cfg.family == "ssm":
        continue

    many = {many}
    rng = np.random.default_rng(many["seed"])
    lens = rng.integers(2, 17, size=many["requests"])
    news = rng.integers(3, 10, size=many["requests"])
    reqs = [(rng.integers(0, cfg.vocab_size, (int(s),)).astype(np.int32),
             int(m)) for s, m in zip(lens, news)]
    arrivals = [0, 0, 1, 3, 9, 9]
    for i, (p, m) in enumerate(reqs):
        out[f"req_{{arch}}_{{i}}"] = p
        meta[f"new_{{arch}}_{{i}}"] = m
    meta[f"arrivals_{{arch}}"] = arrivals
    for staging in (Staging.DIRECT, Staging.TREE):
        eng = ServeEngine(cfg, params, mesh, ServeConfig(
            batch=many["batch"], max_len=many["max_len"], staging=staging))
        eng.place_params(params)
        outs = eng.generate_many(reqs, arrival_steps=arrivals)
        for i, o in enumerate(outs):
            out[f"many_{{arch}}_{{staging.value}}_{{i}}"] = o
        meta[f"stats_{{arch}}_many_{{staging.value}}"] = eng.stats
np.savez({path!r}, **out)
with open({meta_path!r}, "w") as f:
    json.dump(meta, f)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("serve_ref")
    path, meta_path = str(d / "ref.npz"), str(d / "meta.json")
    subproc(_REFERENCE_CODE.format(
        archs=ARCHS, ssm_arch=SSM_ARCH, batch=BATCH, prompt=PROMPT, maxlen=MAXLEN, chunk=CHUNK,
        new=NEW, many=MANY, path=path, meta_path=meta_path),
        devices=1, x64=False, timeout=900)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    with open(meta_path) as f:
        return arrays, json.load(f)


def _cfg(arch):
    return dataclasses.replace(T.reduced(T.get(arch)),
                               compute_dtype="float32")


def _host_model(arrays, arch):
    """The reference's weights in a port model on the host."""
    prefix = f"w_{arch}_"
    tree = {}
    for name, arr in arrays.items():
        if name.startswith(prefix):
            node = tree
            *parents, leaf = name[len(prefix):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arr
    cfg = _cfg(arch)
    model = TM.Transformer(cfg, device="meta")
    model.load_state_dict(convert.model_params_from_numpy(tree, cfg),
                          assign=True)
    return model


def _engine(arrays, arch, **kw):
    scfg = ServeConfig(**dict(dict(batch=BATCH, max_len=MAXLEN,
                                   decode_chunk=CHUNK), **kw))
    host = _host_model(arrays, arch)
    eng = ServeEngine(_cfg(arch), host, scfg, device="cpu")
    eng.place_params(host)
    return eng


def _prompts(arch):
    cfg = _cfg(arch)
    return SyntheticStream(DataConfig(vocab_size=cfg.vocab_size,
                                      batch_size=BATCH, seq_len=PROMPT,
                                      seed=0), cfg).batch(0)["tokens"]


@pytest.mark.parametrize("mode", ["host", "step", "chunk"])
@pytest.mark.parametrize("arch", ARCHS + [SSM_ARCH])
def test_generate_matches_reference(reference, arch, mode):
    arrays, meta = reference
    eng = _engine(arrays, arch, decode_mode=mode)
    out = eng.generate(_prompts(arch), NEW)
    assert out.dtype == np.int32 and out.shape == (BATCH, NEW)
    np.testing.assert_array_equal(out, arrays[f"gen_{arch}_{mode}"])
    assert reference_counters(eng.stats) == meta[f"stats_{arch}_{mode}"]


@pytest.mark.parametrize("arch", ARCHS + [SSM_ARCH])
def test_padded_sub_batch_matches_reference(reference, arch):
    arrays, meta = reference
    eng = _engine(arrays, arch, decode_mode="chunk")
    out = eng.generate(_prompts(arch)[:3], NEW)
    np.testing.assert_array_equal(out, arrays[f"sub_{arch}"])
    np.testing.assert_array_equal(out, arrays[f"gen_{arch}_chunk"][:3])
    assert reference_counters(eng.stats) == meta[f"stats_{arch}_sub"]
    assert eng.stats["batch_padded_rows"] == 1


@pytest.mark.parametrize("staging", ["direct", "tree"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_many_matches_reference(reference, arch, staging):
    arrays, meta = reference
    reqs = [(arrays[f"req_{arch}_{i}"], meta[f"new_{arch}_{i}"])
            for i in range(MANY["requests"])]
    host = _host_model(arrays, arch)
    eng = ServeEngine(_cfg(arch), host, ServeConfig(
        batch=MANY["batch"], max_len=MANY["max_len"],
        staging=Staging(staging)), device="cpu")
    eng.place_params(host)
    outs = eng.generate_many(reqs, arrival_steps=meta[f"arrivals_{arch}"])
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, arrays[f"many_{arch}_{staging}_{i}"])
        assert o.shape == (reqs[i][1],)
    assert reference_counters(eng.stats) == meta[f"stats_{arch}_many_{staging}"]


@pytest.mark.parametrize("staging", ["direct", "tree"])
@pytest.mark.parametrize("arch", ARCHS + [SSM_ARCH])
def test_place_params_bytes_match_reference(reference, arch, staging):
    arrays, meta = reference
    eng = _engine(arrays, arch, staging=Staging(staging))
    assert reference_counters(eng.stats) == meta[f"place_{arch}_{staging}"]
    host = _host_model(arrays, arch)
    assert eng.stats["h2d_bytes"] == sum(
        p.numel() * p.element_size() for p in host.parameters())
    for (n, a), (_, b) in zip(host.named_parameters(),
                              eng.params.named_parameters()):
        assert torch.equal(a, b), n


def test_greedy_continuous_equals_static():
    """Greedy outputs are schedule-independent (the reference's property)."""
    cfg = _cfg("smollm-360m")
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    prompts = _prompts("smollm-360m")
    static = ServeEngine(cfg, model, ServeConfig(batch=BATCH, max_len=MAXLEN),
                         device="cpu").generate(prompts, 6)
    eng = ServeEngine(cfg, model, ServeConfig(batch=2, max_len=MAXLEN,
                                              prefill_bucket=4), device="cpu")
    outs = eng.generate_many([(p, 6) for p in prompts],
                             arrival_steps=[0, 2, 2, 5])
    for row, o in zip(static, outs):
        np.testing.assert_array_equal(o, row)
    assert eng.stats["requests_retired"] == BATCH


# -- temperature sampling, within the port ---------------------------------------


def test_temperature_sampling_is_seeded_and_mode_independent():
    cfg = _cfg("yi-9b")
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    prompts = _prompts("yi-9b")

    def run(mode, seed):
        eng = ServeEngine(cfg, model, ServeConfig(
            batch=BATCH, max_len=MAXLEN, temperature=1.5, seed=seed,
            decode_mode=mode, decode_chunk=CHUNK), device="cpu")
        return eng.generate(prompts, NEW)

    step = run("step", 7)
    np.testing.assert_array_equal(step, run("step", 7))
    np.testing.assert_array_equal(step, run("chunk", 7))
    assert not np.array_equal(step, run("step", 8))
    greedy = ServeEngine(cfg, model, ServeConfig(batch=BATCH, max_len=MAXLEN),
                         device="cpu").generate(prompts, NEW)
    assert not np.array_equal(step, greedy)


# -- configuration and errors ---------------------------------------------------


def test_synthetic_stream_is_bit_identical_to_reference():
    from repro.data.pipeline import DataConfig as RDataConfig
    from repro.data.pipeline import SyntheticStream as RStream
    for seed, index, (b, s, v) in [(0, 0, (4, 512, 64000)),
                                   (3, 7, (2, 33, 512))]:
        got = SyntheticStream(DataConfig(vocab_size=v, batch_size=b,
                                         seq_len=s, seed=seed)).batch(index)
        want = RStream(RDataConfig(vocab_size=v, batch_size=b, seq_len=s,
                                   seed=seed)).batch(index)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_engine_defaults_to_the_card():
    cfg = _cfg("smollm-360m")
    model = TM.Transformer(cfg, device="meta")
    if torch.cuda.is_available():     # as tensors report it: cuda:<current>
        assert ServeEngine(cfg, model, ServeConfig()).device == torch.device(
            "cuda", torch.cuda.current_device())
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ServeEngine(cfg, model, ServeConfig())


def test_engine_errors():
    cfg = _cfg("smollm-360m")
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    eng = ServeEngine(cfg, model, ServeConfig(batch=2, max_len=16),
                      device="cpu")
    with pytest.raises(ValueError, match="exceeds configured batch"):
        eng.generate(np.zeros((3, 4), np.int32), 2)
    with pytest.raises(ValueError, match="max_len"):
        eng.generate_many([(np.zeros(10, np.int32), 8)])
    with pytest.raises(ValueError, match="arrival"):
        eng.generate_many([(np.zeros(3, np.int32), 2)], arrival_steps=[0, 1])
    eng.scfg.decode_mode = "scan"
    with pytest.raises(ValueError, match="decode_mode"):
        eng.generate(np.zeros((2, 4), np.int32), 2)
    with pytest.raises(ValueError, match="staging"):
        ServeConfig(staging=Staging.HOST_FANOUT)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(DeprecationWarning):
            ServeConfig(staging="tree")
    on_meta = ServeEngine(cfg, TM.Transformer(cfg, device="meta"),
                          ServeConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="place_params"):
        on_meta.generate(np.zeros((2, 4), np.int32), 2)


def test_serve_cli_on_cpu(capsys):
    t_cli.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "6", "--new-tokens", "4",
                "--decode-mode", "chunk", "--decode-chunk", "2",
                "--staging", "tree"])
    out = capsys.readouterr().out
    assert "[serve] generated 8 tokens on cpu" in out
    assert out.count("slot ") == 2
    t_cli.main(["--arch", "yi-9b", "--reduced", "--device", "cpu",
                "--continuous", "--requests", "3", "--batch", "2",
                "--prompt-len", "6", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "continuous on cpu: 3 requests, 9 tokens" in out


def test_ssm_engine_keeps_a_state_cache_and_refuses_continuous(reference):
    """``generate`` primes the state cache through the scan; continuous
    batching raises for the ssm family, as the reference's does."""
    arrays, _ = reference
    eng = _engine(arrays, SSM_ARCH)
    with pytest.raises(NotImplementedError, match="continuous batching"):
        eng.generate_many([(np.arange(5, dtype=np.int32), 3)])
    assert eng.stats["prefill_inserts"] == 0
    cfg = _cfg(SSM_ARCH)
    _, cache = TM.prefill(eng.params, cfg, {"tokens": torch.as_tensor(
        _prompts(SSM_ARCH))}, MAXLEN)
    assert set(cache) == {"conv", "h", "pos"}
    assert cache["h"].shape == (cfg.n_layers, BATCH, cfg.d_inner,
                                cfg.ssm.d_state)
    assert cache["h"].dtype == torch.float32 and cache["pos"] == PROMPT


def test_serve_cli_serves_falcon_mamba_on_cpu(capsys):
    outs = {}
    for mode in ("step", "chunk", "host"):
        t_cli.main(["--arch", SSM_ARCH, "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "8", "--new-tokens", "6",
                    "--decode-mode", mode, "--decode-chunk", "4"])
        out = capsys.readouterr().out
        assert "[serve] generated 12 tokens on cpu" in out
        outs[mode] = [line.split("->")[1] for line in out.splitlines()
                      if "slot " in line]
    assert outs["step"] == outs["chunk"] == outs["host"]
    with pytest.raises(NotImplementedError, match="continuous batching"):
        t_cli.main(["--arch", SSM_ARCH, "--reduced", "--device", "cpu",
                    "--continuous", "--requests", "2", "--batch", "2",
                    "--prompt-len", "6", "--new-tokens", "3"])


def test_serve_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        from repro_torch.core.offload import resolve_device
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            t_cli.main(["--reduced"])


def test_continuous_trace_draws_as_the_reference_cli():
    import argparse
    from repro.launch.serve import _continuous_trace as r_trace
    args = argparse.Namespace(requests=8, prompt_len=16, new_tokens=32,
                              arrival_rate=0.5, seed=4)
    got = t_cli._continuous_trace(args, T.get("smollm-360m"))
    want = r_trace(args, T.get("smollm-360m"))
    assert [m for _, m in got[0]] == [m for _, m in want[0]]
    for (p, _), (q, _) in zip(got[0], want[0]):
        np.testing.assert_array_equal(p, q)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_place_pytree_routes_replicated_leaves_through_the_tree():
    """The reference's byte accounting: a replicated leaf crosses the host
    link once and fans out to the other n-1 clusters; a sharded leaf
    crosses once, split into one block per cluster."""
    from repro_torch.core import broadcast as bc

    class Stats:
        h2d_bytes = d2d_bytes = 0

    n = 4
    tree = {"w": np.arange(24, dtype=np.float32).reshape(8, 3),
            "inner": {"b": np.ones(5, np.float32)}}
    placements = {"w": bc.Placement(n, 0), "inner": {"b": bc.Placement(n)}}
    stats = Stats()
    out = bc.place_pytree(tree, placements,
                          bc.TreeStager(torch.device("cpu"), range(n)),
                          stats=stats)
    assert stats.h2d_bytes == 24 * 4 + 5 * 4
    assert stats.d2d_bytes == 5 * 4 * (n - 1)
    np.testing.assert_array_equal(out["w"].numpy(),
                                  tree["w"].reshape(n, 2, 3))
    np.testing.assert_array_equal(out["inner"]["b"].numpy(),
                                  np.ones((n, 5), np.float32))
