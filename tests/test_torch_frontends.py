"""The port's modality frontends and the ``stub`` attention against the
reference's, on the CPU.

One subprocess (``run_subprocess``, one device, 32-bit: the serving stack
breaks under x64) runs the reference on inputs it draws from a numpy seed
and writes inputs and outputs, for ``reduced(paligemma-3b)`` (the vision
stub: 8 prefix positions of precomputed patches, a prefix-LM mask, gemma's
embedding scale, GeGLU, tied embeddings, one KV head) and
``reduced(musicgen-large)`` (the audio stub: codec tokens with sinusoidal
positions), each on the weights of ``init_params(key(0))``:

* ``embed_inputs`` with the patches (x, positions, ``prefix_len``);
* ``forward``, ``prefill`` and three ``decode_step`` calls, in float32 and
  bf16 compute;
* ``multihead_attention`` with a prefix under "xla" and "chunked", and
  under "stub" (GQA, float32 and bf16), and ``forward`` with the stub;
* ``ServeEngine.generate`` with ``extra_inputs`` in every decode mode
  (float32 compute, as ``tests/test_torch_serve.py``), and on a sub-batch
  the engine pads.

The port replays the same inputs; the models load the same weights
through ``convert.model_params_from_numpy``.  Bars: the blocks in float32
at rtol = atol = 1e-5, in bf16 at 1e-2 (one bf16 ulp of unit-scale
values); the models in float32 at 1e-4 (``tests/test_models_smoke.py:65``)
and in bf16 as a 5 % relative L2, as ``tests/test_torch_moe.py`` holds
them; tokens and engine ``stats`` exactly.  Beside them, the port alone:
prefill then decode against the full forward (``tests/test_models_smoke.py
:55-76``'s check and bar), the serve CLI for both models, and the one
difference from the reference: its CLI sizes the cache without the
patches, so it cannot serve paligemma-3b; the port's can.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import SRC
from torch_configs import is_reference_data
from torch_counters import reference_counters
from repro_torch import convert
from repro_torch import models as T
from repro_torch.core.fabric import FabricScheduler
from repro_torch.launch import serve as t_cli
from repro_torch.models import attention as t_attn
from repro_torch.models import model as TM
from repro_torch.serve import ServeConfig, ServeEngine, ServeTenant

VISION, AUDIO = "paligemma-3b", "musicgen-large"
ARCHS = [VISION, AUDIO]
DTYPES = ["float32", "bfloat16"]
F32_TOL = dict(rtol=1e-4, atol=1e-4)          # tests/test_models_smoke.py:65
BLOCK_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
             "bfloat16": dict(rtol=1e-2, atol=1e-2)}
BF16_REL_L2 = 5e-2
DECODE_TOL = dict(rtol=1e-3, atol=1e-3)       # tests/test_models_smoke.py:70
B, S, NEW = 2, 11, 3
BATCH, PROMPT, GEN, CHUNK, SUB = 4, 8, 10, 4, 3
ATT = dict(b=2, hq=4, hkv=1, s=12, d=32, prefix=5, chunk=4)
COUNTS = {VISION: 2_508_662_784, AUDIO: 3_229_812_736}

_REFERENCE_CODE = '''
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
from repro import models as M
from repro.data import DataConfig, SyntheticStream
from repro.launch.mesh import make_mesh
from repro.models import attention as attn
from repro.models import model as MM
from repro.serve import ServeConfig, ServeEngine

rng = np.random.default_rng(23)
mesh = make_mesh((1, 1), ("data", "model"))
out, meta = {}, {}

def f32(*shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)

def put(key, a):
    out[key] = np.asarray(jnp.asarray(a).astype(jnp.float32))

for arch in ARCHS:
    cfg32 = dataclasses.replace(M.reduced(M.get(arch)), compute_dtype="float32")
    params = jax.device_get(M.init_params(jax.random.key(0), cfg32))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[f"w_{arch}_" + "/".join(p.key for p in path)] = np.asarray(leaf)
    vision = cfg32.frontend.kind == "vision_stub"
    p = cfg32.frontend.n_prefix_tokens if vision else 0
    meta[f"prefix_{arch}"] = p
    toks = rng.integers(0, cfg32.vocab_size, (B, S)).astype(np.int32)
    nxt = rng.integers(0, cfg32.vocab_size, (NEW, B, 1)).astype(np.int32)
    out[f"toks_{arch}"], out[f"nxt_{arch}"] = toks, nxt
    batch = {"tokens": toks}
    if vision:
        batch["patches"] = out[f"patches_{arch}"] = f32(B, p, cfg32.d_model,
                                                        scale=0.02)
    for cdt in DTYPES:
        cfg = dataclasses.replace(cfg32, compute_dtype=cdt)
        x, positions, prefix_len = MM.embed_inputs(params, cfg, batch)
        put(f"emb_x_{arch}_{cdt}", x)
        out[f"emb_pos_{arch}_{cdt}"] = np.asarray(positions)
        meta[f"emb_prefix_{arch}_{cdt}"] = int(prefix_len)
        logits, _ = M.forward(params, cfg, batch)
        out[f"fwd_{arch}_{cdt}"] = np.asarray(logits, np.float32)
        lp, cache = M.prefill(params, cfg, batch, p + S + NEW)
        out[f"pre_{arch}_{cdt}"] = np.asarray(lp)
        for n in ("k", "v"):
            put(f"pre_{n}_{arch}_{cdt}", cache[n])
        meta[f"pre_pos_{arch}_{cdt}"] = int(cache["pos"])
        for i in range(NEW):
            ld, cache = M.decode_step(params, cfg, cache, jnp.asarray(nxt[i]))
            out[f"dec_{i}_{arch}_{cdt}"] = np.asarray(ld)
        for n in ("k", "v"):
            put(f"post_{n}_{arch}_{cdt}", cache[n])
        meta[f"dec_pos_{arch}_{cdt}"] = int(cache["pos"])
    logits, _ = M.forward(params, cfg32, batch, M.CallConfig(attn_impl="stub"))
    out[f"fwd_stub_{arch}"] = np.asarray(logits, np.float32)

    # -- serving (float32 compute), every mode and a padded sub-batch
    ex = SyntheticStream(DataConfig(
        vocab_size=cfg32.vocab_size, batch_size=BATCH, seq_len=PROMPT,
        seed=0), cfg32).batch(0)
    extra = {k: v for k, v in ex.items() if k == "patches"} or None
    max_len = p + PROMPT + GEN + 1
    meta[f"max_len_{arch}"] = max_len
    for mode in ("host", "step", "chunk"):
        eng = ServeEngine(cfg32, params, mesh, ServeConfig(
            batch=BATCH, max_len=max_len, decode_mode=mode,
            decode_chunk=CHUNK))
        eng.place_params(params)
        out[f"gen_{arch}_{mode}"] = eng.generate(ex["tokens"], GEN, extra)
        meta[f"stats_{arch}_{mode}"] = eng.stats
    eng = ServeEngine(cfg32, params, mesh, ServeConfig(batch=BATCH,
                                                       max_len=max_len))
    eng.place_params(params)
    sub = {k: v[:SUB] for k, v in extra.items()} if extra else None
    out[f"gen_sub_{arch}"] = eng.generate(ex["tokens"][:SUB], GEN, sub)
    meta[f"stats_sub_{arch}"] = eng.stats

# -- attention with a prefix, and the stub (GQA)
a = ATT
q = f32(a["b"], a["hq"], a["s"], a["d"])
k = f32(a["b"], a["hkv"], a["s"], a["d"])
v = f32(a["b"], a["hkv"], a["s"], a["d"])
out.update(att_q=q, att_k=k, att_v=v)
for impl in ("xla", "chunked"):
    put(f"att_{impl}", attn.multihead_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl=impl,
        prefix_len=a["prefix"], chunk=a["chunk"]))
for cdt in DTYPES:
    dt = jnp.dtype(cdt)
    put(f"stub_{cdt}", attn.multihead_attention(
        jnp.asarray(q, dt), jnp.asarray(k, dt), jnp.asarray(v, dt),
        impl="stub"))

np.savez(__PATH__, **out)
with open(__META__, "w") as f:
    json.dump(meta, f)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("frontends_ref")
    path, meta_path = str(d / "ref.npz"), str(d / "meta.json")
    consts = (f"ARCHS, DTYPES = {ARCHS!r}, {DTYPES!r}\n"
              f"B, S, NEW = {B}, {S}, {NEW}\n"
              f"BATCH, PROMPT, GEN, CHUNK, SUB = {BATCH}, {PROMPT}, {GEN}, "
              f"{CHUNK}, {SUB}\n"
              f"ATT = {ATT!r}\n")
    code = _REFERENCE_CODE.replace("__PATH__", repr(path)).replace(
        "__META__", repr(meta_path))
    subproc(consts + code, devices=1, x64=False, timeout=900)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    with open(meta_path) as f:
        return arrays, json.load(f)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(getattr(torch, dtype))


def _close(got, want, tol):
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **tol)


def _close_model(got, want, cdt):
    """A model-level result: elementwise in float32, relative L2 in bf16."""
    if cdt == "float32":
        _close(got, want, F32_TOL)
        return
    assert tuple(got.shape) == tuple(np.shape(want))
    g = got.detach().to(torch.float64).numpy()
    w = np.asarray(want, np.float64)
    assert np.isfinite(g).all()
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    assert rel <= BF16_REL_L2, f"relative L2 {rel:.4g}"


def _cfg(arch, cdt="float32"):
    return dataclasses.replace(T.reduced(T.get(arch)), compute_dtype=cdt)


def _model(r, arch, cdt="float32"):
    prefix = f"w_{arch}_"
    tree = {}
    for name, arr in r.items():
        if name.startswith(prefix):
            node = tree
            *parents, leaf = name[len(prefix):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arr
    cfg = _cfg(arch, cdt)
    model = TM.Transformer(cfg, device="meta")
    model.load_state_dict(convert.model_params_from_numpy(tree, cfg),
                          assign=True)
    return cfg, model


def _batch(r, arch):
    batch = {"tokens": _t(r[f"toks_{arch}"])}
    if f"patches_{arch}" in r:
        batch["patches"] = _t(r[f"patches_{arch}"])
    return batch


def _served(arch, batch=BATCH):
    """The engine's prompts and extra inputs, drawn as the reference
    draws them."""
    from repro_torch.data import DataConfig, SyntheticStream
    cfg = _cfg(arch)
    ex = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size,
                                    batch_size=batch, seq_len=PROMPT,
                                    seed=0), cfg).batch(0)
    return ex["tokens"], ({k: v for k, v in ex.items() if k == "patches"}
                          or None)


# -- the configurations ------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_modules_are_the_references(arch):
    import importlib
    name = arch.replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    ref = importlib.import_module(f"repro.configs.{name}")
    assert mod.NAME == ref.NAME == arch
    assert mod.CONFIG is T.get(arch)
    is_reference_data(mod.CONFIG, ref.CONFIG)
    is_reference_data(mod.REDUCED, ref.REDUCED)
    assert mod.REDUCED == T.reduced(mod.CONFIG)


def test_published_widths_and_counts():
    v, a = T.get(VISION), T.get(AUDIO)
    assert (v.family, v.n_layers, v.d_model, v.n_heads, v.n_kv_heads,
            v.head_dim, v.d_ff, v.vocab_size, v.act, v.embed_scale,
            v.tie_embeddings, v.frontend.kind, v.frontend.n_prefix_tokens) == (
        "vlm", 18, 2048, 8, 1, 256, 16384, 257216, "gelu", True, True,
        "vision_stub", 256)
    assert (a.family, a.n_layers, a.d_model, a.n_heads, a.n_kv_heads,
            a.head_dim, a.d_ff, a.vocab_size, a.pos_embedding,
            a.frontend.kind) == (
        "audio", 48, 2048, 32, 32, 64, 8192, 2048, "sinusoidal", "audio_stub")
    for arch, n in COUNTS.items():
        TM.require_ported(T.get(arch))
        assert T.count_params(T.get(arch)) == n
    assert TM.prefix_tokens(v) == 256 and TM.prefix_tokens(a) == 0


# -- the embedding -----------------------------------------------------------


@pytest.mark.parametrize("cdt", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_embed_inputs_matches_reference(reference, arch, cdt):
    r, meta = reference
    cfg, model = _model(r, arch, cdt)
    batch = _batch(r, arch)
    x, positions, prefix_len = TM.embed_inputs(model, cfg, batch)
    p = meta[f"prefix_{arch}"]
    assert prefix_len == meta[f"emb_prefix_{arch}_{cdt}"] == p
    assert x.dtype == getattr(torch, cdt) and x.shape == (B, p + S,
                                                          cfg.d_model)
    np.testing.assert_array_equal(positions.numpy(),
                                  r[f"emb_pos_{arch}_{cdt}"])
    assert positions.shape == (B, p + S)
    _close(x, r[f"emb_x_{arch}_{cdt}"], BLOCK_TOL[cdt])
    if p:
        # the patches come first, cast and not scaled; the tokens scaled
        torch.testing.assert_close(x[:, :p], batch["patches"].to(x.dtype),
                                   rtol=0, atol=0)
        tok = model.embed[batch["tokens"].long()].to(x.dtype) * torch.tensor(
            cfg.d_model ** 0.5, dtype=x.dtype)
        torch.testing.assert_close(x[:, p:], tok, rtol=0, atol=0)


# -- the models --------------------------------------------------------------


@pytest.mark.parametrize("cdt", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(reference, arch, cdt):
    r, meta = reference
    cfg, model = _model(r, arch, cdt)
    logits, aux = T.forward(model, cfg, _batch(r, arch))
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    assert logits.shape == (B, meta[f"prefix_{arch}"] + S, cfg.vocab_size)
    _close_model(logits, r[f"fwd_{arch}_{cdt}"], cdt)


@pytest.mark.parametrize("cdt", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(reference, arch, cdt):
    r, meta = reference
    cfg, model = _model(r, arch, cdt)
    p = meta[f"prefix_{arch}"]
    logits, cache = T.prefill(model, cfg, _batch(r, arch), p + S + NEW)
    _close_model(logits, r[f"pre_{arch}_{cdt}"], cdt)
    for n in ("k", "v"):
        _close_model(cache[n], r[f"pre_{n}_{arch}_{cdt}"], cdt)
    assert cache["pos"] == meta[f"pre_pos_{arch}_{cdt}"] == p + S
    for i in range(NEW):
        logits, cache = T.decode_step(model, cfg, cache,
                                      _t(r[f"nxt_{arch}"][i]))
        _close_model(logits, r[f"dec_{i}_{arch}_{cdt}"], cdt)
    for n in ("k", "v"):
        _close_model(cache[n], r[f"post_{n}_{arch}_{cdt}"], cdt)
    assert cache["pos"] == meta[f"dec_pos_{arch}_{cdt}"] == p + S + NEW


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_the_prefix_agrees_with_forward_in_port(arch):
    """The port alone, as tests/test_models_smoke.py:55-76 checks the
    reference: a prefill of P + S positions, one decode step, and the
    forward over P + S + 1 positions; the cache's ``pos`` is P + S + 1."""
    cfg = _cfg(arch)
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=g,
                         dtype=torch.int32)
    p = TM.prefix_tokens(cfg)
    batch = {"tokens": toks[:, :16]}
    if p:
        batch["patches"] = torch.randn((2, p, cfg.d_model), generator=g) * 0.02
    full, _ = T.forward(model, cfg, batch)
    pre, cache = T.prefill(model, cfg, batch, p + 32)
    torch.testing.assert_close(pre[:, -1], full[:, -1], **F32_TOL)
    dec, cache = T.decode_step(model, cfg, cache, toks[:, 16:])
    full2, _ = T.forward(model, cfg, dict(batch, tokens=toks))
    torch.testing.assert_close(dec[:, 0], full2[:, -1], **DECODE_TOL)
    assert int(cache["pos"]) == 16 + p + 1


# -- attention: the prefix mask and the stub -----------------------------------


@pytest.mark.parametrize("impl", ["plain", "chunked"])
def test_prefix_attention_matches_reference(reference, impl):
    r, _ = reference
    q, k, v = (_t(r[f"att_{n}"]) for n in "qkv")
    got = t_attn.multihead_attention(q, k, v, impl=impl,
                                     prefix_len=ATT["prefix"],
                                     chunk=ATT["chunk"])
    _close(got, r["att_xla" if impl == "plain" else "att_chunked"],
           BLOCK_TOL["float32"])
    # the two orders of the same sums, and not the causal result
    other = t_attn.multihead_attention(
        q, k, v, impl="chunked" if impl == "plain" else "plain",
        prefix_len=ATT["prefix"], chunk=ATT["chunk"])
    _close(got, other.numpy(), BLOCK_TOL["float32"])
    causal = t_attn.multihead_attention(q, k, v, impl=impl)
    assert (got[:, :, :ATT["prefix"]] - causal[:, :, :ATT["prefix"]]
            ).abs().max() > 1e-3


@pytest.mark.parametrize("cdt", DTYPES)
def test_stub_matches_reference(reference, cdt):
    r, _ = reference
    q, k, v = (_t(r[f"att_{n}"], cdt) for n in "qkv")
    assert t_attn.resolve_impl("stub", q) == "stub"
    got = t_attn.multihead_attention(q, k, v, impl="stub")
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, r[f"stub_{cdt}"], BLOCK_TOL[cdt])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_the_stub_matches_reference(reference, arch):
    r, _ = reference
    cfg, model = _model(r, arch)
    logits, _ = T.forward(model, cfg, _batch(r, arch),
                          T.CallConfig(attn_impl="stub"))
    _close(logits, r[f"fwd_stub_{arch}"], F32_TOL)


# -- serving -----------------------------------------------------------------


@pytest.mark.parametrize("mode", ["host", "step", "chunk"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(reference, arch, mode):
    r, meta = reference
    cfg, host = _model(r, arch)
    eng = ServeEngine(cfg, host, ServeConfig(
        batch=BATCH, max_len=meta[f"max_len_{arch}"], decode_mode=mode,
        decode_chunk=CHUNK), device="cpu")
    eng.place_params(host)
    prompts, extra = _served(arch)
    out = eng.generate(prompts, GEN, extra)
    assert out.dtype == np.int32 and out.shape == (BATCH, GEN)
    np.testing.assert_array_equal(out, r[f"gen_{arch}_{mode}"])
    assert reference_counters(eng.stats) == meta[f"stats_{arch}_{mode}"]


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_pads_a_sub_batch(reference, arch):
    """A sub-batch (its patches too) is padded by repeating its last row:
    the real rows' tokens are the full batch's and the reference's."""
    r, meta = reference
    cfg, host = _model(r, arch)
    eng = ServeEngine(cfg, host, ServeConfig(
        batch=BATCH, max_len=meta[f"max_len_{arch}"]), device="cpu")
    eng.place_params(host)
    prompts, extra = _served(arch)
    sub = {k: v[:SUB] for k, v in extra.items()} if extra else None
    out = eng.generate(prompts[:SUB], GEN, sub)
    assert out.shape == (SUB, GEN)
    np.testing.assert_array_equal(out, r[f"gen_sub_{arch}"])
    np.testing.assert_array_equal(out, r[f"gen_{arch}_step"][:SUB])
    assert reference_counters(eng.stats) == meta[f"stats_sub_{arch}"]
    assert eng.stats["batch_padded_rows"] == BATCH - SUB


def test_serve_tenant_generates_with_patches(reference):
    r, meta = reference
    cfg, host = _model(r, VISION)
    tenant = ServeTenant(FabricScheduler("cpu", num_clusters=4), cfg, host,
                         ServeConfig(batch=BATCH,
                                     max_len=meta[f"max_len_{VISION}"]),
                         floor=1, burst=2)
    prompts, extra = _served(VISION)
    out = tenant.generate(prompts, GEN, extra)
    np.testing.assert_array_equal(out, r[f"gen_{VISION}_step"])
    assert tenant.peak_burst == 2 and tenant.lease.n == 1
    tenant.close()


def test_generate_refuses_a_prefill_past_max_len():
    """The cache must hold the patches and the prompt: a prefill of P + S
    positions past ``max_len`` raises naming both lengths, before any
    work; P + S itself fits."""
    cfg = _cfg(VISION)
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    prompts, extra = _served(VISION, batch=2)
    p = TM.prefix_tokens(cfg)
    eng = ServeEngine(cfg, model, ServeConfig(batch=2, max_len=PROMPT + 4),
                      device="cpu")
    with pytest.raises(ValueError, match=f"prefill of {p + PROMPT} positions"
                       rf" \({p} prefix \+ {PROMPT} prompt tokens\) exceeds "
                       rf"the engine's max_len {PROMPT + 4}"):
        eng.generate(prompts, 4, extra)
    eng = ServeEngine(cfg, model, ServeConfig(batch=2, max_len=p + PROMPT
                                              + 2), device="cpu")
    assert eng.generate(prompts, 2, extra).shape == (2, 2)
    with pytest.raises(KeyError, match="patches"):
        eng.generate(prompts, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batching_refuses_the_frontends(arch):
    cfg = _cfg(arch)
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    eng = ServeEngine(cfg, model, ServeConfig(batch=2, max_len=32),
                      device="cpu")
    with pytest.raises(NotImplementedError, match="frontends"):
        eng.generate_many([(np.arange(5, dtype=np.int32), 3)])
    cache = T.init_cache(cfg, 2, 32)
    with pytest.raises(NotImplementedError, match="frontends"):
        T.decode_step_ragged(model, cfg, cache,
                             torch.zeros((2, 1), dtype=torch.int32),
                             torch.tensor([3, 3], dtype=torch.int32))


# -- the serve CLIs --------------------------------------------------------------


def _cli_tokens(capsys, arch):
    outs = {}
    for mode in ("step", "chunk", "host"):
        t_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "8", "--new-tokens", "4",
                    "--decode-mode", mode, "--decode-chunk", "2"])
        out = capsys.readouterr().out
        assert "[serve] generated 8 tokens on cpu" in out
        outs[mode] = [line.split("->")[1] for line in out.splitlines()
                      if "slot " in line]
    assert outs["step"] == outs["chunk"] == outs["host"]
    return outs["step"]


def test_serve_cli_serves_musicgen(capsys):
    """The reference's CLI test (tests/test_launch_cli.py:36-41), on the
    port's CLI in every decode mode; continuous batching raises."""
    _cli_tokens(capsys, AUDIO)
    with pytest.raises(NotImplementedError, match="continuous batching"):
        t_cli.main(["--arch", AUDIO, "--reduced", "--device", "cpu",
                    "--continuous", "--requests", "2"])


def test_serve_cli_serves_paligemma_where_the_reference_raises(capsys):
    """The reference's CLI sizes its cache as prompt + new + 1 and leaves
    the 8 patch positions out, so its prefill does not fit; the port's
    holds them (8 + 8 + 4 + 1), in every mode and as a fabric tenant."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    args = ["--arch", VISION, "--reduced", "--batch", "2", "--prompt-len",
            "8", "--new-tokens", "4"]
    proc = subprocess.run(
        [sys.executable, "-m", "repro.launch.serve", *args, "--mesh", "1x1"],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode != 0
    assert "dynamic_update_slice update shape must be smaller" in proc.stderr
    step = _cli_tokens(capsys, VISION)
    t_cli.main(args + ["--device", "cpu", "--fabric"])
    out = capsys.readouterr().out
    assert "fabric tenant (batch 2): 8 tokens" in out
    assert [line.split("->")[1] for line in out.splitlines()
            if "slot " in line] == step
