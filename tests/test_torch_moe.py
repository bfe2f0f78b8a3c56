"""The port's MoE family and MLA attention against the reference's, on the
CPU.

One subprocess (``run_subprocess``, one device, 32-bit: the serving stack
breaks under x64) runs the reference on inputs it draws from a numpy seed
and writes inputs and outputs, for ``reduced(deepseek-v2-lite-16b)`` (MLA,
4 experts top-2, one shared expert) and ``reduced(llama4-scout-17b-a16e)``
(GQA with 4/2 heads of 32, 4 experts top-1, one shared), each on the
weights of ``init_params(key(0))``:

* ``moe_block`` on layer 0's weights: routing without drops, and with
  drops where the router is pushed onto expert 0 (14 tokens for 8 slots:
  every token's feature 0 is 3.0 and the router's weight from it to
  expert 0 is raised by 10);
  the router's top-k indices; exact ties in the router's probabilities
  (``jax.lax.top_k`` on crafted rows, and ``moe_block`` with a zero router
  and with two zero router columns);
* the four MLA functions (``mla_attention`` under "xla" and "chunked");
* ``forward`` (its aux loss too), ``prefill``, ``decode_step`` and, for
  llama4, ``decode_step_ragged``, in float32 and bf16 compute;
* ``ServeEngine.generate`` in every decode mode (float32 compute, as
  ``tests/test_torch_serve.py``), and llama4's ``generate_many``;
* at full width, the parameter tree (``jax.eval_shape``) and
  ``count_params``, total and active.

The port replays the same inputs; the models load the same weights
through ``convert.model_params_from_numpy``.  Bars: the blocks in float32
at rtol = atol = 1e-5 (expert indices exactly, so drops and tie order are
the reference's), in bf16 at 5e-2; the models in float32 at 1e-4
(``tests/test_models_smoke.py:65``) and in bf16 as a 5 % relative L2, as
``tests/test_torch_hybrid.py`` holds them; tokens and engine ``stats``
exactly.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import dataclasses
import json

import numpy as np
import pytest
import torch

from torch_counters import reference_counters
from repro.models import moe as r_moe
from repro_torch import convert
from repro_torch import models as T
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.launch import serve as t_cli
from repro_torch.models import attention as t_attn
from repro_torch.models import model as TM
from repro_torch.models import moe as t_moe
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve.engine import DecodeState

DEEPSEEK, LLAMA4 = "deepseek-v2-lite-16b", "llama4-scout-17b-a16e"
ARCHS = [DEEPSEEK, LLAMA4]
DTYPES = ["float32", "bfloat16"]
F32_TOL = dict(rtol=1e-4, atol=1e-4)          # tests/test_models_smoke.py:65
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
B, S, NEW = 2, 11, 3
BATCH, PROMPT, GEN, CHUNK = 4, 8, 10, 4
MAXLEN = PROMPT + GEN + 1
MANY = dict(requests=5, batch=3, max_len=32, seed=3)
COUNTS = {DEEPSEEK: (16_210_324_992, 2_663_247_360),
          LLAMA4: (107_769_861_120, 17_172_894_720)}

_REFERENCE_CODE = '''
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
from repro import models as M
from repro.data import DataConfig, SyntheticStream
from repro.launch.mesh import make_mesh
from repro.models import attention as attn
from repro.models import moe
from repro.serve import ServeConfig, ServeEngine

rng = np.random.default_rng(21)
mesh = make_mesh((1, 1), ("data", "model"))
out, meta = {}, {}

def f32(*shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)

def put(key, a):
    out[key] = np.asarray(jnp.asarray(a).astype(jnp.float32))

def top_k_idx(x, p, cfg):
    logits = x.reshape(-1, x.shape[-1]) @ np.asarray(p["router"], np.float32)
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    return np.asarray(jax.lax.top_k(probs, cfg.moe.top_k)[1])

# -- exact ties: jax.lax.top_k's order on crafted rows
probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                  [0.4, 0.1, 0.4, 0.1], [0.2, 0.3, 0.2, 0.3],
                  [0.0, 0.5, 0.0, 0.5]], np.float32)
out["tie_probs"] = probs
for k in (1, 2, 3):
    v, i = jax.lax.top_k(jnp.asarray(probs), k)
    out[f"tie_vals_{k}"] = np.asarray(v)
    out[f"tie_idx_{k}"] = np.asarray(i)

for arch in ARCHS:
    cfg32 = dataclasses.replace(M.reduced(M.get(arch)), compute_dtype="float32")
    params = jax.device_get(M.init_params(jax.random.key(0), cfg32))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[f"w_{arch}_" + "/".join(p.key for p in path)] = np.asarray(leaf)
    p = jax.tree.map(lambda a: np.asarray(a[0]), params["layers"]["moe"])
    d = cfg32.d_model

    # -- moe_block: without drops, with drops (router pushed onto expert 0),
    # -- and on exact router ties
    forced = np.array(p["router"])
    forced[0, 0] += 10.0          # feature 0 is 3.0 in every token below
    zero = np.zeros_like(p["router"])
    half = np.array(p["router"])
    half[:, 1] = 0.0
    half[:, 3] = 0.0
    cases = {"nodrop": (p["router"], True), "drop": (forced, False),
             "dropoff": (forced, True), "tie": (zero, False),
             "halftie": (half, True)}
    for cdt in DTYPES:
        dt = jnp.dtype(cdt)
        cfg = dataclasses.replace(cfg32, compute_dtype=cdt)
        x = f32(2, 7, d)
        x[:, :, :4] += 2.0 * np.sign(x[:, :, :4])   # a clear preference
        x[:, :, 0] = 3.0
        out[f"moe_x_{arch}_{cdt}"] = x
        for name, (router, no_drop) in cases.items():
            pp = dict(p, router=router)
            out[f"moe_router_{arch}_{name}"] = np.asarray(router)
            y, aux = moe.moe_block(jnp.asarray(x, dt), pp, cfg,
                                   no_drop=no_drop)
            put(f"moe_y_{arch}_{name}_{cdt}", y)
            meta[f"moe_aux_{arch}_{name}_{cdt}"] = float(aux)
            if cdt == "float32":
                out[f"moe_idx_{arch}_{name}"] = top_k_idx(x, pp, cfg)

    # -- the reduced model
    toks = rng.integers(0, cfg32.vocab_size, (B, S)).astype(np.int32)
    nxt = rng.integers(0, cfg32.vocab_size, (NEW, B, 1)).astype(np.int32)
    out[f"toks_{arch}"], out[f"nxt_{arch}"] = toks, nxt
    names = ("c", "krope") if cfg32.mla else ("k", "v")
    for cdt in DTYPES:
        cfg = dataclasses.replace(cfg32, compute_dtype=cdt)
        logits, aux = M.forward(params, cfg, {"tokens": toks})
        out[f"fwd_{arch}_{cdt}"] = np.asarray(logits, np.float32)
        meta[f"fwd_aux_{arch}_{cdt}"] = float(aux)
        nd, _ = M.forward(params, cfg, {"tokens": toks},
                          M.CallConfig(moe_no_drop=True))
        out[f"fwd_nodrop_{arch}_{cdt}"] = np.asarray(nd, np.float32)
        lp, cache = M.prefill(params, cfg, {"tokens": toks}, S + NEW)
        out[f"pre_{arch}_{cdt}"] = np.asarray(lp)
        for n in names:
            put(f"pre_{n}_{arch}_{cdt}", cache[n])
        meta[f"pre_pos_{arch}_{cdt}"] = int(cache["pos"])
        if cfg.mla is None:
            pos_b = jnp.asarray([S, S - 3], jnp.int32)
            lr, rc = M.decode_step_ragged(params, cfg, dict(cache),
                                          jnp.asarray(nxt[0]), pos_b)
            out[f"rag_{arch}_{cdt}"] = np.asarray(lr)
            for n in names:
                put(f"rag_{n}_{arch}_{cdt}", rc[n])
            meta[f"rag_pos_{arch}_{cdt}"] = int(rc["pos"])
        for i in range(NEW):
            ld, cache = M.decode_step(params, cfg, cache, jnp.asarray(nxt[i]))
            out[f"dec_{i}_{arch}_{cdt}"] = np.asarray(ld)
        for n in names:
            put(f"post_{n}_{arch}_{cdt}", cache[n])
        meta[f"dec_pos_{arch}_{cdt}"] = int(cache["pos"])

    # -- serving (float32 compute)
    prompts = SyntheticStream(DataConfig(
        vocab_size=cfg32.vocab_size, batch_size=BATCH, seq_len=PROMPT,
        seed=0), cfg32).batch(0)["tokens"]
    for mode in ("host", "step", "chunk"):
        eng = ServeEngine(cfg32, params, mesh, ServeConfig(
            batch=BATCH, max_len=MAXLEN, decode_mode=mode,
            decode_chunk=CHUNK))
        eng.place_params(params)
        out[f"gen_{arch}_{mode}"] = eng.generate(prompts, GEN)
        meta[f"stats_{arch}_{mode}"] = eng.stats
    if cfg32.mla is None:
        r2 = np.random.default_rng(MANY["seed"])
        lens = r2.integers(2, 13, size=MANY["requests"])
        news = r2.integers(3, 9, size=MANY["requests"])
        reqs = [(r2.integers(0, cfg32.vocab_size, (int(s),)).astype(np.int32),
                 int(m)) for s, m in zip(lens, news)]
        arrivals = [0, 0, 1, 2, 6]
        for i, (pr, m) in enumerate(reqs):
            out[f"req_{arch}_{i}"] = pr
            meta[f"new_{arch}_{i}"] = m
        meta[f"arrivals_{arch}"] = arrivals
        eng = ServeEngine(cfg32, params, mesh, ServeConfig(
            batch=MANY["batch"], max_len=MANY["max_len"]))
        eng.place_params(params)
        for i, o in enumerate(eng.generate_many(reqs, arrival_steps=arrivals)):
            out[f"many_{arch}_{i}"] = o
        meta[f"stats_{arch}_many"] = eng.stats

    # -- at full width: the tree and the counts
    cfg = M.get(arch)
    key = jax.eval_shape(lambda: jax.random.key(0))
    shapes = jax.eval_shape(lambda k: M.init_params(k, cfg),
                            jax.ShapeDtypeStruct(key.shape, key.dtype))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    meta[f"tree_{arch}"] = {"/".join(p.key for p in path):
                            [list(leaf.shape), str(leaf.dtype)]
                            for path, leaf in flat}
    meta[f"count_{arch}"] = int(M.count_params(cfg))
    meta[f"active_{arch}"] = int(M.count_params(cfg, active_only=True))

# -- MLA: the four functions on deepseek's layer 0
cfg32 = dataclasses.replace(M.reduced(M.get(ARCHS[0])), compute_dtype="float32")
w = {k[len("w_" + ARCHS[0] + "_layers/attn/"):]: v[0] for k, v in out.items()
     if k.startswith("w_" + ARCHS[0] + "_layers/attn/")}
m = cfg32.mla
for cdt in DTYPES:
    dt = jnp.dtype(cdt)
    cfg = dataclasses.replace(cfg32, compute_dtype=cdt)
    x = f32(2, 9, cfg.d_model)
    out[f"mla_x_{cdt}"] = x
    xj = jnp.asarray(x, dt)
    pos = jnp.broadcast_to(jnp.arange(9, dtype=jnp.int32), (2, 9))
    qn, qr = attn.mla_project_q(xj, w, cfg, pos)
    put(f"mla_qn_{cdt}", qn)
    put(f"mla_qr_{cdt}", qr)
    c, kr = attn.mla_compress_kv(xj, w, cfg, pos)
    put(f"mla_c_{cdt}", c)
    put(f"mla_kr_{cdt}", kr)
    for impl in ("xla", "chunked"):
        y = attn.mla_attention(xj, w, cfg, pos, impl=impl, chunk=4)
        put(f"mla_att_{impl}_{cdt}", y)
    y = attn.mla_attention(xj, w, cfg, pos, c=c, k_rope=kr)
    put(f"mla_att_pre_{cdt}", y)
    cc, rc = f32(2, 12, m.kv_lora_rank), f32(2, 12, m.qk_rope_head_dim)
    xd = f32(2, 1, cfg.d_model)
    out.update({f"mlad_x_{cdt}": xd, f"mlad_c_{cdt}": cc, f"mlad_r_{cdt}": rc})
    o, c2, r2 = attn.mla_decode(jnp.asarray(xd, dt), w, cfg,
                                jnp.asarray(cc, dt), jnp.asarray(rc, dt), 5)
    put(f"mlad_o_{cdt}", o)
    put(f"mlad_c2_{cdt}", c2)
    put(f"mlad_r2_{cdt}", r2)

np.savez(__PATH__, **out)
with open(__META__, "w") as f:
    json.dump(meta, f)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("moe_ref")
    path, meta_path = str(d / "ref.npz"), str(d / "meta.json")
    consts = (f"ARCHS, DTYPES = {ARCHS!r}, {DTYPES!r}\n"
              f"B, S, NEW = {B}, {S}, {NEW}\n"
              f"BATCH, PROMPT, GEN, CHUNK, MAXLEN = {BATCH}, {PROMPT}, "
              f"{GEN}, {CHUNK}, {MAXLEN}\n"
              f"MANY = {MANY!r}\n")
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


def _block_tol(cdt):
    return BLOCK_TOL if cdt == "float32" else BF16_TOL


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
    assert rel <= BF16_TOL["rtol"], f"relative L2 {rel:.4g}"


def _cfg(arch, cdt="float32"):
    return dataclasses.replace(T.reduced(T.get(arch)), compute_dtype=cdt)


def _tree(r, arch):
    prefix = f"w_{arch}_"
    tree = {}
    for name, arr in r.items():
        if name.startswith(prefix):
            node = tree
            *parents, leaf = name[len(prefix):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arr
    return tree


def _model(r, arch, cdt="float32"):
    cfg = _cfg(arch, cdt)
    model = TM.Transformer(cfg, device="meta")
    model.load_state_dict(convert.model_params_from_numpy(_tree(r, arch), cfg),
                          assign=True)
    return cfg, model


def _moe_params(r, arch, case):
    _, model = _model(r, arch)
    p = model.layer_params(0)["moe"]
    p["router"] = _t(r[f"moe_router_{arch}_{case}"])
    return p


# -- capacity and routing ----------------------------------------------------


@pytest.mark.parametrize("no_drop", [False, True])
def test_capacity_matches_reference(no_drop):
    """Every path of ``capacity``: C = tokens without drops; with drops the
    floor of 8, the rounding up to 8, and the plain case."""
    assert t_moe.CAPACITY_FACTOR == r_moe.CAPACITY_FACTOR
    for tokens in (1, 4, 7, 14, 64, 100, 2048, 4096):
        for e, k in ((4, 1), (4, 2), (16, 1), (64, 6)):
            assert t_moe.capacity(tokens, e, k, no_drop) == r_moe.capacity(
                tokens, e, k, no_drop), (tokens, e, k)
    if no_drop:
        assert t_moe.capacity(2048, 64, 6, True) == 2048
    else:
        assert t_moe.capacity(4, 64, 6) == 8           # the floor
        assert t_moe.capacity(100, 4, 2) == 64         # 62 rounded up
        assert t_moe.capacity(2048, 64, 6) == 240


@pytest.mark.parametrize("k", [1, 2, 3])
def test_route_breaks_ties_as_jax_top_k(reference, k):
    r, _ = reference
    vals, idx = t_moe.route(_t(r["tie_probs"]), k)
    np.testing.assert_array_equal(idx.numpy(), r[f"tie_idx_{k}"])
    np.testing.assert_array_equal(vals.numpy(), r[f"tie_vals_{k}"])


@pytest.mark.parametrize("case", ["nodrop", "drop", "dropoff", "tie",
                                  "halftie"])
@pytest.mark.parametrize("arch", ARCHS)
def test_router_indices_match_reference(reference, arch, case):
    r, _ = reference
    p = _moe_params(r, arch, case)
    cfg = _cfg(arch)
    x = _t(r[f"moe_x_{arch}_float32"]).reshape(-1, cfg.d_model)
    probs = torch.softmax(x @ p["router"], dim=-1)
    _, idx = t_moe.route(probs, cfg.moe.top_k)
    np.testing.assert_array_equal(idx.numpy(), r[f"moe_idx_{arch}_{case}"])
    if case == "drop":
        # every token's first choice is expert 0, past its 8 slots
        c = t_moe.capacity(x.shape[0], cfg.moe.n_experts, cfg.moe.top_k)
        assert bool((idx[:, 0] == 0).all()) and x.shape[0] > c == 8


@pytest.mark.parametrize("cdt", DTYPES)
@pytest.mark.parametrize("case", ["nodrop", "drop", "dropoff", "tie",
                                  "halftie"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(reference, arch, case, cdt):
    r, meta = reference
    cfg = _cfg(arch, cdt)
    no_drop = case in ("nodrop", "dropoff", "halftie")
    x = _t(r[f"moe_x_{arch}_{cdt}"], cdt)
    y, aux = t_moe.moe_block(x, _moe_params(r, arch, case), cfg,
                             no_drop=no_drop)
    assert y.dtype == x.dtype and aux.dtype == torch.float32
    _close(y, r[f"moe_y_{arch}_{case}_{cdt}"], _block_tol(cdt))
    np.testing.assert_allclose(float(aux), meta[f"moe_aux_{arch}_{case}_{cdt}"],
                               **_block_tol(cdt))


def test_drops_change_the_output(reference):
    """The forced router with drops is not the same block without them:
    the dropped entries' combine weight is zero."""
    r, _ = reference
    for arch in ARCHS:
        a = r[f"moe_y_{arch}_drop_float32"]
        b = r[f"moe_y_{arch}_dropoff_float32"]
        assert np.abs(a - b).max() > 1e-3


def test_moe_block_reads_nothing_on_the_host():
    """On meta tensors (no values: ``.item()``, ``nonzero`` and boolean
    masks raise) the block and the MoE decode steps run to the end, so a
    CUDA graph captures them."""
    t = torch.empty(3, device="meta")
    with pytest.raises(RuntimeError):
        t.sum().item()
    with pytest.raises(NotImplementedError):
        t[torch.empty(3, dtype=torch.bool, device="meta")]
    for arch in ARCHS:
        cfg = T.reduced(T.get(arch))
        model = T.init_params(cfg, device="meta")
        x = torch.empty((2, 5, cfg.d_model), device="meta",
                        dtype=torch.bfloat16)
        for no_drop in (False, True):
            y, aux = t_moe.moe_block(x, model.layer_params(0)["moe"], cfg,
                                     no_drop=no_drop)
            assert y.shape == x.shape and aux.shape == ()
        cache = T.init_cache(cfg, 2, 12, device="meta")
        tok = torch.zeros((2, 1), dtype=torch.int32, device="meta")
        logits, _ = T.decode_step(model, cfg, cache, tok)
        assert logits.shape == (2, 1, cfg.vocab_size)
        if cfg.mla is None:
            pos_b = torch.zeros((2,), dtype=torch.int32, device="meta")
            logits, _ = T.decode_step_ragged(model, cfg, cache, tok, pos_b)
            assert logits.shape == (2, 1, cfg.vocab_size)


# -- MLA ---------------------------------------------------------------------


def _mla(r, cdt):
    cfg, model = _model(r, DEEPSEEK, cdt)
    return cfg, model.layer_params(0)["attn"]


@pytest.mark.parametrize("cdt", DTYPES)
def test_mla_projections_match_reference(reference, cdt):
    r, _ = reference
    cfg, p = _mla(r, cdt)
    x = _t(r[f"mla_x_{cdt}"], cdt)
    pos = torch.arange(9, dtype=torch.int32).expand(2, 9)
    qn, qr = t_attn.mla_project_q(x, p, cfg, pos)
    m = cfg.mla
    assert qn.shape == (2, cfg.n_heads, 9, m.qk_nope_head_dim)
    assert qr.shape == (2, cfg.n_heads, 9, m.qk_rope_head_dim)
    _close(qn, r[f"mla_qn_{cdt}"], _block_tol(cdt))
    _close(qr, r[f"mla_qr_{cdt}"], _block_tol(cdt))
    c, kr = t_attn.mla_compress_kv(x, p, cfg, pos)
    assert kr.shape == (2, 1, 9, m.qk_rope_head_dim)
    _close(c, r[f"mla_c_{cdt}"], _block_tol(cdt))
    _close(kr, r[f"mla_kr_{cdt}"], _block_tol(cdt))


@pytest.mark.parametrize("cdt", DTYPES)
@pytest.mark.parametrize("impl", ["plain", "chunked"])
def test_mla_attention_matches_reference(reference, impl, cdt):
    r, _ = reference
    cfg, p = _mla(r, cdt)
    x = _t(r[f"mla_x_{cdt}"], cdt)
    pos = torch.arange(9, dtype=torch.int32).expand(2, 9)
    y = t_attn.mla_attention(x, p, cfg, pos, impl=impl, chunk=4)
    assert y.dtype == x.dtype
    want = "xla" if impl == "plain" else impl
    _close(y, r[f"mla_att_{want}_{cdt}"], _block_tol(cdt))
    # c and k_rope precomputed, as prefill passes them
    c, kr = t_attn.mla_compress_kv(x, p, cfg, pos)
    pre = t_attn.mla_attention(x, p, cfg, pos, impl=impl, c=c, k_rope=kr,
                               chunk=4)
    _close(pre, r[f"mla_att_pre_{cdt}"], _block_tol(cdt))


@pytest.mark.parametrize("cdt", DTYPES)
def test_mla_decode_matches_reference(reference, cdt):
    r, _ = reference
    cfg, p = _mla(r, cdt)
    cc, rc = _t(r[f"mlad_c_{cdt}"], cdt), _t(r[f"mlad_r_{cdt}"], cdt)
    pos = torch.tensor(5, dtype=torch.int32)
    o, c2, r2 = t_attn.mla_decode(_t(r[f"mlad_x_{cdt}"], cdt), p, cfg, cc,
                                  rc, pos)
    assert c2 is cc and r2 is rc                 # written in place
    _close(o, r[f"mlad_o_{cdt}"], _block_tol(cdt))
    _close(c2, r[f"mlad_c2_{cdt}"], _block_tol(cdt))
    _close(r2, r[f"mlad_r2_{cdt}"], _block_tol(cdt))


def test_auto_refuses_the_kernel_for_mla_shapes():
    """A flash call has one head dim and no prefix mask; MLA's q/k of
    nope + rope with v of v_head_dim is not such a call, at the reduced
    and at the published widths."""
    def qkv(d, dv, hq=4, hkv=4):
        return (torch.empty(1, hq, 8, d, device="meta"),
                torch.empty(1, hkv, 8, d, device="meta"),
                torch.empty(1, hkv, 8, dv, device="meta"))

    assert t_attn.kernel_takes(*qkv(32, 32, hkv=2))     # reduced llama4
    assert t_attn.kernel_takes(*qkv(128, 128, hq=32, hkv=4))
    for arch in (DEEPSEEK, T.reduced(T.get(DEEPSEEK))):
        m = (T.get(arch) if isinstance(arch, str) else arch).mla
        assert not t_attn.kernel_takes(*qkv(
            m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim))
    assert not t_attn.kernel_takes(*qkv(32, 32), prefix_len=4)
    # off the card "auto" is plain whatever the shapes
    q, k, v = (torch.zeros(1, 4, 8, 32) for _ in range(3))
    assert t_attn.resolve_impl("auto", q, k, v) == "plain"


@pytest.mark.parametrize("d", [96, 256])
def test_auto_keeps_the_kernel_for_a_head_dim_it_is_not_built_for(d):
    """One head dim outside HEAD_DIMS is still a flash call (the
    reference's kernel runs it): "auto" resolves it to the kernel, whose
    wrapper raises, and does not go plain without a word."""
    assert d not in HEAD_DIMS
    for hkv in (4, 2):
        q = torch.empty(1, 4, 8, d, device="meta")
        kv = torch.empty(1, hkv, 8, d, device="meta")
        assert t_attn.kernel_takes(q, kv, kv)


@pytest.mark.cuda
def test_auto_refuses_the_kernel_for_mla_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: 'auto' picks the kernel only "
                    "for CUDA tensors")
    dev = torch.device("cuda")
    q = torch.zeros(1, 16, 8, 192, device=dev, dtype=torch.bfloat16)
    v = torch.zeros(1, 16, 8, 128, device=dev, dtype=torch.bfloat16)
    assert t_attn.resolve_impl("auto", q, q, v) == "plain"
    g = torch.zeros(1, 4, 8, 32, device=dev, dtype=torch.bfloat16)
    assert t_attn.resolve_impl("auto", g, g[:, :2], g[:, :2]) == "kernel"
    assert t_attn.resolve_impl("auto", g, g, g, prefix_len=2) == "plain"
    h = torch.zeros(1, 4, 8, 96, device=dev, dtype=torch.bfloat16)
    assert t_attn.resolve_impl("auto", h, h, h) == "kernel"
    with pytest.raises(ValueError, match="head dim 96"):
        t_attn.multihead_attention(h, h, h)


# -- the model ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_tree_and_count_match_reference(reference, arch):
    """At full width: every leaf of the reference's tree at its shape and
    dtype (the router float32), split per layer; the counts, total and
    active, are the reference's."""
    _, meta = reference
    cfg = T.get(arch)
    got = {n: [list(p.shape), str(p.dtype).replace("torch.", "")]
           for n, p in TM.Transformer(cfg, device="meta").state_dict().items()}
    want = {}
    for path, (shape, dtype) in meta[f"tree_{arch}"].items():
        top, *rest = path.split("/")
        if top == "layers":
            assert shape[0] == cfg.n_layers
            for i in range(cfg.n_layers):
                want[".".join(["layers", str(i)] + rest)] = [shape[1:], dtype]
        else:
            want[path.replace("/", ".")] = [shape, dtype]
    assert got == want
    total, active = COUNTS[arch]
    assert T.count_params(cfg) == meta[f"count_{arch}"] == total
    assert T.count_params(cfg, active_only=True) == meta[
        f"active_{arch}"] == active
    assert cfg.param_count() == total


def test_deepseek_at_published_width():
    from repro_torch.configs import deepseek_v2_lite_16b as ds
    cfg = ds.CONFIG
    assert cfg is T.get(DEEPSEEK) and ds.NAME == DEEPSEEK
    assert ds.REDUCED == T.reduced(cfg)
    m, e = cfg.mla, cfg.moe
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab_size,
            e.n_experts, e.top_k, e.n_shared, e.d_ff_expert, m.kv_lora_rank,
            m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim) == (
        27, 2048, 16, 102400, 64, 6, 2, 1408, 512, 128, 64, 128)
    model = T.init_params(cfg, device="meta")
    assert model.layers[0].moe.experts.wi.shape == (64, 2048, 1408)
    assert model.layers[0].moe.shared.wi.shape == (2048, 2 * 1408)
    # the MLA cache of a 4 x (512 + 32 + 1) engine: 27 x 4 x 545 x 576 bf16
    cache = T.init_cache(cfg, 4, 545, device="meta")
    assert sorted(cache) == ["c", "krope", "pos"]
    assert (cache["c"].numel() + cache["krope"].numel()) * 2 == 67_806_720


def test_llama4_config_module():
    from repro_torch.configs import llama4_scout_17b_a16e as l4
    assert l4.CONFIG is T.get(LLAMA4) and l4.NAME == LLAMA4
    assert l4.REDUCED == T.reduced(l4.CONFIG)
    assert (l4.REDUCED.n_layers, l4.REDUCED.d_model, l4.REDUCED.head_dim,
            l4.REDUCED.moe.n_experts, l4.REDUCED.moe.top_k) == (2, 128, 32,
                                                                4, 1)


def test_init_params_sets_the_reference_constants():
    cfg = dataclasses.replace(_cfg(DEEPSEEK), param_dtype="bfloat16")
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    layer = model.layers[1]
    assert layer.moe.router.dtype == torch.float32     # whatever param_dtype
    assert layer.moe.experts.wi.dtype == torch.bfloat16
    assert torch.all(layer.attn.kv_norm == 1.0)
    assert torch.all(layer.ln1 == 1.0) and torch.all(layer.ln2 == 1.0)
    d, fe = cfg.d_model, cfg.moe.d_ff_expert
    # drawn on the fan-in axis: d for wi and the router, fe for wo
    assert float(layer.moe.experts.wi.abs().max()) <= 2.0 * d ** -0.5
    assert float(layer.moe.experts.wo.abs().max()) > 2.0 * d ** -0.5
    assert float(layer.moe.experts.wo.abs().max()) <= 2.0 * fe ** -0.5 + 1e-3
    assert float(layer.moe.router.abs().max()) <= 2.0 * d ** -0.5


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_carries_every_moe_and_mla_leaf(reference, arch):
    r, _ = reference
    cfg = _cfg(arch)
    tree = _tree(r, arch)
    sd = convert.model_params_from_numpy(tree, cfg)
    assert sorted(sd) == sorted(TM.Transformer(cfg, device="meta")
                                .state_dict())
    np.testing.assert_array_equal(sd["layers.1.moe.experts.wo"].numpy(),
                                  tree["layers"]["moe"]["experts"]["wo"][1])
    np.testing.assert_array_equal(sd["layers.0.moe.shared.wg"].numpy(),
                                  tree["layers"]["moe"]["shared"]["wg"][0])
    assert sd["layers.0.moe.router"].dtype == torch.float32
    if cfg.mla:
        np.testing.assert_array_equal(sd["layers.1.attn.wuk"].numpy(),
                                      tree["layers"]["attn"]["wuk"][1])
    stray = dict(tree, layers=dict(tree["layers"], moe=dict(
        tree["layers"]["moe"], gate=tree["layers"]["moe"]["router"])))
    with pytest.raises(ValueError, match="unknown parameter"):
        convert.model_params_from_numpy(stray, cfg)
    short = dict(tree, layers=dict(tree["layers"], moe={
        k: v for k, v in tree["layers"]["moe"].items() if k != "shared"}))
    with pytest.raises(ValueError, match="missing parameters"):
        convert.model_params_from_numpy(short, cfg)


@pytest.mark.parametrize("cdt", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(reference, arch, cdt):
    r, meta = reference
    cfg, model = _model(r, arch, cdt)
    toks = _t(r[f"toks_{arch}"])
    logits, aux = T.forward(model, cfg, {"tokens": toks})
    assert logits.dtype == torch.float32 and aux.dtype == torch.float32
    _close_model(logits, r[f"fwd_{arch}_{cdt}"], cdt)
    np.testing.assert_allclose(float(aux), meta[f"fwd_aux_{arch}_{cdt}"],
                               **(F32_TOL if cdt == "float32" else BF16_TOL))
    nd, _ = T.forward(model, cfg, {"tokens": toks},
                      T.CallConfig(moe_no_drop=True))
    _close_model(nd, r[f"fwd_nodrop_{arch}_{cdt}"], cdt)


@pytest.mark.parametrize("cdt", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(reference, arch, cdt):
    r, meta = reference
    cfg, model = _model(r, arch, cdt)
    names = ("c", "krope") if cfg.mla else ("k", "v")
    logits, cache = T.prefill(model, cfg, {"tokens": _t(r[f"toks_{arch}"])},
                              S + NEW)
    _close_model(logits, r[f"pre_{arch}_{cdt}"], cdt)
    assert sorted(cache) == sorted(names + ("pos",))
    for n in names:
        _close_model(cache[n], r[f"pre_{n}_{arch}_{cdt}"], cdt)
    assert cache["pos"] == meta[f"pre_pos_{arch}_{cdt}"] == S
    for i in range(NEW):
        logits, cache = T.decode_step(model, cfg, cache,
                                      _t(r[f"nxt_{arch}"][i]))
        _close_model(logits, r[f"dec_{i}_{arch}_{cdt}"], cdt)
    for n in names:
        _close_model(cache[n], r[f"post_{n}_{arch}_{cdt}"], cdt)
    assert cache["pos"] == meta[f"dec_pos_{arch}_{cdt}"] == S + NEW


@pytest.mark.parametrize("cdt", DTYPES)
def test_llama4_ragged_step_matches_reference(reference, cdt):
    r, meta = reference
    cfg, model = _model(r, LLAMA4, cdt)
    _, cache = T.prefill(model, cfg, {"tokens": _t(r[f"toks_{LLAMA4}"])},
                         S + NEW)
    pos_b = torch.tensor([S, S - 3], dtype=torch.int32)
    logits, cache = T.decode_step_ragged(model, cfg, cache,
                                         _t(r[f"nxt_{LLAMA4}"][0]), pos_b)
    _close_model(logits, r[f"rag_{LLAMA4}_{cdt}"], cdt)
    for n in ("k", "v"):
        _close_model(cache[n], r[f"rag_{n}_{LLAMA4}_{cdt}"], cdt)
    assert cache["pos"] == meta[f"rag_pos_{LLAMA4}_{cdt}"] == S + 1


def test_mla_decode_agrees_with_forward_in_port():
    """The port alone, as tests/test_models_smoke.py checks the reference:
    decode steps after a prefill against the full-sequence logits (f32,
    routing without drops in both)."""
    cfg = _cfg(DEEPSEEK)
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (2, 14),
                         generator=torch.Generator().manual_seed(2))
    call = T.CallConfig(moe_no_drop=True)
    full, _ = T.forward(model, cfg, {"tokens": toks}, call)
    pre, cache = T.prefill(model, cfg, {"tokens": toks[:, :10]}, 14, call)
    torch.testing.assert_close(pre[:, -1], full[:, 9], rtol=1e-4, atol=1e-4)
    for t in range(10, 14):
        dec, cache = T.decode_step(model, cfg, cache, toks[:, t:t + 1])
        torch.testing.assert_close(dec[:, 0], full[:, t], rtol=1e-4,
                                   atol=1e-4)


def test_mla_limits_and_require_ported():
    cfg = _cfg(DEEPSEEK)
    TM.require_ported(T.get(DEEPSEEK))
    TM.require_ported(T.get(LLAMA4))
    for c in (dataclasses.replace(T.get("zamba2-2.7b"), mla=cfg.mla),
              dataclasses.replace(T.get("falcon-mamba-7b"), moe=cfg.moe)):
        with pytest.raises(NotImplementedError,
                           match="the reference never combines"):
            TM.require_ported(c)
    # a frontend on a state-space family is a mix the port does not build
    with pytest.raises(NotImplementedError,
                       match="the reference never combines"):
        TM.require_ported(dataclasses.replace(
            T.get("falcon-mamba-7b"), frontend=T.get("paligemma-3b").frontend))
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(7))
    toks = torch.zeros((2, 9), dtype=torch.int32)
    _, cache = T.prefill(model, cfg, {"tokens": toks}, 12)
    with pytest.raises(NotImplementedError, match="ragged"):
        T.decode_step_ragged(model, cfg, cache, toks[:, :1],
                             torch.tensor([9, 9], dtype=torch.int32))
    eng = ServeEngine(cfg, model, ServeConfig(batch=2, max_len=12),
                      device="cpu")
    with pytest.raises(NotImplementedError, match="continuous batching"):
        eng.generate_many([(np.arange(5, dtype=np.int32), 3)])
    state = DecodeState(cfg, 2, 12, torch.device("cpu"))
    assert state.cache["c"].shape == (cfg.n_layers, 2, 12,
                                      cfg.mla.kv_lora_rank)
    assert state.cache["krope"].shape == (cfg.n_layers, 2, 12,
                                          cfg.mla.qk_rope_head_dim)


# -- serving -----------------------------------------------------------------


def _prompts(arch):
    from repro_torch.data import DataConfig, SyntheticStream
    cfg = _cfg(arch)
    return SyntheticStream(DataConfig(vocab_size=cfg.vocab_size,
                                      batch_size=BATCH, seq_len=PROMPT,
                                      seed=0), cfg).batch(0)["tokens"]


@pytest.mark.parametrize("mode", ["host", "step", "chunk"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(reference, arch, mode):
    r, meta = reference
    cfg, host = _model(r, arch)
    eng = ServeEngine(cfg, host, ServeConfig(
        batch=BATCH, max_len=MAXLEN, decode_mode=mode, decode_chunk=CHUNK),
        device="cpu")
    assert eng.call.moe_no_drop
    eng.place_params(host)
    out = eng.generate(_prompts(arch), GEN)
    assert out.dtype == np.int32 and out.shape == (BATCH, GEN)
    np.testing.assert_array_equal(out, r[f"gen_{arch}_{mode}"])
    assert reference_counters(eng.stats) == meta[f"stats_{arch}_{mode}"]


def test_llama4_generate_many_matches_reference(reference):
    r, meta = reference
    reqs = [(r[f"req_{LLAMA4}_{i}"], meta[f"new_{LLAMA4}_{i}"])
            for i in range(MANY["requests"])]
    cfg, host = _model(r, LLAMA4)
    eng = ServeEngine(cfg, host, ServeConfig(batch=MANY["batch"],
                                             max_len=MANY["max_len"]),
                      device="cpu")
    eng.place_params(host)
    outs = eng.generate_many(reqs, arrival_steps=meta[f"arrivals_{LLAMA4}"])
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, r[f"many_{LLAMA4}_{i}"])
    assert reference_counters(eng.stats) == meta[f"stats_{LLAMA4}_many"]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_serves_the_moe_family_on_cpu(capsys, arch):
    outs = {}
    for mode in ("step", "chunk", "host"):
        t_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "8", "--new-tokens", "6",
                    "--decode-mode", mode, "--decode-chunk", "4"])
        out = capsys.readouterr().out
        assert "[serve] generated 12 tokens on cpu" in out
        outs[mode] = [line.split("->")[1] for line in out.splitlines()
                      if "slot " in line]
    assert outs["step"] == outs["chunk"] == outs["host"]
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--continuous",
            "--requests", "3", "--batch", "2", "--prompt-len", "6",
            "--new-tokens", "3"]
    if arch == DEEPSEEK:
        with pytest.raises(NotImplementedError, match="continuous batching"):
            t_cli.main(argv)
    else:
        t_cli.main(argv)
        assert "continuous on cpu: 3 requests, 9 tokens" in \
            capsys.readouterr().out


# -- the published DeepSeek-V2-Lite's parts (port only) -------------------------


def _published_small(norm_topk=False, first_dense=1):
    """reduced(deepseek) with a dense first layer, unnormalised top-k and
    DeepSeek-V2-Lite's YaRN, in float32."""
    from repro_torch.models.config import RopeScaling
    cfg = T.reduced(T.get(DEEPSEEK))
    return dataclasses.replace(
        cfg, n_layers=3, compute_dtype="float32",
        moe=dataclasses.replace(cfg.moe, first_dense=first_dense,
                                norm_topk=norm_topk),
        rope_scaling=RopeScaling(factor=40, original_max_position_embeddings=
                                 4096, beta_fast=32, beta_slow=1,
                                 mscale=0.707, mscale_all_dim=0.707))


def _block_inputs(cfg, dtype, t=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    m, d = cfg.moe, cfg.d_model

    def rn(*shape, fan):
        return torch.randn(*shape, generator=g) * fan ** -0.5
    p = {"router": rn(d, m.n_experts, fan=d),
         "experts": {"wi": rn(m.n_experts, d, m.d_ff_expert, fan=d),
                     "wg": rn(m.n_experts, d, m.d_ff_expert, fan=d),
                     "wo": rn(m.n_experts, m.d_ff_expert, d,
                              fan=m.d_ff_expert)},
         "shared": {"wi": rn(d, m.d_ff_expert, fan=d),
                    "wg": rn(d, m.d_ff_expert, fan=d),
                    "wo": rn(m.d_ff_expert, d, fan=m.d_ff_expert)}}
    x = torch.randn(2, t // 2, d, generator=g).to(dtype)
    return x, p


def _buffer_block(x, p, cfg):
    """Today's drop-less dispatch: the (E, T, D) buffer of
    ``capacity(no_drop=True)``, every expert over every token's slot."""
    m = cfg.moe
    xf = x.reshape(-1, x.shape[-1])
    t = xf.shape[0]
    vals, idx = t_moe.route(torch.softmax(
        xf.float() @ p["router"].float(), dim=-1), m.top_k)
    if m.norm_topk:
        vals = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
    return t_moe._capacity_block(
        x, xf, p, cfg, idx.T.reshape(-1), vals.T.reshape(-1),
        t_moe.capacity(t, m.n_experts, m.top_k, no_drop=True))


@pytest.mark.parametrize("cdt", DTYPES)
@pytest.mark.parametrize("norm_topk", [True, False])
def test_grouped_experts_equal_the_buffer(cdt, norm_topk):
    """The grouped drop-less dispatch against the (E·T, D) buffer it
    replaces: float32 within 1e-6 relative (other sums' orders), bf16
    within one bf16 rounding of the result (2^-8 of each value, 2^-8 of
    the output's largest for values near zero)."""
    cfg = _published_small(norm_topk)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=8, top_k=3))
    x, p = _block_inputs(cfg, getattr(torch, cdt))
    got, _ = t_moe.moe_block(x, p, cfg, no_drop=True)
    want = _buffer_block(x, p, cfg)
    assert got.dtype == want.dtype == x.dtype
    if cdt == "float32":
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    else:
        gap = (got.float() - want.float()).abs()
        room = 2.0 ** -8 * (want.float().abs() + want.float().abs().max())
        assert bool((gap <= room).all()), float((gap - room).max())


def test_norm_topk_false_keeps_the_softmax_weights():
    """Without renormalising, a token's routed part is its top-k softmax
    probabilities times its experts' outputs (DeepSeek-V2)."""
    cfg = _published_small(norm_topk=False)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           n_shared=0))
    x, p = _block_inputs(cfg, torch.float32, t=4)
    y, _ = t_moe.moe_block(x, p, cfg, no_drop=True)
    xf = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xf @ p["router"], dim=-1)
    vals, idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    ex = p["experts"]
    want = torch.stack([sum(
        vals[i, j] * (torch.nn.functional.silu(xf[i] @ ex["wg"][e])
                      * (xf[i] @ ex["wi"][e])) @ ex["wo"][e]
        for j, e in enumerate(idx[i].tolist())) for i in range(xf.shape[0])])
    torch.testing.assert_close(y.reshape(-1, cfg.d_model), want,
                               rtol=1e-5, atol=1e-5)
    assert float(vals.sum(-1).max()) < 0.999     # so the flag matters


def test_grouped_experts_keep_fixed_shapes_on_meta():
    """The grouped path on meta tensors (no values, so no host read and no
    shape that depends on the routing): its rows are T·k, whatever the
    routing, as a captured decode step needs."""
    cfg = _published_small()
    m = cfg.moe
    xf = torch.empty((10, cfg.d_model), device="meta", dtype=torch.bfloat16)
    e_flat = torch.empty((10 * m.top_k,), device="meta", dtype=torch.long)
    ex = {n: torch.empty(s, device="meta") for n, s in (
        ("wi", (m.n_experts, cfg.d_model, m.d_ff_expert)),
        ("wg", (m.n_experts, cfg.d_model, m.d_ff_expert)),
        ("wo", (m.n_experts, m.d_ff_expert, cfg.d_model)))}
    y = t_moe.grouped_experts(xf, e_flat, ex, cfg)
    assert y.shape == (10 * m.top_k, cfg.d_model) and y.dtype == xf.dtype


def test_grouped_experts_only_for_bf16_on_the_card():
    """On the card ``torch._grouped_mm`` reads its offsets on the device for
    bf16 alone; every other dtype there keeps the buffer.  Off the card
    every dtype is grouped."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert t_moe.takes_grouped(cuda, torch.bfloat16)
    for dt in (torch.float32, torch.float16):
        assert not t_moe.takes_grouped(cuda, dt)
    for dev in (cpu, torch.device("meta")):
        for dt in (torch.float32, torch.bfloat16):
            assert t_moe.takes_grouped(dev, dt)


@pytest.mark.parametrize("cdt", DTYPES)
def test_drop_less_block_without_grouping_is_the_buffer(monkeypatch, cdt):
    """Where :func:`takes_grouped` says no (f32 on the card), the drop-less
    block is the (E·T, D) buffer, bit for bit."""
    cfg = _published_small()
    x, p = _block_inputs(cfg, getattr(torch, cdt))
    monkeypatch.setattr(t_moe, "takes_grouped", lambda device, dtype: False)
    got, _ = t_moe.moe_block(x, p, cfg, no_drop=True)
    assert torch.equal(got, _buffer_block(x, p, cfg))



def test_yarn_constants_of_the_port():
    """DeepSeek-V2-Lite's YaRN: the ramp between rotary dims 10 and 23 of
    32, m(40, 0.707)² = 1.58963 on MLA's softmax, cos and sin unscaled."""
    from repro_torch.models import layers as L
    rs = _published_small().rope_scaling
    assert L.yarn_range(rs, 64, 10000.0) == (10, 23)
    assert abs(L.yarn_mscale(40, 0.707) ** 2 - 1.58963) < 1e-5
    assert L.yarn_attn_factor(rs) == 1.0
    i = torch.arange(32, dtype=torch.float32)
    extra = 1.0 / 10000.0 ** (2 * i / 64)
    ramp = ((i - 10) / 13).clamp(0, 1)
    want = extra / 40 * ramp + extra * (1 - ramp)
    torch.testing.assert_close(L.yarn_freqs(64, 10000.0, rs), want,
                               rtol=1e-6, atol=0)
    full = dataclasses.replace(T.get(DEEPSEEK), rope_scaling=rs)
    assert abs(t_attn.mla_scale(full) * 192 ** 0.5 - 1.58963) < 1e-5
    assert t_attn.mla_scale(T.get(DEEPSEEK)) is None
    # without YaRN the rotation is the plain one, bit for bit
    x = torch.randn(2, 3, 5, 64)
    pos = torch.arange(5)[None].expand(2, 5)[:, None]
    freqs = L.rope_freqs(64, 10000.0)
    ang = pos[..., None].float() * freqs
    x1, x2 = x.chunk(2, -1)
    plain = torch.cat([x1 * ang.cos() - x2 * ang.sin(),
                       x2 * ang.cos() + x1 * ang.sin()], -1)
    assert torch.equal(L.apply_rope(x, pos, 10000.0), plain)
    assert not torch.allclose(L.apply_rope(x, pos, 10000.0, rs), plain)


def test_first_dense_layers_and_their_forward():
    """Layers before ``first_dense`` hold a gated MLP of ``d_ff`` under
    ``layers.<i>.mlp``, the rest ``layers.<i>.moe``; the model runs."""
    cfg = _published_small()
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    names = dict(model.named_parameters())
    assert names["layers.0.mlp.wi"].shape == (cfg.d_model, cfg.d_ff)
    assert not any(n.startswith("layers.0.moe.") for n in names)
    assert names["layers.1.moe.experts.wi"].shape[0] == cfg.moe.n_experts
    assert not any(n.startswith("layers.1.mlp.") for n in names)
    assert TM.moe_layer(cfg, 1) and not TM.moe_layer(cfg, 0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 6))
    logits, aux = TM.forward(model, cfg, {"tokens": tokens})
    assert logits.shape == (2, 6, cfg.vocab_size)
    assert torch.isfinite(logits).all() and float(aux) > 0


def test_config_coerces_nested_mappings():
    """A configuration file's nested parts, plain mappings, become their
    dataclasses; a key the part lacks raises."""
    from repro_torch.models.config import (
        MLAConfig, ModelConfig, MoEConfig, RopeScaling,
    )
    want = _published_small()
    d = dataclasses.asdict(want)
    got = ModelConfig(**d)
    assert isinstance(got.moe, MoEConfig) and isinstance(got.mla, MLAConfig)
    assert isinstance(got.rope_scaling, RopeScaling) and got == want
    with pytest.raises(ValueError, match="unknown keys"):
        ModelConfig(**{**d, "moe": {**d["moe"], "n_routed": 3}})
    with pytest.raises(ValueError, match="yarn"):
        ModelConfig(**{**d, "rope_scaling": {**d["rope_scaling"],
                                             "type": "linear"}})


def test_stacked_layer_paths_refuse_first_dense(monkeypatch):
    """The reference's stacked tree, its specs and the dry-run have no
    layout for dense layers before MoE ones: they raise, naming the
    field."""
    from repro_torch.dist.sharding import LogicalMesh, param_specs
    from repro_torch.launch import dryrun
    cfg = _published_small()
    with pytest.raises(ValueError, match="first_dense"):
        convert.reference_shapes(cfg)
    model = T.init_params(cfg, device="meta")
    with pytest.raises(ValueError, match="first_dense"):
        convert.model_params_to_numpy(model, cfg)
    with pytest.raises(ValueError, match="first_dense"):
        convert.model_params_from_numpy({}, cfg)
    tree = {"layers": {"mlp": {}, "moe": {}}}
    with pytest.raises(ValueError, match="first_dense"):
        param_specs(tree, LogicalMesh(("data", "model"), (1, 2)))
    monkeypatch.setattr(dryrun, "get", lambda arch: cfg)
    with pytest.raises(ValueError, match="first_dense"):
        dryrun.run_cell(DEEPSEEK, "decode_32k", False)
