"""The port's hybrid family (Mamba-2 SSD + Zamba2's shared attention block)
against the reference's, on the CPU.

One subprocess (``run_subprocess``, one device, 32-bit) runs the reference
on inputs it draws from a numpy seed and writes inputs and outputs:
``mamba2_block`` (with ``return_state``; S = 37 with chunk 16, so S is not
a multiple of the chunk, S = 16 and the short S = 2), ``mamba2_decode`` and
the shared block (``_shared_attn_block``) in float32 and bf16, on the
reduced model's weights with its per-head constants redrawn; for
``reduced(zamba2-2.7b)`` (4 layers, period 2, 4/2 shared heads of 32, N 8,
P 16) the weights of ``init_params(key(0))`` with ``forward``, ``prefill``
and ``decode_step`` on them in both compute dtypes; and at full width the
parameter tree (``jax.eval_shape``) and ``count_params``.  The port
replays the same inputs; the model loads the same weights through
``convert.model_params_from_numpy``.

Bars: float32 at 1e-4 elementwise (the reference's own,
``tests/test_models_smoke.py:65``); bf16 at 5e-2: elementwise for the
blocks, and as a relative L2 distance for the model's logits and caches,
the bar ``chip_smoke.py`` holds the serving phases' bf16 prefill logits
to.  Both packages round activations to bf16 after every product, in
different places of their fused kernels, and four layers with two shared
blocks carry that on: each package's own bf16 logits lie 1.8 % (relative
L2) from its float32 ones, up to 0.08 apart on logits of up to 3.7, and
the two packages' bf16 logits 1.5 % from each other.  The reference scans
each chunk with an associative scan, the port sequentially, so the two
differ by f32 rounding.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch import models as T
from repro_torch.kernels import build as t_build
from repro_torch.launch import serve as t_cli
from repro_torch.models import attention as t_attn
from repro_torch.models import model as TM
from repro_torch.models import ssm as t_ssm
from repro_torch.serve import ServeConfig, ServeEngine

ARCH = "zamba2-2.7b"
F32_TOL = dict(rtol=1e-4, atol=1e-4)          # tests/test_models_smoke.py:65
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)         # tests/test_kernels.py:139
DTYPES = ["float32", "bfloat16"]
BLOCK_S = [37, 16, 2]                         # 37 = 2 chunks of 16 and a short one
B, S, NEW = 2, 21, 3
N_PARAMS = 2_422_670_240

_REFERENCE_CODE = '''
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
from repro import models as M
from repro.models import model as MM
from repro.models import ssm

rng = np.random.default_rng(17)
out, meta = {}, {}

def f32(*shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)

cfg32 = dataclasses.replace(M.reduced(M.get(ARCH)), compute_dtype="float32")
params = jax.device_get(M.init_params(jax.random.key(0), cfg32))
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["w_" + "/".join(p.key for p in path)] = np.asarray(leaf)

# -- the blocks, on layer 0's mixer with its per-head constants redrawn
p = {k: np.array(v[0]) for k, v in params["layers"]["mixer"].items()}
H = p["A_log"].shape[0]
p["dt_bias"] = rng.uniform(-5.0, -1.0, H).astype(np.float32)
p["A_log"] = rng.uniform(-1.0, 1.0, H).astype(np.float32)
p["D"] = rng.uniform(0.5, 1.5, H).astype(np.float32)
p["norm"] = (1.0 + 0.1 * rng.standard_normal(p["norm"].shape)).astype(np.float32)
for k, v in p.items():
    out["mix_" + k] = v
dm, din, K = cfg32.d_model, cfg32.d_inner, cfg32.ssm.d_conv
N, P = cfg32.ssm.d_state, cfg32.ssm.headdim
for cdt in DTYPES:
    dt = jnp.dtype(cdt)
    cfg = dataclasses.replace(cfg32, compute_dtype=cdt)
    for s in BLOCK_S:
        x = f32(2, s, dm)
        out[f"blk_x_{cdt}_{s}"] = x
        y, (tail, hl) = ssm.mamba2_block(jnp.asarray(x, dt), p, cfg,
                                         return_state=True)
        out[f"blk_y_{cdt}_{s}"] = np.asarray(y.astype(jnp.float32))
        out[f"blk_tail_{cdt}_{s}"] = np.asarray(tail.astype(jnp.float32))
        out[f"blk_h_{cdt}_{s}"] = np.asarray(hl)
    x, st = f32(2, 1, dm), f32(2, K - 1, din + 2 * N)
    h = f32(2, H, P, N)
    out.update({f"dec_x_{cdt}": x, f"dec_s_{cdt}": st, f"dec_h_{cdt}": h})
    y, st2, h2 = ssm.mamba2_decode(jnp.asarray(x, dt), p, cfg,
                                   jnp.asarray(st, dt), jnp.asarray(h))
    out[f"dec_y_{cdt}"] = np.asarray(y.astype(jnp.float32))
    out[f"dec_s2_{cdt}"] = np.asarray(st2.astype(jnp.float32))
    out[f"dec_h2_{cdt}"] = np.asarray(h2)
    x = f32(2, 19, dm)
    out[f"sb_x_{cdt}"] = x
    pos = jnp.broadcast_to(jnp.arange(19, dtype=jnp.int32), (2, 19))
    y = MM._shared_attn_block(jnp.asarray(x, dt), params, cfg, pos,
                              M.CallConfig())
    out[f"sb_y_{cdt}"] = np.asarray(y.astype(jnp.float32))

# -- the reduced model: forward / prefill / decode
toks = rng.integers(0, cfg32.vocab_size, (B, S)).astype(np.int32)
nxt = rng.integers(0, cfg32.vocab_size, (NEW, B, 1)).astype(np.int32)
out.update(toks=toks, nxt=nxt)
for cdt in DTYPES:
    cfg = dataclasses.replace(cfg32, compute_dtype=cdt)
    logits, _ = M.forward(params, cfg, {"tokens": toks})
    out[f"fwd_{cdt}"] = np.asarray(logits, np.float32)
    once, _ = M.forward(params, cfg, {"tokens": toks},
                        M.CallConfig(cast_params_once=True))
    out[f"fwd_once_{cdt}"] = np.asarray(once, np.float32)
    lp, cache = M.prefill(params, cfg, {"tokens": toks}, S + NEW)
    out[f"pre_{cdt}"] = np.asarray(lp)
    for name in ("conv", "h", "k", "v"):
        out[f"pre_{name}_{cdt}"] = np.asarray(
            cache[name].astype(jnp.float32))
    meta[f"pre_pos_{cdt}"] = int(cache["pos"])
    for i in range(NEW):
        ld, cache = M.decode_step(params, cfg, cache, jnp.asarray(nxt[i]))
        out[f"dec_{i}_{cdt}"] = np.asarray(ld)
    for name in ("conv", "h", "k", "v"):
        out[f"post_{name}_{cdt}"] = np.asarray(
            cache[name].astype(jnp.float32))
    meta[f"dec_pos_{cdt}"] = int(cache["pos"])

# -- the full-width tree and counts
cfg = M.get(ARCH)
key = jax.eval_shape(lambda: jax.random.key(0))
shapes = jax.eval_shape(lambda k: M.init_params(k, cfg),
                        jax.ShapeDtypeStruct(key.shape, key.dtype))
flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
meta["tree"] = {"/".join(p.key for p in path): list(leaf.shape)
                for path, leaf in flat}
meta["count"] = int(M.count_params(cfg))
meta["active"] = int(M.count_params(cfg, active_only=True))
np.savez(__PATH__, **out)
with open(__META__, "w") as f:
    json.dump(meta, f)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("hybrid_ref")
    path, meta_path = str(d / "ref.npz"), str(d / "meta.json")
    consts = (f"ARCH, DTYPES, BLOCK_S = {ARCH!r}, {DTYPES!r}, {BLOCK_S!r}\n"
              f"B, S, NEW = {B}, {S}, {NEW}\n")
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


def _tol(cdt):
    return F32_TOL if cdt == "float32" else BF16_TOL


def _close_model(got, want, cdt):
    """A model-level result: elementwise in float32, relative L2 in bf16
    (module docstring)."""
    if cdt == "float32":
        _close(got, want, F32_TOL)
        return
    assert tuple(got.shape) == tuple(np.shape(want))
    g = got.detach().to(torch.float64).numpy()
    w = np.asarray(want, np.float64)
    assert np.isfinite(g).all()
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    assert rel <= BF16_TOL["rtol"], f"relative L2 {rel:.4g}"


def _cfg(cdt="float32"):
    return dataclasses.replace(T.reduced(T.get(ARCH)), compute_dtype=cdt)


def _mixer(r):
    return {k[len("mix_"):]: _t(v) for k, v in r.items()
            if k.startswith("mix_")}


def _tree(r):
    tree = {}
    for name, arr in r.items():
        if name.startswith("w_"):
            node = tree
            *parents, leaf = name[2:].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arr
    return tree


def _model(r, cdt="float32"):
    cfg = _cfg(cdt)
    model = TM.Transformer(cfg, device="meta")
    model.load_state_dict(convert.model_params_from_numpy(_tree(r), cfg),
                          assign=True)
    return cfg, model


# -- the Mamba-2 block ---------------------------------------------------------------


@pytest.mark.parametrize("s", BLOCK_S)
@pytest.mark.parametrize("cdt", DTYPES)
def test_mamba2_block_matches_reference(reference, cdt, s):
    r, _ = reference
    cfg, p = _cfg(cdt), _mixer(r)
    x = _t(r[f"blk_x_{cdt}_{s}"], cdt)
    y, (tail, h) = t_ssm.mamba2_block(x, p, cfg, return_state=True)
    assert y.dtype == x.dtype and tail.dtype == x.dtype
    assert h.dtype == torch.float32
    _close(y, r[f"blk_y_{cdt}_{s}"], _tol(cdt))
    # the reference keeps a tail of min(S, K-1) rows; the port pads it
    # with zeros in front to K-1 (test_short_prompt_conv_tail_is_zero_padded)
    want_tail = r[f"blk_tail_{cdt}_{s}"]
    _close(tail[:, tail.shape[1] - want_tail.shape[1]:], want_tail,
           _tol(cdt))
    _close(h, r[f"blk_h_{cdt}_{s}"], _tol(cdt))
    plain = t_ssm.mamba2_block(x, p, cfg, impl="plain")
    torch.testing.assert_close(plain, y, rtol=0, atol=0)


@pytest.mark.parametrize("cdt", DTYPES)
def test_mamba2_decode_matches_reference(reference, cdt):
    r, _ = reference
    y, st, h = t_ssm.mamba2_decode(
        _t(r[f"dec_x_{cdt}"], cdt), _mixer(r), _cfg(cdt),
        _t(r[f"dec_s_{cdt}"], cdt), _t(r[f"dec_h_{cdt}"]))
    assert h.dtype == torch.float32
    _close(y, r[f"dec_y_{cdt}"], _tol(cdt))
    _close(st, r[f"dec_s2_{cdt}"], _tol(cdt))
    _close(h, r[f"dec_h2_{cdt}"], _tol(cdt))


def test_mamba2_chunks_reach_the_scan_as_its_kernel_takes_them(reference,
                                                               monkeypatch):
    """Each chunk is one scan of D = H·P channels: a contiguous decay of
    one value per element (a head's scalar repeated over its (P, N)), b of
    the same shape, c (B, chunk, N), the state (B, H·P, N) f32; the last
    chunk passed short."""
    r, _ = reference
    cfg, p = _cfg(), _mixer(r)
    din, nh, hp, n = t_ssm._mamba2_split(cfg)
    seen = []
    scan = t_ssm._scan

    def spy(a, b, c, h0, impl):
        seen.append((a, b, c, h0))
        return scan(a, b, c, h0, impl)

    monkeypatch.setattr(t_ssm, "_scan", spy)
    x = _t(r["blk_x_float32_37"])
    t_ssm.mamba2_block(x, p, cfg)
    assert [a.shape[1] for a, *_ in seen] == [16, 16, 5]
    for a, b, c, h0 in seen:
        assert a.shape == b.shape == (2, a.shape[1], nh * hp, n)
        assert a.is_contiguous() and a.dtype == b.dtype == torch.float32
        assert c.shape == (2, a.shape[1], n) and c.is_contiguous()
        assert h0.shape == (2, nh * hp, n) and h0.dtype == torch.float32
        per_head = a.reshape(2, -1, nh, hp * n)
        assert torch.equal(per_head, per_head[..., :1].expand_as(per_head))


def test_short_prompt_conv_tail_is_zero_padded():
    """A prompt shorter than d_conv-1 is preceded by zeros in the conv
    state, as the causal conv sees it (the reference keeps a short tail
    there, which its decode step cannot take)."""
    cfg = _cfg()
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(2))
    toks = torch.randint(0, cfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(3))
    full, _ = T.forward(model, cfg, {"tokens": toks})
    _, cache = T.prefill(model, cfg, {"tokens": toks[:, :2]}, 8)
    assert cache["conv"].shape[2] == cfg.ssm.d_conv - 1
    assert float(cache["conv"][:, :, 0].abs().max()) == 0.0
    for t in range(2, 6):
        logits, cache = T.decode_step(model, cfg, cache, toks[:, t:t + 1])
    torch.testing.assert_close(logits[:, 0], full[:, -1], rtol=1e-4,
                               atol=1e-4)


# -- the shared block ------------------------------------------------------------


@pytest.mark.parametrize("cdt", DTYPES)
def test_shared_block_matches_reference(reference, cdt):
    r, _ = reference
    cfg, model = _model(r, cdt)
    x = _t(r[f"sb_x_{cdt}"], cdt)
    pos = torch.arange(19, dtype=torch.int32).expand(2, 19)
    y = TM.shared_attn_block(x, model.shared_params(), cfg, pos)
    assert y.dtype == x.dtype
    _close(y, r[f"sb_y_{cdt}"], _tol(cdt))
    # its weights cast once (cast_params_once) give the per-use casts' values
    once = TM.shared_attn_block(x, model.shared_params(x.dtype), cfg, pos)
    torch.testing.assert_close(once, y, rtol=0, atol=0)
    scfg = TM.shared_config(cfg)
    assert (scfg.n_heads, scfg.n_kv_heads, scfg.head_dim, scfg.qkv_bias) == (
        4, 2, 32, False)


# -- the model ---------------------------------------------------------------------


def test_parameter_tree_and_count_match_reference(reference):
    """At full width: every leaf of the reference's tree at its shape, the
    layer leaves split per layer, the shared block's held once."""
    _, meta = reference
    cfg = T.get(ARCH)
    got = {n: list(p.shape) for n, p in
           TM.Transformer(cfg, device="meta").state_dict().items()}
    want = {}
    for path, shape in meta["tree"].items():
        top, *rest = path.split("/")
        if top == "layers":
            assert shape[0] == cfg.n_layers
            for i in range(cfg.n_layers):
                want[".".join(["layers", str(i)] + rest)] = shape[1:]
        else:
            want[path.replace("/", ".")] = shape
    assert got == want
    assert got["shared_block.attn.wq"] == [2560, 2560]
    assert T.count_params(cfg) == meta["count"] == N_PARAMS
    assert T.count_params(cfg, active_only=True) == meta["active"]
    model = T.init_params(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == N_PARAMS


def test_zamba2_at_published_width():
    from repro_torch.configs import zamba2_27b
    cfg = zamba2_27b.CONFIG
    assert cfg is T.get(ARCH) and cfg.family == "hybrid"
    din, nh, hp, n = t_ssm._mamba2_split(cfg)
    scfg = TM.shared_config(cfg)
    assert (cfg.n_layers, cfg.d_model, din, nh, hp, n, cfg.ssm.d_conv,
            cfg.hybrid.period, scfg.n_heads, scfg.n_kv_heads, scfg.head_dim,
            cfg.d_ff, cfg.vocab_size) == (
        54, 2560, 5120, 80, 64, 64, 4, 6, 32, 32, 80, 10240, 32000)
    assert zamba2_27b.NAME == ARCH
    assert zamba2_27b.REDUCED == T.reduced(cfg)
    # a 4 x 512 prefill: a scan a chunk of every layer, the shared block
    # after every 6th layer
    chunks = -(-512 // cfg.ssm.chunk)
    assert (cfg.n_layers * chunks, cfg.n_layers // cfg.hybrid.period) == (
        108, 9)


def test_init_params_sets_the_reference_constants():
    cfg = _cfg()
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    mixer = model.layers[1].mixer
    assert torch.all(mixer.A_log == 0.0) and torch.all(mixer.D == 1.0)
    assert torch.all(mixer.dt_bias == -4.6) and torch.all(mixer.norm == 1.0)
    assert torch.all(mixer.conv_b == 0.0) and torch.all(model.layers[0].ln
                                                        == 1.0)
    # conv_w is drawn on its last axis (fan-in d_conv)
    assert float(mixer.conv_w.abs().max()) <= 2.0 * (1 / cfg.ssm.d_conv) ** 0.5
    assert float(mixer.conv_w.abs().max()) > 2.0 * (1 / cfg.d_inner) ** 0.5
    sb = model.shared_block
    assert torch.all(sb.ln1 == 1.0) and torch.all(sb.ln2 == 1.0)
    assert not hasattr(sb.attn, "bq")
    assert float(sb.attn.wq.abs().max()) <= 2.0 * (1 / cfg.d_model) ** 0.5


def test_converter_keeps_the_shared_block_whole(reference):
    r, _ = reference
    cfg = _cfg()
    tree = _tree(r)
    sd = convert.model_params_from_numpy(tree, cfg)
    shared = sorted(k for k in sd if k.startswith("shared_block."))
    assert shared == sorted(
        f"shared_block.{k}" for k in ("ln1", "ln2", "attn.wq", "attn.wk",
                                      "attn.wv", "attn.wo", "mlp.wi",
                                      "mlp.wg", "mlp.wo"))
    np.testing.assert_array_equal(sd["shared_block.attn.wq"].numpy(),
                                  tree["shared_block"]["attn"]["wq"])
    np.testing.assert_array_equal(sd["layers.3.mixer.A_log"].numpy(),
                                  tree["layers"]["mixer"]["A_log"][3])
    stacked = dict(tree, shared_block=dict(
        tree["shared_block"], ln1=np.ones((cfg.n_layers, cfg.d_model),
                                          np.float32)))
    with pytest.raises(ValueError, match="shape"):
        convert.model_params_from_numpy(stacked, cfg)


@pytest.mark.parametrize("cdt", DTYPES)
def test_forward_matches_reference(reference, cdt):
    r, _ = reference
    cfg, model = _model(r, cdt)
    logits, aux = T.forward(model, cfg, {"tokens": _t(r["toks"])})
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    _close_model(logits, r[f"fwd_{cdt}"], cdt)
    once, _ = T.forward(model, cfg, {"tokens": _t(r["toks"])},
                        T.CallConfig(cast_params_once=True))
    _close_model(once, r[f"fwd_once_{cdt}"], cdt)


@pytest.mark.parametrize("cdt", DTYPES)
def test_prefill_and_decode_match_reference(reference, cdt):
    r, meta = reference
    cfg, model = _model(r, cdt)
    logits, cache = T.prefill(model, cfg, {"tokens": _t(r["toks"])}, S + NEW)
    _close_model(logits, r[f"pre_{cdt}"], cdt)
    for name in ("conv", "h", "k", "v"):
        _close_model(cache[name], r[f"pre_{name}_{cdt}"], cdt)
    assert cache["pos"] == meta[f"pre_pos_{cdt}"] == S
    for i in range(NEW):
        logits, cache = T.decode_step(model, cfg, cache, _t(r["nxt"][i]))
        _close_model(logits, r[f"dec_{i}_{cdt}"], cdt)
    for name in ("conv", "h", "k", "v"):
        _close_model(cache[name], r[f"post_{name}_{cdt}"], cdt)
    assert cache["pos"] == meta[f"dec_pos_{cdt}"] == S + NEW


def test_prefill_decode_agree_with_forward_in_port():
    """The port alone, as tests/test_models_smoke.py checks the reference:
    a prompt of 2 chunks and a short one, then decode steps."""
    cfg = _cfg()
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(2))
    full, _ = T.forward(model, cfg, {"tokens": toks})
    pre, cache = T.prefill(model, cfg, {"tokens": toks[:, :37]}, 40)
    torch.testing.assert_close(pre[:, -1], full[:, 36], rtol=1e-4, atol=1e-4)
    for t in range(37, 40):
        dec, cache = T.decode_step(model, cfg, cache, toks[:, t:t + 1])
        torch.testing.assert_close(dec[:, 0], full[:, t], rtol=1e-4,
                                   atol=1e-4)


def test_prefill_runs_a_scan_a_chunk_and_the_shared_block_a_period(
        monkeypatch):
    """The launches a prefill makes, counted through the two entry points
    the kernels sit behind: one scan per chunk of every layer, one
    attention per application of the shared block (at full width: 108 and
    9, test_zamba2_at_published_width); its K/V in slot idx // period."""
    cfg = _cfg()
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(5))
    counts = {"scan": 0, "attention": []}
    scan, mha = t_ssm._scan, t_attn.multihead_attention

    def count_scan(*args):
        counts["scan"] += 1
        return scan(*args)

    def count_mha(q, k, v, **kw):
        counts["attention"].append(tuple(q.shape))
        return mha(q, k, v, **kw)

    monkeypatch.setattr(t_ssm, "_scan", count_scan)
    monkeypatch.setattr(t_attn, "multihead_attention", count_mha)
    toks = torch.randint(0, cfg.vocab_size, (2, 37),
                         generator=torch.Generator().manual_seed(6))
    _, cache = T.prefill(model, cfg, {"tokens": toks}, 40)
    apps = cfg.n_layers // cfg.hybrid.period
    assert counts["scan"] == cfg.n_layers * 3
    assert counts["attention"] == [(2, 4, 37, 32)] * apps
    assert cache["k"].shape == (apps, 2, 40, 2 * 32)
    assert float(cache["k"][:, :, 37:].abs().max()) == 0.0
    assert bool((cache["k"][:, :, :37].abs().amax(dim=-1) > 0).all())


def test_hybrid_limits():
    cfg = _cfg()
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(7))
    toks = torch.zeros((2, 9), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds max_len"):
        T.prefill(model, cfg, {"tokens": toks}, 8)
    _, cache = T.prefill(model, cfg, {"tokens": toks}, 12)
    with pytest.raises(NotImplementedError, match="ragged"):
        T.decode_step_ragged(model, cfg, cache, toks[:, :1],
                             torch.tensor([9, 9], dtype=torch.int32))
    eng = ServeEngine(cfg, model, ServeConfig(batch=2, max_len=12),
                      device="cpu")
    with pytest.raises(NotImplementedError, match="continuous batching"):
        eng.generate_many([(np.arange(5, dtype=np.int32), 3)])


def test_require_ported_admits_the_hybrid_with_mamba2_only():
    cfg = T.get(ARCH)
    TM.require_ported(cfg)
    bad = [dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                            version=1)),
           dataclasses.replace(cfg, hybrid=None),
           dataclasses.replace(cfg, family="ssm"),
           dataclasses.replace(T.get("yi-9b"), hybrid=cfg.hybrid)]
    for c in bad:
        with pytest.raises(NotImplementedError,
                           match="the reference never combines"):
            TM.require_ported(c)


# -- serving -----------------------------------------------------------------------


def test_serve_cli_serves_zamba2_on_cpu(capsys):
    outs = {}
    for mode in ("step", "chunk", "host"):
        t_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "8", "--new-tokens", "6",
                    "--decode-mode", mode, "--decode-chunk", "4"])
        out = capsys.readouterr().out
        assert "[serve] generated 12 tokens on cpu" in out
        outs[mode] = [line.split("->")[1] for line in out.splitlines()
                      if "slot " in line]
    assert outs["step"] == outs["chunk"] == outs["host"]
    with pytest.raises(NotImplementedError, match="continuous batching"):
        t_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--continuous", "--requests", "2", "--batch", "2",
                    "--prompt-len", "6", "--new-tokens", "3"])


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernel runs only on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mamba2_kernel_path_matches_plain_at_full_width(cuda):
    """One zamba2-2.7b mixer at its published width on a 4 x 256 chunk of
    prefill (a, b (4, 256, 5120, 64) at the scan), float32 compute: the
    kernel path against the plain scan, one launch; the block's output at
    the serving phases' f32 prefill bar (1e-3), the state at the scan's."""
    cfg = dataclasses.replace(T.get(ARCH), compute_dtype="float32")
    g = torch.Generator(device=cuda).manual_seed(0)
    mixer = TM.Mamba2Mixer(cfg, torch.float32, cuda)
    with torch.no_grad():
        TM._init_mamba2_(mixer, g)
        mixer.dt_bias.uniform_(-5.0, -1.0, generator=g)
        mixer.A_log.uniform_(-1.0, 1.0, generator=g)
    p = dict(mixer.named_parameters())
    x = torch.randn((4, cfg.ssm.chunk, cfg.d_model), generator=g,
                    device=cuda)
    before = t_build.launch_counts()["ssm_scan"]
    y_k, (tail_k, h_k) = t_ssm.mamba2_block(x, p, cfg, return_state=True,
                                            impl="kernel")
    torch.cuda.synchronize()
    assert t_build.launch_counts()["ssm_scan"] == before + 1
    y_p, (tail_p, h_p) = t_ssm.mamba2_block(x, p, cfg, return_state=True,
                                            impl="plain")
    assert h_k.shape == (4, 80, 64, 64)
    torch.testing.assert_close(y_k, y_p, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(tail_k, tail_p, rtol=0, atol=0)
    torch.testing.assert_close(h_k, h_p, **SCAN_TOL)
