"""The port's SSM scan and Mamba-1 model against the reference's, on the CPU.

One subprocess (``run_subprocess``, one device, 32-bit) runs the reference
on inputs it draws from a numpy seed and writes inputs and outputs: the
Pallas ``ssm_scan`` in interpret mode and ``kernels.ref.ssm_scan`` over
``tests/test_kernels.py:126-130``'s sweep, ``chunked_linear_recurrence``
with a nonzero initial state, ``causal_conv``, ``conv_decode``,
``mamba1_block`` (with ``return_state``, S not a multiple of the chunk) and
``mamba1_decode``; for ``reduced(falcon-mamba-7b)`` the weights of
``init_params(key(0))`` with ``forward``, ``prefill`` and ``decode_step`` on
them; and at full width the parameter tree (``jax.eval_shape``) and
``count_params``.  The port replays the same inputs; the models load the
same weights through ``convert.model_params_from_numpy``.

Bars: the scan at 2e-4 (``tests/test_kernels.py:139``); the reference scans
each chunk with an associative scan, the port sequentially, so the two
differ by f32 rounding.  The blocks and the model in float32 at 1e-4 (the
reference's own, ``tests/test_models_smoke.py:65``) and in bf16 at 5e-2:
both packages round activations to bf16 after every product, in different
places of their fused kernels (``tests/test_torch_models.py``).
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
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.models import model as TM
from repro_torch.models import ssm as t_ssm

ARCH = "falcon-mamba-7b"
SCAN_SHAPES = [(1, 64, 128, 16), (2, 100, 64, 16), (1, 33, 512, 8)]
SCAN_CHUNKS = [16, 64]
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)         # tests/test_kernels.py:139
F32_TOL = dict(rtol=1e-4, atol=1e-4)          # tests/test_models_smoke.py:65
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
DTYPES = ["float32", "bfloat16"]
BLOCK_S = [37, 16]                            # 37 = 2 chunks of 16 and a short one
B, S, NEW = 2, 21, 3

_REFERENCE_CODE = '''
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
from repro import models as M
from repro.kernels import ref as kref
from repro.kernels.ssm_scan import ssm_scan
from repro.models import ssm

rng = np.random.default_rng(13)
out, meta = {}, {}

def f32(*shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)

# -- the scan: Pallas (interpret) and the sequential oracle
for shape in SCAN_SHAPES:
    Bs, Ss, Ds, Ns = shape
    tag = "x".join(map(str, shape))
    a = rng.uniform(0.7, 0.999, shape).astype(np.float32)
    b, c = f32(*shape, scale=0.1), f32(Bs, Ss, Ns)
    out.update({f"scan_a_{tag}": a, f"scan_b_{tag}": b, f"scan_c_{tag}": c})
    out[f"scan_ref_{tag}"] = np.asarray(kref.ssm_scan(a, b, c))
    for chunk in SCAN_CHUNKS:
        out[f"scan_pallas_{tag}_{chunk}"] = np.asarray(
            ssm_scan(a, b, c, chunk=chunk, interpret=True))

# -- the recurrence with a nonzero initial state
a = rng.uniform(0.8, 0.999, (2, 37, 24, 8)).astype(np.float32)
b, h0 = f32(2, 37, 24, 8, scale=0.1), f32(2, 24, 8)
hs, hl = ssm.chunked_linear_recurrence(a, b, h0, 16)
out.update(clr_a=a, clr_b=b, clr_h0=h0, clr_hs=np.asarray(hs),
           clr_hl=np.asarray(hl))
a = rng.uniform(0.8, 0.999, (2, 21, 3, 1, 1)).astype(np.float32)
b, h0 = f32(2, 21, 3, 4, 8, scale=0.1), f32(2, 3, 4, 8)
hs, hl = ssm.chunked_linear_recurrence(a, b, h0, 8)
out.update(bclr_a=a, bclr_b=b, bclr_h0=h0, bclr_hs=np.asarray(hs),
           bclr_hl=np.asarray(hl))

# -- the blocks, on the reduced model's layer-0 mixer
cfg32 = dataclasses.replace(M.reduced(M.get(ARCH)), compute_dtype="float32")
params = jax.device_get(M.init_params(jax.random.key(0), cfg32))
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["w_" + "/".join(p.key for p in path)] = np.asarray(leaf)
p = {k: np.array(v[0]) for k, v in params["layers"]["mixer"].items()}
p["dt_bias"] = rng.uniform(-5.0, -1.0, p["dt_bias"].shape).astype(np.float32)
for k, v in p.items():
    out["mix_" + k] = v
din, dm, K = cfg32.d_inner, cfg32.d_model, cfg32.ssm.d_conv
for cdt in DTYPES:
    dt = jnp.dtype(cdt)
    x, w, bias = f32(2, 19, din), f32(din, K, scale=0.5), f32(din)
    out.update({f"cc_x_{cdt}": x, f"cc_w_{cdt}": w, f"cc_b_{cdt}": bias})
    out[f"cc_{cdt}"] = np.asarray(
        ssm.causal_conv(jnp.asarray(x, dt), jnp.asarray(w, dt),
                        jnp.asarray(bias, dt)).astype(jnp.float32))
    xn, st = f32(2, din), f32(2, K - 1, din)
    out.update({f"cd_x_{cdt}": xn, f"cd_s_{cdt}": st})
    y, st2 = ssm.conv_decode(jnp.asarray(xn, dt), jnp.asarray(st, dt),
                             jnp.asarray(w, dt), jnp.asarray(bias, dt))
    out[f"cd_y_{cdt}"] = np.asarray(y.astype(jnp.float32))
    out[f"cd_s2_{cdt}"] = np.asarray(st2.astype(jnp.float32))
    cfg = dataclasses.replace(cfg32, compute_dtype=cdt)
    for s in BLOCK_S:
        x = f32(2, s, dm)
        out[f"blk_x_{cdt}_{s}"] = x
        y, (tail, hl) = ssm.mamba1_block(jnp.asarray(x, dt), p, cfg,
                                         return_state=True)
        out[f"blk_y_{cdt}_{s}"] = np.asarray(y.astype(jnp.float32))
        out[f"blk_tail_{cdt}_{s}"] = np.asarray(tail.astype(jnp.float32))
        out[f"blk_h_{cdt}_{s}"] = np.asarray(hl)
    x, st, h = f32(2, 1, dm), f32(2, K - 1, din), f32(2, din, cfg.ssm.d_state)
    out.update({f"dec_x_{cdt}": x, f"dec_s_{cdt}": st, f"dec_h_{cdt}": h})
    y, st2, h2 = ssm.mamba1_decode(jnp.asarray(x, dt), p, cfg,
                                   jnp.asarray(st, dt), jnp.asarray(h))
    out[f"dec_y_{cdt}"] = np.asarray(y.astype(jnp.float32))
    out[f"dec_s2_{cdt}"] = np.asarray(st2.astype(jnp.float32))
    out[f"dec_h2_{cdt}"] = np.asarray(h2)

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
lp, cache = M.prefill(params, cfg32, {"tokens": toks}, S + NEW)
out.update(pre=np.asarray(lp), pre_conv=np.asarray(cache["conv"]),
           pre_h=np.asarray(cache["h"]))
meta["pre_pos"] = int(cache["pos"])
for i in range(NEW):
    ld, cache = M.decode_step(params, cfg32, cache, jnp.asarray(nxt[i]))
    out[f"dec_{i}"] = np.asarray(ld)
out.update(dec_conv=np.asarray(cache["conv"]), dec_h=np.asarray(cache["h"]))
meta["dec_pos"] = int(cache["pos"])

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
    d = tmp_path_factory.mktemp("ssm_ref")
    path, meta_path = str(d / "ref.npz"), str(d / "meta.json")
    consts = (f"ARCH, SCAN_SHAPES, SCAN_CHUNKS = {ARCH!r}, {SCAN_SHAPES!r}, "
              f"{SCAN_CHUNKS!r}\nDTYPES, BLOCK_S = {DTYPES!r}, {BLOCK_S!r}\n"
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


def _cfg(cdt="float32"):
    return dataclasses.replace(T.reduced(T.get(ARCH)), compute_dtype=cdt)


def _mixer(r):
    return {k[len("mix_"):]: _t(v) for k, v in r.items()
            if k.startswith("mix_")}


def _model(r, cdt="float32"):
    tree = {}
    for name, arr in r.items():
        if name.startswith("w_"):
            node = tree
            *parents, leaf = name[2:].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arr
    cfg = _cfg(cdt)
    model = TM.Transformer(cfg, device="meta")
    model.load_state_dict(convert.model_params_from_numpy(tree, cfg),
                          assign=True)
    return cfg, model


# -- the scan ---------------------------------------------------------------------


@pytest.mark.parametrize("chunk", SCAN_CHUNKS)
@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_plain_scan_matches_pallas_and_reference_oracle(reference, shape,
                                                        chunk):
    r, _ = reference
    tag = "x".join(map(str, shape))
    a, b, c = (_t(r[f"scan_{k}_{tag}"]) for k in "abc")
    got = t_ops.ssm_scan(a, b, c)
    assert got.dtype == torch.float32
    _close(got, r[f"scan_pallas_{tag}_{chunk}"], SCAN_TOL)
    _close(got, r[f"scan_ref_{tag}"], SCAN_TOL)


@pytest.mark.parametrize("split", [1, 16, 30])
def test_scan_with_state_matches_chunked_linear_recurrence(reference, split):
    """Two scans joined through h0/return_state give the recurrence's states
    contracted with c, and its final state."""
    r, _ = reference
    a, b, h0 = _t(r["clr_a"]), _t(r["clr_b"]), _t(r["clr_h0"])
    c = _t(np.random.default_rng(5).standard_normal(
        (2, 37, 8)).astype(np.float32))
    y1, h = t_ops.ssm_scan(a[:, :split], b[:, :split], c[:, :split], h0=h0,
                           return_state=True)
    y2, h = t_ops.ssm_scan(a[:, split:], b[:, split:], c[:, split:], h0=h,
                           return_state=True)
    want = np.einsum("bsdn,bsn->bsd", r["clr_hs"], c.numpy())
    _close(torch.cat([y1, y2], dim=1), want, SCAN_TOL)
    _close(h, r["clr_hl"], SCAN_TOL)


@pytest.mark.parametrize("kind", ["clr", "bclr"])
def test_chunked_linear_recurrence_matches_reference(reference, kind):
    r, _ = reference
    hs, hl = t_ssm.chunked_linear_recurrence(
        _t(r[f"{kind}_a"]), _t(r[f"{kind}_b"]), _t(r[f"{kind}_h0"]), 8)
    _close(hs, r[f"{kind}_hs"], SCAN_TOL)
    _close(hl, r[f"{kind}_hl"], SCAN_TOL)


def test_scan_edges_on_cpu():
    rng = np.random.default_rng(3)
    a = _t(rng.uniform(0.5, 1.0, (2, 1, 5, 8)).astype(np.float32))
    b = _t(rng.standard_normal((2, 1, 5, 8)).astype(np.float32))
    c = _t(rng.standard_normal((2, 1, 8)).astype(np.float32))
    h0 = _t(rng.standard_normal((2, 5, 8)).astype(np.float32))
    y, h = t_ops.ssm_scan(a, b, c, h0=h0, return_state=True)   # S = 1
    want_h = a[:, 0] * h0 + b[:, 0]
    torch.testing.assert_close(h, want_h)
    torch.testing.assert_close(y[:, 0], (want_h * c[:, 0, None]).sum(-1))
    yb = t_ops.ssm_scan(a.bfloat16(), b.bfloat16(), c.bfloat16())
    assert yb.dtype == torch.bfloat16 and yb.shape == (2, 1, 5)


def test_kernel_impl_raises_on_cpu():
    a = torch.ones(1, 2, 3, 8)
    before = t_build.launch_counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_ops.ssm_scan(a, a, torch.ones(1, 2, 8), impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        from repro_torch.kernels.ssm_scan import ssm_scan as kernel
        kernel(a, a, torch.ones(1, 2, 8))
    with pytest.raises(ValueError, match="impl"):
        t_ssm.resolve_impl("pallas", a)
    assert t_build.launch_counts() == before       # no kernel ran
    assert t_ssm.resolve_impl("auto", a) == "plain"


# -- conv and the blocks ------------------------------------------------------------


@pytest.mark.parametrize("cdt", DTYPES)
def test_causal_conv_and_conv_decode_match_reference(reference, cdt):
    r, _ = reference
    w, bias = _t(r[f"cc_w_{cdt}"], cdt), _t(r[f"cc_b_{cdt}"], cdt)
    _close(t_ssm.causal_conv(_t(r[f"cc_x_{cdt}"], cdt), w, bias),
           r[f"cc_{cdt}"], _tol(cdt))
    y, st = t_ssm.conv_decode(_t(r[f"cd_x_{cdt}"], cdt),
                              _t(r[f"cd_s_{cdt}"], cdt), w, bias)
    _close(y, r[f"cd_y_{cdt}"], _tol(cdt))
    _close(st, r[f"cd_s2_{cdt}"], _tol(cdt))


@pytest.mark.parametrize("s", BLOCK_S)
@pytest.mark.parametrize("cdt", DTYPES)
def test_mamba1_block_matches_reference(reference, cdt, s):
    r, _ = reference
    cfg, p = _cfg(cdt), _mixer(r)
    x = _t(r[f"blk_x_{cdt}_{s}"], cdt)
    y, (tail, h) = t_ssm.mamba1_block(x, p, cfg, return_state=True)
    assert y.dtype == x.dtype and tail.dtype == x.dtype
    assert h.dtype == torch.float32
    _close(y, r[f"blk_y_{cdt}_{s}"], _tol(cdt))
    _close(tail, r[f"blk_tail_{cdt}_{s}"], _tol(cdt))
    _close(h, r[f"blk_h_{cdt}_{s}"], _tol(cdt))
    plain = t_ssm.mamba1_block(x, p, cfg, impl="plain")
    torch.testing.assert_close(plain, y, rtol=0, atol=0)


@pytest.mark.parametrize("cdt", DTYPES)
def test_mamba1_decode_matches_reference(reference, cdt):
    r, _ = reference
    y, st, h = t_ssm.mamba1_decode(
        _t(r[f"dec_x_{cdt}"], cdt), _mixer(r), _cfg(cdt),
        _t(r[f"dec_s_{cdt}"], cdt), _t(r[f"dec_h_{cdt}"]))
    _close(y, r[f"dec_y_{cdt}"], _tol(cdt))
    _close(st, r[f"dec_s2_{cdt}"], _tol(cdt))
    _close(h, r[f"dec_h2_{cdt}"], _tol(cdt))


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


# -- the model ---------------------------------------------------------------------


def test_parameter_tree_and_count_match_reference(reference):
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
    assert T.count_params(cfg) == meta["count"] == 7_272_665_088
    assert T.count_params(cfg, active_only=True) == meta["active"]


def test_falcon_mamba_at_published_width():
    from repro_torch.configs import falcon_mamba_7b
    cfg = falcon_mamba_7b.CONFIG
    assert cfg is T.get(ARCH) and cfg.family == "ssm"
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm.d_state,
            cfg.ssm.d_conv, cfg.vocab_size, cfg.tie_embeddings) == (
        64, 4096, 8192, 16, 4, 65024, False)
    assert t_ssm._dt_rank(cfg) == 256 and cfg.ssm.chunk == 256
    assert falcon_mamba_7b.REDUCED == T.reduced(cfg)


def test_init_params_sets_the_reference_constants():
    cfg = _cfg()
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    mixer = model.layers[1].mixer
    n = cfg.ssm.d_state
    torch.testing.assert_close(
        mixer.A_log, torch.log(torch.arange(1, n + 1.0)).expand(
            cfg.d_inner, n))
    assert torch.all(mixer.dt_bias == -4.6) and torch.all(mixer.D == 1.0)
    assert torch.all(mixer.conv_b == 0.0) and torch.all(model.layers[0].ln
                                                        == 1.0)
    # conv_w is drawn on its last axis (fan-in d_conv)
    assert float(mixer.conv_w.abs().max()) <= 2.0 * (1 / cfg.ssm.d_conv) ** 0.5
    assert float(mixer.conv_w.abs().max()) > 2.0 * (1 / cfg.d_inner) ** 0.5


@pytest.mark.parametrize("cdt", DTYPES)
def test_forward_matches_reference(reference, cdt):
    r, _ = reference
    cfg, model = _model(r, cdt)
    logits, aux = T.forward(model, cfg, {"tokens": _t(r["toks"])})
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    _close(logits, r[f"fwd_{cdt}"], _tol(cdt))
    once, _ = T.forward(model, cfg, {"tokens": _t(r["toks"])},
                        T.CallConfig(cast_params_once=True))
    _close(once, r[f"fwd_once_{cdt}"], _tol(cdt))


def test_prefill_and_decode_match_reference(reference):
    r, meta = reference
    cfg, model = _model(r)
    logits, cache = T.prefill(model, cfg, {"tokens": _t(r["toks"])}, S + NEW)
    _close(logits, r["pre"], F32_TOL)
    _close(cache["conv"], r["pre_conv"], F32_TOL)
    _close(cache["h"], r["pre_h"], F32_TOL)
    assert cache["pos"] == meta["pre_pos"] == S
    for i in range(NEW):
        logits, cache = T.decode_step(model, cfg, cache, _t(r["nxt"][i]))
        _close(logits, r[f"dec_{i}"], F32_TOL)
    _close(cache["conv"], r["dec_conv"], F32_TOL)
    _close(cache["h"], r["dec_h"], F32_TOL)
    assert cache["pos"] == meta["dec_pos"]
    with pytest.raises(NotImplementedError, match="ragged"):
        T.decode_step_ragged(model, cfg, cache, _t(r["nxt"][0]),
                             torch.tensor([S, S], dtype=torch.int32))


def test_prefill_decode_agree_with_forward_in_port():
    """The port alone, as tests/test_models_smoke.py checks the reference:
    a prompt of 2 chunks and a short one, then decode steps."""
    cfg = _cfg()
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(2))
    full, _ = T.forward(model, cfg, {"tokens": toks})
    pre, cache = T.prefill(model, cfg, {"tokens": toks[:, :37]}, 4)
    torch.testing.assert_close(pre[:, -1], full[:, 36], rtol=1e-4, atol=1e-4)
    for t in range(37, 40):
        dec, cache = T.decode_step(model, cfg, cache, toks[:, t:t + 1])
        torch.testing.assert_close(dec[:, 0], full[:, t], rtol=1e-4,
                                   atol=1e-4)
    with pytest.raises(ValueError, match="ssm impl"):
        T.forward(model, cfg, {"tokens": toks},
                  T.CallConfig(ssm_impl="pallas"))


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernel runs only on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernel_matches_plain_on_card(cuda, dtype):
    rng = np.random.default_rng(0)
    for shape in SCAN_SHAPES + [(3, 1, 77, 16), (1, 40, 33, 64)]:
        bsz, s, d, n = shape
        a = torch.from_numpy(rng.uniform(0.7, 0.999, shape)).to(dtype)
        b = torch.from_numpy(rng.standard_normal(shape) * 0.1).to(dtype)
        c = torch.from_numpy(rng.standard_normal((bsz, s, n))).to(dtype)
        h0 = torch.from_numpy(rng.standard_normal((bsz, d, n))).float()
        want_y, want_h = t_ref.ssm_scan(a, b, c, h0=h0, return_state=True)
        got_y, got_h = t_ops.ssm_scan(a.to(cuda), b.to(cuda), c.to(cuda),
                                      h0=h0.to(cuda), return_state=True,
                                      impl="kernel")
        torch.cuda.synchronize()
        tol = SCAN_TOL if dtype == torch.float32 else dict(rtol=1e-2,
                                                           atol=1e-2)
        torch.testing.assert_close(got_y.cpu().float(), want_y.float(),
                                   **tol)
        torch.testing.assert_close(got_h.cpu(), want_h, **SCAN_TOL)
