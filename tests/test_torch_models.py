"""The port's dense models against the reference's, on the CPU.

One subprocess (``run_subprocess``, one device, 32-bit) runs the
reference: every ``layers.py`` function on numpy inputs, ``init_params``'
tree (names and shapes) for the four dense architectures and the two
frontend ones (paligemma-3b, musicgen-large) at full width via
``jax.eval_shape``, ``count_params``, and — for ``reduced(yi-9b)`` and
``reduced(smollm-360m)`` — the weights of ``init_params(key(0))`` with
``forward``, ``prefill``, ``decode_step`` and ``decode_step_ragged`` on
them.  The port loads the same weights through
``convert.model_params_from_numpy`` and replays the same inputs.

Bars: float32 compute at ``rtol=atol=1e-4``, the reference's own
(``tests/test_models_smoke.py:65``); the bf16 forward (the configurations'
own ``compute_dtype``) at ``rtol=atol=5e-2``: both packages round
activations to bf16 after every product and norm, in different places of
their fused kernels, so logits of order 1 differ by a few bf16 ulps
(1 ulp = 2⁻⁸ relative).
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import dataclasses
import json

import numpy as np
import pytest
import torch

from torch_configs import is_reference_data
from repro_torch import convert
from repro_torch import models as T
from repro_torch.models import layers as L
from repro_torch.models import model as TM

DENSE = ["phi3-medium-14b", "qwen1.5-110b", "smollm-360m", "yi-9b"]
FRONTENDS = ["musicgen-large", "paligemma-3b"]
SMALL = ["yi-9b", "smollm-360m"]
F32_TOL = dict(rtol=1e-4, atol=1e-4)        # tests/test_models_smoke.py:65
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
B, S, MAXLEN = 2, 16, 32
POS_B = (16, 9)

_REFERENCE_CODE = '''
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
from repro import models as M
from repro.models import layers as L

rng = np.random.default_rng(11)
out, meta = {{}}, {{}}

def rnd(*shape):
    return rng.standard_normal(shape).astype(np.float32)

# -- layers
x, w, gate = rnd(3, 5, 64), rnd(64), rnd(3, 5, 64)
out.update(ly_x=x, ly_w=w, ly_gate=gate)
out["ly_rms"] = np.asarray(L.rms_norm(x, w, 1e-5))
out["ly_rms_p1"] = np.asarray(L.rms_norm(x, w, 1e-6, plus_one=True))
out["ly_grms"] = np.asarray(L.gated_rms_norm(x, gate, w))
out["ly_freqs"] = np.asarray(L.rope_freqs(32, 10000.0))
xr, pos = rnd(2, 3, 7, 32), np.arange(14, dtype=np.int32).reshape(2, 7)
out.update(ly_xr=xr, ly_pos=pos)
out["ly_rope"] = np.asarray(L.apply_rope(xr, pos[:, None], 500000.0))
out["ly_sin"] = np.asarray(L.sinusoidal_positions(pos, 48))
wi, wg, wo = rnd(64, 96) * 0.1, rnd(64, 96) * 0.1, rnd(96, 64) * 0.1
out.update(ly_wi=wi, ly_wg=wg, ly_wo=wo)
out["ly_swiglu"] = np.asarray(L.gated_mlp(x, wi, wg, wo, "silu"))
out["ly_geglu"] = np.asarray(L.gated_mlp(x, wi, wg, wo, "gelu"))
out["ly_softcap"] = np.asarray(L.softcap(x * 10, 30.0))

# -- the parameter tree and counts at full width
for arch in {full}:
    cfg = M.get(arch)
    key = jax.eval_shape(lambda: jax.random.key(0))
    shapes = jax.eval_shape(lambda k: M.init_params(k, cfg),
                            jax.ShapeDtypeStruct(key.shape, key.dtype))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    meta[arch] = {{
        "tree": {{"/".join(p.key for p in path): list(leaf.shape)
                  for path, leaf in flat}},
        "count": int(M.count_params(cfg)),
        "active": int(M.count_params(cfg, active_only=True))}}

# -- forward / prefill / decode on the reduced models
for arch in {small}:
    for cdt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(M.reduced(M.get(arch)), compute_dtype=cdt)
        params = jax.device_get(M.init_params(jax.random.key(0), cfg))
        tag = f"{{arch}}_{{cdt}}"
        if cdt == "float32":
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
                out[f"w_{{arch}}_" + "/".join(p.key for p in path)] = \\
                    np.asarray(leaf)
        toks = rng.integers(0, cfg.vocab_size, ({b}, {s})).astype(np.int32)
        nxt = rng.integers(0, cfg.vocab_size, ({b}, 1)).astype(np.int32)
        out[f"toks_{{tag}}"], out[f"nxt_{{tag}}"] = toks, nxt
        call = M.CallConfig(moe_no_drop=True)
        logits, _ = M.forward(params, cfg, {{"tokens": toks}}, call)
        out[f"fwd_{{tag}}"] = np.asarray(logits, np.float32)
        if cdt != "float32":
            continue
        lp, cache = M.prefill(params, cfg, {{"tokens": toks}}, {maxlen}, call)
        out[f"pre_{{tag}}"] = np.asarray(lp)
        out[f"pre_k_{{tag}}"] = np.asarray(cache["k"])
        out[f"pre_v_{{tag}}"] = np.asarray(cache["v"])
        ld, cache = M.decode_step(params, cfg, cache, jnp.asarray(nxt), call)
        out[f"dec_{{tag}}"] = np.asarray(ld)
        out[f"dec_k_{{tag}}"] = np.asarray(cache["k"])
        meta[f"pos_{{tag}}"] = int(cache["pos"])
        pos_b = jnp.asarray({pos_b}, jnp.int32)
        lr, cache = M.decode_step_ragged(params, cfg, cache, jnp.asarray(nxt),
                                         pos_b, call)
        out[f"rag_{{tag}}"] = np.asarray(lr)
        out[f"rag_k_{{tag}}"] = np.asarray(cache["k"])
np.savez({path!r}, **out)
with open({meta_path!r}, "w") as f:
    json.dump(meta, f)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("models_ref")
    path, meta_path = str(d / "ref.npz"), str(d / "meta.json")
    subproc(_REFERENCE_CODE.format(dense=DENSE, small=SMALL, b=B, s=S,
                                   full=DENSE + FRONTENDS,
                                   maxlen=MAXLEN, pos_b=POS_B, path=path,
                                   meta_path=meta_path),
            devices=1, x64=False, timeout=900)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    with open(meta_path) as f:
        return arrays, json.load(f)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **tol)


def _tree(arrays, arch):
    """The reference's weights of ``arch`` as a nested dict."""
    prefix = f"w_{arch}_"
    tree = {}
    for name, arr in arrays.items():
        if not name.startswith(prefix):
            continue
        node = tree
        *parents, leaf = name[len(prefix):].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def _model(arrays, arch, compute_dtype="float32"):
    cfg = dataclasses.replace(T.reduced(T.get(arch)),
                              compute_dtype=compute_dtype)
    model = TM.Transformer(cfg, device="meta")
    model.load_state_dict(convert.model_params_from_numpy(
        _tree(arrays, arch), cfg), assign=True)
    return cfg, model


# -- layers ---------------------------------------------------------------------


def test_layers_match_reference(reference):
    r, _ = reference
    x, w, gate = _t(r["ly_x"]), _t(r["ly_w"]), _t(r["ly_gate"])
    tol = dict(rtol=1e-5, atol=1e-5)
    _close(L.rms_norm(x, w, 1e-5), r["ly_rms"], tol)
    _close(L.rms_norm(x, w, 1e-6, plus_one=True), r["ly_rms_p1"], tol)
    _close(L.gated_rms_norm(x, gate, w), r["ly_grms"], tol)
    _close(L.rope_freqs(32, 10000.0), r["ly_freqs"], tol)
    pos = _t(r["ly_pos"])
    _close(L.apply_rope(_t(r["ly_xr"]), pos[:, None], 500000.0),
           r["ly_rope"], tol)
    _close(L.sinusoidal_positions(pos, 48), r["ly_sin"], tol)
    wi, wg, wo = _t(r["ly_wi"]), _t(r["ly_wg"]), _t(r["ly_wo"])
    _close(L.gated_mlp(x, wi, wg, wo, "silu"), r["ly_swiglu"], tol)
    _close(L.gated_mlp(x, wi, wg, wo, "gelu"), r["ly_geglu"], tol)
    _close(L.softcap(x * 10, 30.0), r["ly_softcap"], tol)
    assert L.softcap(x, 0.0) is x


def test_layers_keep_the_input_dtype():
    x = torch.randn(2, 3, 64).to(torch.bfloat16)
    w = torch.ones(64)
    assert L.rms_norm(x, w).dtype == torch.bfloat16
    assert L.apply_rope(x, torch.arange(3)[None].expand(2, 3),
                        1e4).dtype == torch.bfloat16


def test_dense_init_is_a_truncated_fan_in_normal():
    g = torch.Generator().manual_seed(0)
    w = L.dense_init((256, 512), g)
    std = (1.0 / 256) ** 0.5
    assert w.dtype == torch.float32 and w.shape == (256, 512)
    assert float(w.abs().max()) <= 2.0 * std + 1e-7
    # N(0,1) cut at ±2 has std 0.8796
    assert abs(float(w.std()) / std - 0.8796) < 0.02
    again = L.dense_init((256, 512), torch.Generator().manual_seed(0))
    assert torch.equal(w, again)            # the generator decides every draw
    assert L.dense_init((8, 4), g, dtype=torch.bfloat16).dtype == \
        torch.bfloat16
    emb = L.dense_init((512, 64), g, in_axis=-1)
    assert float(emb.abs().max()) <= 2.0 * (1 / 64) ** 0.5 + 1e-7


# -- the parameter tree and counts ----------------------------------------------


@pytest.mark.parametrize("arch", DENSE + FRONTENDS)
def test_parameter_names_and_shapes_follow_the_reference_tree(reference,
                                                              arch):
    _, meta = reference
    cfg = T.get(arch)
    got = {n: list(p.shape) for n, p in
           TM.Transformer(cfg, device="meta").state_dict().items()}
    want = {}
    for path, shape in meta[arch]["tree"].items():
        top, *rest = path.split("/")
        if top == "layers":
            assert shape[0] == cfg.n_layers
            for i in range(cfg.n_layers):
                want[".".join(["layers", str(i)] + rest)] = shape[1:]
        else:
            want[path.replace("/", ".")] = shape
    assert got == want


@pytest.mark.parametrize("arch", DENSE + FRONTENDS)
def test_count_params_matches_reference(reference, arch):
    _, meta = reference
    cfg = T.get(arch)
    assert T.count_params(cfg) == meta[arch]["count"]
    assert T.count_params(cfg, active_only=True) == meta[arch]["active"]
    assert cfg.param_count() == meta[arch]["count"]


def test_yi_9b_at_published_width():
    cfg = T.get("yi-9b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
        48, 4096, 32, 4, 128, 11008, 64000)
    assert T.count_params(cfg) == 8_829_407_232


def test_registry_and_configs_are_the_reference_data():
    import importlib
    from repro.models import registry as r_registry
    from repro_torch.configs import smollm_360m, yi_9b
    assert sorted(T.ARCHS) == sorted(r_registry.ARCHS)
    for name, cfg in T.ARCHS.items():
        is_reference_data(cfg, r_registry.ARCHS[name])
    assert yi_9b.CONFIG is T.get("yi-9b")
    assert smollm_360m.REDUCED == T.reduced(T.get("smollm-360m"))
    # the config modules of the dense, hybrid and moe families, each the
    # twin of the reference's (its NAME, CONFIG and REDUCED)
    for mod in ("phi3_medium_14b", "qwen15_110b", "zamba2_27b",
                "deepseek_v2_lite_16b", "llama4_scout_17b_a16e"):
        ours = importlib.import_module(f"repro_torch.configs.{mod}")
        theirs = importlib.import_module(f"repro.configs.{mod}")
        assert ours.NAME == theirs.NAME and ours.CONFIG is T.get(ours.NAME)
        for field in ("CONFIG", "REDUCED"):
            is_reference_data(getattr(ours, field), getattr(theirs, field))
    # the paper's platform: the port's own jobs and machine constants
    from repro.configs import paper_occamy as r_occamy
    from repro_torch.configs import paper_occamy
    assert paper_occamy.NAME == r_occamy.NAME == "occamy"
    assert dataclasses.asdict(paper_occamy.CONFIG) == dataclasses.asdict(
        r_occamy.CONFIG)
    assert (paper_occamy.CONFIG.num_clusters,
            paper_occamy.CONFIG.num_cores) == (32, 289)
    assert sorted(paper_occamy.PAPER_JOBS) == sorted(r_occamy.PAPER_JOBS)
    assert paper_occamy.OccamyParams.__module__.startswith("repro_torch.")
    with pytest.raises(KeyError):
        T.get("no-such-arch")


# -- model_params_from_numpy ----------------------------------------------------


def test_model_params_from_numpy_round_trip_and_errors(reference):
    r, _ = reference
    arch = "smollm-360m"
    cfg = T.reduced(T.get(arch))
    tree = _tree(r, arch)
    sd = convert.model_params_from_numpy(tree, cfg)
    np.testing.assert_array_equal(sd["layers.1.attn.wq"].numpy(),
                                  tree["layers"]["attn"]["wq"][1])
    assert "lm_head" not in sd                  # tied embeddings
    with pytest.raises(ValueError, match="unknown"):
        convert.model_params_from_numpy(dict(tree, extra=np.zeros(3)), cfg)
    short = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing"):
        convert.model_params_from_numpy(short, cfg)
    bad = dict(tree, final_norm=np.zeros(7, np.float32))
    with pytest.raises(ValueError, match="shape"):
        convert.model_params_from_numpy(bad, cfg)


# -- forward / prefill / decode ------------------------------------------------


@pytest.mark.parametrize("impl", ["plain", "chunked"])
@pytest.mark.parametrize("arch", SMALL)
def test_forward_matches_reference(reference, arch, impl):
    r, _ = reference
    cfg, model = _model(r, arch)
    tag = f"{arch}_float32"
    call = T.CallConfig(attn_impl=impl, attn_chunk=8)
    logits, aux = T.forward(model, cfg, {"tokens": _t(r[f"toks_{tag}"])},
                            call)
    _close(logits, r[f"fwd_{tag}"], F32_TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", SMALL)
def test_forward_bf16_matches_reference(reference, arch):
    r, _ = reference
    cfg, model = _model(r, arch, compute_dtype="bfloat16")
    tag = f"{arch}_bfloat16"
    logits, _ = T.forward(model, cfg, {"tokens": _t(r[f"toks_{tag}"])})
    assert logits.dtype == torch.float32
    _close(logits, r[f"fwd_{tag}"], BF16_TOL)
    once, _ = T.forward(model, cfg, {"tokens": _t(r[f"toks_{tag}"])},
                        T.CallConfig(cast_params_once=True))
    torch.testing.assert_close(once, logits, rtol=0, atol=0)


@pytest.mark.parametrize("arch", SMALL)
def test_prefill_and_decode_match_reference(reference, arch):
    r, meta = reference
    cfg, model = _model(r, arch)
    tag = f"{arch}_float32"
    logits, cache = T.prefill(model, cfg, {"tokens": _t(r[f"toks_{tag}"])},
                              MAXLEN)
    _close(logits, r[f"pre_{tag}"], F32_TOL)
    _close(cache["k"], r[f"pre_k_{tag}"], F32_TOL)
    _close(cache["v"], r[f"pre_v_{tag}"], F32_TOL)
    assert cache["pos"] == S
    nxt = _t(r[f"nxt_{tag}"])
    logits, cache = T.decode_step(model, cfg, cache, nxt)
    _close(logits, r[f"dec_{tag}"], F32_TOL)
    _close(cache["k"], r[f"dec_k_{tag}"], F32_TOL)
    assert cache["pos"] == meta[f"pos_{tag}"]
    pos_b = torch.tensor(POS_B, dtype=torch.int32)
    logits, cache = T.decode_step_ragged(model, cfg, cache, nxt, pos_b)
    _close(logits, r[f"rag_{tag}"], F32_TOL)
    _close(cache["k"], r[f"rag_k_{tag}"], F32_TOL)
    assert int(cache["pos"]) == max(POS_B) + 1


def test_prefill_decode_agree_with_forward_in_port():
    """The port alone, as tests/test_models_smoke.py checks the reference."""
    cfg = dataclasses.replace(T.reduced(T.get("yi-9b")),
                              compute_dtype="float32")
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(1),
                          device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(2))
    full, _ = T.forward(model, cfg, {"tokens": toks})
    pre, cache = T.prefill(model, cfg, {"tokens": toks[:, :-1]}, 20)
    torch.testing.assert_close(pre[:, -1], full[:, -2], rtol=1e-4, atol=1e-4)
    dec, cache = T.decode_step(model, cfg, cache, toks[:, -1:])
    torch.testing.assert_close(dec[:, 0], full[:, -1], rtol=1e-3, atol=1e-3)
    with pytest.raises(ValueError, match="max_len"):
        T.prefill(model, cfg, {"tokens": toks}, 8)


def test_init_params_needs_a_generator_and_is_seeded():
    cfg = T.reduced(T.get("smollm-360m"))
    with pytest.raises(ValueError, match="Generator"):
        T.init_params(cfg, device="cpu")
    a = T.init_params(cfg, generator=torch.Generator().manual_seed(5))
    b = T.init_params(cfg, generator=torch.Generator().manual_seed(5))
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    assert float(a.final_norm.min()) == 1.0 and not a.embed.requires_grad
