"""The port's training substrate against the reference's, on the CPU.

One subprocess (``run_subprocess``, 8 devices, 32-bit) runs the
reference: for every reduced configuration in float32 compute, the weights
of ``init_params(key(0))`` and ``jax.value_and_grad`` of ``loss_fn`` on a
seeded batch; two ``train_step_fn`` steps of the reduced smollm-360m
(2 microbatches) with its metrics and parameters after them; the schedule;
AdamW on a crafted tree with stacked layer leaves; the int8 quantizer and
error feedback on crafted and seeded inputs; ``compressed_psum`` and
``dp_grads_compressed`` inside ``shard_map`` on an 8-way data mesh; and
``input_specs`` of every full configuration.  The port replays each with
the reference's weights (``convert.model_params_from_numpy``).

Bars: ``loss_fn`` and its gradients at rtol = atol = 1e-4 (the bar of
``tests/test_torch_models.py``); the two steps' loss, ``lr`` and
``grad_norm`` at 1e-4, the parameters at a relative L2 of at most 1e-4 a
leaf and elementwise within 2 · lr · steps (Adam's first steps move a
weight by about lr whatever its gradient's size, so a gradient near 0 may
flip its step's sign); int8 codes, scales, dequantized values and
residuals bit for bit; the reductions at 1e-6 of the reference's (the
shards' sum in another order) and at the reference's own 5 % of the exact
value.  The rest mirrors ``tests/test_substrate.py`` and the train half of
``tests/test_models_smoke.py`` on the port alone, and holds the grad guard:
every kernel wrapper raises under autograd.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import dataclasses
import json

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro_torch import convert
from repro_torch import models as T
from repro_torch.data import DataConfig, SyntheticStream, input_specs
from repro_torch.dist.compression import (
    compressed_psum, dequantize_int8, dp_grads_compressed,
    error_feedback_compress, init_residual, quantize_int8,
)
from repro_torch.kernels import atax, axpy, build, covariance, matmul, ops
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ssm_scan
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.model import prefix_tokens
from repro_torch.optim import (
    AdamWConfig, adamw_init, adamw_update, decays, global_norm,
    linear_warmup_cosine,
)
from repro_torch.train import (
    TRAIN_CALL, TrainConfig, build_train_step, grads_with_microbatching,
    train_step_fn,
)

ARCHS = sorted(T.ARCHS)
TOL = dict(rtol=1e-4, atol=1e-4)            # tests/test_torch_models.py:36
B, S = 2, 16
STEP_TCFG = dict(total_steps=20, warmup_steps=2, base_lr=1e-3,
                 microbatches=2)
STEP_DATA = dict(batch_size=4, seq_len=16, seed=3)
STEPS = 2

_REFERENCE_CODE = '''
import dataclasses, json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro import models as M
from repro.compat import shard_map
from repro.data.pipeline import DataConfig, SyntheticStream, input_specs
from repro.dist.compression import (
    compressed_psum, dp_grads_compressed, error_feedback_compress,
    quantize_int8)
from repro.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro.optim.schedule import linear_warmup_cosine
from repro.train.step import TrainConfig, train_step_fn

out, meta = {{}}, {{}}

def paths(tree):
    return {{"/".join(p.key for p in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}}

# -- loss_fn and its gradients, every reduced configuration
for arch in {archs}:
    cfg = dataclasses.replace(M.reduced(M.get(arch)), compute_dtype="float32")
    params = M.init_params(jax.random.key(0), cfg)
    rng = np.random.default_rng(5)
    batch = {{"tokens": rng.integers(0, cfg.vocab_size, ({b}, {s})).astype(np.int32),
              "labels": rng.integers(0, cfg.vocab_size, ({b}, {s})).astype(np.int32)}}
    if cfg.frontend and cfg.frontend.kind == "vision_stub":
        batch["patches"] = rng.standard_normal(
            ({b}, cfg.frontend.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    for k, v in batch.items():
        out[f"b_{{arch}}_{{k}}"] = v
    (loss, aux), grads = jax.value_and_grad(
        lambda p: M.loss_fn(p, cfg, batch), has_aux=True)(params)
    meta[f"loss_{{arch}}"] = [float(loss), float(aux["nll"]), float(aux["aux"])]
    for k, v in paths(params).items():
        out[f"w_{{arch}}_{{k}}"] = v
    for k, v in paths(grads).items():
        out[f"g_{{arch}}_{{k}}"] = v

# -- two train steps of the reduced smollm-360m (2 microbatches)
cfg = dataclasses.replace(M.reduced(M.get("smollm-360m")), compute_dtype="float32")
params = M.init_params(jax.random.key(0), cfg)
opt = adamw_init(params)
stream = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, **{data}), cfg)
step_fn = jax.jit(train_step_fn(cfg, TrainConfig(**{tcfg})))
meta["steps"] = []
for i in range({steps}):
    params, opt, m = step_fn(params, opt, stream.batch(i), jnp.asarray(i))
    meta["steps"].append({{k: float(v) for k, v in m.items()}})
for k, v in paths(params).items():
    out[f"step_{{k}}"] = v

# -- the schedule
meta["lrs"] = [float(linear_warmup_cosine(jnp.asarray(s), base_lr=1.0,
                                          warmup_steps=10, total_steps=100))
               for s in range(100)]

# -- AdamW on a crafted tree: stacked layer leaves, a top-level norm
rng = np.random.default_rng(9)
tree = {{"w": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal((4,)).astype(np.float32),
         "final_norm": rng.standard_normal((4,)).astype(np.float32),
         "layers": {{"ln1": rng.standard_normal((2, 4)).astype(np.float32),
                     "wq": rng.standard_normal((2, 4, 3)).astype(np.float32)}}}}
grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 3).astype(np.float32), tree)
acfg = AdamWConfig(weight_decay=0.5, clip_norm=1.0)
state = adamw_init(tree, acfg)
p = tree
for i in range(2):
    p, state, am = adamw_update(grads, state, p, jnp.float32(0.1), acfg)
for k, v in paths(tree).items():
    out[f"adam_in_{{k}}"] = v
for k, v in paths(grads).items():
    out[f"adam_g_{{k}}"] = v
for k, v in paths(p).items():
    out[f"adam_out_{{k}}"] = v
for k, v in paths(state["mu"]).items():
    out[f"adam_mu_{{k}}"] = v
meta["adam_gnorm"] = float(am["grad_norm"])

# -- int8 codes: crafted halves (scale 1: x / scale on .5 exactly) and seeds
xs = {{"halves": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -127.0, 0.0],
                         np.float32),
       "zeros": np.zeros(7, np.float32),
       "tiny": np.array([1e-13, -3e-13, 0.0], np.float32)}}
for seed in range(4):
    xs[f"seed{{seed}}"] = (np.random.default_rng(seed).standard_normal((33, 17))
                          * 10.0 ** (seed - 2)).astype(np.float32)
for name, x in xs.items():
    q, scale = quantize_int8(jnp.asarray(x))
    out[f"q_x_{{name}}"], out[f"q_q_{{name}}"] = x, np.asarray(q)
    out[f"q_s_{{name}}"] = np.asarray(scale)
rng = np.random.default_rng(1)
residual = {{"a": np.zeros((16,), np.float32), "b": np.zeros((4, 5), np.float32)}}
for i in range(5):
    g = {{"a": (rng.standard_normal(16) * 0.01).astype(np.float32),
          "b": rng.standard_normal((4, 5)).astype(np.float32)}}
    dq, residual = error_feedback_compress(g, residual)
    for k in g:
        out[f"ef_g{{i}}_{{k}}"] = g[k]
        out[f"ef_dq{{i}}_{{k}}"] = np.asarray(dq[k])
        out[f"ef_r{{i}}_{{k}}"] = np.asarray(residual[k])

# -- the reductions inside shard_map on an 8-way data mesh
mesh = Mesh(np.array(jax.devices()), ("data",))
x = np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32)
fs = jax.jit(shard_map(lambda v: compressed_psum(v, "data"), mesh=mesh,
                       in_specs=P("data"), out_specs=P("data")))
out["psum_x"], out["psum"] = x, np.asarray(fs(jnp.asarray(x)))[0]
def lin_loss(w, batch):
    return jnp.mean((batch["x"] @ w - batch["y"]) ** 2)
rng = np.random.default_rng(0)
w = rng.standard_normal((16, 1)).astype(np.float32)
bx = rng.standard_normal((32, 16)).astype(np.float32)
by = rng.standard_normal((32, 1)).astype(np.float32)
gs = jax.jit(shard_map(dp_grads_compressed(lin_loss, axis="data"), mesh=mesh,
    in_specs=(P(), {{"x": P("data"), "y": P("data")}}), out_specs=(P(), P())))
loss_c, g_c = gs(w, {{"x": bx, "y": by}})
out.update(dp_w=w, dp_x=bx, dp_y=by, dp_g=np.asarray(g_c))
meta["dp_loss"] = float(loss_c)

# -- input specs of every full configuration
meta["specs"] = {{
    f"{{arch}}/{{mode}}": {{k: [list(v.shape), str(v.dtype)] for k, v in
                            input_specs(M.get(arch), mode=mode, batch=4,
                                        seq=300).items()}}
    for arch in {archs} for mode in ("train", "prefill", "decode")}}
np.savez({path!r}, **out)
with open({meta_path!r}, "w") as f:
    json.dump(meta, f)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("train_ref")
    path, meta_path = str(d / "ref.npz"), str(d / "meta.json")
    subproc(_REFERENCE_CODE.format(archs=ARCHS, b=B, s=S, data=STEP_DATA,
                                   tcfg=STEP_TCFG, steps=STEPS, path=path,
                                   meta_path=meta_path),
            devices=8, x64=False, timeout=900)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    with open(meta_path) as f:
        return arrays, json.load(f)


def _tree(arrays, prefix):
    """The reference's leaves named ``prefix + path`` as a nested dict."""
    tree = {}
    for name, arr in arrays.items():
        if name.startswith(prefix):
            node = tree
            *parents, leaf = name[len(prefix):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arr
    return tree


def _f32(arch):
    return dataclasses.replace(T.reduced(T.get(arch)),
                               compute_dtype="float32")


def _model(cfg, tree):
    model = T.Transformer(cfg, device="meta")
    model.load_state_dict(convert.model_params_from_numpy(tree, cfg),
                          assign=True)
    return model


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# -- loss_fn and gradients against jax.value_and_grad --------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(reference, arch):
    r, meta = reference
    cfg = _f32(arch)
    model = _model(cfg, _tree(r, f"w_{arch}_"))
    batch = {k[len(f"b_{arch}_"):]: torch.from_numpy(v)
             for k, v in r.items() if k.startswith(f"b_{arch}_")}
    loss, grads = grads_with_microbatching(cfg, TRAIN_CALL, 1)(model, batch)
    with torch.no_grad():
        _, parts = T.loss_fn(model, cfg, batch, TRAIN_CALL)
    want_loss, want_nll, want_aux = meta[f"loss_{arch}"]
    np.testing.assert_allclose(float(loss), want_loss, **TOL)
    np.testing.assert_allclose(float(parts["nll"]), want_nll, **TOL)
    np.testing.assert_allclose(float(parts["aux"]), want_aux, **TOL)
    got = convert.model_params_to_numpy(grads, cfg)
    want = _tree(r, f"g_{arch}_")
    flat_got, flat_want = _flat(got), _flat(want)
    assert set(flat_got) == set(flat_want)
    for path, g in flat_got.items():
        np.testing.assert_allclose(g, flat_want[path], **TOL, err_msg=path)


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-lite-16b",
                                  "falcon-mamba-7b", "zamba2-2.7b",
                                  "paligemma-3b"])
def test_remat_gives_the_same_gradients(arch):
    cfg = _f32(arch)
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(2),
                          device="cpu")
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.frontend:
        batch["patches"] = rng.standard_normal(
            (B, cfg.frontend.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    out, saved = {}, {}
    for remat in (True, False):
        call = dataclasses.replace(TRAIN_CALL, remat=remat)
        out[remat] = grads_with_microbatching(cfg, call, 1)(model, batch)
        # what autograd keeps for the backward outside recomputed layers
        kept = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: kept.append(t.numel() * t.element_size()) or t,
                lambda t: t):
            T.loss_fn(model, cfg, batch, call)
        saved[remat] = sum(kept)
    assert saved[True] < 0.5 * saved[False], saved
    assert float(out[True][0]) == float(out[False][0])
    for name, g in out[True][1].items():
        torch.testing.assert_close(g, out[False][1][name], rtol=1e-6,
                                   atol=1e-7, msg=name)


# -- the train step against the reference's ------------------------------------------


def test_train_steps_match_reference(reference):
    r, meta = reference
    cfg = _f32("smollm-360m")
    model = _model(cfg, _tree(r, "w_smollm-360m_"))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = adamw_init(model)
    stream = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size,
                                        **STEP_DATA), cfg)
    tcfg = TrainConfig(**STEP_TCFG)
    step = train_step_fn(cfg, tcfg)
    for i, want in enumerate(meta["steps"]):
        _, opt, m = step(model, opt, stream.batch(i), i)
        got = {k: float(v) for k, v in m.items()}
        assert set(got) == set(want) == {"loss", "lr", "grad_norm",
                                         "arrivals"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    assert int(opt["count"]) == STEPS
    bound = 2 * tcfg.base_lr * STEPS
    flat = _flat(convert.model_params_to_numpy(model, cfg))
    want = _flat(_tree(r, "step_"))
    moved = _flat(convert.model_params_to_numpy(start, cfg))
    assert set(flat) == set(want)
    for path, got in flat.items():
        name = path
        assert _rel_l2(got, want[path]) <= 1e-4, name
        assert np.max(np.abs(got - want[path])) <= bound, name
        assert np.any(got != moved[path]), f"{name} did not move"


def test_train_config_is_the_references_on_the_plain_paths():
    tcfg = TrainConfig()
    assert (tcfg.base_lr, tcfg.warmup_steps, tcfg.total_steps,
            tcfg.microbatches) == (3e-4, 100, 1000, 1)
    assert tcfg.adamw == AdamWConfig()
    assert (tcfg.call.attn_impl, tcfg.call.ssm_impl, tcfg.call.remat,
            tcfg.call.moe_no_drop) == ("plain", "plain", True, False)


def test_build_train_step_specs_and_device():
    cfg = T.reduced(T.get("smollm-360m"))
    bs = input_specs(cfg, mode="train", batch=8, seq=16)
    step, pspecs, ospecs, bspecs = build_train_step(cfg, TrainConfig(), bs,
                                                    device="cpu")
    assert bspecs == {"tokens": (), "labels": ()}       # 1 x 1 mesh
    assert ospecs["mu"] is pspecs and ospecs["count"] == ()
    assert set(pspecs) == {"embed", "final_norm", "layers"}
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    opt = adamw_init(model)
    batch = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size,
                                       batch_size=4, seq_len=16)).batch(0)
    with pytest.raises(ValueError, match="batch shapes"):
        step(model, opt, batch, 0)


def test_build_train_step_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = T.reduced(T.get("smollm-360m"))
    bs = input_specs(cfg, mode="train", batch=8, seq=16)
    with pytest.raises(RuntimeError, match="CUDA device"):
        build_train_step(cfg, TrainConfig(), bs)


# -- optimizer (tests/test_substrate.py) ---------------------------------------------


def test_adamw_against_naive_reference():
    """One AdamW step vs a hand-written scalar reference."""
    cfg = AdamWConfig(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                      clip_norm=0)
    w0 = np.array([[1.0, -2.0], [0.5, 3.0]], np.float32)
    gw = np.array([[0.1, -0.2], [0.3, 0.4]], np.float32)
    p = {"w": torch.from_numpy(w0.copy())}
    state = adamw_init(p, cfg)
    adamw_update({"w": torch.from_numpy(gw)}, state, p, 0.01, cfg)
    m, v = 0.1 * gw, 0.001 * gw ** 2
    want = w0 - 0.01 * (m / 0.1) / (np.sqrt(v / 0.001) + 1e-8)
    np.testing.assert_allclose(p["w"].numpy(), want, rtol=1e-5)


def test_adamw_weight_decay_matrices_only():
    cfg = AdamWConfig(weight_decay=0.1, clip_norm=0)
    p = {"w": torch.ones((2, 2)), "b": torch.ones((2,))}
    g = {"w": torch.zeros((2, 2)), "b": torch.zeros((2,))}
    adamw_update(g, adamw_init(p, cfg), p, 0.1, cfg)
    assert float(p["w"][0, 0]) < 1.0      # decayed
    assert float(p["b"][0]) == 1.0        # biases not decayed


def test_adamw_decays_by_the_references_stacked_rank(reference):
    """A per-layer (d,) norm is the reference's stacked (L, d) leaf, so it
    is decayed; a top-level (d,) one is not: the crafted tree through both
    packages, two steps with clipping."""
    r, meta = reference
    cfg = AdamWConfig(weight_decay=0.5, clip_norm=1.0)
    tree, grads = _tree(r, "adam_in_"), _tree(r, "adam_g_")

    def port(t):
        out = {k: torch.from_numpy(np.array(v)) for k, v in t.items()
               if k != "layers"}
        for k, v in t["layers"].items():
            for i in range(v.shape[0]):
                out[f"layers.{i}.{k}"] = torch.from_numpy(np.array(v[i]))
        return out

    p, g = port(tree), port(grads)
    assert {n: decays(n, t) for n, t in p.items()} == {
        "w": True, "b": False, "final_norm": False, "layers.0.ln1": True,
        "layers.1.ln1": True, "layers.0.wq": True, "layers.1.wq": True}
    state = adamw_init(p, cfg)
    for _ in range(2):
        _, state, am = adamw_update(g, state, p, 0.1, cfg)
    np.testing.assert_allclose(float(am["grad_norm"]), meta["adam_gnorm"],
                               rtol=1e-6)
    for name, want in (("out", port(_tree(r, "adam_out_"))),
                       ("mu", port(_tree(r, "adam_mu_")))):
        got = p if name == "out" else state["mu"]
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{name} {k}")


def test_grad_clipping():
    cfg = AdamWConfig(clip_norm=1.0)
    p = {"w": torch.zeros((4,))}
    g = {"w": torch.full((4,), 100.0)}
    _, _, metrics = adamw_update(g, adamw_init(p, cfg), p, 0.0, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    assert float(global_norm([torch.full((4,), 100.0)])) == 200.0


def test_schedule_shape(reference):
    _, meta = reference
    lrs = [float(linear_warmup_cosine(s, base_lr=1.0, warmup_steps=10,
                                      total_steps=100)) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1.0          # warmup rises
    assert lrs[10] == pytest.approx(max(lrs), rel=0.05)
    assert lrs[-1] < 0.2                   # cosine decays
    np.testing.assert_allclose(lrs, meta["lrs"], rtol=1e-6)
    on_device = linear_warmup_cosine(torch.tensor(3), base_lr=1.0,
                                     warmup_steps=10, total_steps=100)
    assert on_device.dtype == torch.float32 and on_device.ndim == 0


def test_microbatch_equivalence():
    """grads(mb=1) == grads(mb=4) on the same global batch."""
    cfg = T.reduced(T.get("smollm-360m"))
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (8, 32)).astype(
        np.int32), "labels": rng.integers(0, cfg.vocab_size, (8, 32)).astype(
            np.int32)}
    l1, g1 = grads_with_microbatching(cfg, TRAIN_CALL, 1)(model, batch)
    l4, g4 = grads_with_microbatching(cfg, TRAIN_CALL, 4)(model, batch)
    assert float(l1) == pytest.approx(float(l4), rel=1e-4)
    assert set(g1) == set(g4)
    for name in g1:
        assert g4[name].dtype == torch.float32
        # bf16 accumulation-order noise (the reference's bar)
        np.testing.assert_allclose(g1[name].float().numpy(),
                                   g4[name].numpy(), rtol=2e-3, atol=1.5e-3,
                                   err_msg=name)


# -- compression ---------------------------------------------------------------------


@given(st.integers(0, 10))
@settings(max_examples=20, deadline=None)
def test_quantize_roundtrip_error_bound(seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        512).astype(np.float32))
    q, scale = quantize_int8(x)
    err = torch.abs(dequantize_int8(q, scale) - x)
    assert float(err.max()) <= float(scale) * 0.5 + 1e-7


def test_error_feedback_reduces_bias():
    rng = np.random.default_rng(0)
    grads = [{"w": torch.from_numpy((rng.standard_normal(256) * 0.01)
                                    .astype(np.float32))} for _ in range(50)]
    residual = init_residual(grads[0])
    acc_c, acc_t = np.zeros(256), np.zeros(256)
    for g in grads:
        dq, residual = error_feedback_compress(g, residual)
        acc_c += dq["w"].numpy()
        acc_t += g["w"].numpy()
    _, scale = quantize_int8(torch.from_numpy(acc_t.astype(np.float32)))
    assert np.abs(acc_c - acc_t).max() < 5 * float(scale)


def test_int8_codes_match_the_reference_bit_for_bit(reference):
    r, _ = reference
    names = [k[len("q_x_"):] for k in r if k.startswith("q_x_")]
    assert "halves" in names and len(names) == 7
    for name in names:
        q, scale = quantize_int8(torch.from_numpy(r[f"q_x_{name}"]))
        assert q.dtype == torch.int8 and scale.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), r[f"q_q_{name}"], name)
        assert scale.numpy().tobytes() == r[f"q_s_{name}"].tobytes(), name
    # round half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 3.5 -> 4
    np.testing.assert_array_equal(r["q_q_halves"],
                                  [127, 0, 2, 2, 0, -2, 4, -127, 0])
    residual = init_residual({"a": torch.zeros(16), "b": torch.zeros(4, 5)})
    for i in range(5):
        g = {k: torch.from_numpy(r[f"ef_g{i}_{k}"]) for k in ("a", "b")}
        dq, residual = error_feedback_compress(g, residual)
        for k in g:
            assert dq[k].numpy().tobytes() == r[f"ef_dq{i}_{k}"].tobytes()
            assert (residual[k].numpy().tobytes()
                    == r[f"ef_r{i}_{k}"].tobytes())


def test_compressed_psum_on_a_logical_data_axis(reference):
    r, _ = reference
    x = torch.from_numpy(r["psum_x"])
    got = compressed_psum(x)
    np.testing.assert_allclose(got.numpy(), r["psum"], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(compressed_psum(list(x)), got, rtol=0, atol=0)
    want = x.sum(dim=0)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < 0.05, rel


def test_dp_grads_compressed_close_to_exact(reference):
    r, meta = reference

    def loss(w, batch):
        return torch.mean((batch["x"] @ w - batch["y"]) ** 2)

    w = torch.from_numpy(r["dp_w"])
    x, y = torch.from_numpy(r["dp_x"]), torch.from_numpy(r["dp_y"])
    shards = [{"x": x[i * 4:(i + 1) * 4], "y": y[i * 4:(i + 1) * 4]}
              for i in range(8)]
    loss_c, g_c = dp_grads_compressed(loss)(w, shards)
    np.testing.assert_allclose(g_c.numpy(), r["dp_g"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss_c), meta["dp_loss"], rtol=1e-6)
    wg = w.clone().requires_grad_(True)
    loss_e = loss(wg, {"x": x, "y": y})
    (g_e,) = torch.autograd.grad(loss_e, [wg])
    rel = float((g_c - g_e).abs().max() / (g_e.abs().max() + 1e-9))
    assert rel < 0.05, rel
    assert abs(float(loss_c) - float(loss_e)) < 1e-5
    named = dp_grads_compressed(lambda p, b: loss(p["w"], b))
    _, g_named = named({"w": w}, shards)
    torch.testing.assert_close(g_named["w"], g_c, rtol=0, atol=0)


# -- the train half of tests/test_models_smoke.py ------------------------------------


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend and cfg.frontend.kind == "vision_stub":
        out["patches"] = rng.standard_normal(
            (b, cfg.frontend.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_step(arch):
    cfg = T.reduced(T.get(arch))
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    batch = _batch(cfg)
    logits, aux = T.forward(model, cfg, batch, TRAIN_CALL)
    seq_total = S + prefix_tokens(cfg)
    assert logits.shape == (B, seq_total, cfg.vocab_size)
    assert bool(torch.all(torch.isfinite(logits)))
    loss, grads = grads_with_microbatching(cfg, TRAIN_CALL, 1)(model, batch)
    gn = global_norm(grads)
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(gn))
    assert 0.0 < float(loss) < 20.0
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = adamw_init(model)
    _, opt, m = train_step_fn(cfg, TrainConfig(base_lr=1e-3,
                                               warmup_steps=1))(
        model, opt, batch, 0)
    assert float(m["loss"]) == float(loss) and int(opt["count"]) == 1
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert any(not torch.equal(before[n], p)
               for n, p in model.named_parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_cover_model_inputs(reference, arch):
    """input_specs() provides a meta stand-in for every input forward()
    needs, the reference's shapes and dtypes."""
    _, meta = reference
    cfg = T.get(arch)
    for mode in ("train", "prefill", "decode"):
        specs = input_specs(cfg, mode=mode, batch=4, seq=300)
        assert "tokens" in specs
        if mode == "train":
            assert "labels" in specs
        if (cfg.frontend and cfg.frontend.kind == "vision_stub"
                and mode != "decode"):
            assert "patches" in specs
        assert all(t.device.type == "meta" for t in specs.values())
        got = {k: [list(t.shape), str(t.dtype).replace("torch.", "")]
               for k, t in specs.items()}
        assert got == meta["specs"][f"{arch}/{mode}"], mode


# -- the grad guard ------------------------------------------------------------------


def _wrapper_calls():
    f32 = dict(dtype=torch.float32)
    return {
        "axpy": lambda g: axpy.axpy(torch.ones(8, **f32).requires_grad_(g),
                                    torch.ones(8, **f32), 2.0),
        "matmul": lambda g: matmul.matmul(
            torch.ones(4, 4, **f32).requires_grad_(g), torch.ones(4, 4, **f32)),
        "atax": lambda g: atax.atax(torch.ones(4, 4, **f32),
                                    torch.ones(4, **f32).requires_grad_(g)),
        "covariance": lambda g: covariance.covariance(
            torch.ones(4, 8, **f32).requires_grad_(g)),
        "flash_attention": lambda g: flash.flash_attention(
            torch.ones(1, 2, 4, 32, **f32), torch.ones(1, 1, 4, 32, **f32),
            torch.ones(1, 1, 4, 32, **f32).requires_grad_(g)),
        "qk_tile": lambda g: flash.qk_tile(
            torch.ones(64, 64, dtype=torch.bfloat16).requires_grad_(g),
            torch.ones(64, 64, dtype=torch.bfloat16)),
        "ssm_scan": lambda g: ssm_scan.ssm_scan(
            torch.ones(1, 2, 3, 8, **f32), torch.ones(1, 2, 3, 8, **f32),
            torch.ones(1, 2, 8, **f32),
            h0=torch.zeros(1, 3, 8, **f32).requires_grad_(g)),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_grad_guard_every_wrapper(name):
    """Each wrapper refuses an input that requires grad under autograd,
    before its device check; without grad the device check speaks."""
    call = _wrapper_calls()[name]
    with pytest.raises(RuntimeError, match="no backward pass") as e:
        call(True)
    assert build.BACKWARD in str(e.value) and name in str(e.value)
    with pytest.raises(ValueError, match="CUDA"):
        call(False)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        call(True)


@pytest.mark.parametrize("arch", ["smollm-360m", "falcon-mamba-7b"])
def test_grad_guard_through_the_model(monkeypatch, arch):
    """On CUDA tensors "auto" picks the kernels; under autograd the forward
    then raises instead of dropping the gradient.  The CPU stands in for the
    card here: the resolvers answer as they do for a CUDA tensor."""
    monkeypatch.setattr(ops, "_resolve", lambda impl, t: "kernel")
    monkeypatch.setattr(attn, "resolve_impl",
                        lambda impl, q, k=None, v=None, prefix_len=0:
                        "kernel")
    monkeypatch.setattr(ssm_lib, "resolve_impl", lambda impl, t: "kernel")
    cfg = T.reduced(T.get(arch))
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    model.requires_grad_(True)
    auto = T.CallConfig(attn_impl="auto", ssm_impl="auto")
    with pytest.raises(RuntimeError, match="no backward pass"):
        T.loss_fn(model, cfg, _batch(cfg), auto)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        T.forward(model, cfg, _batch(cfg), auto)
