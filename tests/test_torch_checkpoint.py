"""Checkpoints, resume and elastic restore of the port, and checkpoints
crossing between the packages, on the CPU.

The port trains the reduced smollm-360m (float32 compute, 2 microbatches,
a logical 4 x 2 ``("data", "model")`` mesh) for 3 steps and writes a
checkpoint.  Then one subprocess (``run_subprocess``, 8 devices, 32-bit)
runs the reference: ``tests/test_checkpoint.py``'s run on a real 4 x 2
mesh, its checkpoint after 4 steps and the loss of its next step; the
port's checkpoint restored and stepped; and the specs ``param_specs``,
``batch_specs`` and ``cache_specs`` give every full configuration on the
4 x 2 mesh.  The port then restores the reference's checkpoint and steps.

Bars: the next step's loss after crossing, either way, at rtol = atol =
1e-4 (float32 compute in two packages); specs and manifests exactly; the
port's own resume bit for bit; the elastic restore bit-identical.  The
rest mirrors ``tests/test_checkpoint.py`` and ``tests/test_elastic.py``,
and holds ``convert``'s round trip of parameters and AdamW state.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch import models as T
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.data import DataConfig, SyntheticStream, input_specs
from repro_torch.dist import (
    LogicalMesh, batch_specs, cache_specs, param_specs,
)
from repro_torch.ft.elastic import elastic_restore, make_data_mesh
from repro_torch.optim import adamw_init
from repro_torch.train import TrainConfig, build_train_step

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = sorted(T.ARCHS)
MESH = LogicalMesh(("data", "model"), (4, 2))
DATA = dict(batch_size=8, seq_len=32, seed=7)
TCFG = dict(total_steps=20, warmup_steps=2, base_lr=1e-3, microbatches=2)
PORT_SAVE = 3
CACHE = dict(batch=8, max_len=64)

_REFERENCE_CODE = '''
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro import models as M
from repro.train import TrainConfig, build_train_step
from repro.optim.adamw import adamw_init
from repro.data import DataConfig, SyntheticStream
from repro.dist.sharding import batch_specs, cache_specs, param_specs, to_shardings
from repro.checkpoint import save, restore
from repro.checkpoint.store import _spec_to_json

meta = {{}}
cfg = dataclasses.replace(M.reduced(M.get("smollm-360m")), compute_dtype="float32")
mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
stream = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, **{data}), cfg)
bs = {{k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in stream.batch(0).items()}}
step_fn, pspecs, ospecs, bspecs = build_train_step(cfg, mesh, TrainConfig(**{tcfg}), bs)
specs = {{"params": pspecs, "opt": ospecs}}
params = jax.device_put(M.init_params(jax.random.key(0), cfg), to_shardings(pspecs, mesh))
opt = jax.device_put(adamw_init(params), to_shardings(ospecs, mesh))
def put(i):
    return jax.device_put(stream.batch(i), to_shardings(bspecs, mesh))
for i in range(4):
    params, opt, m = step_fn(params, opt, put(i), jnp.asarray(i))
save({ref_dir!r}, 4, {{"params": params, "opt": opt}}, specs, data_index=4)
_, _, m = step_fn(params, opt, put(4), jnp.asarray(4))
meta["ref_next_loss"] = float(m["loss"])

st, di, state = restore({port_dir!r}, mesh, specs)
meta["port_ckpt"] = [st, di]
_, _, m = step_fn(state["params"], state["opt"], put(di), jnp.asarray(di))
meta["loss_on_port_ckpt"] = float(m["loss"])

def as_json(tree):
    return jax.tree.map(_spec_to_json, tree, is_leaf=lambda x: isinstance(x, P))

key = jax.eval_shape(lambda: jax.random.key(0))
meta["specs"] = {{}}
for arch in {archs}:
    c = M.get(arch)
    shapes = jax.eval_shape(lambda k: M.init_params(k, c),
                            jax.ShapeDtypeStruct(key.shape, key.dtype))
    caches = jax.eval_shape(lambda: M.init_cache(c, {cache[batch]}, {cache[max_len]}))
    meta["specs"][arch] = {{"params": as_json(param_specs(shapes, mesh)),
                           "cache": as_json(cache_specs(caches, mesh))}}
meta["batch_specs"] = as_json(batch_specs(bs, mesh))
pod = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"))
meta["pod_specs"] = {{"batch": as_json(batch_specs(bs, pod)),
                     "cache": as_json(cache_specs(jax.eval_shape(
                         lambda: M.init_cache(cfg, 8, 16)), pod))}}
with open({meta_path!r}, "w") as f:
    json.dump(meta, f)
'''


def _cfg():
    return dataclasses.replace(T.reduced(T.get("smollm-360m")),
                               compute_dtype="float32")


def _setup(cfg, mesh=MESH):
    stream = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, **DATA),
                             cfg)
    bs = input_specs(cfg, mode="train", batch=DATA["batch_size"],
                     seq=DATA["seq_len"])
    step, pspecs, ospecs, _ = build_train_step(cfg, TrainConfig(**TCFG), bs,
                                               mesh=mesh, device="cpu")
    return stream, step, {"params": pspecs, "opt": ospecs}


def _state(model, opt, cfg):
    return {"params": convert.model_params_to_numpy(model, cfg),
            "opt": convert.adamw_state_to_numpy(opt, cfg)}


def _load(state, cfg):
    """A model and AdamW state from a restored checkpoint's state."""
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(convert.model_params_from_numpy(state["params"],
                                                          cfg))
    return model, convert.adamw_state_from_numpy(state["opt"], cfg)


@pytest.fixture(scope="module")
def crossed(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("ckpt_cross")
    port_dir, ref_dir = str(d / "port"), str(d / "ref")
    cfg = _cfg()
    stream, step, specs = _setup(cfg)
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(3),
                          device="cpu")
    opt = adamw_init(model)
    for i in range(PORT_SAVE):
        _, opt, _ = step(model, opt, stream.batch(i), i)
    save(port_dir, PORT_SAVE, _state(model, opt, cfg), specs,
         data_index=PORT_SAVE)
    _, _, m = step(model, opt, stream.batch(PORT_SAVE), PORT_SAVE)
    meta_path = str(d / "meta.json")
    subproc(_REFERENCE_CODE.format(data=DATA, tcfg=TCFG, archs=ARCHS,
                                   cache=CACHE, ref_dir=ref_dir,
                                   port_dir=port_dir, meta_path=meta_path),
            devices=8, x64=False, timeout=900)
    with open(meta_path) as f:
        meta = json.load(f)
    return {"port_dir": port_dir, "ref_dir": ref_dir, "meta": meta,
            "port_next_loss": float(m["loss"]), "specs": specs}


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)


# -- across the packages --------------------------------------------------------------


def test_reference_checkpoint_restores_in_the_port(crossed):
    cfg = _cfg()
    stream, step, specs = _setup(cfg)
    st, di, state = restore(crossed["ref_dir"], MESH, specs, device="cpu")
    assert (st, di) == (4, 4)
    model, opt = _load(state, cfg)
    assert int(opt["count"]) == 4
    _, _, m = step(model, opt, stream.batch(di), di)
    np.testing.assert_allclose(float(m["loss"]),
                               crossed["meta"]["ref_next_loss"], **TOL)


def test_port_checkpoint_restores_in_the_reference(crossed):
    meta = crossed["meta"]
    assert meta["port_ckpt"] == [PORT_SAVE, PORT_SAVE]
    np.testing.assert_allclose(meta["loss_on_port_ckpt"],
                               crossed["port_next_loss"], **TOL)


def test_manifests_agree(crossed):
    """The same run's checkpoint in both packages: the same groups, leaf
    names, shapes, dtypes and specs."""
    ref = _manifest(crossed["ref_dir"], 4)
    port = _manifest(crossed["port_dir"], PORT_SAVE)
    assert set(ref) == set(port) == {"step", "data_index", "groups", "specs"}
    assert port["groups"] == ref["groups"]
    assert port["specs"] == ref["specs"]
    assert port["groups"]["opt"]["count"] == {"shape": [], "dtype": "int32"}
    files = sorted(os.listdir(os.path.join(crossed["port_dir"],
                                           f"step_{PORT_SAVE:08d}")))
    assert files == ["manifest.json", "opt.npz", "params.npz"]


def _json(tree):
    if isinstance(tree, dict):
        return {k: _json(v) for k, v in tree.items()}
    return [list(d) if isinstance(d, tuple) else d for d in tree]


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_references(crossed, arch):
    """Over the reference's stacked tree, on a 4 x 2 mesh, every full
    configuration: the parameters' specs, the caches' and (once) the
    batch's."""
    want = crossed["meta"]["specs"][arch]
    cfg = T.get(arch)
    assert _json(param_specs(convert.reference_shapes(cfg), MESH)) == \
        want["params"]
    cache = T.init_cache(cfg, CACHE["batch"], CACHE["max_len"],
                         device="meta")
    assert _json(cache_specs(cache, MESH)) == want["cache"]
    bs = input_specs(_cfg(), mode="train", batch=DATA["batch_size"],
                     seq=DATA["seq_len"])
    assert _json(batch_specs(bs, MESH)) == crossed["meta"]["batch_specs"]
    pod = LogicalMesh(("pod", "data", "model"), (2, 2, 2))
    assert _json(batch_specs(bs, pod)) == crossed["meta"]["pod_specs"][
        "batch"]
    assert _json(cache_specs(T.init_cache(_cfg(), 8, 16, device="meta"),
                             pod)) == crossed["meta"]["pod_specs"]["cache"]


def test_specs_read_the_stacked_tree():
    """A per-layer (d,) norm is the reference's (L, d): it shards over the
    model axis; the port's own (d,) would replicate."""
    cfg = T.get("smollm-360m")
    specs = param_specs(convert.reference_shapes(cfg), MESH)
    assert specs["layers"]["ln1"] == (None, "model")
    assert specs["final_norm"] == ()
    assert specs["layers"]["attn"]["wq"] == (None, None, "model")
    per_layer = dict(T.Transformer(cfg, device="meta").named_parameters())
    assert param_specs({"ln1": per_layer["layers.0.ln1"]}, MESH) == {
        "ln1": ()}


# -- the port alone (tests/test_checkpoint.py, tests/test_elastic.py) --------------------


def test_bitwise_resume_and_elastic(tmp_path):
    cfg = T.reduced(T.get("smollm-360m"))
    stream, step, specs = _setup(cfg)
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    opt = adamw_init(model)
    for i in range(4):
        _, opt, m = step(model, opt, stream.batch(i), i)
    d = str(tmp_path)
    save(d, 4, _state(model, opt, cfg), specs, data_index=4)
    assert latest_step(d) == 4
    for i in range(4, 6):                     # continue 2 steps
        _, opt, m = step(model, opt, stream.batch(i), i)
    ref = float(m["loss"])
    # simulated failure: restore and replay -> bitwise identical
    st, di, state = restore(d, MESH, specs, device="cpu")
    assert (st, di) == (4, 4)
    model2, opt2 = _load(state, cfg)
    for i in range(di, 6):
        _, opt2, m2 = step(model2, opt2, stream.batch(i), i)
    assert float(m2["loss"]) == ref
    for (n, p), p2 in zip(model.named_parameters(), model2.parameters()):
        assert torch.equal(p, p2), n
    # elastic: the same run on 2 surviving data ways
    st, di, state, mesh2 = elastic_restore(d, range(2),
                                           convert.reference_shapes(cfg),
                                           device="cpu")
    assert mesh2.shape == {"data": 2}
    stream2, step2, _ = _setup(cfg, mesh2)
    model3, opt3 = _load(state, cfg)
    _, _, m3 = step2(model3, opt3, stream2.batch(di), di)
    assert np.isfinite(float(m3["loss"]))


def test_retention_gc(tmp_path):
    state = {"params": {"w": np.arange(4.0)}}
    for step in (1, 2, 3, 4, 5):
        save(str(tmp_path), step, state, keep=2, data_index=step)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000004", "step_00000005"]
    st, di, got = restore(str(tmp_path), device="cpu")
    assert st == 5 and di == 5
    np.testing.assert_array_equal(got["params"]["w"].numpy(), np.arange(4.0))
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "none"), device="cpu")


def test_make_data_mesh_defaults_to_one_way():
    mesh = make_data_mesh()
    assert mesh.axis_names == ("data",) and mesh.size == 1
    assert make_data_mesh(range(8)).shape == {"data": 8}


def test_elastic_restore_shrunken_mesh_bit_identical(tmp_path):
    cfg = T.reduced(T.get("smollm-360m"))
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    opt = adamw_init(model)
    written = _state(model, opt, cfg)
    mesh8 = make_data_mesh(range(8))
    pspecs = param_specs(convert.reference_shapes(cfg), mesh8)
    specs = {"params": pspecs, "opt": {"mu": pspecs, "nu": pspecs,
                                       "count": ()}}
    d = str(tmp_path)
    save(d, 3, written, specs, data_index=12)
    assert latest_step(d) == 3
    # half the machine is gone: restore on the 2 survivors
    step, data_index, state, mesh2 = elastic_restore(
        d, range(2), convert.reference_shapes(cfg), device="cpu")
    assert (step, data_index) == (3, 12)
    assert mesh2.size == 2 and mesh2.axis_names == ("data",)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                       else {prefix + k: v})
        return out

    got, want = flat(state), flat(written)
    assert set(got) == set(want)
    for k in want:
        assert got[k].device.type == "cpu"
        assert got[k].numpy().dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], k)


def test_restore_checks_the_specs_against_the_mesh(tmp_path):
    save(str(tmp_path), 1, {"params": {"w": np.zeros((6, 4))}})
    ok = {"params": {"w": (None, "model")}}
    restore(str(tmp_path), LogicalMesh(("model",), (2,)), ok, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        restore(str(tmp_path), LogicalMesh(("model",), (8,)), ok,
                device="cpu")
    with pytest.raises(ValueError, match="no axis"):
        restore(str(tmp_path), LogicalMesh(("data",), (2,)), ok,
                device="cpu")


def test_restore_defaults_to_the_card(tmp_path, monkeypatch):
    save(str(tmp_path), 1, {"params": {"w": np.zeros(2)}})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        restore(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        elastic_restore(str(tmp_path), range(1), {"w": np.zeros(2)})


# -- convert: parameters and AdamW state across, exactly -------------------------------


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-lite-16b",
                                  "zamba2-2.7b"])
def test_convert_round_trip(arch):
    cfg = T.reduced(T.get(arch))
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(1),
                          device="cpu")
    tree = convert.model_params_to_numpy(model, cfg)
    shapes = convert.reference_shapes(cfg)

    def flat(t, prefix=""):
        out = {}
        for k, v in t.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                       else {prefix + k: v})
        return out

    assert {k: tuple(v.shape) for k, v in flat(tree).items()} == {
        k: tuple(v.shape) for k, v in flat(shapes).items()}
    back = convert.model_params_from_numpy(tree, cfg)
    for name, p in model.named_parameters():
        assert torch.equal(back[name], p), name
    opt = adamw_init(model)
    g = torch.Generator().manual_seed(2)
    for d in (opt["mu"], opt["nu"]):
        for t in d.values():
            t.copy_(torch.randn(t.shape, generator=g))
    opt["count"].fill_(7)
    tree = convert.adamw_state_to_numpy(opt, cfg)
    assert tree["count"].dtype == np.int32 and tree["count"].shape == ()
    back = convert.adamw_state_from_numpy(tree, cfg)
    assert int(back["count"]) == 7 and back["count"].dtype == torch.int32
    for part in ("mu", "nu"):
        assert set(back[part]) == set(opt[part])
        for name, t in opt[part].items():
            assert torch.equal(back[part][name], t), (part, name)
    # the port's names and the reference's leaves are checked both ways
    with pytest.raises(ValueError, match="unknown"):
        convert.model_params_to_numpy(dict(model.named_parameters(),
                                           extra=torch.zeros(1)), cfg)
    bad = convert.adamw_state_to_numpy(opt, cfg)
    bad["mu"]["bogus"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unknown parameter"):
        convert.adamw_state_from_numpy(bad, cfg)
    bad = convert.adamw_state_to_numpy(opt, cfg)
    bad["nu"]["embed"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert.adamw_state_from_numpy(bad, cfg)
    bad = convert.adamw_state_to_numpy(opt, cfg)
    del bad["mu"]["final_norm"]
    with pytest.raises(ValueError, match="missing"):
        convert.adamw_state_from_numpy(bad, cfg)
