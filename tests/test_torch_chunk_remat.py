"""``CallConfig.attn_chunk_remat`` — the chunked attention's per-chunk
recompute — on the CPU, against the knob off and against the reference's
``remat_chunk=True``.

Sizes: S 512 against chunk 128 and head dim 32 (the reduced
configurations'), so that the chunks' (B, H, S, chunk) tiles dwarf their
O(S) carries and the knob has a gap to show; f32 compute.

* The knob on against off, for dense GQA (smollm-360m), reduced MLA
  (deepseek-v2-lite-16b) and reduced zamba2-2.7b (whose attention is its
  shared block): the same loss and gradients through a training call
  with layer remat (the chunk checkpoints nested in the layers'), at
  ``test_remat_gives_the_same_gradients``'s bar (loss equal, ``rtol=1e-6,
  atol=1e-7``; ``tests/test_torch_train.py``); the forward bit for bit;
  the bytes that ``saved_tensors_hooks`` sees for the attention block's
  backward (no layer remat there, so the chunks' saves are visible)
  below half; and the peak of live bytes over the block's forward and
  backward, which also holds what the checkpoints keep, lower by at
  least one (B, H, S, chunk) f32 tile for every chunk but one.
* The port with the knob against the reference's ``remat_chunk=True``
  gradients on the same weights (through ``convert``), at the bar
  ``test_loss_and_grads_match_reference`` holds port-vs-reference
  gradients to (``rtol = atol = 1e-4``).  One reference subprocess, one
  device, 32-bit.
* The launch layer: ``default_call`` takes the knob, the three sharding
  knobs still raise, and the dry-run CLI counts smollm-360m's ``train_4k``
  with it.  (``op_cost`` against ``hlo_cost`` with the knob is in
  ``tests/test_torch_dryrun.py``'s parity subprocess.)
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch import models as T
from repro_torch.launch import dryrun
from repro_torch.launch.op_cost import OpCounter
from repro_torch.launch.cells import UNPORTED_CALL_KNOBS, default_call
from repro_torch.models import attention as attn
from repro_torch.models import model as model_lib
from repro_torch.train import TRAIN_CALL, grads_with_microbatching

ARCHS = ["smollm-360m", "deepseek-v2-lite-16b", "zamba2-2.7b"]
B, S, CHUNK = 2, 512, 128
SAME = dict(rtol=1e-6, atol=1e-7)           # tests/test_torch_train.py:306
TOL = dict(rtol=1e-4, atol=1e-4)            # tests/test_torch_train.py:58


def _call(knob: bool):
    """A training call (layer remat on) through the chunked attention."""
    return dataclasses.replace(TRAIN_CALL, attn_impl="chunked",
                               attn_chunk=CHUNK, attn_chunk_remat=knob)


def _f32(arch):
    return dataclasses.replace(T.reduced(T.get(arch)),
                               compute_dtype="float32")


def _batch(cfg, seed=4):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _model(cfg):
    return T.init_params(cfg, generator=torch.Generator().manual_seed(2),
                         device="cpu")


# -- the knob on against off ---------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_knob_gives_the_same_loss_and_gradients(arch):
    cfg = _f32(arch)
    model = _model(cfg)
    batch = _batch(cfg)
    out = {knob: grads_with_microbatching(cfg, _call(knob), 1)(model, batch)
           for knob in (True, False)}
    assert float(out[True][0]) == float(out[False][0])
    assert set(out[True][1]) == set(out[False][1])
    for name, g in out[True][1].items():
        torch.testing.assert_close(g, out[False][1][name], **SAME, msg=name)


def _grad_model_and_input(arch):
    cfg = _f32(arch)
    model = _model(cfg)
    for p in model.parameters():
        p.requires_grad_(True)
    x = torch.randn((B, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    return cfg, model, x, torch.arange(S)[None].expand(B, S)


def _attention_block(arch, cfg, model, x, positions, knob):
    """The model's attention on ``x``: a decoder layer's GQA or MLA
    attention, or zamba2's shared block."""
    call = _call(knob)
    if cfg.family == "hybrid":
        return model_lib.shared_attn_block(x, model.shared_params(), cfg,
                                           positions, call)
    fn = attn.mla_attention if cfg.mla else attn.gqa_attention
    return fn(x, model.layer_params(0)["attn"], cfg, positions,
              impl=call.attn_impl, chunk=call.attn_chunk,
              remat_chunk=call.attn_chunk_remat)


@pytest.mark.parametrize("arch", ARCHS)
def test_knob_keeps_the_forward_and_halves_the_saved_bytes(arch):
    """The hook sees what autograd packs outside the chunk checkpoints;
    what a checkpoint keeps for its recompute (the carry, the scaled q,
    the chunk's K/V) it never sees: the live peak below holds those."""
    cfg, model, x, positions = _grad_model_and_input(arch)
    out, saved = {}, {}
    for knob in (True, False):
        kept = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: kept.append(t.numel() * t.element_size()) or t,
                lambda t: t):
            out[knob] = _attention_block(arch, cfg, model, x, positions, knob)
        saved[knob] = sum(kept)
    with torch.no_grad():
        plain = _attention_block(arch, cfg, model, x, positions, True)
    assert torch.equal(out[True], out[False])
    assert torch.equal(plain, out[False])
    assert saved[True] < 0.5 * saved[False], saved


@pytest.mark.parametrize("arch", ARCHS)
def test_knob_lowers_the_live_peak(arch):
    """The peak of live bytes (``op_cost.OpCounter``: every storage an op
    allocates, from its first output until its last tensor dies, the
    checkpoints' kept inputs and the recompute included) over the
    attention block's forward and backward.  Without the knob every
    chunk's probability tile stays alive for its P.V backward until the
    backward reaches it; with it at most one chunk's tiles are alive at
    once.  So the peak falls by at least one (B, H, S, chunk) f32 tile
    for every chunk but one, and the counted FLOPs rise by the
    recompute."""
    cfg, model, x, positions = _grad_model_and_input(arch)
    peak, flops = {}, {}
    for knob in (True, False):
        counter = OpCounter()
        with counter:
            _attention_block(arch, cfg, model, x, positions,
                             knob).sum().backward()
        peak[knob], flops[knob] = counter.peak, counter.flops
        model.zero_grad(set_to_none=True)
    tile = B * cfg.n_heads * S * CHUNK * 4
    assert peak[False] - peak[True] >= (S // CHUNK - 1) * tile, peak
    assert flops[True] > flops[False], flops


def test_knob_records_nothing_without_grad():
    """Under ``torch.no_grad`` (a prefill) the body runs as it is: no
    checkpoint, the same bits as the knob off."""
    cfg = _f32("smollm-360m")
    model = _model(cfg)
    batch = {"tokens": _batch(cfg)["tokens"]}
    with torch.no_grad():
        got = {knob: model_lib.prefill(model, cfg, batch, S, _call(knob))
               for knob in (True, False)}
    assert torch.equal(got[True][0], got[False][0])
    for name in ("k", "v"):
        assert torch.equal(got[True][1][name], got[False][1][name])


def test_short_last_chunk_is_sliced():
    """A sequence that is not a multiple of the chunk: the last chunk is
    sliced short (not padded), with and without the knob, and the
    gradients agree with the plain attention's."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, 2, 300, 32), generator=g).requires_grad_(True)
               for _ in range(3))
    grads = {}
    for impl, knob in (("plain", False), ("chunked", False),
                       ("chunked", True)):
        o = attn.multihead_attention(q, k, v, impl=impl, chunk=CHUNK,
                                     remat_chunk=knob)
        grads[impl, knob] = torch.autograd.grad(o.square().sum(), (q, k, v))
    for a, b in zip(grads["chunked", True], grads["chunked", False]):
        assert torch.equal(a, b)
    for a, b in zip(grads["chunked", True], grads["plain", False]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# -- against the reference's remat_chunk=True ---------------------------------------

_REFERENCE_CODE = '''
import dataclasses
import numpy as np
import jax
from repro import models as M
from repro.models.model import CallConfig

call = CallConfig(attn_impl="chunked", attn_chunk={chunk}, attn_chunk_remat=True)
out = {{}}

def paths(tree):
    return {{"/".join(p.key for p in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}}

for arch in {archs}:
    cfg = dataclasses.replace(M.reduced(M.get(arch)), compute_dtype="float32")
    params = M.init_params(jax.random.key(0), cfg)
    rng = np.random.default_rng(7)
    batch = {{"tokens": rng.integers(0, cfg.vocab_size, ({b}, {s})).astype(np.int32),
              "labels": rng.integers(0, cfg.vocab_size, ({b}, {s})).astype(np.int32)}}
    (loss, _), grads = jax.value_and_grad(
        lambda p: M.loss_fn(p, cfg, batch, call), has_aux=True)(params)
    out[f"loss_{{arch}}"] = np.asarray(loss)
    for k, v in batch.items():
        out[f"b_{{arch}}_{{k}}"] = v
    for k, v in paths(params).items():
        out[f"w_{{arch}}_{{k}}"] = v
    for k, v in paths(grads).items():
        out[f"g_{{arch}}_{{k}}"] = v
np.savez({path!r}, **out)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory, subproc):
    path = str(tmp_path_factory.mktemp("chunk_remat_ref") / "ref.npz")
    subproc(_REFERENCE_CODE.format(archs=ARCHS, b=B, s=S, chunk=CHUNK,
                                   path=path),
            devices=1, x64=False, timeout=900)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _tree(arrays, prefix):
    tree = {}
    for name, arr in arrays.items():
        if name.startswith(prefix):
            node = tree
            *parents, leaf = name[len(prefix):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arr
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_the_references_remat_chunk(reference, arch):
    cfg = _f32(arch)
    model = T.Transformer(cfg, device="meta")
    model.load_state_dict(convert.model_params_from_numpy(
        _tree(reference, f"w_{arch}_"), cfg), assign=True)
    batch = {k: torch.from_numpy(reference[f"b_{arch}_{k}"])
             for k in ("tokens", "labels")}
    loss, grads = grads_with_microbatching(cfg, _call(True), 1)(model, batch)
    np.testing.assert_allclose(float(loss), float(reference[f"loss_{arch}"]),
                               **TOL)
    got = _flat(convert.model_params_to_numpy(grads, cfg))
    want = _flat(_tree(reference, f"g_{arch}_"))
    assert set(got) == set(want)
    for path, g in got.items():
        np.testing.assert_allclose(g, want[path], **TOL, err_msg=path)


# -- the launch layer ---------------------------------------------------------------


def test_default_call_takes_the_knob():
    assert default_call("train", 4096, {"attn_chunk_remat": True}
                        ).attn_chunk_remat
    assert not default_call("train", 4096).attn_chunk_remat
    assert UNPORTED_CALL_KNOBS == ("residual_spec", "attn_q_sharding",
                                   "moe_buffer_sharding")
    assert not hasattr(model_lib.CallConfig(), "attn_q_sharding")


def test_dryrun_cli_counts_train_4k_with_the_knob(tmp_path, capsys):
    dryrun.main(["--arch", "smollm-360m", "--shape", "train_4k",
                 "--call-override", json.dumps({"attn_chunk_remat": True}),
                 "--out", str(tmp_path)])
    assert "ERROR" not in capsys.readouterr().out
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    ok = [r for r in recs if r.get("status") == "ok"]
    assert ok and all(r["arch"] == "smollm-360m" and r["shape"] == "train_4k"
                      for r in ok)
    assert all(r["roofline"]["flops_per_device"] > 0 for r in ok)
