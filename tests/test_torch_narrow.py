"""Serving weights narrowed once to the compute dtype, in their own storage
(``repro_torch.models.model.narrow_serving_weights``).

On the CPU, for every family the engine serves (at a tiny width, bf16
compute): a narrowed model's prefill and decode logits are the bits of a
copy that casts its float32 weights at each use; the leaves read in
float32 keep their dtype and values; a second call narrows nothing; the
bytes returned are the narrowed leaves' float32 bytes; over one flat
float32 buffer the narrowed leaves stay in that buffer, and a chunk
boundary inside a leaf changes nothing.  The engine narrows on the card
only, and counts its link bytes at the declared dtypes either way.

The ``cuda`` tests run an engine on the card over a small MLA + MoE and a
small dense GQA model against a loop over ``prefill``/``decode_step`` on
the same seed's float32 weights, and skip without a card.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import models as T
from repro_torch.models import model as TM
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve.engine import SERVE_CALL

BF16 = torch.bfloat16
FAMILIES = {"dense": ("yi-9b", {}),
            "bias": ("qwen1.5-110b", {}),
            "mla_moe": ("deepseek-v2-lite-16b", {"first_dense": 1}),
            "moe_gqa": ("llama4-scout-17b-a16e", {}),
            "ssm": ("falcon-mamba-7b", {}),
            "hybrid": ("zamba2-2.7b", {}),
            "tied": ("smollm-360m", {})}
#: the families with a ragged decode step (GQA attention, no state cache)
RAGGED = ("dense", "bias", "moe_gqa", "tied")
B, S, MAXLEN, STEPS = 2, 8, 16, 3


def _cfg(tag, compute_dtype="bfloat16"):
    arch, moe_kw = FAMILIES[tag]
    cfg = T.reduced(T.get(arch))
    if moe_kw:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_kw))
    return dataclasses.replace(cfg, compute_dtype=compute_dtype)


def _perturb_(model, seed):
    """Every vector leaf moved off its initial constants (norm gains at
    one, biases at zero, the SSM's constants), so that a leaf read in
    float32 and narrowed would read other values."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g).to(p.device))
    return model


def _model(cfg, seed=0, device="cpu"):
    model = T.init_params(cfg, generator=torch.Generator(
        device=device).manual_seed(seed), device=device)
    return _perturb_(model, seed + 1)


def _narrowable(model):
    """name -> leaf of every float32 leaf read through a cast."""
    return {n: p for n, p in model.named_parameters()
            if p.dtype == torch.float32
            and n.rsplit(".", 1)[-1] not in TM.F32_READS}


def _logits(model, cfg, toks, nxt, ragged):
    """Prefill logits, then each decode step's (uniform positions, or per
    row under ``ragged``)."""
    lg, cache = T.prefill(model, cfg, {"tokens": toks}, MAXLEN, SERVE_CALL)
    out = [lg]
    pos_b = torch.full((B,), S, dtype=torch.int32)
    for tok in nxt:
        if ragged:
            lg, cache = T.decode_step_ragged(model, cfg, cache, tok, pos_b)
            pos_b = pos_b + 1
        else:
            lg, cache = T.decode_step(model, cfg, cache, tok, SERVE_CALL)
        out.append(lg)
    return out


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_narrowed_logits_are_the_per_use_casts_bits(tag):
    cfg = _cfg(tag)
    cast = _model(cfg)
    narrowed = copy.deepcopy(cast)
    want_bytes = sum(p.numel() * 4 for p in _narrowable(cast).values())
    assert TM.narrow_serving_weights(narrowed, cfg) == want_bytes > 0
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                           dtype=torch.int32)
    nxt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (STEPS, B, 1)),
                          dtype=torch.int32)
    for ragged in (False, True) if tag in RAGGED else (False,):
        got = _logits(narrowed, cfg, toks, nxt, ragged)
        want = _logits(cast, cfg, toks, nxt, ragged)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("tag", list(FAMILIES))
def test_narrowing_keeps_the_float32_reads_and_runs_once(tag):
    cfg = _cfg(tag)
    before = _model(cfg)
    model = copy.deepcopy(before)
    TM.narrow_serving_weights(model, cfg)
    narrowed = _narrowable(before)
    kept = 0
    for name, p in model.named_parameters():
        was = before.get_parameter(name)
        assert p.shape == was.shape and p.is_contiguous(), name
        if name in narrowed:
            assert p.dtype == BF16, name
            torch.testing.assert_close(p, was.to(BF16), rtol=0, atol=0)
        else:
            assert p.dtype == was.dtype == torch.float32, name
            torch.testing.assert_close(p, was, rtol=0, atol=0)
            kept += 1
    assert kept > 0
    assert TM.narrow_serving_weights(model, cfg) == 0


@pytest.mark.parametrize("tag", ["mla_moe", "hybrid", "tied"])
def test_narrowing_stays_in_one_flat_buffer(tag):
    """Over one flat float32 buffer (every leaf a view of it), each
    narrowed leaf starts where its float32 values did: nothing new."""
    cfg = _cfg(tag)
    src = _model(cfg)
    shapes = [(n, t.shape) for n, t in src.state_dict().items()]
    flat = torch.empty(sum(math.prod(s) for _, s in shapes))
    state, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        state[name] = flat[at:at + n].view(shape)
        state[name].copy_(src.get_parameter(name))
        at += n
    model = TM.Transformer(cfg, device="meta")
    model.load_state_dict(state, assign=True)
    ptrs = {n: p.data_ptr() for n, p in model.named_parameters()}
    TM.narrow_serving_weights(model, cfg)
    base = flat.untyped_storage().data_ptr()
    for name, p in model.named_parameters():
        assert p.data_ptr() == ptrs[name], name
        assert p.untyped_storage().data_ptr() == base, name
        torch.testing.assert_close(
            p, src.get_parameter(name).to(p.dtype), rtol=0, atol=0)


def test_narrowing_across_chunks_and_odd_leaves(monkeypatch):
    """Chunks of 48 bytes (24 bf16 values) inside one leaf; a leaf off a
    16-byte boundary and a transposed one are copied instead, with the
    same values."""
    monkeypatch.setattr(TM, "NARROW_CHUNK_BYTES", 48)
    cfg = _cfg("dense")
    g = torch.Generator().manual_seed(7)
    buf = torch.randn(1 + 3 * 129 * 7, generator=g)
    mod = torch.nn.Module()
    mod.wide = torch.nn.Parameter(torch.randn(5, 101, generator=g),
                                  requires_grad=False)
    mod.off = torch.nn.Parameter(buf[1:1 + 129 * 7].view(129, 7),
                                 requires_grad=False)
    mod.turned = torch.nn.Parameter(torch.randn(9, 6, generator=g).T,
                                    requires_grad=False)
    want = {n: p.detach().to(BF16) for n, p in mod.named_parameters()}
    ptr = mod.wide.data_ptr()
    assert TM.narrow_serving_weights(mod, cfg) == 4 * (505 + 903 + 54)
    for name, p in mod.named_parameters():
        assert p.dtype == BF16 and p.shape == want[name].shape, name
        torch.testing.assert_close(p, want[name], rtol=0, atol=0)
    assert mod.wide.data_ptr() == ptr
    assert mod.off.untyped_storage().data_ptr() \
        != buf.untyped_storage().data_ptr()


def test_float32_compute_narrows_nothing():
    cfg = _cfg("dense", compute_dtype="float32")
    model = _model(cfg)
    assert TM.narrow_serving_weights(model, cfg) == 0
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_engine_on_the_cpu_keeps_its_weights():
    """Off the card the engine serves the weights as they are; placing a
    model counts its link bytes at the declared dtypes, narrowed or
    not."""
    cfg = _cfg("dense")
    model = _model(cfg)
    f32_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    eng = ServeEngine(cfg, model, ServeConfig(batch=B, max_len=MAXLEN),
                      device="cpu")
    assert eng.stats["narrowed_bytes"] == 0
    assert all(p.dtype == torch.float32 for p in model.parameters())
    eng.place_params(model)
    narrowed = copy.deepcopy(model)
    TM.narrow_serving_weights(narrowed, cfg)
    other = ServeEngine(cfg, narrowed, ServeConfig(batch=B, max_len=MAXLEN),
                        device="cpu")
    other.place_params(narrowed)
    assert eng.stats["h2d_bytes"] == other.stats["h2d_bytes"] == f32_bytes
    assert other.stats["narrowed_bytes"] == 0


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine narrows on the card")
    return torch.device("cuda")


def _greedy_loop(model, cfg, prompts, n_new, dev):
    """Greedy tokens and prefill logits through ``prefill`` and
    ``decode_step``, as the engine's step mode runs them."""
    lg, cache = T.prefill(model, cfg, {"tokens": torch.as_tensor(
        prompts, device=dev)}, MAXLEN, SERVE_CALL)
    logits = lg
    toks = [lg[:, -1].argmax(-1).to(torch.int32)[:, None]]
    for _ in range(n_new - 1):
        lg, cache = T.decode_step(model, cfg, cache, toks[-1], SERVE_CALL)
        toks.append(lg[:, 0].argmax(-1).to(torch.int32)[:, None])
    return torch.cat(toks, dim=1).cpu().numpy(), logits


def _ragged_loop(model, cfg, requests, dev):
    """``generate_many``'s greedy tokens with every request admitted at
    step 0 into a slot of its own: each ``prompt[:-1]`` prefilled alone
    into its slot's cache rows, then ``decode_step_ragged`` over all."""
    cache = T.init_cache(cfg, len(requests), MAXLEN, device=dev)
    tok = torch.zeros((len(requests), 1), dtype=torch.int32, device=dev)
    pos_b = torch.zeros((len(requests),), dtype=torch.int32, device=dev)
    for j, (prompt, _) in enumerate(requests):
        _, pc = T.prefill(model, cfg, {"tokens": torch.as_tensor(
            prompt[None, :-1], device=dev)}, MAXLEN, SERVE_CALL)
        cache["k"][:, j:j + 1] = pc["k"]
        cache["v"][:, j:j + 1] = pc["v"]
        tok[j, 0] = int(prompt[-1])
        pos_b[j] = prompt.size - 1
    out = []
    for _ in range(max(n for _, n in requests)):
        lg, cache = T.decode_step_ragged(model, cfg, cache, tok, pos_b)
        tok = lg[:, 0].argmax(-1).to(torch.int32)[:, None]
        pos_b = pos_b + 1
        out.append(tok)
    out = torch.cat(out, dim=1).cpu().numpy()
    return [out[j, :n] for j, (_, n) in enumerate(requests)]


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("tag", ["mla_moe", "dense"])
def test_engine_narrows_on_card(cuda, tag):
    cfg = _cfg(tag)
    served, cast = _model(cfg, device=cuda), _model(cfg, device=cuda)
    want_bytes = sum(p.numel() * 4 for p in _narrowable(cast).values())
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, served, ServeConfig(batch=B, max_len=MAXLEN))
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before \
        <= TM.NARROW_CHUNK_BYTES
    assert eng.stats["narrowed_bytes"] == want_bytes > 0
    assert not _narrowable(served)
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    got = eng.generate(prompts, 6)
    want, want_lg = _greedy_loop(cast, cfg, prompts, 6, cuda)
    np.testing.assert_array_equal(got, want)
    got_lg = _greedy_loop(served, cfg, prompts, 1, cuda)[1]
    assert _rel_l2(got_lg, want_lg) <= 1e-3
    assert ServeEngine(cfg, served, ServeConfig(
        batch=B, max_len=MAXLEN)).stats["narrowed_bytes"] == 0
    if tag == "dense":
        rng = np.random.default_rng(6)
        requests = [(rng.integers(0, cfg.vocab_size, s).astype(np.int32), n)
                    for s, n in ((9, 5), (4, 3), (10, 6))]
        many = ServeEngine(cfg, served, ServeConfig(
            batch=len(requests), max_len=MAXLEN, prefill_bucket=1))
        for g, w in zip(many.generate_many(requests),
                        _ragged_loop(cast, cfg, requests, cuda)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_narrowing_a_leaf_of_many_chunks_on_card(cuda):
    """A leaf of 2.5 chunks, narrowed on the card: the values of a cast,
    the leaf's own address, and one chunk at most beside it."""
    cfg = _cfg("dense")
    n = 5 * TM.NARROW_CHUNK_BYTES // 4
    mod = torch.nn.Module()
    mod.w = torch.nn.Parameter(torch.randn(n, device=cuda).view(-1, 1024),
                               requires_grad=False)
    want = mod.w.detach().to(BF16)
    ptr = mod.w.data_ptr()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    assert TM.narrow_serving_weights(mod, cfg) == 4 * n
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before \
        <= TM.NARROW_CHUNK_BYTES
    assert mod.w.data_ptr() == ptr and mod.w.dtype == BF16
    torch.testing.assert_close(mod.w, want, rtol=0, atol=0)
