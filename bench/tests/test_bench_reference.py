"""The plain reference against the port at a reduced size on the CPU, both
in float32: logits, loss, gradients, one AdamW step and a prefill."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from bench import drivers  # noqa: E402
from bench.arch.dense_gqa import leaf_shapes  # noqa: E402
from bench.reference import dense_gqa as ref  # noqa: E402
from bench.weights import make_weights  # noqa: E402

from repro_torch.models.model import (  # noqa: E402
    CallConfig, forward, loss_fn, prefill,
)
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: E402

PLAIN = CallConfig(attn_impl="plain", ssm_impl="plain", remat=False)
TOL = dict(rtol=1e-4, atol=1e-5)        # float32, other orders of sums


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: one intra-op thread is faster, and leaves the cores
    to the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny(name):
    cfg = json.loads((ROOT / f"bench/configs/{name}.json").read_text())
    return {**cfg, **cfg["rehearsal"], "compute_dtype": "float32"}


@pytest.fixture(params=["smollm-360m", "yi-9b"])
def case(request):
    cfg = tiny(request.param)
    w = make_weights(cfg, 7, "cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (2, 24),
                           generator=torch.Generator().manual_seed(3))
    return cfg, w, tokens


def test_weights_named_as_the_program(case):
    cfg, w, _ = case
    model = drivers.load_model(drivers.model_config(cfg), w)
    assert [n for n, _ in model.named_parameters()] == [
        n for n, _ in leaf_shapes(cfg)]
    assert torch.equal(make_weights(cfg, 7, "cpu")["embed"], w["embed"])
    assert not torch.equal(make_weights(cfg, 8, "cpu")["embed"], w["embed"])


def test_logits(case):
    cfg, w, tokens = case
    model = drivers.load_model(drivers.model_config(cfg), w)
    got, _ = forward(model, drivers.model_config(cfg), {"tokens": tokens},
                     PLAIN)
    want = torch.stack([ref.Decoder(cfg, w).logits_at(t, range(24))
                        for t in tokens])
    torch.testing.assert_close(got, want, **TOL)


def test_prefill_last_logits(case):
    cfg, w, tokens = case
    mcfg = drivers.model_config(cfg)
    model = drivers.load_model(mcfg, w)
    got, _ = prefill(model, mcfg, {"tokens": tokens[:1]}, 32, PLAIN)
    want = ref.Decoder(cfg, w).logits_at(tokens[0], [23])
    torch.testing.assert_close(got[0], want, **TOL)


def test_loss_grads_and_adamw(case):
    cfg, w, tokens = case
    mcfg = drivers.model_config(cfg)
    labels = torch.roll(tokens, -1, dims=1)
    model = drivers.load_model(mcfg, {n: t.clone() for n, t in w.items()})
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss, _ = loss_fn(model, mcfg, {"tokens": tokens, "labels": labels},
                      PLAIN)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    mine = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    total = ref.Decoder(cfg, mine).loss_sum(tokens, labels) / tokens.numel()
    total.backward()
    torch.testing.assert_close(loss.detach(), total.detach(), **TOL)
    for n in params:
        torch.testing.assert_close(grads[n], mine[n].grad, **TOL)

    hyper = {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
             "clip_norm": 1.0}
    with torch.no_grad():
        for p in params.values():
            p.requires_grad_(False)
        state = adamw_init(model, AdamWConfig(**hyper))
        adamw_update(grads, state, model, 2e-3, AdamWConfig(**hyper))
        plain = {n: t.detach().clone() for n, t in mine.items()}
        ref.adamw_step(plain, {n: mine[n].grad for n in mine},
                       {"count": 0, "mu": {}, "nu": {}}, 2e-3, hyper)
    for n, p in params.items():
        torch.testing.assert_close(p, plain[n], **TOL)


def test_schedule_matches_the_train_cli():
    from repro_torch.optim.schedule import linear_warmup_cosine
    for step in (0, 1, 4, 5, 50, 99, 150):
        assert ref.lr_at(step, 1e-3, 5, 100) == pytest.approx(
            float(linear_warmup_cosine(step, base_lr=1e-3, warmup_steps=5,
                                       total_steps=100)), rel=1e-6)


def test_fp8_round_is_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    e8 = (ref.fp8_round(x) - x).norm() / x.norm()
    e16 = (x.bfloat16().float() - x).norm() / x.norm()
    assert 8 * e16 < e8 < 0.1
