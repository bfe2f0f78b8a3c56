"""DeepSeek-V2-Lite's plain reference (``bench/reference/mla_moe.py``)
against the program at the rehearsal size on the CPU: the prefill's
logits and the decode's through the latent cache, in float32 and in bf16;
the leaves, their names and the full-width count; the work counts."""

import json
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from bench import drivers, work  # noqa: E402
from bench.arch import mla_moe as arch  # noqa: E402
from bench.reference import mla_moe as ref  # noqa: E402
from bench.weights import make_weights  # noqa: E402

from repro_torch.models.model import (  # noqa: E402
    CallConfig, decode_step, prefill,
)

NAME = "deepseek-v2-lite-16b"
FULL = json.loads((ROOT / f"bench/configs/{NAME}.json").read_text())
CALL = CallConfig(attn_impl="chunked", attn_chunk=8, moe_no_drop=True)
PROMPT, SERVED, MAX_LEN = 21, 6, 32


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: one intra-op thread is faster, and leaves the cores
    to the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny(dtype):
    return {**FULL, **FULL["rehearsal"], "compute_dtype": dtype}


def served_by_program(cfg, w, prompt, served):
    """The program's logits (n, V) before each served token: the prefill's
    last, then a decode step through the cache per served token but the
    last (the reference's served tokens fed in)."""
    mcfg = drivers.model_config(cfg)
    model = drivers.load_model(mcfg, w)
    with torch.no_grad():
        logits, cache = prefill(model, mcfg, {"tokens": prompt[None]},
                                MAX_LEN, CALL)
        out = [logits[0, -1]]
        for tok in served[:-1]:
            logits, cache = decode_step(model, mcfg, cache,
                                        tok.view(1, 1), CALL)
            out.append(logits[0, -1])
    return torch.stack(out)


def case(dtype, seed=3):
    cfg = tiny(dtype)
    w = make_weights(cfg, seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, cfg["vocab_size"], (PROMPT,), generator=gen)
    served = torch.randint(0, cfg["vocab_size"], (SERVED,), generator=gen)
    return cfg, w, prompt, served


def test_prefill_and_decode_in_float32():
    """f32 on both sides: the same arithmetic in other orders (the chunked
    online softmax, the decode's absorbed ``wuk``, the grouped products)."""
    cfg, w, prompt, served = case("float32")
    got = served_by_program(cfg, w, prompt, served)
    want = ref.served_logits(cfg, w, prompt, served)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_prefill_and_decode_in_bf16():
    """bf16 products against the f32 reference: within 3 % of the logits'
    norm (bf16 keeps 8 bits, about 0.4 % a rounding, over 3 layers of
    products and a routing that may flip), and well apart from a shifted
    token's logits."""
    cfg, w, prompt, served = case("bfloat16")
    got = served_by_program(cfg, w, prompt, served)
    want = ref.served_logits(cfg, w, prompt, served)
    rel = (got - want).norm() / want.norm()
    assert rel < 0.03, rel
    assert (got.roll(1, dims=-1) - want).norm() / want.norm() > 0.5


def test_leaves_named_as_the_program():
    cfg = tiny("float32")
    w = make_weights(cfg, 7, "cpu")
    model = drivers.load_model(drivers.model_config(cfg), w)
    assert [n for n, _ in model.named_parameters()] == [
        n for n, _ in arch.leaf_shapes(cfg)]
    names = dict(arch.leaf_shapes(cfg))
    assert "layers.0.mlp.wi" in names and "layers.0.moe.router" not in names
    assert "layers.1.moe.experts.wi" in names and "layers.1.mlp.wi" not in names
    # a stacked expert's fan-in is its axis 1 (the d of (E, d, fe))
    wi = w["layers.1.moe.experts.wi"]
    assert abs(float(wi.std()) * math.sqrt(wi.shape[1]) - 1) < 0.2


def test_full_width_count_and_work():
    """The published model's 15,706,484,224 parameters, and its prefill
    work: 2.24 G weights a token (27 MLA layers, the dense layer, 26 of a
    router, 6 routed and 2 shared experts), the head once, causal MLA."""
    shapes = arch.leaf_shapes(FULL)
    assert sum(math.prod(s) for _, s in shapes) == 15_706_484_224
    assert drivers.model_config(FULL).param_count() == 15_706_484_224
    mla = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    expert = 3 * 2048 * 1408
    assert arch.token_weights(FULL) == (
        27 * mla + 3 * 2048 * 10944 + 26 * (2048 * 64 + 8 * expert))
    assert arch.token_weights(FULL) == 2_241_593_344
    length = 13_777
    pairs = length * (length + 1) // 2
    assert arch.prefill_flops(FULL, length) == (
        2 * 2_241_593_344 * length + 2 * 2048 * 102_400
        + 2 * 16 * 320 * 27 * pairs)
    # a decode step reads at least a token's weights and the head
    assert arch.step_weight_bytes(FULL) == 2 * (2_241_593_344
                                                + 2048 * 102_400)
    assert arch.cache_bytes_per_position(FULL) == 27 * 576 * 2
    t = 4 * length
    flops = 26 * 2 * 6 * t * 3 * 2048 * 1408
    assert math.isclose(arch.experts_least_s(FULL, t),
                        flops / work.PEAK_BF16_FLOPS, rel_tol=1e-12)


def test_yarn_of_the_reference():
    rs = FULL["rope_scaling"]
    assert ref.yarn_bounds(rs, 64, 10000.0) == (10, 23)
    assert math.isclose(ref.yarn_mscale(40, 0.707) ** 2, 1.58963,
                        rel_tol=1e-5)
    f = ref.inv_freq(FULL, 64, "cpu")
    extra = 10000.0 ** (-torch.arange(0, 64, 2) / 64)
    assert torch.allclose(f[:10], extra[:10])
    assert torch.allclose(f[23:], extra[23:] / 40)


def test_fp8_control_is_coarser():
    cfg, w, prompt, served = case("float32")
    exact = ref.served_logits(cfg, w, prompt, served)
    low = ref.served_logits(cfg, w, prompt, served, "fp8")
    assert (low - exact).norm() / exact.norm() > 0.03
