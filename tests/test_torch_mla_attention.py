"""MLA's prefill attention kernel (``kernels/mla_attention.py``,
``csrc/mla_attention.cu``) and the rule that sends a call to it.

On the CPU: the dispatch rule (head dims 192/128, bf16, on the card, no
prefix mask, no autograd recording; "auto" stays plain), the "chunked"
path's bits where the kernel does not run, the plain version against the
chunked loop, and the wrapper's refusals.  On the card (``-m cuda``; this
file imports no JAX): the kernel against the f32 loop at the long-prompt
cell's shapes, the bottom-right mask with Sq != Skv, impl "kernel", more
than 65,535 (batch, head) planes, and one kernel launch a layer in a bf16
prefill of DeepSeek-V2-Lite's configuration.

Run the card cases on a machine with the card:
``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_mla_attention.py``.
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import pytest
import torch

from repro_torch.kernels import build as t_build
from repro_torch.kernels import mla_attention as t_mla
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.models import attention as t_attn
from repro_torch.models import get as t_get
from repro_torch.models import reduced as t_reduced

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16, F32 = torch.bfloat16, torch.float32
#: DeepSeek-V2-Lite's softmax scale under its YaRN: 1.58963 / sqrt(192)
YARN_SCALE = 1.5896321 / 192 ** 0.5
#: the kernel against the f32 loop: its bf16 output is one rounding of an
#: f32 result (about 1.6e-3 relative L2 on unit-scale rows), so about one
#: bf16 ulp
REL_L2 = 4e-3
#: the share of outputs that are not the f32 loop's result rounded to bf16:
#: P split into a bf16 head and tail leaves 0.13-0.81 %, P rounded to bf16
#: alone 28-37 % (H100, S of 64 to 13,777, the YaRN scale)
OFF_ROUNDED = 2e-2


def fake(shape, dtype=BF16, cuda=True, grad=False):
    """What the dispatch rule reads of a tensor, without a card."""
    return SimpleNamespace(shape=torch.Size(shape), dtype=dtype,
                           is_cuda=cuda, requires_grad=grad)


def mla_call(b=2, h=16, s=9, dq=192, dv=128, **kw):
    return (fake((b, h, s, dq), **kw), fake((b, h, s, dq), **kw),
            fake((b, h, s, dv), **kw))


# -- the dispatch rule ---------------------------------------------------------

#: (case, the call, prefix_len, whether the kernel takes it)
RULE = [
    ("bf16 on the card, 192/128", mla_call(), 0, True),
    ("the long-prompt cell's shape", mla_call(4, 16, 13777), 0, True),
    ("B*H = 65536 planes", mla_call(4096, 16, 9), 0, True),
    ("2^31 CTAs, past a grid's x", mla_call(65536, 16, 128 * 2048), 0,
     False),
    ("f32", mla_call(dtype=F32), 0, False),
    ("on the CPU", mla_call(cuda=False), 0, False),
    ("autograd records", mla_call(grad=True), 0, False),
    ("reduced deepseek 32 + 16 / 32", mla_call(dq=48, dv=32), 0, False),
    ("16 + 16 / 16", mla_call(dq=32, dv=16), 0, False),
    ("a prefix mask", mla_call(), 4, False),
    ("GQA: one head dim", (fake((1, 32, 9, 128)), fake((1, 4, 9, 128)),
                           fake((1, 4, 9, 128))), 0, False),
    ("one head dim 192", mla_call(dv=192), 0, False),
    ("other head counts", (fake((1, 16, 9, 192)), fake((1, 8, 9, 192)),
                           fake((1, 8, 9, 128))), 0, False),
]


@pytest.mark.parametrize("case,qkv,prefix,want", RULE,
                         ids=[r[0] for r in RULE])
def test_dispatch_rule(case, qkv, prefix, want):
    assert t_mla.takes(*qkv, prefix_len=prefix) is want, case


def test_dispatch_rule_reads_the_grad_mode():
    """An input that requires grad reaches the kernel only where autograd
    records nothing."""
    qkv = mla_call(grad=True)
    assert not t_mla.takes(*qkv)
    with torch.no_grad():
        assert t_mla.takes(*qkv)


def test_auto_stays_plain_for_mla_on_the_card():
    """"auto" resolves MLA's split dims to "plain", on the card too."""
    assert t_attn.resolve_impl("auto", *mla_call()) == "plain"
    assert t_attn.resolve_impl("auto", *mla_call(cuda=False)) == "plain"


@pytest.mark.parametrize("impl,runs", [("chunked", True), ("kernel", True),
                                       ("plain", False), ("auto", False),
                                       ("stub", False)])
def test_multihead_attention_sends_kernel_calls(monkeypatch, impl, runs):
    """Where the rule admits a call, "chunked" and "kernel" run the MLA
    kernel with the call's scale; "plain", "auto" and "stub" never do."""
    seen = []

    def kernel(q, k, v, *, scale=None, impl="auto"):
        seen.append((impl, scale))
        return torch.zeros(*q.shape[:3], v.shape[-1], dtype=q.dtype)

    monkeypatch.setattr(t_mla, "takes", lambda q, k, v, prefix_len=0: True)
    monkeypatch.setattr(t_ops, "mla_attention", kernel)
    q, k, v = (torch.randn(1, 2, 8, d).to(BF16) for d in (192, 192, 128))
    o = t_attn.multihead_attention(q, k, v, impl=impl, scale=0.25)
    assert o.shape == (1, 2, 8, 128)
    assert seen == ([("kernel", 0.25)] if runs else [])


@pytest.mark.parametrize("dims", [(48, 32), (32, 16), (192, 128)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_chunked_on_the_cpu_is_the_loop_bit_for_bit(dims, dtype):
    """Off the card "chunked" runs the loop as before, the same bits."""
    dq, dv = dims
    g = torch.Generator().manual_seed(dq + dv)
    q, k = (torch.randn(2, 4, 37, dq, generator=g).to(dtype)
            for _ in range(2))
    v = torch.randn(2, 4, 37, dv, generator=g).to(dtype)
    before = t_build.launch_counts()
    got = t_attn.multihead_attention(q, k, v, impl="chunked", chunk=8,
                                     scale=YARN_SCALE)
    want = t_attn._chunked_attention(q, k, v, prefix_len=0, chunk=8,
                                     scale=YARN_SCALE)
    assert torch.equal(got, want)
    assert t_build.launch_counts() == before


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_tiny_mla_model_keeps_the_loop_on_the_cpu(dtype):
    """The reduced DeepSeek's "chunked" MLA attention on the CPU: the loop,
    bit for bit, and no kernel launch."""
    cfg = dataclasses.replace(t_reduced(t_get("deepseek-v2-lite-16b")),
                              compute_dtype=str(dtype).split(".")[1])
    m = cfg.mla
    g = torch.Generator().manual_seed(3)
    d, r = cfg.d_model, m.kv_lora_rank
    hq = cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
    p = {"wq": torch.randn(d, hq, generator=g) * d ** -0.5,
         "wdkv": torch.randn(d, r + m.qk_rope_head_dim, generator=g)
         * d ** -0.5,
         "kv_norm": torch.ones(r),
         "wuk": torch.randn(r, cfg.n_heads * m.qk_nope_head_dim,
                            generator=g) * r ** -0.5,
         "wuv": torch.randn(r, cfg.n_heads * m.v_head_dim, generator=g)
         * r ** -0.5,
         "wo": torch.randn(cfg.n_heads * m.v_head_dim, d, generator=g)
         * d ** -0.5}
    x = torch.randn(2, 21, d, generator=g).to(dtype)
    pos = torch.arange(21)[None].expand(2, 21)
    before = t_build.launch_counts()
    got = t_attn.mla_attention(x, p, cfg, pos, impl="chunked", chunk=8)
    assert t_build.launch_counts() == before

    # the same layer with the loop called directly
    c, k_rope = t_attn.mla_compress_kv(x, p, cfg, pos)
    q_nope, q_rope = t_attn.mla_project_q(x, p, cfg, pos)
    k_nope = t_attn._split_heads(torch.matmul(c, p["wuk"].to(dtype)),
                                 cfg.n_heads)
    v = t_attn._split_heads(torch.matmul(c, p["wuv"].to(dtype)), cfg.n_heads)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(2, cfg.n_heads, 21,
                                         m.qk_rope_head_dim)], dim=-1)
    o = t_attn._chunked_attention(q, k, v, prefix_len=0, chunk=8,
                                  scale=t_attn.mla_scale(cfg))
    want = torch.matmul(t_attn._merge_heads(o), p["wo"].to(dtype))
    assert torch.equal(got, want)


# -- the plain version and the wrapper ---------------------------------------


@pytest.mark.parametrize("sq,skv", [(37, 37), (20, 50), (1, 9)])
@pytest.mark.parametrize("scale", [None, YARN_SCALE])
def test_plain_is_the_loop(sq, skv, scale):
    """The op's CPU path (``ref.masked_attention``) computes the chunked
    loop's function: the mask aligned bottom-right, the scale, 1/sqrt(192)
    when None."""
    g = torch.Generator().manual_seed(sq * skv)
    q = torch.randn(2, 3, sq, 192, generator=g)
    k = torch.randn(2, 3, skv, 192, generator=g)
    v = torch.randn(2, 3, skv, 128, generator=g)
    want = t_attn._chunked_attention(q, k, v, prefix_len=0, chunk=16,
                                     scale=scale)
    got = t_ops.mla_attention(q, k, v, scale=scale)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_plain_row_with_no_column_is_the_mean_of_v():
    """Sq > Skv: the first Sq - Skv rows see no column and give the mean
    of V, as a softmax over a row of -1e30 does."""
    g = torch.Generator().manual_seed(5)
    q = torch.randn(1, 2, 7, 192, generator=g)
    k = torch.randn(1, 2, 3, 192, generator=g)
    v = torch.randn(1, 2, 3, 128, generator=g)
    o = t_ops.mla_attention(q, k, v)
    mean = v.mean(dim=2, keepdim=True).expand(1, 2, 4, 128)
    torch.testing.assert_close(o[:, :, :4], mean, rtol=1e-6, atol=1e-6)


REFUSED = [
    ("v of 192", (1, 2, 8, 192), (1, 2, 8, 192), (1, 2, 8, 192), BF16),
    ("q of 128", (1, 2, 8, 128), (1, 2, 8, 192), (1, 2, 8, 128), BF16),
    ("heads", (1, 4, 8, 192), (1, 2, 8, 192), (1, 2, 8, 128), BF16),
    ("k and v lengths", (1, 2, 8, 192), (1, 2, 8, 192), (1, 2, 9, 128), BF16),
    ("3-d", (2, 8, 192), (2, 8, 192), (2, 8, 128), BF16),
    ("f32", (1, 2, 8, 192), (1, 2, 8, 192), (1, 2, 8, 128), F32),
]


@pytest.mark.parametrize("case,qs,ks,vs,dtype", REFUSED,
                         ids=[r[0] for r in REFUSED])
def test_wrapper_refuses(case, qs, ks, vs, dtype):
    q, k, v = (torch.zeros(s, dtype=dtype) for s in (qs, ks, vs))
    with pytest.raises(ValueError):
        t_mla.mla_attention(q, k, v)


def test_wrapper_refuses_cpu_tensors_and_grad():
    q, k = (torch.zeros(1, 2, 8, 192, dtype=BF16) for _ in range(2))
    v = torch.zeros(1, 2, 8, 128, dtype=BF16)
    before = t_build.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        t_mla.mla_attention(q, k, v)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_ops.mla_attention(q, k, v, impl="kernel")
    with pytest.raises(RuntimeError, match="requires grad"):
        t_mla.mla_attention(q.requires_grad_(), k, v)
    assert t_build.launch_counts() == before


def test_kernel_is_registered():
    k = t_build.KERNELS["mla_attention"]
    assert k.source.endswith("csrc/mla_attention.cu")
    assert "mla_attention.cu" in t_build.SOURCES
    assert "repro_mla_attention" in t_build.SIGNATURES
    assert t_mla.HEAD_DIMS == (192, 128)


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _rel_l2(got, want):
    g, w = got.double(), want.double()
    return ((g - w).norm() / w.norm()).item()


def _inputs(dev, b, h, sq, skv, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, sq, 192, generator=g, device=dev).to(BF16)
    k = torch.randn(b, h, skv, 192, generator=g, device=dev).to(BF16)
    v = torch.randn(b, h, skv, 128, generator=g, device=dev).to(BF16)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("s", [64, 4871, 13777])
@pytest.mark.parametrize("scale", [None, YARN_SCALE], ids=["rsqrt", "yarn"])
def test_kernel_matches_the_f32_loop_on_card(cuda, s, scale):
    """(4, 16, S, 192/128) as the long-prompt cell sends it (13,777 is the
    ragged edge), against the chunked loop run in f32."""
    q, k, v = _inputs(cuda, 4, 16, s, s, s)
    before = t_build.KERNELS["mla_attention"].launches
    got = t_attn.multihead_attention(q, k, v, impl="chunked", scale=scale)
    assert t_build.KERNELS["mla_attention"].launches == before + 1
    want = t_attn._chunked_attention(q.float(), k.float(), v.float(),
                                     prefix_len=0, scale=scale)
    torch.cuda.synchronize()
    assert got.shape == (4, 16, s, 128) and got.dtype == BF16
    assert torch.isfinite(got.float()).all()
    assert _rel_l2(got, want) <= REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("s", [64, 4871, 13777])
def test_kernel_keeps_p_to_about_16_bits_on_card(cuda, s):
    """P enters P·V as a bf16 head and tail: nearly every output is the
    f32 loop's result rounded to bf16.  A kernel that rounds P to bf16
    alone is off in about a third of them."""
    q, k, v = _inputs(cuda, 4, 16, s, s, s + 1)
    got = t_ops.mla_attention(q, k, v, scale=YARN_SCALE, impl="kernel")
    want = t_attn._chunked_attention(q.float(), k.float(), v.float(),
                                     prefix_len=0, scale=YARN_SCALE)
    off = (got != want.to(BF16)).double().mean().item()
    assert off <= OFF_ROUNDED


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", [(100, 300), (1, 77), (130, 65),
                                    (300, 300)])
def test_kernel_bottom_right_mask_on_card(cuda, sq, skv):
    """Sq < Skv aligns the mask bottom-right; Sq > Skv's first rows see no
    column and give the mean of V, as the plain version."""
    q, k, v = _inputs(cuda, 2, 3, sq, skv, sq + skv)
    got = t_ops.mla_attention(q, k, v, scale=YARN_SCALE, impl="kernel")
    want = t_ref.masked_attention(q.float(), k.float(), v.float(),
                                  t_ref.causal_mask(sq, skv, cuda),
                                  YARN_SCALE)
    torch.cuda.synchronize()
    assert _rel_l2(got, want) <= REL_L2


@pytest.mark.cuda
def test_kernel_impl_runs_the_mla_kernel_on_card(cuda):
    """impl "kernel" on MLA's dims runs the MLA kernel (the flash kernel
    takes one head dim): one launch, the f32 loop's output."""
    q, k, v = _inputs(cuda, 1, 16, 8, 8, 8)
    before = t_build.KERNELS["mla_attention"].launches
    got = t_attn.multihead_attention(q, k, v, impl="kernel")
    assert t_build.KERNELS["mla_attention"].launches == before + 1
    want = t_attn._chunked_attention(q.float(), k.float(), v.float(),
                                     prefix_len=0)
    torch.cuda.synchronize()
    assert got.shape == (1, 16, 8, 128)
    assert _rel_l2(got, want) <= REL_L2


@pytest.mark.cuda
def test_kernel_takes_more_than_65535_planes_on_card(cuda):
    """B·H = 65,536 (4,096 rows of 16 heads): past a grid's y, which the
    flat grid does not use.  "chunked" runs the kernel, held to the f32
    loop."""
    q, k, v = _inputs(cuda, 4096, 16, 3, 5, 65)
    before = t_build.KERNELS["mla_attention"].launches
    got = t_attn.multihead_attention(q, k, v, impl="chunked",
                                     scale=YARN_SCALE)
    assert t_build.KERNELS["mla_attention"].launches == before + 1
    want = t_attn._chunked_attention(q.float(), k.float(), v.float(),
                                     prefix_len=0, scale=YARN_SCALE)
    torch.cuda.synchronize()
    assert got.shape == (4096, 16, 3, 128)
    assert _rel_l2(got, want) <= REL_L2


def _cell_config(n_layers):
    """DeepSeek-V2-Lite as the long-prompt cell runs it
    (``bench/configs/deepseek-v2-lite-16b.json``), cut to ``n_layers``."""
    from repro_torch.models.config import ModelConfig
    with open(os.path.join(REPO, "bench", "configs",
                           "deepseek-v2-lite-16b.json")) as f:
        raw = json.load(f)
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{k: v for k, v in raw.items() if k in names})
    return dataclasses.replace(cfg, n_layers=n_layers)


@pytest.mark.cuda
def test_prefill_launches_the_kernel_once_a_layer_on_card(cuda):
    """A bf16 prefill of the cell's configuration (at full width, cut to
    its dense layer and two MoE layers; a short ragged prompt) through
    "chunked": one kernel launch a layer, and finite logits."""
    from repro_torch.models import CallConfig, init_params, prefill
    cfg = _cell_config(3)
    model = init_params(cfg, generator=torch.Generator(device=cuda)
                        .manual_seed(0), device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 300), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    call = CallConfig(attn_impl="chunked", moe_no_drop=True)
    before = t_build.KERNELS["mla_attention"].launches
    logits, _ = prefill(model, cfg, {"tokens": tokens}, 320, call)
    torch.cuda.synchronize()
    assert t_build.KERNELS["mla_attention"].launches == before + cfg.n_layers
    assert torch.isfinite(logits).all()
