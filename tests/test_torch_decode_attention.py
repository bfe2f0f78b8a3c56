"""The decode attention (``kernels.ops.decode_attention``).

On the CPU the wrapper runs its plain version, held here to the masked f32
attend the model's decode ran before it (``_masked_attend`` below: the
cache split into heads and widened, every Smax column scored and masked)
within f32 rounding, over the registry's head dims and groups, ragged
lengths (1, Smax and one past Smax, clamped) and bf16 and f32 caches; and
the wrapper's refusals, with no launch counted.  The launch plan is pure
arithmetic and is held here too.

The tests marked ``cuda`` need a card and skip without one: the kernel
against the plain version at Yi-9B's batch-decode shapes and at every
registry head dim and group, a captured graph replayed after its lengths
changed, and the launch count.  This file imports no JAX, so they run on
the card as they are::

    python -m pytest -q -m cuda tests/test_torch_decode_attention.py
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import pytest
import torch

from repro_torch.kernels import build as t_build
from repro_torch.kernels import decode_attention as t_dec
from repro_torch.kernels import ops as t_ops

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 80, 128, 256)
GROUPS = (1, 3, 8)
SMAX = 24
#: every GQA/MHA configuration of the registry as (Hq, Hkv, d): phi3,
#: qwen1.5, smollm, yi, llama4, paligemma, zamba2's shared block, musicgen,
#: and the reduced siblings (groups 2 and 4 at d 32)
REGISTRY = ((40, 10, 128), (64, 8, 128), (15, 5, 64), (32, 4, 128),
            (40, 8, 128), (8, 1, 256), (32, 32, 80), (32, 32, 64),
            (4, 2, 32), (4, 1, 32))


def _masked_attend(q, k_cache, v_cache, lengths, head_dim):
    """The model's decode attend as it was: q (B, Hq, d), the cache split
    into (B, Hkv, Smax, d) views and widened to f32, all Smax columns
    scored, the columns at or past each row's length masked with -1e30."""
    b, hq, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2] // d
    kk = k_cache.reshape(b, smax, hkv, d).transpose(1, 2)
    vv = v_cache.reshape(b, smax, hkv, d).transpose(1, 2)
    qg = q.to(torch.float32).reshape(b, hkv, hq // hkv, d)
    s = torch.einsum("bgrd,bgkd->bgrk", qg, kk.to(torch.float32))
    s = s / (head_dim ** 0.5)
    valid = (torch.arange(smax)[None, None, None, :]
             <= (lengths.to(torch.long) - 1)[:, None, None, None])
    s = s.masked_fill(~valid, NEG_INF)
    o = torch.einsum("bgrk,bgkd->bgrd", torch.softmax(s, dim=-1),
                     vv.to(torch.float32))
    return o.reshape(b, hq, d).to(q.dtype)


def _inputs(b, hq, hkv, d, smax, dtype, lengths, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, hq, d, generator=g).to(dtype)
    k = torch.randn(b, smax, hkv * d, generator=g).to(dtype)
    v = torch.randn(b, smax, hkv * d, generator=g).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32)
    return [t.to(device) for t in (q, k, v, lens)]


# -- the plain version on the CPU -------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plain_equals_masked_attend(d, group, dtype):
    hkv = 2
    # lengths 1, Smax, past Smax (clamped) and one between
    q, k, v, lens = _inputs(4, hkv * group, hkv, d, SMAX, dtype,
                            [1, SMAX, SMAX + 5, 9])
    before = t_build.launch_counts()
    got = t_ops.decode_attention(q, k, v, lens, scale=1.0 / d ** 0.5)
    want = _masked_attend(q, k, v, lens.clamp(max=SMAX), d)
    assert got.shape == q.shape and got.dtype == dtype
    # f32 rounding: the scale multiplies where the old attend divided; a
    # bf16 output may round the last f32 bit to the other bf16 neighbour
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32
           else dict(rtol=2 ** -8, atol=1e-6))
    torch.testing.assert_close(got.float(), want.float(), **tol)
    # row 0 attends position 0 alone: its V row, exactly as widened
    v0 = v[0, 0].reshape(hkv, d).repeat_interleave(group, dim=0)
    torch.testing.assert_close(got[0].float(), v0.float(), **tol)
    assert t_build.launch_counts() == before     # no kernel ran


def test_plain_reads_no_position_past_the_length():
    q, k, v, lens = _inputs(2, 8, 1, 64, SMAX, torch.float32, [5, 17])
    got = t_ops.decode_attention(q, k, v, lens, scale=0.125)
    k2, v2 = k.clone(), v.clone()
    k2[0, 5:] = float("nan")
    v2[0, 5:] = 1e30
    k2[1, 17:] = -7.0
    assert torch.equal(
        t_ops.decode_attention(q, k2, v2, lens, scale=0.125), got)


def test_plain_takes_any_head_dim_and_group():
    # the benchmark's CPU rehearsal decodes at head dim 16; the kernel's
    # limits are its own
    for hq, hkv, d in ((4, 2, 16), (16, 1, 48)):
        q, k, v, lens = _inputs(2, hq, hkv, d, SMAX, torch.float32, [3, 30])
        got = t_ops.decode_attention(q, k, v, lens, scale=d ** -0.5)
        torch.testing.assert_close(
            got, _masked_attend(q, k, v, lens.clamp(max=SMAX), d),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fault", ["strided_cache", "f16_cache", "f64_cache",
                                   "mixed_caches", "int64_lengths",
                                   "head_dim_48", "group_16", "shapes"])
def test_wrapper_refuses(fault):
    q, k, v, lens = _inputs(2, 8, 2, 64, SMAX, torch.float32, [3, 4])
    # the kernel's limits, which its wrapper checks before the device
    kernel_only = fault in ("head_dim_48", "group_16")
    if fault == "strided_cache":
        k = torch.randn(2, SMAX, 2 * 128)[:, :, :128]
    elif fault == "f16_cache":
        k, v = k.half(), v.half()
    elif fault == "f64_cache":
        k, v = k.double(), v.double()
    elif fault == "mixed_caches":
        v = v.to(torch.bfloat16)
    elif fault == "int64_lengths":
        lens = lens.long()
    elif fault == "head_dim_48":
        q, k, v, lens = _inputs(2, 8, 2, 48, SMAX, torch.float32, [3, 4])
    elif fault == "group_16":
        q, k, v, lens = _inputs(2, 16, 1, 64, SMAX, torch.float32, [3, 4])
    else:
        lens = lens[:1]
    before = t_build.launch_counts()
    with pytest.raises(ValueError):
        t_dec.decode_attention(q, k, v, lens, scale=0.125)
    if not kernel_only:
        with pytest.raises(ValueError):
            t_ops.decode_attention(q, k, v, lens, scale=0.125)
    assert t_build.launch_counts() == before


def test_kernel_impl_needs_cuda():
    q, k, v, lens = _inputs(2, 8, 2, 64, SMAX, torch.bfloat16, [3, 4])
    before = t_build.launch_counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_ops.decode_attention(q, k, v, lens, scale=0.125, impl="kernel")
    with pytest.raises(ValueError):
        t_ops.decode_attention(q, k, v, lens, scale=0.125, impl="pallas")
    assert t_build.launch_counts() == before


# -- the launch plan ----------------------------------------------------------


@pytest.mark.parametrize("shape", [
    (256, 4, 1024, 128, torch.bfloat16),    # Yi-9B's batch-decode step
    (4, 4, 545, 128, torch.bfloat16),       # chip_smoke's static batch
    (1, 1, 1, 64, torch.bfloat16),
    (8, 1, 800, 256, torch.float32),        # paligemma in f32
    (4, 32, 545, 80, torch.bfloat16),       # zamba2's shared block
    (2, 2, 100_000, 32, torch.float32),
])
def test_plan_covers_the_cache_and_fills_the_card(shape):
    b, hkv, smax, d, dtype = shape
    tp = t_dec.tile(d, dtype)
    chunk, chunks = t_dec.plan(b, hkv, smax, d, dtype, sms=132)
    assert chunk % tp == 0 and 1 <= chunks <= t_dec.MAX_CHUNKS
    assert (chunks - 1) * chunk < smax <= chunks * chunk
    # as many CTAs as the plan's waves, or one a tile where Smax is short
    target = t_dec.WAVES * t_dec.CTAS_PER_SM * 132
    assert b * hkv * chunks >= min(target, b * hkv * -(-smax // tp))


def test_tile_by_row_bytes():
    assert [t_dec.tile(d, torch.bfloat16) for d in HEAD_DIMS] == [
        64, 64, 64, 64, 32]
    assert [t_dec.tile(d, torch.float32) for d in HEAD_DIMS] == [
        64, 64, 32, 32, 16]


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _held(got, q, k, v, lens, d):
    """The kernel's output against the plain version computed from the
    same values in f32: within f32 rounding, plus the one rounding to bf16
    where q is bf16."""
    want = t_dec.plain(q.float(), k, v, lens, scale=1.0 / d ** 0.5)
    tol = (dict(rtol=2e-5, atol=2e-5) if q.dtype == torch.float32
           else dict(rtol=2 ** -8, atol=2e-5))
    torch.testing.assert_close(got.float(), want, **tol)


@pytest.mark.cuda
def test_kernel_matches_plain_at_batch_decode_shapes(cuda):
    g = torch.Generator().manual_seed(7)
    lengths = torch.randint(1, 1025, (256,), generator=g).tolist()
    lengths[:3] = [1, 1024, 64]
    q, k, v, lens = _inputs(256, 32, 4, 128, 1024, torch.bfloat16, lengths,
                            device=cuda)
    got = t_ops.decode_attention(q, k, v, lens, scale=128 ** -0.5)
    torch.cuda.synchronize()
    _held(got, q, k, v, lens, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("heads", REGISTRY,
                         ids=[f"{hq}x{hkv}x{d}" for hq, hkv, d in REGISTRY])
def test_kernel_matches_plain_at_registry_shapes(cuda, heads, dtype):
    hq, hkv, d = heads
    smax = 545
    q, k, v, lens = _inputs(4, hq, hkv, d, smax, dtype,
                            [1, smax, smax + 3, 200], device=cuda)
    got = t_ops.decode_attention(q, k, v, lens, scale=1.0 / d ** 0.5)
    torch.cuda.synchronize()
    _held(got, q, k, v, lens, d)


@pytest.mark.cuda
def test_graph_replays_with_new_lengths(cuda):
    q, k, v, lens = _inputs(8, 32, 4, 128, 1024, torch.bfloat16,
                            [5, 900, 1024, 1, 64, 65, 300, 511],
                            device=cuda)
    scale = 128 ** -0.5
    t_ops.decode_attention(q, k, v, lens, scale=scale)      # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = t_ops.decode_attention(q, k, v, lens, scale=scale)
    lens.copy_(torch.tensor([1000, 3, 17, 1024, 128, 2, 640, 63],
                            dtype=torch.int32))
    graph.replay()
    eager = t_ops.decode_attention(q, k, v, lens, scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    _held(out, q, k, v, lens, 128)


@pytest.mark.cuda
def test_launch_count_rises_by_one_per_call(cuda):
    q, k, v, lens = _inputs(2, 8, 2, 64, 100, torch.bfloat16, [3, 100],
                            device=cuda)
    before = t_build.launch_counts()
    for _ in range(3):
        t_ops.decode_attention(q, k, v, lens, scale=0.125)
    torch.cuda.synchronize()
    after = t_build.launch_counts()
    assert after["decode_attention"] - before["decode_attention"] == 3
    assert {n: c for n, c in after.items() if n != "decode_attention"} == {
        n: c for n, c in before.items() if n != "decode_attention"}
