"""The port's attention against the reference's, on the CPU.

One subprocess (``run_subprocess``, one device, 32-bit: the model stack
breaks under x64) makes every input with numpy and runs the reference on
it: ``repro.kernels.ref.attention``, the Pallas flash kernel in interpret
mode (``ops.attention(impl="pallas")``) and the model's GQA decode paths.
It writes inputs and outputs to one ``.npz``; the port replays the same
inputs in-process on the CPU, where ``ops.attention`` runs its plain
version and the model's ``"plain"``/``"chunked"`` impls run as written.
Everything is float32 and held to ``2e-3``, the bar of the reference's
kernel tests (``tests/test_kernels.py:78-113``).

Sq < Skv is held to ``ref.attention`` only: the TPU kernel aligns its
causal mask top-left (``flash_attention.py:52, 67-71``) while
``ref.attention``, the model's mask (``ref.causal_mask``) and the
port's kernel align it bottom-right, and the two agree only for Sq ==
Skv.  So is causal Sq > Skv, whose first Sq - Skv rows see no column:
``ref.attention`` gives them the mean of V (a softmax over a row filled
with -1e30), held at ``1e-5``.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import build as t_build
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.models import attention as t_attn
from repro_torch.models import get as t_get
from repro_torch.models import reduced as t_reduced

TOL = dict(rtol=2e-3, atol=2e-3)      # tests/test_kernels.py:78-113
#: tests/test_kernels.py's flash sweep: (B, H, S, D), Sq == Skv
SWEEP = [(1, 2, 128, 64), (2, 4, 256, 64), (1, 2, 100, 64), (1, 8, 128, 128),
         (1, 1, 384, 80)]
#: Sq < Skv: (B, H, Sq, Skv, D)
OFFSET = [(1, 2, 37, 100, 64), (2, 4, 64, 160, 32), (1, 2, 1, 45, 80),
          (1, 1, 130, 131, 128)]
#: GQA: (B, Hq, Hkv, Sq, Skv, D)
GQA = [(2, 8, 2, 48, 48, 32), (1, 32, 4, 64, 64, 128), (1, 6, 3, 20, 50, 64)]
#: causal Sq > Skv: (B, H, Sq, Skv, D)
ABOVE = [(1, 2, 40, 9, 64), (2, 3, 70, 33, 128)]
DECODE = dict(arch="yi-9b", batch=2, smax=24, pos=9, pos_b=(3, 17))

_REFERENCE_CODE = '''
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro.kernels import ops, ref
from repro.models import attention as attn
from repro import models as M

rng = np.random.default_rng(7)
out = {{}}

def rnd(*shape):
    return rng.standard_normal(shape).astype(np.float32)

for i, (b, h, s, d) in enumerate({sweep}):
    q, k, v = rnd(b, h, s, d), rnd(b, h, s, d), rnd(b, h, s, d)
    out.update({{f"sweep{{i}}_q": q, f"sweep{{i}}_k": k, f"sweep{{i}}_v": v}})
    for causal in (True, False):
        out[f"sweep{{i}}_ref_{{causal}}"] = np.asarray(
            ref.attention(q, k, v, causal=causal))
        out[f"sweep{{i}}_pallas_{{causal}}"] = np.asarray(
            ops.attention(q, k, v, causal=causal, impl="pallas"))
for i, (b, h, sq, skv, d) in enumerate({offset}):
    q, k, v = rnd(b, h, sq, d), rnd(b, h, skv, d), rnd(b, h, skv, d)
    out.update({{f"off{{i}}_q": q, f"off{{i}}_k": k, f"off{{i}}_v": v}})
    for causal in (True, False):
        out[f"off{{i}}_ref_{{causal}}"] = np.asarray(
            ref.attention(q, k, v, causal=causal))
for i, (b, hq, hkv, sq, skv, d) in enumerate({gqa}):
    q, k, v = rnd(b, hq, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv, skv, d)
    out.update({{f"gqa{{i}}_q": q, f"gqa{{i}}_k": k, f"gqa{{i}}_v": v}})
    out[f"gqa{{i}}_ref"] = np.asarray(ops.attention(q, k, v, impl="xla"))
    out[f"gqa{{i}}_xla"] = np.asarray(attn.multihead_attention(
        q, k, v, impl="xla"))
    if sq == skv:
        out[f"gqa{{i}}_pallas"] = np.asarray(
            ops.attention(q, k, v, impl="pallas"))

dec = {decode}
cfg = dataclasses.replace(M.reduced(M.get(dec["arch"])),
                          compute_dtype="float32")
params = jax.device_get(M.init_params(jax.random.key(3), cfg))
p = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
for name, val in p.items():
    out[f"dec_p_{{name}}"] = np.asarray(val)
b, smax = dec["batch"], dec["smax"]
kvd = cfg.n_kv_heads * cfg.head_dim
x = rnd(b, 1, cfg.d_model)
kc, vc = rnd(b, smax, kvd), rnd(b, smax, kvd)
out.update({{"dec_x": x, "dec_k": kc, "dec_v": vc}})
o, k2, v2 = attn.gqa_decode(jnp.asarray(x), p, cfg, jnp.asarray(kc),
                            jnp.asarray(vc), dec["pos"])
out.update({{"dec_o": np.asarray(o), "dec_k2": np.asarray(k2),
             "dec_v2": np.asarray(v2)}})
pos_b = jnp.asarray(dec["pos_b"], jnp.int32)
o, k2, v2 = attn.gqa_decode_ragged(jnp.asarray(x), p, cfg, jnp.asarray(kc),
                                   jnp.asarray(vc), pos_b)
out.update({{"rag_o": np.asarray(o), "rag_k2": np.asarray(k2),
             "rag_v2": np.asarray(v2)}})
rng = np.random.default_rng(11)
for i, (b, h, sq, skv, d) in enumerate({above}):
    q, k, v = rnd(b, h, sq, d), rnd(b, h, skv, d), rnd(b, h, skv, d)
    out.update({{f"above{{i}}_q": q, f"above{{i}}_k": k, f"above{{i}}_v": v}})
    out[f"above{{i}}_ref"] = np.asarray(ref.attention(q, k, v, causal=True))
np.savez({path!r}, **out)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory, subproc):
    path = str(tmp_path_factory.mktemp("attn_ref") / "ref.npz")
    subproc(_REFERENCE_CODE.format(sweep=SWEEP, offset=OFFSET, gqa=GQA,
                                   above=ABOVE, decode=DECODE, path=path),
            devices=1, x64=False, timeout=900)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(), want,
                               **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("i", range(len(SWEEP)))
def test_ref_attention_matches_reference_and_pallas(reference, i, causal):
    r = reference
    q, k, v = (_t(r[f"sweep{i}_{n}"]) for n in "qkv")
    got = t_ref.attention(q, k, v, causal=causal)
    _close(got, r[f"sweep{i}_ref_{causal}"])
    # Sq == Skv: the TPU kernel's top-left mask agrees with bottom-right
    _close(got, r[f"sweep{i}_pallas_{causal}"])
    before = t_build.launch_counts()
    _close(t_ops.attention(q, k, v, causal=causal), r[f"sweep{i}_ref_{causal}"])
    assert t_build.launch_counts() == before     # the plain version ran


@pytest.mark.parametrize("impl", ["plain", "chunked"])
@pytest.mark.parametrize("i", range(len(SWEEP)))
def test_multihead_attention_matches_pallas(reference, i, impl):
    r = reference
    q, k, v = (_t(r[f"sweep{i}_{n}"]) for n in "qkv")
    got = t_attn.multihead_attention(q, k, v, impl=impl, chunk=48)
    _close(got, r[f"sweep{i}_pallas_True"])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("i", range(len(OFFSET)))
def test_sq_below_skv_matches_reference_ref(reference, i, causal):
    """Bottom-right causal alignment, held to ``ref.attention`` only (the
    TPU kernel aligns top-left, which differs here)."""
    r = reference
    q, k, v = (_t(r[f"off{i}_{n}"]) for n in "qkv")
    want = r[f"off{i}_ref_{causal}"]
    _close(t_ref.attention(q, k, v, causal=causal), want)
    if causal:      # the model's impls are always causal
        for impl in ("plain", "chunked"):
            _close(t_attn.multihead_attention(q, k, v, impl=impl, chunk=32),
                   want)


@pytest.mark.parametrize("i", range(len(ABOVE)))
def test_sq_above_skv_matches_reference_ref(reference, i):
    """Causal Sq > Skv: the rows that see no column take the mean of V,
    in the port's plain version as in the reference's."""
    r = reference
    q, k, v = (_t(r[f"above{i}_{n}"]) for n in "qkv")
    want = r[f"above{i}_ref"]
    for got in (t_ref.attention(q, k, v, causal=True),
                t_ops.attention(q, k, v, causal=True)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    sq, skv = q.shape[2], k.shape[2]
    np.testing.assert_allclose(want[:, :, :sq - skv],
                               np.broadcast_to(r[f"above{i}_v"].mean(
                                   axis=2, keepdims=True),
                                   want[:, :, :sq - skv].shape),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("i", range(len(GQA)))
def test_gqa_matches_reference(reference, i):
    r = reference
    q, k, v = (_t(r[f"gqa{i}_{n}"]) for n in "qkv")
    want = r[f"gqa{i}_ref"]
    _close(t_ops.attention(q, k, v), want)
    _close(t_ref.attention(q, k, v), want)
    for impl in ("plain", "chunked"):
        _close(t_attn.multihead_attention(q, k, v, impl=impl, chunk=16),
               r[f"gqa{i}_xla"])
    if f"gqa{i}_pallas" in r:
        _close(t_ops.attention(q, k, v), r[f"gqa{i}_pallas"])


def _decode_setup(r):
    cfg = dataclasses.replace(t_reduced(t_get(DECODE["arch"])),
                              compute_dtype="float32")
    p = {name[len("dec_p_"):]: _t(r[name]) for name in r
         if name.startswith("dec_p_")}
    return cfg, p, _t(r["dec_x"]), _t(r["dec_k"]), _t(r["dec_v"])


def test_gqa_decode_matches_reference(reference):
    r = reference
    cfg, p, x, kc, vc = _decode_setup(r)
    o, k2, v2 = t_attn.gqa_decode(x, p, cfg, kc, vc, DECODE["pos"])
    _close(o, r["dec_o"])
    _close(k2, r["dec_k2"])
    _close(v2, r["dec_v2"])
    assert k2 is kc                      # written in place


def test_gqa_decode_ragged_matches_reference(reference):
    r = reference
    cfg, p, x, kc, vc = _decode_setup(r)
    pos_b = torch.tensor(DECODE["pos_b"], dtype=torch.int32)
    o, k2, v2 = t_attn.gqa_decode_ragged(x, p, cfg, kc, vc, pos_b)
    _close(o, r["rag_o"])
    _close(k2, r["rag_k2"])
    _close(v2, r["rag_v2"])


# -- the impl switch ------------------------------------------------------------


def test_impl_switch_on_cpu():
    q = torch.randn(1, 4, 16, 32)
    k = torch.randn(1, 2, 16, 32)
    assert t_attn.resolve_impl("auto", q) == "plain"
    with pytest.raises(RuntimeError, match="CUDA"):
        t_attn.multihead_attention(q, k, k, impl="kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_ops.attention(q, k, k, impl="kernel")
    with pytest.raises(ValueError):
        t_attn.multihead_attention(q, k, k, impl="xla")
    assert t_attn.resolve_impl("stub", q) == "stub"
    with pytest.raises(ValueError, match="multiple"):
        t_ops.attention(q, torch.randn(1, 3, 16, 32), torch.randn(1, 3, 16, 32))


def test_kernel_wrapper_validates_before_launching():
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.randn(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)                 # CPU tensors never launch
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(torch.randn(1, 2, 8, 48), torch.randn(1, 2, 8, 48),
                        torch.randn(1, 2, 8, 48))
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q, torch.randn(1, 3, 8, 32), torch.randn(1, 3, 8, 32))


def test_fully_visible_rows_match_a_dense_softmax():
    """The plain version against a direct numpy softmax, GQA and Sq < Skv."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, 4, 3, 32)).astype(np.float32)
    k = rng.standard_normal((1, 2, 5, 32)).astype(np.float32)
    v = rng.standard_normal((1, 2, 5, 32)).astype(np.float32)
    got = t_ref.attention(_t(q), _t(k), _t(v), causal=True).numpy()
    kk, vv = np.repeat(k, 2, axis=1), np.repeat(v, 2, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q, kk) / np.sqrt(32)
    mask = np.tril(np.ones((3, 5), bool), k=2)
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose(got, np.einsum("bhqk,bhkd->bhqd", p, vv),
                               rtol=1e-5, atol=1e-5)


#: (Sq, Skv, prefix_len, chunk): Sq <= Skv, Sq > Skv, a prefix, and KV
#: chunks whose last one is short
MASKS = [(37, 100, 0, 100), (64, 64, 0, 64), (1, 45, 0, 45), (40, 9, 0, 9),
         (70, 33, 0, 33), (20, 20, 8, 20), (12, 30, 8, 30), (20, 50, 0, 16),
         (20, 50, 8, 16), (50, 20, 8, 7)]


@pytest.mark.parametrize("sq, skv, prefix, chunk", MASKS)
def test_causal_mask_equals_the_forms_it_replaced(sq, skv, prefix, chunk):
    """``ref.causal_mask`` against the three masks it replaced, written
    out here as they were: the ``tril`` (``ref.causal_mask`` and
    ``ref.attention``, no prefix), the model's plain mask, and the chunked
    attention's mask of one KV chunk from column ``start`` on."""
    full = t_ref.causal_mask(sq, skv, prefix_len=prefix)
    if prefix == 0:
        tril = torch.ones(sq, skv, dtype=torch.bool).tril(diagonal=skv - sq)
        assert torch.equal(full, tril)
    rows = torch.arange(sq)[:, None] + (skv - sq)
    cols = torch.arange(skv)[None, :]
    plain = (cols <= rows) | (cols < prefix) if prefix > 0 else cols <= rows
    assert torch.equal(full, plain)
    for start in range(0, skv, chunk):
        width = min(chunk, skv - start)
        cols = start + torch.arange(width)[None, :]
        allowed = cols <= rows
        if prefix > 0:
            allowed = allowed | (cols < prefix)
        got = t_ref.causal_mask(sq, skv, prefix_len=prefix, start=start,
                                width=width)
        assert torch.equal(got, allowed)
        assert torch.equal(got, full[:, start:start + width])


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_on_card(cuda, dtype):
    g = torch.Generator().manual_seed(0)
    tol = 2e-3 if dtype == torch.float32 else 1e-2
    for (b, hq, hkv, sq, skv, d) in [(1, 2, 2, 128, 128, 64),
                                     (2, 8, 2, 70, 130, 32),
                                     (1, 4, 1, 100, 100, 80),
                                     (1, 32, 4, 200, 200, 128)]:
        q = torch.randn(b, hq, sq, d, generator=g).to(dtype).to(cuda)
        k = torch.randn(b, hkv, skv, d, generator=g).to(dtype).to(cuda)
        v = torch.randn(b, hkv, skv, d, generator=g).to(dtype).to(cuda)
        for causal in (True, False):
            got = t_ops.attention(q, k, v, causal=causal, impl="kernel")
            want = t_ref.attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
