"""The tensor-core kernels: bf16 flash attention (wgmma fed by TMA) and
fp64 matmul (DMMA behind a cp.async ring).

This file imports no JAX, so the cases marked ``cuda`` run as they are on
a machine with the card (``python -m pytest -m cuda
tests/test_torch_tensor_cores.py``); here they skip.  On the CPU it holds
the plain versions to numpy on the shapes the kernels find hardest (causal
rows that see no column, skinny and ragged fp64 products) and the SASS
census parser to a listing of known counts.

Tolerances: flash attention as ``chip_smoke.py``'s ``FLASH_TOL`` (f32
2e-3, the reference kernel tests' bar; bf16 1e-2, about one bf16 ulp of
unit-scale outputs); fp64 matmul at 1e-9, the job path's bar
(``tests/test_offload_runtime.py:17``); one Q·Kᵀ tile at 1e-5 relative,
since bf16 × bf16 products are exact in f32 and only the order of the
f32 sums differs.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import zlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import build as t_build
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.flash_attention import qk_tile

FLASH_TOL = {torch.float32: 2e-3, torch.bfloat16: 1e-2}
JOB_TOL = 1e-9
#: (B, Hq, Hkv, Sq, Skv, D): every head dim, GQA, Sq < Skv, causal
#: Sq > Skv (rows with no visible column), Sq and Skv off the tiles
#: (128 query rows, 64 KV rows), Skv = 1
FLASH_CASES = [
    (1, 2, 2, 128, 128, 64),
    (2, 4, 2, 96, 96, 32),
    (1, 1, 1, 384, 384, 80),
    (1, 8, 8, 128, 128, 128),
    (1, 32, 4, 200, 200, 128),
    (2, 8, 2, 64, 200, 128),
    (1, 4, 4, 37, 300, 64),
    (1, 2, 2, 40, 9, 64),
    (2, 8, 2, 300, 70, 128),
    (1, 3, 1, 130, 65, 80),
    (2, 4, 4, 100, 33, 32),
    (1, 2, 2, 5, 1, 80),
    (1, 4, 2, 1, 1, 128),
    (3, 6, 3, 129, 191, 64),
]
#: fp64 matmul (batch, M, K, N): the tile height follows M, K and N off
#: the 16-deep panels and 64-wide tiles, odd row lengths (8-byte copies)
MATMUL_CASES = [(32, m, k, n) for m in (1, 2, 16, 31, 32, 33, 128, 1024)
                for k, n in ((1024, 1024), (100, 130), (33, 65))]


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


# -- on the CPU ------------------------------------------------------------------


@pytest.mark.parametrize("case", [(1, 2, 2, 40, 9, 64), (2, 8, 2, 300, 70, 32),
                                  (1, 3, 1, 7, 2, 80)])
def test_plain_rows_with_no_visible_column_take_the_mean_of_v(case):
    """Causal Sq > Skv: rows r with r + Skv - Sq < 0 see no column, and a
    softmax over a row filled with -1e30 is uniform: the mean of V (per
    KV head).  The other rows see columns 0 .. r + Skv - Sq only."""
    b, hq, hkv, sq, skv, d = case
    rng = _rng("empty rows", case)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    got = t_ref.attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=True).numpy()
    rep = hq // hkv
    kk, vv = np.repeat(k, rep, axis=1), np.repeat(v, rep, axis=1)
    empty = sq - skv
    np.testing.assert_allclose(
        got[:, :, :empty],
        np.broadcast_to(vv.mean(axis=2, keepdims=True), got[:, :, :empty].shape),
        rtol=1e-5, atol=1e-5)
    s = np.einsum("bhqd,bhkd->bhqk", q, kk) / np.sqrt(d)
    s = np.where(np.tril(np.ones((sq, skv), bool), k=skv - sq), s, -np.inf)
    s = s[:, :, empty:]
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose(got[:, :, empty:],
                               np.einsum("bhqk,bhkd->bhqd", p, vv),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [1, 2, 16, 31, 33, 128])
def test_plain_fp64_matmul_on_skinny_ragged_shards(m):
    rng = _rng("matmul", m)
    a = rng.standard_normal((4, m, 33))
    b = rng.standard_normal((4, 33, 65))
    got = t_ops.matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float64 and got.shape == (4, m, 65)
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-12, atol=1e-12)


_LISTING = """
\t\tFunction : _ZN2tc18flash_wgmma_kernelILi128EEEv
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0150*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0160*/                   HGMMA.64x128x16.F32.BF16 R88, R20, gdesc[UR8], R88 ;
        /*0170*/              @P0  UTMALDG.3D [UR8], [UR4] ;
\t\tFunction : _ZN4dmma18matmul_dmma_kernelILi32EEEv
        /*0170*/                   DMMA.884 R8, R10, R12, R8 ;
        /*0180*/              @!P1 LDGSTS.E.BYPASS.LTC128B.128 [R3], desc[UR6][R4.64] ;
        /*0190*/                   DMMA.884 R14, R10, R12, R14 ;
\t\tFunction : _Z11axpy_kernelIdEvv
        /*0000*/                   FFMA R1, R2, R3, R4 ;
\t\tFunction : _ZN12_GLOBAL__N_119atax_cluster_kernelIdLi8ELi1EEEvv
        /*0200*/              @P0  UBLKCP.S.G [UR4], [UR6], UR8 ;
"""


def test_sass_census_counts_each_function():
    census = t_build.parse_sass(_LISTING)
    assert census == {
        "_ZN2tc18flash_wgmma_kernelILi128EEEv":
            dict(HGMMA=2, HMMA=0, DMMA=0, UTMALDG=1, LDGSTS=0, UBLKCP=0),
        "_ZN4dmma18matmul_dmma_kernelILi32EEEv":
            dict(HGMMA=0, HMMA=0, DMMA=2, UTMALDG=0, LDGSTS=1, UBLKCP=0),
        "_Z11axpy_kernelIdEvv":
            dict(HGMMA=0, HMMA=0, DMMA=0, UTMALDG=0, LDGSTS=0, UBLKCP=0),
        "_ZN12_GLOBAL__N_119atax_cluster_kernelIdLi8ELi1EEEvv":
            dict(HGMMA=0, HMMA=0, DMMA=0, UTMALDG=0, LDGSTS=0, UBLKCP=1),
    }


def test_qk_tile_validates_before_launching():
    q = torch.zeros(64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        qk_tile(q, q)                               # CPU tensors never launch
    with pytest.raises(ValueError, match="tiles"):
        qk_tile(q.float(), q.float())
    with pytest.raises(ValueError, match="tiles"):
        qk_tile(torch.zeros(32, 64, dtype=torch.bfloat16),
                torch.zeros(32, 64, dtype=torch.bfloat16))


# -- on the card --------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _card(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 80, 128])
def test_qk_tile_matches_f32_product_on_card(cuda, d):
    rng = _rng("qk", d)
    q, k = (_card(rng, (64, d), torch.bfloat16, cuda) for _ in range(2))
    got = qk_tile(q, k)
    want = q.double() @ k.double().T
    torch.cuda.synchronize()
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_on_card(cuda, dtype, case, causal):
    b, hq, hkv, sq, skv, d = case
    rng = _rng("flash", case)
    q = _card(rng, (b, hq, sq, d), dtype, cuda)
    k, v = (_card(rng, (b, hkv, skv, d), dtype, cuda) for _ in range(2))
    before = t_build.KERNELS["flash_attention"].launches
    got = t_ops.attention(q, k, v, causal=causal, impl="kernel")
    want = t_ref.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert t_build.KERNELS["flash_attention"].launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if causal and sq > skv:       # rows with no visible column: mean of V
        mean = v.float().mean(dim=2, keepdim=True).repeat_interleave(
            hq // hkv, dim=1)
        torch.testing.assert_close(got[:, :, :sq - skv].float(),
                                   mean.expand(-1, -1, sq - skv, -1),
                                   rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", MATMUL_CASES)
def test_fp64_matmul_matches_plain_on_card(cuda, case):
    batch, m, k, n = case
    rng = _rng("dmma", case)
    a = torch.from_numpy(rng.standard_normal((batch, m, k))).to(cuda)
    b = torch.from_numpy(rng.standard_normal((batch, k, n))).to(cuda)
    got = t_ops.matmul(a, b, impl="kernel")
    want = t_ref.matmul(a, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=JOB_TOL, atol=JOB_TOL)


@pytest.mark.cuda
def test_fp64_matmul_on_a_view_with_odd_offset(cuda):
    """Operands that start off a 16-byte boundary take the 8-byte copies."""
    rng = _rng("dmma view")
    a = torch.from_numpy(rng.standard_normal(1 + 3 * 40 * 64)).to(cuda)
    b = torch.from_numpy(rng.standard_normal(1 + 3 * 64 * 48)).to(cuda)
    a, b = a[1:].view(3, 40, 64), b[1:].view(3, 64, 48)
    torch.testing.assert_close(t_ops.matmul(a, b, impl="kernel"),
                               t_ref.matmul(a, b), rtol=JOB_TOL, atol=JOB_TOL)


@pytest.mark.cuda
def test_flash_kernel_on_views_off_a_16_byte_boundary(cuda):
    """TMA reads 16-byte aligned tensors: the wrapper copies a view that
    starts elsewhere, and the result is the same."""
    rng = _rng("flash view")
    q, k, v = (_card(rng, (1 + 2 * 70 * 64,), torch.bfloat16, cuda)
               for _ in range(3))
    q, k, v = (t[1:].view(1, 2, 70, 64) for t in (q, k, v))
    assert q.data_ptr() % 16
    got = t_ops.attention(q, k, v, causal=True, impl="kernel")
    with pytest.raises(ValueError, match="KV column"):
        t_ops.attention(q, k[:, :, :0], v[:, :, :0], impl="kernel")
    torch.testing.assert_close(got.float(),
                               t_ref.attention(q, k, v).float(),
                               rtol=FLASH_TOL[torch.bfloat16],
                               atol=FLASH_TOL[torch.bfloat16])
