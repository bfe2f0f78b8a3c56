"""Covariance (the fp64 SYRK on DMMA) and axpy (16-byte packs) on the
shapes their kernels find hardest.

On the CPU the port's ``ops.covariance`` and ``ops.axpy`` run their plain
versions; they are held on the exact shapes ``chip_smoke.py`` sends to the
kernels:
  * f32 (and bf16 for axpy) to the Pallas kernels in interpret mode, under
    ``tests/test_kernels.py``'s tolerances (covariance 1e-4 with symmetry
    at 1e-5; axpy 2e-4 in f32, 3e-2 in bf16);
  * fp64 to numpy at 1e-12: ragged M and N, data offset by +1e3 (a mean
    large against the spread, where the SYRK's zero fill past N shows if
    it is not masked), views one element off a 16-byte boundary.
The wrappers refuse CPU tensors before launching anything.

The ``cuda`` cases hold the kernels to the plain versions on the card
(fp64 at the job path's 1e-9, ``tests/test_offload_runtime.py:17``, and
covariance exactly symmetric); they decide in a fixture that there is no
card and skip here.  The JAX package is imported inside the tests that use
it, so on a machine with the card and no JAX ``python -m pytest -m cuda
tests/test_torch_syrk_axpy.py`` runs the ``cuda`` cases as they are.
"""

import zlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import build as t_build
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.atax import atax as k_atax
from repro_torch.kernels.axpy import axpy as k_axpy
from repro_torch.kernels.covariance import covariance as k_covariance
from repro_torch.kernels.flash_attention import flash_attention as k_flash
from repro_torch.kernels.matmul import matmul as k_matmul
from repro_torch.kernels.ssm_scan import ssm_scan as k_scan

JOB_TOL = 1e-9
EXACT = dict(rtol=1e-12, atol=1e-12)
#: M off the 16/32/64 tiles, N off the 16-deep panels (chip_smoke.py)
COV_SHAPES = [(m, n) for m in (1, 2, 17, 33, 65, 130) for n in (2, 17, 100)]
#: +1e3-offset data: (batch, M, N)
COV_OFFSET = [(3, 65, 100), (2, 130, 17), (1, 33, 2)]
#: views one element off a 16-byte boundary: (batch, M, N)
COV_VIEWS = [(3, 33, 100), (2, 65, 17)]
AXPY_LENGTHS = [1, 7, 4097, (1 << 20) + 3]
#: x, y offsets in elements; z is fresh, on a 16-byte boundary, so the
#: kernel takes 16-byte packs only where x and y sit on one too
AXPY_OFFSETS = [(0, 0), (1, 1), (1, 2), (0, 1), (3, 0)]
TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),      # test_kernels.py:14-16
       torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _sample_cov(a):
    c = a - a.mean(axis=-1, keepdims=True)
    return c @ np.swapaxes(c, -1, -2) / (a.shape[-1] - 1)


def _offset_views(rng, n, offsets, make):
    """Vectors of length n, each a view ``o`` elements into its buffer."""
    return [make(rng.standard_normal(n + 3))[o:o + n] for o in offsets]


@pytest.fixture(scope="module")
def pallas():
    """The reference package's kernel entry points (Pallas, interpret mode
    on the CPU)."""
    from repro.kernels import ops
    return ops


# -- on the CPU: the plain versions against the reference ----------------------


@pytest.mark.parametrize("mn", COV_SHAPES)
def test_covariance_f32_matches_pallas(pallas, mn):
    import jax.numpy as jnp
    data = _rng("cov f32", mn).standard_normal(mn).astype(np.float32)
    want = np.asarray(pallas.covariance(jnp.asarray(data), impl="pallas"))
    got = t_ops.covariance(torch.from_numpy(data))
    assert got.dtype == torch.float32 and got.shape == (mn[0], mn[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), got.numpy().T, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mn", COV_SHAPES)
def test_covariance_fp64_ragged_matches_numpy(mn):
    a = _rng("cov f64", mn).standard_normal((3,) + mn)
    got = t_ops.covariance(torch.from_numpy(a))
    assert got.dtype == torch.float64 and got.shape == (3, mn[0], mn[0])
    np.testing.assert_allclose(got.numpy(), _sample_cov(a), **EXACT)


@pytest.mark.parametrize("shape", COV_OFFSET)
def test_covariance_fp64_offset_data_matches_numpy(shape):
    """A mean of 1e3 against a spread of 1: the two-pass result, as the
    reference computes it, to 1e-12 (the one-pass form cancels here)."""
    a = _rng("cov offset", shape).standard_normal(shape) + 1e3
    got = t_ops.covariance(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, _sample_cov(a), **EXACT)
    assert np.abs(got).max() < 10          # no trace of mu_i * mu_j ~ 1e6


@pytest.mark.parametrize("shape", COV_VIEWS)
def test_covariance_fp64_view_off_16_bytes_matches_numpy(shape):
    flat = torch.from_numpy(
        _rng("cov view", shape).standard_normal(1 + int(np.prod(shape))))
    view = flat[1:].view(shape)
    assert view.data_ptr() % 16 and view.is_contiguous()
    np.testing.assert_allclose(t_ops.covariance(view).numpy(),
                               _sample_cov(view.numpy()), **EXACT)


@pytest.mark.parametrize("n", AXPY_LENGTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_axpy_matches_pallas(pallas, dtype, n):
    import jax.numpy as jnp
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    rng = _rng("axpy", str(dtype), n)
    xj, yj = (jnp.asarray(rng.standard_normal(n), jdt) for _ in range(2))
    want = np.asarray(pallas.axpy(xj, yj, 2.5, impl="pallas"), np.float32)
    xt, yt = (torch.from_numpy(np.array(v.astype(jnp.float32))).to(dtype)
              for v in (xj, yj))
    got = t_ops.axpy(xt, yt, 2.5)
    assert got.dtype == dtype and got.shape == (n,)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("offsets", AXPY_OFFSETS)
@pytest.mark.parametrize("n", AXPY_LENGTHS)
def test_axpy_fp64_views_match_numpy(n, offsets):
    x, y = _offset_views(_rng("axpy views", n, offsets), n, offsets,
                         torch.from_numpy)
    got = t_ops.axpy(x, y, 2.5)
    assert got.dtype == torch.float64 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), 2.5 * x.numpy() + y.numpy(),
                               **EXACT)


_CPU = torch.zeros
_WRAPPERS = {
    "axpy": lambda: k_axpy(_CPU(8), _CPU(8), 2.0),
    "matmul": lambda: k_matmul(_CPU(2, 3), _CPU(3, 4)),
    "atax": lambda: k_atax(_CPU(4, 3), _CPU(3)),
    "covariance": lambda: k_covariance(_CPU(3, 5)),
    "flash_attention": lambda: k_flash(*(_CPU(1, 2, 8, 64) for _ in range(3))),
    "ssm_scan": lambda: k_scan(_CPU(1, 4, 8, 16), _CPU(1, 4, 8, 16),
                               _CPU(1, 4, 16)),
}


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_wrappers_refuse_cpu_tensors_before_launching(name):
    before = t_build.launch_counts()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _WRAPPERS[name]()
    assert t_build.launch_counts() == before


def test_check_inputs_reports_a_cpu_tensor_before_its_layout_or_dtype():
    """One pass over the tensors finds a fault; the message names the
    first in the order device, dtype, layout."""
    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        t_build.check_inputs("k", x, x.T)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        t_build.check_inputs("k", x, x.double())


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _held_cov(data):
    before = t_build.KERNELS["covariance"].launches
    got = t_ops.covariance(data, impl="kernel")
    want = t_ref.covariance(data)
    torch.cuda.synchronize()
    assert t_build.KERNELS["covariance"].launches == before + 1
    assert got.dtype == data.dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=JOB_TOL, atol=JOB_TOL)
    assert torch.equal(got, got.mT)


@pytest.mark.cuda
@pytest.mark.parametrize("mn", COV_SHAPES)
def test_fp64_covariance_kernel_ragged_on_card(cuda, mn):
    _held_cov(torch.from_numpy(
        _rng("cov f64", mn).standard_normal((3,) + mn)).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", COV_OFFSET + [(8, 1024, 200),
                                                (1, 2048, 64)])
def test_fp64_covariance_kernel_offset_data_on_card(cuda, shape):
    """+1e3 data; (8, 1024, 200) takes the 128-row tiles, (1, 2048, 64)
    the 64-row ones (too few 128 tiles to fill the card twice)."""
    _held_cov(torch.from_numpy(
        _rng("cov offset", shape).standard_normal(shape) + 1e3).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", COV_VIEWS)
def test_fp64_covariance_kernel_view_off_16_bytes_on_card(cuda, shape):
    flat = torch.from_numpy(_rng("cov view", shape).standard_normal(
        1 + int(np.prod(shape)))).to(cuda)
    view = flat[1:].view(shape)
    assert view.data_ptr() % 16
    _held_cov(view)


@pytest.mark.cuda
@pytest.mark.parametrize("mn", [(1, 2), (17, 100), (130, 17), (65, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_covariance_kernel_f32_bf16_on_card(cuda, dtype, mn):
    data = torch.from_numpy(_rng("cov lp", mn).standard_normal(
        (2,) + mn)).to(dtype).to(cuda)
    got = t_ops.covariance(data, impl="kernel").double()
    want = t_ref.covariance(data).double()
    tol = 1e-4 if dtype == torch.float32 else 1e-2      # test_kernels.py:73
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    torch.testing.assert_close(got, got.mT, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", AXPY_OFFSETS)
@pytest.mark.parametrize("n", AXPY_LENGTHS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_axpy_kernel_views_on_card(cuda, dtype, n, offsets):
    x, y = _offset_views(_rng("axpy card", n, offsets), n, offsets,
                         lambda a: torch.from_numpy(a).to(dtype).to(cuda))
    before = t_build.KERNELS["axpy"].launches
    got = k_axpy(x, y, 2.5)
    want = t_ref.axpy(x, y, 2.5)
    torch.cuda.synchronize()
    assert t_build.KERNELS["axpy"].launches == before + 1
    assert got.dtype == dtype and got.shape == (n,)
    tol = (dict(rtol=JOB_TOL, atol=JOB_TOL) if dtype == torch.float64
           else TOL[dtype])
    torch.testing.assert_close(got.double(), want.double(), **tol)
    t_ops.axpy(x, y, 2.5, impl="kernel")          # and through ops
    assert t_build.KERNELS["axpy"].launches == before + 2
