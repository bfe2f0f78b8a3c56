"""The port's kernel functions against the Pallas kernels.

On the CPU the port's ``ops`` run the plain PyTorch versions (the
hand-written CUDA kernels run only on the card); they are held to the
Pallas kernels in interpret mode over ``tests/test_kernels.py``'s shape
sweeps and per-dtype tolerances, on the same inputs made with numpy.  The
float64 versions — the job path's type — are held to numpy at 1e-12.  The
tests at the end need a CUDA card and skip without one; ``chip_smoke.py``
runs the same comparison on the H100.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread)

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as r_ops
from repro_torch.kernels import build as t_build
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

RNG = np.random.default_rng(42)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    # tests/test_kernels.py:14-16
    return (dict(rtol=3e-2, atol=3e-2) if name == "bfloat16"
            else dict(rtol=2e-4, atol=2e-4))


def _pair(arr, name):
    """One numpy array as the same values in both frameworks."""
    jdt, tdt = DTYPES[name]
    j = jnp.asarray(arr, jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("n", [64, 100, 1024, 4096, 5000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_axpy(n, dtype):
    xj, xt = _pair(RNG.standard_normal(n), dtype)
    yj, yt = _pair(RNG.standard_normal(n), dtype)
    want = r_ops.axpy(xj, yj, 2.5, impl="pallas")
    got = t_ops.axpy(xt, yt, 2.5)
    assert got.shape == tuple(want.shape) and got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("mkn", [(128, 128, 128), (256, 384, 128),
                                 (100, 70, 36), (17, 300, 129), (512, 64, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul(mkn, dtype):
    m, k, n = mkn
    aj, at = _pair(RNG.standard_normal((m, k)), dtype)
    bj, bt = _pair(RNG.standard_normal((k, n)), dtype)
    want = r_ops.matmul(aj, bj, impl="pallas")
    got = t_ops.matmul(at, bt)
    assert got.shape == (m, n)
    # tests/test_kernels.py:43-44
    np.testing.assert_allclose(
        _f32(got), _f32(want),
        rtol=5e-2 if dtype == "bfloat16" else 1e-3,
        atol=5e-1 if dtype == "bfloat16" else 1e-2)


@pytest.mark.parametrize("mn", [(256, 128), (100, 64), (512, 256), (33, 100)])
def test_atax(mn):
    m, n = mn
    aj, at = _pair(RNG.standard_normal((m, n)), "float32")
    xj, xt = _pair(RNG.standard_normal(n), "float32")
    want = r_ops.atax(aj, xj, impl="pallas")
    got = t_ops.atax(at, xt)
    # tests/test_kernels.py:63
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("mn", [(32, 64), (128, 256), (100, 50), (8, 2)])
def test_covariance(mn):
    m, n = mn
    dj, dt = _pair(RNG.standard_normal((m, n)), "float32")
    want = r_ops.covariance(dj, impl="pallas")
    got = t_ops.covariance(dt)
    # tests/test_kernels.py:73-75
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_f32(got), _f32(got).T, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1, 7, 1023, 2048])
def test_axpy_any_length(n):
    """Arbitrary (non-aligned) lengths: the port pads nothing."""
    x = torch.arange(n, dtype=torch.float32)
    got = t_ops.axpy(x, torch.ones(n), -1.0)
    np.testing.assert_allclose(got.numpy(), 1.0 - np.arange(n), rtol=1e-6)


# -- float64: the job path's type, against numpy ------------------------------


def test_float64_plain_versions_match_numpy():
    a = RNG.standard_normal((3, 40, 24))
    b = RNG.standard_normal((3, 24, 16))
    x = RNG.standard_normal((3, 24))
    y = RNG.standard_normal((3, 24))
    T = torch.from_numpy
    tol = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(t_ops.axpy(T(x), T(y), 2.5).numpy(),
                               2.5 * x + y, **tol)
    np.testing.assert_allclose(t_ops.matmul(T(a), T(b)).numpy(), a @ b, **tol)
    want = np.einsum("bmn,bm->bn", a, np.einsum("bmn,bn->bm", a, x))
    np.testing.assert_allclose(t_ops.atax(T(a), T(x)).numpy(), want, **tol)
    c = a - a.mean(axis=-1, keepdims=True)
    np.testing.assert_allclose(t_ops.covariance(T(a)).numpy(),
                               c @ c.transpose(0, 2, 1) / (a.shape[-1] - 1),
                               **tol)
    for got in (t_ops.axpy(T(x), T(y), 2.5), t_ops.covariance(T(a))):
        assert got.dtype == torch.float64


def test_batched_plain_equals_per_item():
    a = torch.from_numpy(RNG.standard_normal((2, 3, 17, 9)))
    x = torch.from_numpy(RNG.standard_normal((2, 3, 9)))
    batched = t_ops.atax(a, x)
    cov = t_ops.covariance(a)
    # batched and single BLAS calls may sum in another order: fp64 rounding
    tol = dict(rtol=1e-12, atol=1e-12)
    for i in range(2):
        for j in range(3):
            torch.testing.assert_close(batched[i, j],
                                       t_ops.atax(a[i, j], x[i, j]), **tol)
            torch.testing.assert_close(cov[i, j],
                                       t_ops.covariance(a[i, j]), **tol)


# -- the impl switch ----------------------------------------------------------


def test_impl_switch_on_cpu():
    x = torch.ones(8, dtype=torch.float64)
    before = t_build.launch_counts()
    assert torch.equal(t_ops.axpy(x, x, 2.0, impl="auto"),
                       t_ops.axpy(x, x, 2.0, impl="plain"))
    with pytest.raises(ValueError):
        t_ops.axpy(x, x, 2.0, impl="pallas")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_ops.axpy(x, x, 2.0, impl="kernel")
    assert t_build.launch_counts() == before     # no kernel ran


#: kernels with no Pallas twin, each with the reference function whose
#: plain work it takes over
NO_PALLAS_TWIN = {"decode_attention": "gqa_decode_ragged",
                  "mla_attention": "_chunked_attention"}


def test_kernel_table_names_real_files():
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for k in t_build.KERNELS.values():
        assert os.path.exists(os.path.join(repo, k.source)), k.source
        path, line = k.replaces.rsplit(":", 1)
        src = open(os.path.join(repo, path)).read().splitlines()
        name = NO_PALLAS_TWIN.get(k.name, k.name)
        assert src[int(line) - 1].startswith(f"def {name}("), k.replaces
        # a Pallas twin lives under the reference's kernels, a plain
        # function outside them
        assert path.startswith("src/repro/kernels/") == (
            k.name not in NO_PALLAS_TWIN), k.replaces
    assert set(t_build.SOURCES) == {
        os.path.basename(k.source) for k in t_build.KERNELS.values()}


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_kernels_match_plain_on_card(cuda, dtype):
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64).to(
            dtype).to(cuda)

    tol = {torch.float64: 1e-12, torch.float32: 2e-3,
           torch.bfloat16: 5e-1}[dtype]
    a, b, x, y = rnd(2, 33, 70), rnd(2, 70, 36), rnd(2, 70), rnd(2, 70)
    pairs = [(t_ops.axpy(x, y, 2.5, impl="kernel"), t_ref.axpy(x, y, 2.5)),
             (t_ops.matmul(a, b, impl="kernel"), t_ref.matmul(a, b)),
             (t_ops.atax(a, x, impl="kernel"), t_ref.atax(a, x)),
             (t_ops.covariance(a, impl="kernel"), t_ref.covariance(a))]
    torch.cuda.synchronize()
    for got, want in pairs:
        torch.testing.assert_close(got.double(), want.double(), rtol=tol,
                                   atol=tol)
