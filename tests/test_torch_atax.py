"""atax on Hopper (``csrc/atax.cu``): its launch plan and the order in which
it sums.

The kernel runs only on the card.  Here, on the CPU:
  * :func:`repro_torch.kernels.atax.plan` over a grid of shapes: every
    column belongs to exactly one cluster rank, every row to exactly one
    (row group, panel); shared memory, cluster size and grid within the
    card's limits; one row group at the offload job's shape;
  * an order twin: a PyTorch function that cuts and sums as the kernel does
    (column slices, panels, ranks in order, row groups in order), held to
    the Pallas kernel in interpret mode at ``tests/test_kernels.py``'s
    sweep (2e-3, ``test_kernels.py:63``) and to ``ref.atax`` in fp64 at
    1e-12 on ragged shapes (the same as the kernel's hard cases in
    ``chip_smoke.py``).

The ``cuda`` cases hold the kernel itself to ``ref.atax`` on those shapes
(fp64 at the job path's 1e-9, ``tests/test_offload_runtime.py:17``; f32 at
2e-3; bf16 at 1e-2, about one bf16 ulp, since both sides sum in f32 and
round once), with A and x one element off a 16-byte boundary too, and
check that two calls give identical bits.  They decide in a fixture that
there is no card and skip here; JAX is imported inside the test that uses
it, so ``python -m pytest -m cuda tests/test_torch_atax.py`` runs them on a
machine with the card and no JAX.
"""

import zlib

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro_torch.kernels import atax as k_atax
from repro_torch.kernels import build as t_build
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

H100_SMS = 132
#: shared memory a CTA may use on Hopper (the hopper-kernels table)
SMEM_LIMIT = 232448
DTYPES = (torch.float64, torch.float32, torch.bfloat16)
#: ragged M and N (chip_smoke.py's hard cases): panels of 8, 4 and 2 rows
#: cut short, M below a panel, slices of one chunk and slices cut short
HARD_M = (1, 2, 7, 17, 33, 130)
HARD_N = (1, 2, 17, 100, 4097)
HARD = [(m, n) for m in HARD_M for n in HARD_N]
SWEEP = [(256, 128), (100, 64), (512, 256), (33, 100)]   # test_kernels.py
CARD_TOL = {torch.float64: dict(rtol=1e-9, atol=1e-9),
            torch.float32: dict(rtol=2e-3, atol=2e-3),
            torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def ordered_atax(a: torch.Tensor, x: torch.Tensor, p: k_atax.Plan):
    """y = Aᵀ(A x) for a (B, M, N), x (B, N), cut and summed as the kernel
    does under plan ``p``: for every row group, its panels in order; for a
    panel, each rank's partial A·x over its column slice, the ranks summed
    in order 0..C-1 into t; each slice then adds its A_sliceᵀ t.  The row
    groups' partial rows are summed in order.  In the accumulator type."""
    acc = t_build.acc_dtype(a.dtype)
    a, x = a.to(acc), x.to(acc)
    bsz, m, n = a.shape
    slices = [p.columns(c, n) for c in range(p.cluster)]
    y = torch.zeros((bsz, n), dtype=acc)
    for b in range(bsz):
        total = None
        for g in range(p.groups):
            part = torch.zeros(n, dtype=acc)
            for panel in p.panels(g, m):
                rows = slice(panel * p.rows, min((panel + 1) * p.rows, m))
                t = None
                for c in slices:
                    tc = a[b, rows, c.start:c.stop] @ x[b, c.start:c.stop]
                    t = tc if t is None else t + tc
                for c in slices:
                    part[c.start:c.stop] += a[b, rows, c.start:c.stop].T @ t
            total = part if total is None else total + part
        y[b] = total
    return y


# -- the plan -----------------------------------------------------------------


def _check_plan(batch, m, n, dtype):
    p = k_atax.plan(batch, m, n, dtype, H100_SMS)
    owner = np.zeros(n, int)
    for c in range(p.cluster):
        owner[list(p.columns(c, n))] += 1
    assert (owner == 1).all()
    # every rank of the cluster owns at least one column (no idle CTA)
    assert all(len(p.columns(c, n)) for c in range(p.cluster))
    covered = np.zeros(m, int)
    for g in range(p.groups):
        walk = p.panels(g, m)
        assert len(walk) >= 1                       # no empty row group
        for panel in walk:
            covered[panel * p.rows:min((panel + 1) * p.rows, m)] += 1
    assert (covered == 1).all()
    assert 1 <= p.cluster <= 8 and p.rows in (2, 4, 8)
    assert p.stages in (2, 3) and p.chunks in (1, 2, 4)
    assert p.rows * p.chunks <= k_atax.MAX_ROWS_X_CHUNKS
    assert p.threads % 32 == 0 and 32 <= p.threads <= 512
    assert p.threads * p.chunks >= p.slice_chunks
    assert p.smem == p.stages * p.rows * p.slice_chunks * 16
    assert p.smem + 2048 <= SMEM_LIMIT
    assert batch * p.groups * p.cluster <= 2 ** 31 - 1   # grid x
    return p


@settings(max_examples=200, deadline=None)
@given(batch=st.integers(1, 70000), m=st.integers(1, 9000),
       n=st.integers(1, 70000), dtype=st.sampled_from(DTYPES))
def test_plan_covers_every_column_and_row_once(batch, m, n, dtype):
    limit = 8 * 512 * 4 * (16 // dtype.itemsize)
    if n > limit:
        with pytest.raises(ValueError, match="at most"):
            k_atax.plan(batch, m, n, dtype, H100_SMS)
        return
    _check_plan(batch, m, n, dtype)


@pytest.mark.parametrize("batch", [1, 3, 32])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_on_the_checked_shapes(dtype, batch):
    for shape in HARD + SWEEP + [(4096, 4096), (8192, 8192)]:
        _check_plan(batch, *shape, dtype)


def test_plan_at_the_offload_shapes():
    """The n = 32 shard (32, 128, 4096) fp64 is one wave of 32 clusters of
    8 CTAs (8-row panels, two stages, so that three CTAs share an SM), one
    row group (no second pass); the n = 8 and n = 1 shards split their
    rows until they fill one wave."""
    p = k_atax.plan(32, 128, 4096, torch.float64, H100_SMS)
    assert (p.cluster, p.groups, p.rows, p.stages, p.threads) == (8, 1, 8, 2,
                                                                  256)
    assert 32 * p.groups <= p.wave
    assert k_atax.plan(8, 512, 4096, torch.float64, H100_SMS).groups == 5
    tall = k_atax.plan(1, 4096, 4096, torch.float64, H100_SMS)
    assert (tall.rows, tall.stages, tall.groups) == (8, 3, tall.wave)
    assert sum(len(tall.panels(g, 4096)) for g in range(tall.groups)) == 512
    # the default job at n = 32: two rows of 64, below one panel
    small = k_atax.plan(32, 2, 64, torch.float64, H100_SMS)
    assert (small.cluster, small.rows, small.groups) == (1, 2, 1)


def test_plan_takes_the_cards_own_count_of_clusters():
    """With a count from the card the plan fills that wave: more clusters
    at once give more row groups; a card that holds too few for the
    first shape makes the plan take another."""
    asked = []

    def clusters(c, rows, stages, threads, chunks):
        asked.append((c, rows, stages, threads, chunks))
        return 60 if (rows, stages) == (8, 3) else 1
    p = k_atax.plan(1, 4096, 4096, torch.float64, H100_SMS, clusters)
    assert (p.rows, p.stages, p.groups, p.wave) == (8, 3, 60, 60)
    assert asked[0] == (8, 8, 3, 256, 1)
    p = k_atax.plan(32, 128, 4096, torch.float64, H100_SMS,
                    lambda c, r, st, t, ch: 32 if (r, st) == (4, 3) else 30)
    assert (p.rows, p.stages, p.groups) == (4, 3, 1)
    # the H100's counts at the n = 32 shard (``launch_ab.py --kernel
    # atax``): 2-row panels fill the wave best, but 8-row ones cost a
    # quarter of the exchanges
    h100 = {(8, 3): 30, (8, 2): 45, (4, 3): 62, (4, 2): 62, (2, 3): 77,
            (2, 2): 77}
    p = k_atax.plan(32, 128, 4096, torch.float64, H100_SMS,
                    lambda c, r, st, t, ch: h100[r, st])
    assert (p.rows, p.stages, p.groups) == (8, 2, 1)


def test_plan_refuses_rows_wider_than_the_kernel_holds():
    k_atax.plan(1, 4, 8 * 512 * 4 * 2, torch.float64, H100_SMS)
    with pytest.raises(ValueError, match="at most 32768"):
        k_atax.plan(1, 4, 8 * 512 * 4 * 2 + 1, torch.float64, H100_SMS)
    with pytest.raises(ValueError):
        k_atax.plan(1, 0, 8, torch.float64, H100_SMS)


# -- the order twin -------------------------------------------------------------


@pytest.mark.parametrize("mn", SWEEP)
def test_order_twin_matches_pallas(mn):
    import jax.numpy as jnp
    from repro.kernels import ops as r_ops
    m, n = mn
    rng = _rng("atax sweep", mn)
    a = rng.standard_normal((m, n)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(r_ops.atax(jnp.asarray(a), jnp.asarray(x),
                                 impl="pallas"))
    p = k_atax.plan(1, m, n, torch.float32, H100_SMS)
    got = ordered_atax(torch.from_numpy(a)[None], torch.from_numpy(x)[None],
                       p)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("mn", HARD)
@pytest.mark.parametrize("batch", [1, 3])
def test_order_twin_fp64_matches_ref(batch, mn):
    rng = _rng("atax f64", batch, mn)
    a = torch.from_numpy(rng.standard_normal((batch,) + mn))
    x = torch.from_numpy(rng.standard_normal((batch, mn[1])))
    p = k_atax.plan(batch, *mn, torch.float64, H100_SMS)
    np.testing.assert_allclose(ordered_atax(a, x, p).numpy(),
                               t_ref.atax(a, x).numpy(), rtol=1e-12,
                               atol=1e-12)


def test_order_twin_takes_clusters_and_row_groups():
    """The ragged shapes above reach both cuts the twin mirrors: a cluster of
    8 ranks with a short last slice, and more than one row group."""
    p = k_atax.plan(1, 130, 4097, torch.float64, H100_SMS)
    assert p.cluster == 8 and p.groups > 1
    assert len(p.columns(7, 4097)) < len(p.columns(0, 4097))


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _held(a, x):
    """One launch, held to ref.atax, and the same bits from a second call."""
    count = t_build.KERNELS["atax"]
    before = count.launches
    got = k_atax.atax(a, x)
    again = t_ops.atax(a, x, impl="kernel")
    want = t_ref.atax(a, x)
    torch.cuda.synchronize()
    assert count.launches == before + 2
    assert got.dtype == a.dtype and got.shape == want.shape
    torch.testing.assert_close(got.double(), want.double(),
                               **CARD_TOL[a.dtype])
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("mn", HARD)
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_atax_kernel_ragged_on_card(cuda, dtype, batch, mn):
    rng = _rng("atax card", str(dtype), batch, mn)
    a = torch.from_numpy(rng.standard_normal((batch,) + mn)).to(dtype)
    x = torch.from_numpy(rng.standard_normal((batch, mn[1]))).to(dtype)
    _held(a.to(cuda), x.to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 33, 100), (1, 130, 4096),
                                   (2, 17, 4097)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_atax_kernel_views_off_16_bytes_on_card(cuda, dtype, shape):
    rng = _rng("atax view", str(dtype), shape)
    n = int(np.prod(shape))
    a = torch.from_numpy(rng.standard_normal(n + 1)).to(dtype).to(cuda)
    x = torch.from_numpy(rng.standard_normal(n + 1)).to(dtype).to(cuda)
    av = a[1:].view(shape)
    xv = x[1:1 + shape[0] * shape[2]].view(shape[0], shape[2])
    assert av.data_ptr() % 16 and xv.data_ptr() % 16
    _held(av, xv)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 128, 4096), (8, 512, 4096),
                                   (1, 4096, 4096), (32, 2, 64)])
def test_atax_kernel_offload_shapes_on_card(cuda, shape):
    rng = _rng("atax job", shape)
    a = torch.from_numpy(rng.standard_normal(shape)).to(cuda)
    x = torch.from_numpy(rng.standard_normal(shape[::2])).to(cuda)
    _held(a, x)
