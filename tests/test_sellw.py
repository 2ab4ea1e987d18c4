"""SELLW window-SELL engine: build + execute vs scipy gold.

Covers the structural edge cases the builder must survive: banded (single
window), scattered columns (multi-window secondary chunks), long rows
(multi-segment, >8 segments → multi-chunk), empty rows/blocks, rectangular
shapes, m/n not multiples of 128.
"""

import numpy as np
import pytest

from conftest import random_host_csr
from spmv_research_tpu.core.host import HostCSR
from spmv_research_tpu.ops import spmv
from spmv_research_tpu.ops.sellw import (SellWBuildError, build_sellw,
                                         execute_sellw_numpy)


def _gold(host, x):
    return host.to_scipy() @ x


def _check(host, rng, atol=1e-5):
    import jax.numpy as jnp

    A = build_sellw(host, max_chunk_factor=1e9)  # no suitability gate
    x = rng.uniform(-1, 1, host.n)
    gold = _gold(host, x)
    scale = np.maximum(np.abs(gold), 1.0)
    # values plane is fp32; program semantics otherwise exact in fp64
    np.testing.assert_allclose(execute_sellw_numpy(A, x) / scale,
                               gold / scale, atol=1e-6)
    xj = jnp.asarray(x, jnp.float32)
    y = np.asarray(spmv(A, xj, impl="xla"), np.float64)
    np.testing.assert_allclose(y / scale, gold / scale, atol=atol)
    return A


def _banded_csr(m, n, bw, avg, rng):
    rows, cols = [], []
    for i in range(m):
        k = max(int(rng.poisson(avg)), 0)
        c0 = int(i * n / max(m, 1))
        cc = np.unique(rng.integers(max(0, c0 - bw), min(n, c0 + bw + 1),
                                    size=k))
        rows.extend([i] * cc.size)
        cols.extend(cc.tolist())
    import scipy.sparse as sp
    v = rng.uniform(-1, 1, len(rows))
    mat = sp.csr_matrix((v, (rows, cols)), shape=(m, n))
    mat.sum_duplicates()
    mat.sort_indices()
    return HostCSR.from_scipy(mat)


def test_sellw_banded(rng):
    host = _banded_csr(500, 500, 40, 6, rng)
    A = _check(host, rng)
    # banded: ~1 chunk per block, no pathological blow-up
    assert A.nchunks <= 3 * ((host.m + 127) // 128)


def test_sellw_random_scattered(rng):
    host = random_host_csr(300, 4000, 0.01, rng)
    _check(host, rng)  # cols span 32 x2d rows -> multi-window chunks


def test_sellw_long_rows(rng):
    # one row of ~1400 nnz (needs >8 segments -> multiple chunks), plus skew
    import scipy.sparse as sp
    m, n = 260, 1500
    rows = [0] * 1400 + [1] * 300
    cols = rng.choice(n, 1400, replace=False).tolist() + \
        rng.integers(0, n, 300).tolist()
    for i in range(2, m, 3):
        rows.extend([i] * 4)
        cols.extend(rng.integers(0, n, 4).tolist())
    v = rng.uniform(-1, 1, len(rows))
    mat = sp.csr_matrix((v, (rows, cols)), shape=(m, n))
    mat.sum_duplicates()
    mat.sort_indices()
    _check(HostCSR.from_scipy(mat), rng)


def test_sellw_empty_rows_and_blocks(rng):
    import scipy.sparse as sp
    m, n = 700, 300
    # only rows 400..420 populated: blocks 0..2 empty, block 3 partial
    rows = np.repeat(np.arange(400, 420), 5)
    cols = rng.integers(0, n, rows.size)
    v = rng.uniform(-1, 1, rows.size)
    mat = sp.csr_matrix((v, (rows, cols)), shape=(m, n))
    mat.sum_duplicates()
    mat.sort_indices()
    _check(HostCSR.from_scipy(mat), rng)


def test_sellw_rectangular_odd_sizes(rng):
    _check(random_host_csr(137, 93, 0.08, rng), rng)
    _check(random_host_csr(129, 1030, 0.02, rng), rng)


def test_sellw_single_entry(rng):
    import scipy.sparse as sp
    mat = sp.csr_matrix(([2.5], ([7], [11])), shape=(64, 64))
    _check(HostCSR.from_scipy(mat), rng)


def test_sellw_streamed_wins_for_huge_n(rng):
    """Wide x (n=1030, 9 x2d rows, not a multiple of 128): the windows
    row-gather from a padded x plane."""
    host = _banded_csr(400, 1030, 30, 5, rng)
    A = _check(host, rng)
    assert A.x_rows == 9


def test_sellw_generator_twin(rng):
    """Small twin-style matrix through the RCM + SELLW path (the bench path)."""
    from spmv_research_tpu.gen import ArtificialParams, artificial_matrix_generation
    from spmv_research_tpu.convert import rcm_reorder

    p = ArtificialParams(1200, 1200, 6.0, 4.0, "normal", "random", bw=0.3,
                         skew=10.0, avg_num_neighbours=1.0,
                         cross_row_similarity=0.5, seed=7)
    host, _ = artificial_matrix_generation(p)
    host, _ = rcm_reorder(host)
    _check(host, rng)


def test_sellw_spmm(rng):
    """SpMM (xla impl) vs dense gold, K not multiple of 8."""
    import jax.numpy as jnp
    from spmv_research_tpu.ops import spmm

    host = _banded_csr(400, 500, 35, 6, rng)
    A = build_sellw(host, max_chunk_factor=1e9)
    for K in (5, 16):
        X = rng.uniform(-1, 1, (host.n, K)).astype(np.float32)
        want = host.to_scipy() @ X.astype(np.float64)
        scale = np.maximum(np.abs(want), 1.0)
        Y = np.asarray(spmm(A, jnp.asarray(X), impl="xla"), np.float64)
        np.testing.assert_allclose(Y / scale, want / scale, atol=1e-5,
                                   err_msg=f"K={K}")


@pytest.mark.parametrize("G", [1, 4, 8])
def test_sellw_block_grouping(rng, G):
    """G-way block grouping (group=G): numpy and XLA tiers agree on a
    banded matrix at every G."""
    import scipy.sparse as sp
    import jax.numpy as jnp
    from spmv_research_tpu.ops.sellw import build_sellw, execute_sellw_numpy
    from spmv_research_tpu.ops import spmv as do_spmv

    m = n = 1500
    A = sp.diags([rng.uniform(-1, 1, m) for _ in range(7)],
                 [-200, -129, -1, 0, 1, 129, 200], shape=(m, n),
                 format="csr")
    A.eliminate_zeros()
    A.sort_indices()
    host = HostCSR.from_scipy(A)
    F = build_sellw(host, group=G)
    assert F.G == G
    x = rng.uniform(-1, 1, n).astype(np.float32)
    want = A @ x.astype(np.float64)
    scale = np.abs(A) @ np.abs(x).astype(np.float64) + 1e-30
    y_np = execute_sellw_numpy(F, x.astype(np.float64))
    y_xla = np.asarray(do_spmv(F, jnp.asarray(x), impl="xla"))
    for y in (y_np, y_xla):
        assert np.max(np.abs(y - want) / scale) < 1e-5
