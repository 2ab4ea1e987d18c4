"""BTILE (dense-tile SpMM/SDDMM engine) correctness vs scipy."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from spmv_research_tpu.core.host import HostCSR
from spmv_research_tpu.ops.btile import (
    BTileBuildError, build_btile, execute_btile_numpy,
    sddmm_btile_xla, sddmm_slab_to_csr_values, spmm_btile_xla)


def _banded(m, n, nnz_row, bw, seed):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), nnz_row)
    ctr = (rows * n) // max(m, 1)
    cols = np.clip(ctr + rng.integers(-bw, bw + 1, rows.size), 0, n - 1)
    vals = rng.uniform(0.1, 1.0, rows.size)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    A.sum_duplicates()
    A.sort_indices()
    return HostCSR(a=A.data, ia=A.indptr.astype(np.int64),
                   ja=A.indices.astype(np.int64), m=m, n=n)


CASES = [
    (300, 300, 8, 30, 0),       # small banded, 1 band
    (2500, 2500, 12, 200, 1),   # multiple bands
    (1500, 900, 16, 300, 2),    # non-square, wide-ish band
    (1100, 1300, 9, 64, 3),     # non-square tall
]


@pytest.mark.parametrize("m,n,nnz_row,bw,seed", CASES)
@pytest.mark.parametrize("k", [16, 64])
def test_btile_spmm_matches_scipy(m, n, nnz_row, bw, seed, k):
    host = _banded(m, n, nnz_row, bw, seed)
    A = build_btile(host)
    rng = np.random.default_rng(seed + 100)
    X = rng.uniform(-1, 1, (n, k))
    ref = host.to_scipy() @ X
    # tiles are stored fp32 -> value-cast noise even in the fp64 replay
    got_np = execute_btile_numpy(A, X)
    np.testing.assert_allclose(got_np, ref, rtol=1e-4, atol=1e-5)
    got_xla = np.asarray(spmm_btile_xla(A, jnp.asarray(X, jnp.float32)))
    np.testing.assert_allclose(got_xla, ref, rtol=2e-5, atol=2e-5)


def test_btile_rejects_scattered():
    rng = np.random.default_rng(7)
    m = n = 4000
    rows = np.repeat(np.arange(m), 3)
    cols = rng.integers(0, n, rows.size)
    A = sp.coo_matrix((np.ones(rows.size), (rows, cols)),
                      shape=(m, n)).tocsr()
    A.sum_duplicates()
    host = HostCSR(a=A.data, ia=A.indptr.astype(np.int64),
                   ja=A.indices.astype(np.int64), m=m, n=n)
    with pytest.raises(BTileBuildError):
        build_btile(host)


@pytest.mark.parametrize("m,n,nnz_row,bw,seed", CASES[:2])
@pytest.mark.parametrize("k", [16, 64])
def test_btile_sddmm_matches_dense(m, n, nnz_row, bw, seed, k):
    host = _banded(m, n, nnz_row, bw, seed)
    A = build_btile(host)
    rng = np.random.default_rng(seed + 200)
    Am = rng.uniform(-1, 1, (m, k))
    Bm = rng.uniform(-1, 1, (n, k))
    rows = np.repeat(np.arange(m), host.row_lengths())
    ref = np.sum(Am[rows] * Bm[host.ja], axis=1)
    slab = sddmm_btile_xla(A, jnp.asarray(Am, jnp.float32),
                           jnp.asarray(Bm, jnp.float32))
    got = sddmm_slab_to_csr_values(A, np.asarray(slab), host)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_btile_empty_bands():
    # a matrix with an entirely empty row band in the middle
    m = n = 3000
    rng = np.random.default_rng(5)
    base = np.concatenate([np.arange(0, 900), np.arange(2100, 3000)])
    rows = np.repeat(base, 12)
    cols = np.clip(rows + rng.integers(-30, 31, rows.size), 0, n - 1)
    A = sp.coo_matrix((np.ones(rows.size), (rows, cols)),
                      shape=(m, n)).tocsr()
    A.sum_duplicates()
    host = HostCSR(a=A.data, ia=A.indptr.astype(np.int64),
                   ja=A.indices.astype(np.int64), m=m, n=n)
    fmt = build_btile(host)
    X = np.ones((n, 16))
    ref = host.to_scipy() @ X
    got = np.asarray(spmm_btile_xla(fmt, jnp.asarray(X, jnp.float32)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
