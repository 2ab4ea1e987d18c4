"""SELLR engine: build + numpy/XLA differential tests.

Strategy per SURVEY.md §4: golden-model differential testing against
scipy.sparse on random + pathological matrices, fp32 gate 1e-7 relative
(the reference's float gate, ``bench_spmv.cpp:114-119``).
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from spmv_research_tpu.core.host import HostCSR
from spmv_research_tpu.ops.sellr import (SellRBuildError, build_sellr,
                                         execute_sellr_numpy, sellr_xla_raw,
                                         spmv_sellr_xla)


def _host(A):
    A = A.tocsr()
    A.sort_indices()
    return A, HostCSR(ia=A.indptr.astype(np.int32),
                      ja=A.indices.astype(np.int32),
                      a=A.data.astype(np.float64), m=A.shape[0], n=A.shape[1])


def _band(m, n, band, nnzpr_hi, seed):
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for r in range(m):
        k = rng.integers(1, nnzpr_hi)
        c0 = max(0, min(n - 1 - band, int(r * n / m) - band // 2))
        cs = np.unique(rng.integers(c0, min(c0 + band, n), k))
        rows += [r] * len(cs)
        cols += list(cs)
    vals = np.random.default_rng(seed + 1).standard_normal(len(rows))
    return sp.csr_matrix((vals, (rows, cols)), shape=(m, n))


def _check(A, factor=4.0, gate=2e-7):
    A, host = _host(A)
    x = np.random.default_rng(42).standard_normal(A.shape[1])
    F = build_sellr(host, max_slot_factor=factor)
    y_ref = A @ x
    den = max(np.abs(y_ref).max(), 1e-30)
    assert np.abs(execute_sellr_numpy(F, x) - y_ref).max() / den < 1e-6
    xd = jnp.asarray(x, jnp.float32)
    y_xla = np.asarray(spmv_sellr_xla(F, xd)).astype(np.float64)
    assert np.abs(y_xla - y_ref).max() / den < gate
    return F


def test_banded_medium():
    F = _check(_band(3000, 3000, 300, 9, 0))
    assert F.nchunks > 0


def test_multi_group_narrow():
    _check(_band(5000, 5000, 40, 6, 2))


def test_tridiag_like():
    F = _check(_band(9000, 9000, 5, 4, 3))
    assert F.stages <= 3


def test_rectangular_tall():
    _check(_band(4000, 1000, 200, 7, 4))


def test_rectangular_wide():
    _check(_band(1000, 4000, 500, 7, 5), factor=25)


def test_dense_row_long_parts():
    A = _band(2000, 2000, 150, 7, 6).tolil()
    A[500, :1900] = 1.5
    F = _check(A, factor=12)
    assert F.stages == 7  # 1900-nnz row split into <=128-lane parts


def test_empty_rows_and_row0_seeding():
    A = _band(2000, 2000, 100, 6, 8).tolil()
    A[100:300, :] = 0
    _check(A, factor=8)


def test_scattered_refused():
    _, host = _host(sp.random(30000, 30000, 2e-4, format="csr",
                              random_state=7))
    with pytest.raises(SellRBuildError):
        build_sellr(host)


def test_empty_matrix_refused():
    _, host = _host(sp.csr_matrix((64, 64)))
    with pytest.raises(SellRBuildError):
        build_sellr(host)


def test_footprint_and_meta():
    A, host = _host(_band(3000, 3000, 120, 7, 9))
    F = build_sellr(host)
    assert F.mem_footprint_bytes() > 8 * F.nnz  # word+vals at least
    assert F.nnz == host.nnz
    assert F.shape == (3000, 3000)
    # every live chunk names the first y2d row of its 1024-row group
    nsteps = F.word.shape[0] // 8 // 64
    cmeta = np.asarray(F.smeta).reshape(nsteps, 1024)[:, 512:576].reshape(-1)
    assert np.all(cmeta[: F.nchunks] % 8 == 0)
    assert np.all(cmeta[: F.nchunks] < F.y_rows)


@pytest.mark.parametrize("band,nnzpr_hi,seed", [(300, 9, 11), (40, 6, 12)])
def test_sellr_xla_raw_matches_numpy(band, nnzpr_hi, seed):
    """The raw-array entry the distributed layer calls: x2d plane in,
    (y_rows, 128) plane out, equal to the fp64 program replay."""
    A, host = _host(_band(2500, 2500, band, nnzpr_hi, seed))
    F = build_sellr(host)
    x = np.random.default_rng(seed).standard_normal(host.n)
    x2d = np.zeros(F.x_rows * 128, np.float32)
    x2d[: host.n] = x
    y2 = sellr_xla_raw(F.word, F.vals, F.smeta,
                       jnp.asarray(x2d.reshape(F.x_rows, 128)),
                       stages=F.stages, rolls=F.rolls, x_rows=F.x_rows,
                       y_rows=F.y_rows)
    assert y2.shape == (F.y_rows, 128)
    want = execute_sellr_numpy(F, x.astype(np.float32).astype(np.float64))
    y = np.asarray(y2, np.float64).reshape(-1)[: host.m]
    assert np.abs(y - want).max() / max(np.abs(want).max(), 1e-30) < 2e-7
