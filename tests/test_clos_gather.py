"""CLOSG (row-gather + Clos) engine tests."""

import numpy as np
import pytest

from conftest import random_host_csr

from spmv_research_tpu.ops.clos_gather import (build_clos_gather,
                                               execute_closg_numpy)
from spmv_research_tpu.ops import spmv


@pytest.mark.parametrize("m,n,density", [(300, 300, 0.01), (500, 200, 0.02),
                                         (64, 4000, 0.003), (1000, 50, 0.08)])
def test_closg_numpy_vs_scipy(rng, m, n, density):
    host = random_host_csr(m, n, density, rng)
    A = build_clos_gather(host, )
    x = rng.uniform(-1, 1, n)
    y = execute_closg_numpy(A, x)
    sp = host.to_scipy()
    want = sp @ x
    scale = np.abs(sp) @ np.abs(x) + 1e-30
    assert np.max(np.abs(y - want) / scale) < 1e-6


def _few_long_rows(rng, m=4000, n=4000):
    """Short rows (3 nnz) plus five ~600-nnz rows: a deep segmented scan
    (10 stages) over mostly trivial rows."""
    import scipy.sparse as sp
    from spmv_research_tpu.core.host import HostCSR

    rows, cols = [], []
    for i in range(m):
        k = 600 if i in (17, 901, 902, 2500, 3999) else 3
        rows.append(np.full(k, i))
        cols.append(rng.choice(n, k, replace=False))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = rng.uniform(-1, 1, rows.shape[0])
    mat = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    mat.sum_duplicates(); mat.sort_indices()
    return HostCSR.from_scipy(mat)


@pytest.mark.parametrize("case", ["square", "wide", "few_long_rows"])
def test_closg_device_impls(rng, case):
    """The XLA lowering and the fp64 program replay against scipy."""
    import jax.numpy as jnp

    host = {"square": lambda: random_host_csr(400, 400, 0.015, rng),
            "wide": lambda: random_host_csr(500, 700, 0.01, rng),
            "few_long_rows": lambda: _few_long_rows(rng)}[case]()
    A = build_clos_gather(host)
    x = rng.uniform(-1, 1, host.n).astype(np.float32)
    y = np.asarray(spmv(A, jnp.asarray(x)))
    S = host.to_scipy()
    want = S @ x.astype(np.float64)
    scale = np.abs(S) @ np.abs(x).astype(np.float64) + 1e-30
    assert np.max(np.abs(y - want) / scale) < 1e-5
    y64 = execute_closg_numpy(A, x.astype(np.float64))
    assert np.max(np.abs(y64 - want) / scale) < 1e-6   # fp32 value plane


def test_closg_pathological(rng):
    import scipy.sparse as sp
    from spmv_research_tpu.core.host import HostCSR

    # dense column block + empty rows + single dense row
    m = n = 300
    rows = np.concatenate([np.arange(200), np.full(64, 7)])
    cols = np.concatenate([np.full(200, 17), rng.choice(n, 64, replace=False)])
    vals = rng.uniform(-1, 1, rows.shape[0])
    mat = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    mat.sum_duplicates()
    mat.sort_indices()
    host = HostCSR.from_scipy(mat)
    A = build_clos_gather(host, )
    x = rng.uniform(-1, 1, n)
    scale = np.abs(mat) @ np.abs(x) + 1e-30
    assert np.max(np.abs(execute_closg_numpy(A, x) - mat @ x) / scale) < 1e-6

@pytest.mark.parametrize("impl", ["xla"])
def test_closg_value_lut(rng, impl):
    """Pattern/quantized matrices: value dict rides r1 spare bits (DIV/CV
    compressed-value role) — footprint drops by the whole value plane."""
    import jax.numpy as jnp
    import scipy.sparse as sp
    from spmv_research_tpu.core.host import HostCSR

    m = n = 400
    mat = sp.random(m, n, 0.02, random_state=7, format="csr")
    mat.data = rng.choice([1.0, -1.0, 0.5, 2.0], mat.nnz)  # 4 distinct values
    host = HostCSR.from_scipy(mat)
    A = build_clos_gather(host, value_lut=True)
    assert A.use_vlut
    A_plain = build_clos_gather(host, value_lut=False)
    assert A.mem_footprint_bytes() < A_plain.mem_footprint_bytes()
    x = rng.uniform(-1, 1, n).astype(np.float32)
    y = np.asarray(spmv(A, jnp.asarray(x), impl=impl))
    want = mat @ x.astype(np.float64)
    assert np.allclose(y, want, atol=1e-4)
    # numpy host reference too
    y64 = execute_closg_numpy(A, x.astype(np.float64))
    assert np.allclose(y64, want, atol=1e-8)

def test_closg_chunked(rng):
    """Matrices past the 2^20 single-program cap split into row chunks."""
    import jax.numpy as jnp
    import scipy.sparse as sp
    from spmv_research_tpu.core.host import HostCSR
    from spmv_research_tpu.ops.clos_gather import (build_clos_gather_auto,
                                                   ClosGChunked)

    mat = sp.random(2000, 1500, 0.015, random_state=9, format="csr")
    host = HostCSR.from_scipy(mat)
    A = build_clos_gather_auto(host, max_N=16384)  # force chunking
    assert isinstance(A, ClosGChunked) and len(A.chunks) > 1
    assert A.row_split[0] == 0 and A.row_split[-1] == host.m
    x = rng.uniform(-1, 1, 1500).astype(np.float32)
    y = np.asarray(spmv(A, jnp.asarray(x), impl="xla"))
    want = mat @ x.astype(np.float64)
    assert np.allclose(y, want, atol=1e-4)
    y64 = execute_closg_numpy(A, x.astype(np.float64))
    assert np.allclose(y64, want, atol=1e-8)


@pytest.mark.parametrize("impl", ["xla"])
def test_closg_high_degree(rng, impl):
    """Dense rows (~70 nnz/row, the raefsky3-twin regime): each 128-row y
    group draws its row ends from many scan rows (C > 32 candidates)."""
    import jax.numpy as jnp
    import scipy.sparse as sp
    from spmv_research_tpu.core.host import HostCSR

    m = n = 1500
    rows = np.repeat(np.arange(m), 70)
    cols = rng.integers(0, n, rows.size)
    vals = rng.uniform(-1, 1, rows.size)
    mat = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    mat.sum_duplicates(); mat.sort_indices()
    host = HostCSR.from_scipy(mat)
    A = build_clos_gather(host)
    assert A.C > 32
    x = rng.uniform(-1, 1, n).astype(np.float32)
    y = np.asarray(spmv(A, jnp.asarray(x), impl=impl))
    want = mat @ x.astype(np.float64)
    scale = np.abs(mat) @ np.abs(x).astype(np.float64) + 1e-30
    assert np.max(np.abs(y - want) / scale) < 1e-5
    y64 = execute_closg_numpy(A, x.astype(np.float64))
    assert np.max(np.abs(y64 - want) / scale) < 1e-6


@pytest.mark.parametrize("impl", ["xla"])
def test_closg_spmm_scan(rng, impl):
    """CLOSG SpMM = lax.scan over X columns (one compiled SpMV body;
    reference bench_spmm.cpp K_DIM role)."""
    import jax.numpy as jnp
    from spmv_research_tpu.ops import spmm

    host = random_host_csr(500, 400, 0.02, rng)
    A = build_clos_gather(host)
    K = 5
    X = rng.uniform(-1, 1, (host.n, K)).astype(np.float32)
    Y = np.asarray(spmm(A, jnp.asarray(X), impl=impl))
    want = host.to_scipy() @ X.astype(np.float64)
    scale = np.abs(host.to_scipy()) @ np.abs(X).astype(np.float64) + 1e-30
    assert Y.shape == (host.m, K)
    assert np.max(np.abs(Y - want) / scale) < 1e-5


@pytest.mark.parametrize("value_lut", [False, True])
def test_closg_footprint_counts_every_leaf(rng, value_lut):
    """Every device leaf of a CLOSG program is read by its XLA lowering, so
    the footprint (the bytes the roofline streams) is all of them."""
    import jax

    host = random_host_csr(300, 300, 0.02, rng)
    host.a[:] = np.round(host.a * 2) / 2        # few distinct values
    A = build_clos_gather(host, value_lut=value_lut)
    assert A.use_vlut == value_lut
    leaves = jax.tree_util.tree_leaves(A)
    assert A.mem_footprint_bytes() == sum(l.nbytes for l in leaves)
