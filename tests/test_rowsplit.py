"""Long-row split transform + RSPLIT wrapper format tests.

Reference role: "perfect nnz balance" mid-row splitting
(``benchmark_code/BENCH/src/spmv_kernels/csr.cpp:96-108,655-710``) and DIV
work stealing for skewed rows (``DIV/div.cpp:991-1060``) — realized here
as a build-time row subdivision + partial-sum combine.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from conftest import random_host_csr

from spmv_research_tpu.core.host import HostCSR
from spmv_research_tpu.ops.rowsplit import split_long_rows, wrap_row_split
from spmv_research_tpu.ops.clos_gather import build_clos_gather_auto
from spmv_research_tpu.ops import spmv


def _skewed_host(rng, m=600, n=600,
                 heavy=((7, 1500), (200, 900), (599, 641), (300, 100))):
    # row 300 (100 nnz) sits BETWEEN the part size T and the split threshold
    # in the tests below: it must be kept whole, not truncated to T.
    """Sparse background + a few mega-rows."""
    bg = sp.random(m, n, density=0.004, random_state=np.random.RandomState(3),
                   format="lil")
    for r, deg in heavy:
        cols = rng.choice(n, size=min(deg, n), replace=False)
        bg[r, cols] = rng.uniform(0.5, 1.0, cols.size)
    mat = bg.tocsr()
    mat.sum_duplicates()
    mat.sort_indices()
    return HostCSR.from_scipy(mat)


def test_split_long_rows_structure(rng):
    host = _skewed_host(rng)
    csr2, heavy, seg_ptr = split_long_rows(host, T=64, threshold=128)
    lengths2 = np.diff(csr2.ia)
    assert lengths2.max() <= 128   # sub-threshold rows stay whole
    assert lengths2[heavy].max() <= 64
    assert lengths2[host.m:].max() <= 64
    assert csr2.nnz == host.nnz
    # reassembling sub-rows reproduces the original matrix exactly
    l0 = np.diff(host.ia)
    assert heavy.tolist() == np.flatnonzero(l0 > 128).tolist()
    A2 = sp.csr_matrix((csr2.a, csr2.ja, csr2.ia), shape=(csr2.m, csr2.n))
    x = rng.uniform(-1, 1, host.n)
    y2 = A2 @ x
    y = y2[: host.m].copy()
    extras = y2[host.m:]
    for i, r in enumerate(heavy):
        y[r] += extras[seg_ptr[i]: seg_ptr[i + 1]].sum()
    want = host.to_scipy() @ x
    assert np.allclose(y, want, rtol=1e-12)


def test_split_noop_below_threshold(rng):
    host = random_host_csr(300, 300, 0.01, rng)
    csr2, heavy, seg_ptr = split_long_rows(host, T=64, threshold=10**9)
    assert csr2 is host and heavy is None and seg_ptr is None


@pytest.mark.parametrize("impl", ["xla"])
def test_closg_auto_rowsplit_device(rng, impl):
    """build_clos_gather_auto wraps skewed matrices in RSPLIT transparently."""
    import jax.numpy as jnp

    host = _skewed_host(rng)
    assert np.diff(host.ia).max() > 512   # rows are capped at n=600 cols
    import spmv_research_tpu.ops.clos_gather as cg
    old = cg.SPLIT_ROW_NNZ
    cg.SPLIT_ROW_NNZ = 512       # force the split path on this small matrix
    try:
        A = build_clos_gather_auto(host)
    finally:
        cg.SPLIT_ROW_NNZ = old
    assert A.format_name == "RSPLIT"
    assert A.nnz == host.nnz
    x = rng.uniform(-1, 1, host.n).astype(np.float32)
    y = np.asarray(spmv(A, jnp.asarray(x), impl=impl))
    want = host.to_scipy() @ x.astype(np.float64)
    scale = np.abs(host.to_scipy()) @ np.abs(x).astype(np.float64) + 1e-30
    assert np.max(np.abs(y - want) / scale) < 1e-5


def test_closg_auto_no_split_for_uniform(rng):
    """High-average matrices must NOT be mass-split (combine would be
    scatter-bound); they keep the plain CLOSG route."""
    host = random_host_csr(256, 256, 0.15, rng)
    A = build_clos_gather_auto(host)
    assert A.format_name == "CLOSG"


@pytest.mark.parametrize("impl", ["xla"])
def test_rowsplit_spmm(rng, impl):
    """RSPLIT SpMM: scanned column loop over the wrapped SpMV."""
    import jax.numpy as jnp
    from spmv_research_tpu.ops import spmm
    import spmv_research_tpu.ops.clos_gather as cg

    host = _skewed_host(rng)
    old = cg.SPLIT_ROW_NNZ
    cg.SPLIT_ROW_NNZ = 512
    try:
        A = build_clos_gather_auto(host)
    finally:
        cg.SPLIT_ROW_NNZ = old
    assert A.format_name == "RSPLIT"
    K = 4
    X = rng.uniform(-1, 1, (host.n, K)).astype(np.float32)
    Y = np.asarray(spmm(A, jnp.asarray(X), impl=impl))
    want = host.to_scipy() @ X.astype(np.float64)
    scale = np.abs(host.to_scipy()) @ np.abs(X).astype(np.float64) + 1e-30
    assert Y.shape == (host.m, K)
    assert np.max(np.abs(Y - want) / scale) < 1e-5
