"""SPMD distributed SELLR on the virtual 8-device CPU mesh.

The engine must run as one shard_map
program (shape-uniform per-shard SELLR), and the ring strategy's per-step
work must be 1/k of the total nnz (build-time column partitioning, not
masked re-reads)."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax

from spmv_research_tpu.core.host import HostCSR
from spmv_research_tpu.parallel.dist import make_sparse_mesh
from spmv_research_tpu.parallel.dist_sellr import (build_dist_sellr,
                                                   dist_spmv_sellr_host)


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
    A = sp.csr_matrix((vals, (rows, cols)), shape=(m, n))
    A.sort_indices()
    return A


@pytest.fixture(scope="module")
def problem():
    A = _band(6000, 6000, 700, 8, 11)
    host = HostCSR(ia=A.indptr.astype(np.int32),
                   ja=A.indices.astype(np.int32),
                   a=A.data.astype(np.float64), m=6000, n=6000)
    x = np.random.default_rng(1).standard_normal(6000)
    return A, host, x


@pytest.fixture(scope="module")
def mesh():
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    return make_sparse_mesh(8)


@pytest.mark.parametrize("strategy", ["allgather", "ring", "psum_scatter"])
def test_dist_sellr_matches_scipy(problem, mesh, strategy):
    A, host, x = problem
    D = build_dist_sellr(host, mesh, strategy=strategy,
                         max_slot_factor=30.0)
    y = dist_spmv_sellr_host(D, x)
    y_ref = A @ x
    err = np.abs(y - y_ref).max() / np.abs(y_ref).max()
    assert err < 2e-6, f"{strategy}: err {err}"


def test_ring_total_work_is_nnz_not_k_nnz(problem, mesh):
    """Ring step j on device d executes only the (d, (d+j)%k) column-block
    program. Each nnz is therefore touched EXACTLY ONCE across the k steps
    (build-time column partitioning) — the round-1 CSR ring re-read all
    local nnz every step, k x the work.

    (Per-STEP totals are matrix-dependent: a banded matrix concentrates
    its nnz in the diagonal blocks, so step 0 carries most of the work
    while every device is equally busy on its own nnz/k diagonal block.)"""
    _, host, _ = problem
    D = build_dist_sellr(host, mesh, strategy="ring", max_slot_factor=30.0)
    k = D.k
    nz = D.shard_nnz  # (k devices, k blocks)
    # total across all (device, step) pairs = nnz, i.e. 1/k of the old
    # O(k*nnz) design's touched volume
    assert nz.sum() == host.nnz
    # per device: the k steps partition its local nnz exactly
    for d in range(k):
        per_dev = sum(nz[d, (d + j) % k] for j in range(k))
        assert per_dev == nz[d].sum()
    # devices are balanced at the step where each hits its own diagonal
    diag = np.array([nz[d, d] for d in range(k)])
    assert diag.max() <= 3.0 * max(diag.mean(), 1)


def test_shape_uniformity(problem, mesh):
    _, host, _ = problem
    D = build_dist_sellr(host, mesh, strategy="ring", max_slot_factor=30.0)
    # one stacked program array set, identical shape per (device, block)
    assert D.word.shape[0] == D.word.shape[1] == D.k
    assert D.word.shape == (D.k, D.k) + D.word.shape[2:]
    assert D.vals.shape == D.word.shape
