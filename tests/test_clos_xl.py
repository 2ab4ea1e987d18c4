"""CLOSGX — scan-over-uniform-chunks XL engine tests.

Reference role: single-chip coverage of the largest validation matrices
(audikw_1/cage15/kmer_V2a class, ``run.sh:137-191``) that exceed the
fused chunked-CLOSG program cap.
"""

import numpy as np
import pytest

from conftest import random_host_csr

from spmv_research_tpu.ops.clos_xl import build_clos_gather_xl, ClosGX
from spmv_research_tpu.ops import spmv, spmm


def _check(host, A, rng, impl):
    import jax.numpy as jnp
    x = rng.uniform(-1, 1, host.n).astype(np.float32)
    y = np.asarray(spmv(A, jnp.asarray(x), impl=impl))
    S = host.to_scipy()
    want = S @ x.astype(np.float64)
    scale = np.abs(S) @ np.abs(x).astype(np.float64) + 1e-30
    assert y.shape == (host.m,)
    assert np.max(np.abs(y - want) / scale) < 1e-5


@pytest.mark.parametrize("impl", ["xla"])
def test_closgx_multi_chunk(rng, impl):
    host = random_host_csr(4000, 900, 0.008, rng)   # ~29k nnz, non-square
    A = build_clos_gather_xl(host, chunk_N=8192)
    assert isinstance(A, ClosGX)
    assert A.n_chunks >= 3
    _check(host, A, rng, impl)


@pytest.mark.parametrize("impl", ["xla"])
def test_closgx_streamed_wins(rng, impl):
    """Wide x (n=1500, 12 x2d rows) across two or more chunks: every chunk
    row-gathers its windows from the shared x plane."""
    host = random_host_csr(2000, 1500, 0.01, rng)
    A = build_clos_gather_xl(host, chunk_N=8192)
    assert A.n_chunks >= 2
    _check(host, A, rng, impl)


def test_closgx_auto_routing(rng):
    """build_clos_gather_auto hands oversized matrices to the XL builder
    instead of raising."""
    from spmv_research_tpu.ops.clos_gather import build_clos_gather_auto
    host = random_host_csr(3000, 800, 0.01, rng)
    A = build_clos_gather_auto(host, max_N=8192, max_chunks=2)
    assert A.format_name == "CLOSGX"
    _check(host, A, rng, "xla")


def test_closgx_spmm(rng):
    import jax.numpy as jnp
    host = random_host_csr(2500, 700, 0.01, rng)
    A = build_clos_gather_xl(host, chunk_N=8192)
    X = rng.uniform(-1, 1, (host.n, 3)).astype(np.float32)
    Y = np.asarray(spmm(A, jnp.asarray(X), impl="xla"))
    S = host.to_scipy()
    want = S @ X.astype(np.float64)
    scale = np.abs(S) @ np.abs(X).astype(np.float64) + 1e-30
    assert np.max(np.abs(Y - want) / scale) < 1e-5


def test_closgx_footprint_and_yslot(rng):
    """yslot names each row's last CSR slot in its chunk (-1 for empty
    rows and padding); the footprint counts every device leaf."""
    import jax

    host = random_host_csr(3000, 600, 0.004, rng)
    A = build_clos_gather_xl(host, chunk_N=8192)
    leaves = jax.tree_util.tree_leaves(A)
    assert A.mem_footprint_bytes() == sum(l.nbytes for l in leaves)
    ys = np.asarray(A.yslot).reshape(A.n_chunks, -1)
    lens = np.diff(host.ia.astype(np.int64))
    live = ys[ys >= 0]
    assert live.size == int((lens > 0).sum())
    assert live.max() < A.N
    _check(host, A, rng, "xla")
