"""BSRG width-classed block slabs + block-dense MXU SDDMM."""

import numpy as np
import pytest
import scipy.sparse as sp

from conftest import random_host_csr


def _blocked_host(rng, mb=20, nb=12, br=8, bc=128, frac=0.15):
    """Block-sparse matrix: a random subset of (br,bc) blocks is dense."""
    m, n = mb * br, nb * bc
    mask = rng.random((mb, nb)) < frac
    mask[0, 0] = True
    dense = np.where(np.kron(mask, np.ones((br, bc), bool)),
                     rng.uniform(-1, 1, (m, n)), 0.0)
    mat = sp.csr_matrix(dense)
    from spmv_research_tpu.core.host import HostCSR
    return HostCSR.from_scipy(mat), mat


def test_bsrg_spmv_spmm(rng):
    import jax.numpy as jnp
    from spmv_research_tpu.ops import build_bsrg, spmv, spmm

    host, mat = _blocked_host(rng)
    A = build_bsrg(host)
    x = rng.uniform(-1, 1, host.n).astype(np.float32)
    y = np.asarray(spmv(A, jnp.asarray(x)))
    assert np.allclose(y, mat @ x.astype(np.float64), atol=1e-3)
    X = rng.uniform(-1, 1, (host.n, 16)).astype(np.float32)
    Y = np.asarray(spmm(A, jnp.asarray(X)))
    assert np.max(np.abs(Y - mat @ X.astype(np.float64))) < 1e-3


def test_bsrg_unblocked_random(rng):
    """Width classes handle irregular block counts and ragged edges."""
    import jax.numpy as jnp
    from spmv_research_tpu.ops import build_bsrg, spmv

    host = random_host_csr(500, 700, 0.02, rng)   # not block-aligned sizes
    A = build_bsrg(host)
    x = rng.uniform(-1, 1, 700).astype(np.float32)
    y = np.asarray(spmv(A, jnp.asarray(x)))
    want = host.to_scipy() @ x.astype(np.float64)
    assert np.allclose(y, want, atol=1e-3)


def test_sddmm_bsr_mxu(rng):
    import jax.numpy as jnp
    from spmv_research_tpu.convert import build_bsr
    from spmv_research_tpu.ops import sddmm

    host, mat = _blocked_host(rng, mb=10, nb=6)
    S = build_bsr(host)
    k = 16
    Aa = rng.uniform(-1, 1, (host.m, k)).astype(np.float32)
    Bb = rng.uniform(-1, 1, (host.n, k)).astype(np.float32)
    C = np.asarray(sddmm(S, jnp.asarray(Aa), jnp.asarray(Bb), impl="xla"))
    # gold: dense product masked by the stored pattern, in BSR block layout
    P = (Aa.astype(np.float64) @ Bb.astype(np.float64).T)
    data = np.asarray(S.data)
    rows = np.asarray(S.block_rows)
    cols = np.asarray(S.block_cols)
    mb = (host.m + S.br - 1) // S.br
    want = np.zeros_like(data, dtype=np.float64)
    Ppad = np.zeros((mb * S.br, ((host.n + S.bc - 1)//S.bc) * S.bc))
    Ppad[:host.m, :host.n] = P
    for b in range(data.shape[0]):
        if rows[b] >= mb:
            continue
        blk = Ppad[rows[b]*S.br:(rows[b]+1)*S.br,
                   cols[b]*S.bc:(cols[b]+1)*S.bc]
        want[b] = np.where(data[b] != 0, blk, 0.0)
    assert np.max(np.abs(C.reshape(want.shape) - want)) < 1e-3
