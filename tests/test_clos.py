"""CLOS routed-SpMV engine tests (router, program, executors).

Mirrors test_bfly.py: differential against scipy on random + pathological
matrices (reference strategy: golden-model validation, bench_spmv.cpp:61-235).
"""

import numpy as np
import pytest

from conftest import random_host_csr

from spmv_research_tpu.ops.clos_route import (euler_edge_color, route_clos,
                                              apply_clos_numpy, route_invreg,
                                              apply_invreg_numpy)
from spmv_research_tpu.ops.clos import build_clos, execute_clos_numpy
from spmv_research_tpu.ops import spmv


def test_euler_edge_coloring_proper(rng):
    for levels, nv in ((1, 3), (4, 7), (7, 16)):
        d = 1 << levels
        left = np.repeat(np.arange(nv), d)
        right = rng.permutation(np.repeat(np.arange(nv), d))
        c = euler_edge_color(left, right, levels)
        assert c.min() >= 0 and c.max() < d
        assert len(set(zip(left.tolist(), c.tolist()))) == nv * d
        assert len(set(zip(right.tolist(), c.tolist()))) == nv * d


def test_invreg_route_roundtrip(rng):
    n_vregs, n_lanes = 4, 128
    tot = n_vregs * 8 * n_lanes
    vreg = np.arange(tot) // (8 * n_lanes)
    pos_src = np.arange(tot) % (8 * n_lanes)
    pos_dst = np.concatenate([rng.permutation(8 * n_lanes)
                              for _ in range(n_vregs)])
    p = route_invreg(vreg, pos_src, pos_dst, n_vregs, n_lanes)
    v = rng.uniform(size=(n_vregs * 8, n_lanes))
    out = apply_invreg_numpy(v, p)
    flat = v.reshape(n_vregs, -1)
    want = np.zeros_like(flat)
    for w in range(n_vregs):
        sel = vreg == w
        want[w, pos_dst[sel]] = flat[w, pos_src[sel]]
    assert np.allclose(out.reshape(n_vregs, -1), want)


def test_clos_full_and_partial_perm(rng):
    N = 8192
    tgt = rng.permutation(N)
    cp = route_clos(np.arange(N), tgt, N)
    v = rng.uniform(size=N)
    out = apply_clos_numpy(v, cp)
    want = np.zeros(N)
    want[tgt] = v
    assert np.allclose(out, want)

    src = rng.choice(N, 1000, replace=False)
    dst = rng.choice(N, 1000, replace=False)
    cp = route_clos(src, dst, N)
    v = np.zeros(N)
    v[src] = rng.uniform(size=1000) + 1
    out = apply_clos_numpy(v, cp)
    assert np.allclose(out[dst], v[src])


@pytest.mark.parametrize("m,n,density", [(300, 300, 0.01), (500, 200, 0.02),
                                         (64, 4000, 0.003)])
def test_clos_numpy_vs_scipy(rng, m, n, density):
    host = random_host_csr(m, n, density, rng)
    A = build_clos(host, )
    x = rng.uniform(-1, 1, n)
    y = execute_clos_numpy(A, x)
    sp = host.to_scipy()
    want = sp @ x
    scale = np.abs(sp) @ np.abs(x) + 1e-30
    assert np.max(np.abs(y - want) / scale) < 1e-6


def test_clos_pathological(rng):
    import scipy.sparse as sp
    from spmv_research_tpu.core.host import HostCSR

    # empty rows, dense row, duplicate-free single column hammering
    m = n = 200
    rows = np.concatenate([np.zeros(150, int), [5] * 1, np.arange(50) + 100])
    cols = np.concatenate([rng.integers(0, n, 150), [7], [3] * 50])
    vals = rng.uniform(-1, 1, rows.shape[0])
    mat = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    mat.sum_duplicates()
    mat.sort_indices()
    host = HostCSR.from_scipy(mat)
    A = build_clos(host, )
    x = rng.uniform(-1, 1, n)
    scale = np.abs(mat) @ np.abs(x) + 1e-30
    assert np.max(np.abs(execute_clos_numpy(A, x) - mat @ x) / scale) < 1e-6


@pytest.mark.parametrize("impl", ["xla"])
def test_clos_device_impls(rng, impl):
    import jax.numpy as jnp

    host = random_host_csr(400, 400, 0.015, rng)
    A = build_clos(host, )
    x = rng.uniform(-1, 1, 400).astype(np.float32)
    y = np.asarray(spmv(A, jnp.asarray(x), impl=impl))
    want = host.to_scipy() @ x.astype(np.float64)
    assert np.allclose(y, want, atol=1e-4)
