"""Multicast-Clos gather engine tests (CLOSM)."""

import numpy as np
import pytest

from conftest import random_host_csr

from spmv_research_tpu.ops.clos_mcast import (route_invreg_gather,
                                              route_mcast, apply_mcast_numpy,
                                              build_clos_mcast,
                                              execute_closm_numpy)
from spmv_research_tpu.ops.clos_route import InVregPlanes
from spmv_research_tpu.ops import spmv


def test_invreg_gather_with_duplication(rng):
    n_vregs, W = 3, 128
    # every output slot reads a random source — heavy duplication
    tot = n_vregs * 8 * W
    vreg = np.arange(tot) // (8 * W)
    out_pos = np.arange(tot) % (8 * W)
    src_pos = rng.integers(0, 8 * W, tot)
    planes, spilled = route_invreg_gather(vreg, out_pos, src_pos, n_vregs, W)
    from spmv_research_tpu.ops.clos_route import apply_invreg_numpy
    v = rng.uniform(size=(n_vregs * 8, W))
    out = apply_invreg_numpy(v, planes)
    flat_in = v.reshape(n_vregs, -1)
    flat_out = out.reshape(n_vregs, -1)
    ok = ~spilled
    got = flat_out[vreg[ok], out_pos[ok]]
    want = flat_in[vreg[ok], src_pos[ok]]
    assert np.allclose(got, want)
    # with full random fan-in, some spill is allowed but should be small
    assert spilled.mean() < 0.15


def test_route_mcast_roundtrip(rng):
    N = 8192
    K = 5000
    out = rng.choice(N, K, replace=False)
    src = rng.integers(0, N // 4, K) * 4   # spread-style sources, duplicated
    r = route_mcast(src, out, N)
    v = rng.uniform(size=N)
    got = apply_mcast_numpy(v, r)
    ok = ~r.spilled
    assert np.allclose(got[out[ok]], v[src[ok]])
    assert r.spilled.mean() < 0.05


@pytest.mark.parametrize("m,n,density", [(300, 300, 0.01), (500, 200, 0.02),
                                         (64, 4000, 0.003)])
def test_closm_numpy_vs_scipy(rng, m, n, density):
    host = random_host_csr(m, n, density, rng)
    A = build_clos_mcast(host, )
    x = rng.uniform(-1, 1, n)
    y = execute_closm_numpy(A, x)
    sp = host.to_scipy()
    want = sp @ x
    scale = np.abs(sp) @ np.abs(x) + 1e-30
    assert np.max(np.abs(y - want) / scale) < 1e-6


@pytest.mark.parametrize("impl", ["xla"])
def test_closm_device_impls(rng, impl):
    import jax.numpy as jnp

    host = random_host_csr(400, 400, 0.015, rng)
    A = build_clos_mcast(host, )
    x = rng.uniform(-1, 1, 400).astype(np.float32)
    y = np.asarray(spmv(A, jnp.asarray(x), impl=impl))
    want = host.to_scipy() @ x.astype(np.float64)
    assert np.allclose(y, want, atol=1e-4)


def test_closm_pathological(rng):
    import scipy.sparse as sp
    from spmv_research_tpu.core.host import HostCSR

    # one column hammered by many rows (max duplication), empty rows
    m = n = 300
    rows = np.concatenate([np.arange(200), [250] * 30])
    cols = np.concatenate([np.full(200, 17), rng.integers(0, n, 30)])
    vals = rng.uniform(-1, 1, rows.shape[0])
    mat = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    mat.sum_duplicates()
    mat.sort_indices()
    host = HostCSR.from_scipy(mat)
    A = build_clos_mcast(host, )
    x = rng.uniform(-1, 1, n)
    scale = np.abs(mat) @ np.abs(x) + 1e-30
    assert np.max(np.abs(execute_closm_numpy(A, x) - mat @ x) / scale) < 1e-6
