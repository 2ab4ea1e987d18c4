"""Tests for the routed-butterfly (BFLY) SpMV engine.

Covers the routing builder (greedy + exact Waksman), the numpy reference
executor, the XLA executor, and the Pallas executor in interpret mode —
all differentially against scipy (SURVEY.md §4 test strategy).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from spmv_research_tpu.ops.routing import (
    greedy_route, apply_pass_numpy, build_bfly_program, execute_numpy,
)
from spmv_research_tpu.ops.waksman import route_waksman
from spmv_research_tpu.ops.bfly import build_bfly
from spmv_research_tpu.ops import spmv
from conftest import random_host_csr

RTOL, ATOL = 3e-5, 2e-5


def test_waksman_permutation_fuzz():
    for trial in range(30):
        rs = np.random.default_rng(trial)
        L = int(rs.integers(2, 9))
        N = 1 << L
        perm = rs.permutation(N)
        p = route_waksman(np.arange(N), perm, L, N)
        v = rs.uniform(1, 2, N)
        out = apply_pass_numpy(v, p)
        np.testing.assert_allclose(out[perm], v)


def test_waksman_partial_routes_targets():
    """Default-keep semantics: every routed target receives its value.
    (Non-target cells may hold stale copies by design; the SpMV pipeline
    overwrites/zeroes every cell it consumes — fill, vals, out_valid.)"""
    rs = np.random.default_rng(3)
    N, L = 256, 8
    src = rs.choice(N, 60, replace=False)
    tgt = rs.choice(N, 60, replace=False)
    p = route_waksman(src, tgt, L, N)
    v = np.zeros(N)
    vv = rs.uniform(1, 2, 60)
    v[src] = vv
    out = apply_pass_numpy(v, p)
    np.testing.assert_allclose(out[tgt], vv)


def test_greedy_merge_route():
    rs = np.random.default_rng(5)
    N, L = 256, 8
    E = 120
    src = np.sort(rs.choice(N, E, replace=False))
    tgt = np.sort(rs.integers(0, 30, E)) * 8
    passes = greedy_route(src, tgt, L, N, allow_merge=True)
    v = np.zeros(N)
    vv = rs.uniform(1, 2, E)
    v[src] = vv
    out = sum(apply_pass_numpy(v, p) for p in passes)
    ref = np.zeros(N)
    np.add.at(ref, tgt, vv)
    np.testing.assert_allclose(out, ref)


def test_program_numpy_matches_scipy(rng):
    for (m, n, d) in [(100, 80, 0.05), (64, 64, 0.25), (300, 500, 0.01)]:
        h = random_host_csr(m, n, d, rng)
        prog = build_bfly_program(h, dtype=np.float64)
        x = rng.uniform(-1, 1, n)
        y = execute_numpy(prog, x)
        np.testing.assert_allclose(y, h.to_scipy() @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("impl", ["xla"])
def test_bfly_spmv_impls(impl, rng):
    mats = [random_host_csr(100, 80, 0.05, rng),
            random_host_csr(64, 64, 0.2, rng),
            random_host_csr(500, 700, 0.01, rng)]
    for h in mats:
        B = build_bfly(h)
        x = rng.uniform(-1, 1, h.n)
        y = np.asarray(spmv(B, jnp.asarray(x, jnp.float32), impl=impl))
        np.testing.assert_allclose(y, h.to_scipy() @ x, rtol=RTOL, atol=ATOL)


def test_bfly_pathological(rng):
    import scipy.sparse as sp
    from spmv_research_tpu.core.host import HostCSR

    # empty rows + dense row
    A = sp.random(80, 80, 0.03, random_state=0).tolil()
    A[7, :] = 1.5
    A[20, :] = 0
    h_csr = A.tocsr()
    h_csr.sort_indices()
    h = HostCSR.from_scipy(h_csr)
    B = build_bfly(h)
    x = rng.uniform(-1, 1, 80)
    y = np.asarray(spmv(B, jnp.asarray(x, jnp.float32), impl="xla"))
    np.testing.assert_allclose(y, h.to_scipy() @ x, rtol=RTOL, atol=ATOL)
