"""Solver-benchmark repairs:

* chunked trisolve schedule (bounded padding; scircuit-class matrices),
* SPD / diag-dominant solver-dataset analogs,
* jitted solver benches that converge and gate out garbage rows.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import jax.numpy as jnp

from spmv_research_tpu.core.host import HostCSR
from spmv_research_tpu.convert import make_spd, make_diag_dominant
from spmv_research_tpu.solvers.ilu import (
    build_chunk_schedule, build_level_schedule, build_schedule,
    ChunkSchedule, sptrsv, ilu0)
from spmv_research_tpu.harness.workloads import (
    bench_cg, bench_trisolve, BenchGateError)
from spmv_research_tpu.harness.config import BenchConfig


def _rand_square(m=150, density=0.03, seed=0):
    rng = np.random.default_rng(seed)
    A = sp.random(m, m, density, random_state=rng, format="csr")
    A = A + sp.diags(rng.uniform(1.0, 2.0, m))
    return HostCSR.from_scipy(A.tocsr())


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("C", [8, 64])
def test_chunk_schedule_matches_scipy(lower, C):
    host = _rand_square(123, 0.05, seed=3)
    T = (sp.tril if lower else sp.triu)(host.to_scipy(), format="csr")
    hostT = HostCSR.from_scipy(T)
    b = np.random.default_rng(1).uniform(0, 1, host.m)
    xref = sp.linalg.spsolve_triangular(T.tocsr(), b, lower=lower)
    cs = build_chunk_schedule(hostT, lower=lower, dtype=jnp.float32, C=C)
    x = np.asarray(sptrsv(cs, jnp.asarray(b, jnp.float32)), np.float64)
    rel = np.abs(x - xref).max() / np.abs(xref).max()
    assert rel < 1e-4      # fp32 solve; C=8 exercises straddling rows


def test_chunk_schedule_wide_row_straddles():
    # one row with 300 off-diagonals straddles multiple C=64 chunks
    m = 320
    rng = np.random.default_rng(7)
    rows = [np.array([m - 1] * 300)]
    cols = [rng.choice(m - 1, 300, replace=False)]
    vals = [rng.uniform(0.1, 1.0, 300)]
    rows.append(np.arange(m))
    cols.append(np.arange(m))
    vals.append(np.full(m, 2.0))
    T = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(m, m))
    hostT = HostCSR.from_scipy(T)
    b = rng.uniform(0, 1, m)
    xref = sp.linalg.spsolve_triangular(T.tocsr(), b, lower=True)
    cs = build_chunk_schedule(hostT, lower=True, dtype=jnp.float32, C=64)
    x = np.asarray(sptrsv(cs, jnp.asarray(b, jnp.float32)), np.float64)
    assert np.abs(x - xref).max() / np.abs(xref).max() < 1e-4


def test_build_schedule_falls_back_to_chunked():
    # long dependency chain (bidiagonal): n_levels = m, dense schedule pads
    # n_levels x R x W -> small here, so force the fallback via monkey bound
    host = _rand_square(80, 0.02, seed=5)
    T = HostCSR.from_scipy(sp.tril(host.to_scipy(), format="csr"))
    dense = build_schedule(T, lower=True, dtype=jnp.float32)
    chunk = build_chunk_schedule(T, lower=True, dtype=jnp.float32, C=32)
    b = np.random.default_rng(2).uniform(0, 1, host.m)
    xd = np.asarray(sptrsv(dense, jnp.asarray(b, jnp.float32)))
    xc = np.asarray(sptrsv(chunk, jnp.asarray(b, jnp.float32)))
    np.testing.assert_allclose(xd, xc, rtol=1e-5, atol=1e-6)


def test_ilu0_pivot_clamp_keeps_factors_finite():
    # engineered near-singular pivot: row 1 eliminates to ~0 diagonal
    A = sp.csr_matrix(np.array([[1.0, 1.0, 0.0],
                                [1.0, 1.0 + 1e-14, 1.0],
                                [0.0, 1.0, 1.0]]))
    L, U = ilu0(HostCSR.from_scipy(A))
    assert np.isfinite(L.a).all() and np.isfinite(U.a).all()
    assert np.abs(U.a).max() < 1e12    # no exploded values


def test_make_spd_is_spd():
    host = _rand_square(60, 0.05, seed=9)
    S = make_spd(host).to_scipy().toarray()
    assert np.allclose(S, S.T)
    w = np.linalg.eigvalsh(S)
    assert w.min() > 0


def test_make_diag_dominant():
    host = _rand_square(60, 0.05, seed=10)
    D = make_diag_dominant(host).to_scipy().tocsr()
    dia = D.diagonal()
    off = np.abs(D).sum(axis=1).A1 - np.abs(dia) if hasattr(
        np.abs(D).sum(axis=1), "A1") else \
        np.asarray(np.abs(D).sum(axis=1)).ravel() - np.abs(dia)
    assert (np.abs(dia) > off).all()


def _csr_fmt(host):
    from spmv_research_tpu.convert import build_csr
    return build_csr(host, dtype=jnp.float32)


def test_bench_cg_converges_and_is_fast_path():
    host = make_spd(_rand_square(200, 0.03, seed=11))
    cfg = BenchConfig(min_time_s=0.1, min_num_loops=4, cg_max_num_iters=100)
    r = bench_cg(host, _csr_fmt(host), config=cfg, impl="xla",
                 matrix_name="t")
    assert r.extra["converged"]
    assert r.mape < 1e-4
    assert np.isfinite(r.time_iter_median) and r.time_iter_median > 0


def test_gate_rejects_garbage_rows():
    # the sweep-level gate: NaN metrics and non-progressing solves are
    # FAILED rows, never data
    from spmv_research_tpu.harness.sweep import _gate_result
    from spmv_research_tpu.harness.workloads import WorkloadResult

    def mk(mape, max_ae):
        return WorkloadResult(workload="cg", matrix_name="t",
                              format_name="CSR", impl="xla", k=0,
                              time_iter_median=1e-3, gflops=1.0,
                              num_loops=10, mape=mape, max_ae=max_ae,
                              extra={})
    with pytest.raises(BenchGateError):
        _gate_result(mk(float("nan"), 0.0), "trisolve")
    with pytest.raises(BenchGateError):
        _gate_result(mk(1.0, 1.0), "cg")          # residual 1.0: no progress
    _gate_result(mk(1e-6, 1e-6), "cg")            # healthy row passes
    _gate_result(mk(0.5, 0.5), "spmv")            # non-solver: finite is ok


def test_bench_bicgstab_dd_converges():
    host = make_diag_dominant(_rand_square(200, 0.03, seed=13))
    cfg = BenchConfig(min_time_s=0.1, min_num_loops=4, cg_max_num_iters=100)
    r = bench_cg(host, _csr_fmt(host), config=cfg, impl="xla",
                 matrix_name="t", bicgstab=True)
    assert r.extra["converged"]
    assert r.mape < 1e-4


def test_bench_trisolve_gate_and_run():
    host = make_diag_dominant(_rand_square(150, 0.03, seed=14))
    cfg = BenchConfig(min_time_s=0.1, min_num_loops=4)
    r = bench_trisolve(host, config=cfg, matrix_name="t")
    assert np.isfinite(r.mape) and r.mape < 1e-2
