"""SELLWDS (fp64-at-speed double-single SELLW) + part_cap and chunk layout."""
import numpy as np
import pytest
import scipy.sparse as sp
import jax.numpy as jnp

from spmv_research_tpu.core.host import HostCSR
from spmv_research_tpu.ops import spmv
from spmv_research_tpu.ops.sellw import build_sellw, execute_sellw_numpy
from spmv_research_tpu.ops.sellw_ds import (build_sellwds, spmv_sellwds_f64,
                                            SellWDS)


def _banded(m=2500, max_k=50, seed=0, lognormal=True):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(m):
        k = int(rng.integers(1, max_k))
        c = np.clip(i + rng.integers(-250, 250, k), 0, m - 1)
        v = rng.uniform(-1, 1, k)
        if lognormal:
            v = v * rng.lognormal(0, 3, k)   # wide magnitude spread
        rows += [i] * k
        cols += c.tolist()
        vals += v.tolist()
    S = sp.csr_matrix((vals, (rows, cols)), shape=(m, m))
    S.sum_duplicates()
    return HostCSR.from_scipy(S)


@pytest.mark.parametrize("cap", [4, 8, 128])
def test_part_cap_preserves_results(cap):
    host = _banded(1500, 40, seed=1, lognormal=False)
    x = np.random.default_rng(2).uniform(0, 1, host.m)
    gold = host.to_scipy() @ x
    A = build_sellw(host, dtype=jnp.float32, part_cap=cap)
    y = execute_sellw_numpy(A, x)
    assert np.abs(y - gold).max() / np.abs(gold).max() < 1e-6
    yp = np.asarray(spmv(A, jnp.asarray(x, jnp.float32), impl="xla"),
                    np.float64)
    assert np.abs(yp - gold).max() / np.abs(gold).max() < 1e-5
    # stage depth really is bounded by the cap
    assert A.stages <= max(int(cap - 1).bit_length(), 0)


def test_sellw_chunk_layout():
    """Chunks are stored unpadded; yidx names a chunk's output row
    (g·nchunks + chunk) or the all-zero row G·nchunks, and every y block
    that holds nonzeros is fed by at least one chunk."""
    host = _banded(2000, 60, seed=3, lognormal=False)
    A = build_sellw(host, dtype=jnp.float32, part_cap=128)
    assert A.wrow.shape[0] == 8 * A.nchunks
    yidx = np.asarray(A.yidx)
    assert yidx.min() >= 0 and yidx.max() <= A.G * A.nchunks
    lens = np.diff(host.ia.astype(np.int64))
    nonempty = np.add.reduceat(lens, np.arange(0, host.m, 128)) > 0
    assert np.all((yidx[:, nonempty] < A.G * A.nchunks).any(axis=0))


@pytest.mark.parametrize("impl", ["xla"])
def test_sellwds_passes_fp64_gate(impl):
    host = _banded(2500, 50, seed=0, lognormal=True)
    A = build_sellwds(host)
    x = np.random.default_rng(1).uniform(-1, 1, host.m)
    gold = host.spmv_gold(x).astype(np.float64)
    y = spmv_sellwds_f64(A, x)
    rel = np.abs(y - gold) / np.maximum(np.abs(gold), 1e-300)
    assert rel.max() < 1e-10     # the reference's fp64 gate

    # fp32 x convenience entry stays close (x cast is the only loss)
    y32 = np.asarray(spmv(A, jnp.asarray(x, jnp.float32), impl=impl),
                     np.float64)
    gold32 = host.to_scipy() @ x.astype(np.float32).astype(np.float64)
    rel32 = np.abs(y32 - gold32) / np.maximum(np.abs(gold32), 1e-300)
    assert rel32.max() < 1e-6


def test_sellwds_rejects_overflow_values():
    host = _banded(500, 10, seed=5, lognormal=False)
    host.a[0] = 1e35
    with pytest.raises(Exception):
        build_sellwds(host)


def test_sellwds_harness_fp64_gate_hook():
    from spmv_research_tpu.harness.bench import bench_spmv
    from spmv_research_tpu.harness.config import BenchConfig
    host = _banded(1200, 30, seed=7, lognormal=True)
    A = build_sellwds(host)
    cfg = BenchConfig(min_time_s=0.05, min_num_loops=4)
    r = bench_spmv(host, A, config=cfg, impl="xla", matrix_name="t")
    assert r.metrics.mape < 1e-10    # judged against the fp64 gate
