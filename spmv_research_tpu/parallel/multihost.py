"""Multi-host runtime setup and weak-scaling measurement.

The reference has no distributed backend (SURVEY.md §5.8) — its SLURM scripts
launch independent single-node jobs. Here multi-host is first-class:
`init_multihost` wraps `jax.distributed.initialize` (one process per host,
DCN-coordinated), and `weak_scaling_efficiency` measures the BASELINE.md
target (≥70% efficiency at N ≥ 2 hosts) by scaling the synthetic problem with
the mesh while keeping per-device work constant.

On a single host, the same code paths run over the chip mesh (ICI) or a
virtual CPU mesh (tests / dryrun).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..core.host import HostCSR
from ..gen import ArtificialParams, artificial_matrix_generation
from .dist import make_sparse_mesh, build_sharded_csr, distributed_spmv


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """Initialize the JAX multi-host runtime (no-op when single-process).

    In managed cluster environments arguments may be auto-detected;
    otherwise (as on a bare GPU host) pass coordinator host:port, world
    size and rank explicitly.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    elif coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address)


def _bench_dist_spmv(A, x, strategy: str, reps: int = 8) -> float:
    """Median time of one distributed SpMV (differential, D2H-synced)."""
    @jax.jit
    def chain(xv, data, cols, rows, k):
        from .dist import distributed_spmv_arrays
        def body(_, v):
            y = distributed_spmv_arrays(A, data, cols, rows, v, strategy)
            return v + y * 1e-30
        v = jax.lax.fori_loop(0, k, body, xv)
        return jnp.sum(v[:8])

    import functools
    lo = functools.partial(chain, k=2)
    hi = functools.partial(chain, k=10)
    args = (x, A.data, A.cols, A.rows)
    float(np.asarray(lo(*args)))
    float(np.asarray(hi(*args)))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(np.asarray(lo(*args)))
        t_lo = time.perf_counter() - t0
        t0 = time.perf_counter()
        float(np.asarray(hi(*args)))
        t_hi = time.perf_counter() - t0
        ts.append((t_hi - t_lo) / 8)
    pos = [t for t in ts if t > 0] or [1e-9]
    return float(np.median(pos))


def weak_scaling_efficiency(rows_per_device: int = 100_000,
                            avg_nnz_per_row: float = 8.0,
                            strategy: str = "allgather",
                            device_counts=None, seed: int = 14) -> dict:
    """Weak scaling: per-device problem size fixed.

    Two efficiencies per k (both ideal 1.0):
      * ``efficiency``          = t(1 dev, W) / t(k dev, k·W) — the classic
        definition; only meaningful on k *real* chips.
      * ``efficiency_overhead`` = t(1 dev, k·W) / t(k dev, k·W) — sharding/
        collective overhead at equal total work; the honest number on a
        virtual (shared-core) CPU mesh, where k devices share one socket's
        FLOPs and the classic metric has a 1/k floor by construction.
    """
    max_dev = jax.device_count()
    device_counts = device_counts or [k for k in (1, 2, 4, 8) if k <= max_dev]
    out = {}
    t1 = None
    for k in device_counts:
        m = rows_per_device * k
        p = ArtificialParams(m, m, avg_nnz_per_row, avg_nnz_per_row / 3,
                             "normal", "random", bw=0.05, skew=1.0,
                             avg_num_neighbours=0.5, cross_row_similarity=0.3,
                             seed=seed)
        host, _ = artificial_matrix_generation(p)
        rng = np.random.Generator(np.random.PCG64(0))
        xv = rng.uniform(size=m)
        mesh1 = make_sparse_mesh(1)
        A1 = build_sharded_csr(host, mesh1)
        t_1dev = _bench_dist_spmv(A1, A1.pad_vector(xv), strategy)
        if k == 1:
            t = t_1dev
        else:
            mesh = make_sparse_mesh(k)
            A = build_sharded_csr(host, mesh)
            t = _bench_dist_spmv(A, A.pad_vector(xv), strategy)
        if t1 is None:
            t1 = t
        out[k] = {"time": t, "efficiency": t1 / t if t > 0 else 0.0,
                  "efficiency_overhead": t_1dev / t if t > 0 else 0.0,
                  "nnz": host.nnz}
    return out
