#!/usr/bin/env python
"""Real ≥2-process distributed run on the CPU backend (the multi-host
bootstrap exercised with two processes). Each process owns 4 virtual CPU devices; the 2-process
global mesh (8 devices) executes the distributed SpMV with each halo
strategy, and rank 0 gates the result against scipy.

Usage (what tools/launch_multihost.sh automates per host):
    python tools/multiproc_cpu_test.py            # spawns rank 1, runs rank 0
    python tools/multiproc_cpu_test.py --rank 1   # worker
"""
import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

COORD = "127.0.0.1:8931"


def run_rank(rank: int) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)   # 4 local -> 8 global
    from spmv_research_tpu.parallel import init_multihost
    init_multihost(coordinator_address=COORD, num_processes=2,
                   process_id=rank)
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, len(jax.devices())

    import numpy as np
    import scipy.sparse as sp
    from jax.sharding import Mesh
    from spmv_research_tpu.core.host import HostCSR
    from spmv_research_tpu.parallel.dist import (build_sharded_csr,
                                                 distributed_spmv)

    mesh = Mesh(np.array(jax.devices()).reshape(8), ("d",))
    rng = np.random.RandomState(0)
    A = sp.random(1600, 1600, 0.01, random_state=rng, format="csr")
    A.sort_indices()
    host = HostCSR(ia=A.indptr.astype(np.int32),
                   ja=A.indices.astype(np.int32),
                   a=A.data.astype(np.float64), m=1600, n=1600)
    S = build_sharded_csr(host, mesh, axis="d")
    x = np.random.default_rng(1).standard_normal(1600)
    ref = A @ x
    for strategy in ("allgather", "ring"):
        xp = S.pad_vector(x)
        # NOTE: an outer jit must not close over S's sharded arrays —
        # multi-process JAX rejects closures spanning non-addressable
        # devices (single-process tests never catch this); the shard_map
        # inside distributed_spmv passes them as arguments.
        from jax.experimental import multihost_utils
        yg = distributed_spmv(S, xp, strategy=strategy)
        y = S.unpad_vector(
            np.asarray(multihost_utils.process_allgather(yg,
                                                         tiled=True)))
        err = float(np.abs(y - ref).max() / np.abs(ref).max())
        if rank == 0:
            print(f"rank0 2-process {strategy}: err={err:.2e} "
                  f"ok={err < 2e-5}", flush=True)
        assert err < 2e-5, (strategy, err)
    if rank == 0:
        print("MULTIPROC OK: 2 processes x 4 devices, allgather + ring",
              flush=True)
    jax.distributed.shutdown()
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, default=None)
    args = ap.parse_args()
    if args.rank is not None:
        return run_rank(args.rank)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    worker = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", "1"],
        env=env)
    try:
        rc = run_rank(0)
    finally:
        worker.wait(timeout=120)
    return rc or worker.returncode


if __name__ == "__main__":
    sys.exit(main())
