#!/usr/bin/env python
"""L1 end-to-end: materialize twins as .mtx files, sweep FROM DISK, and
assert the disk-sourced results match the in-memory path.

The reference crosses MatrixMarket I/O on every run (``bench.cpp:560`` ->
``matrix_market.c:258``); this drives the same layer: generator ->
``mtx_write`` -> ``mtx_read`` (native parser when built) -> ``coo_to_csr``
-> format build -> bench -> CSV. Device numbers come only from a run on the
GPU; on the CPU it checks the I/O path.

Usage: python tools/mtx_sweep.py [outdir] [n_twins]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "out_logs/mtx_sweep"
    n_twins = int(sys.argv[2]) if len(sys.argv) > 2 else 5

    from spmv_research_tpu.core.host import HostCOO
    from spmv_research_tpu.gen import generate_from_line
    from spmv_research_tpu.harness import BenchConfig, run_sweep
    from spmv_research_tpu.io.matrix_market import mtx_read, mtx_write
    from spmv_research_tpu.convert.coo_csr import coo_to_csr

    lines = [ln.strip() for ln in open("datasets/validation_twins.txt")
             if ln.strip() and not ln.startswith("#")][:n_twins]
    os.makedirs(outdir, exist_ok=True)
    mtx_dir = os.path.join(outdir, "mtx")
    os.makedirs(mtx_dir, exist_ok=True)

    paths = []
    for ln in lines:
        name = ln.split()[-1]
        path = os.path.join(mtx_dir, f"{name}.mtx")
        t0 = time.time()
        host, _ = generate_from_line(ln)
        if not os.path.exists(path):
            rows = np.repeat(np.arange(host.m, dtype=np.int32),
                             host.row_lengths())
            coo = HostCOO(rows=rows, cols=host.ja.copy(),
                          vals=host.a.copy(), m=host.m, n=host.n)
            mtx_write(path, coo)
        # round-trip parity: disk -> parse -> CSR equals the in-memory CSR
        back = coo_to_csr(mtx_read(path, expand_symmetry=True))
        assert back.nnz == host.nnz, (name, back.nnz, host.nnz)
        assert np.array_equal(back.ia, host.ia), name
        assert np.array_equal(back.ja, host.ja), name
        assert np.allclose(back.a, host.a, rtol=1e-12), name
        print(f"# {name}: wrote+verified {path} "
              f"({os.path.getsize(path)/1e6:.1f} MB, {time.time()-t0:.1f}s)",
              flush=True)
        paths.append(path)

    if os.environ.get("MTX_VERIFY_ONLY"):
        print("# MTX_VERIFY_ONLY set: skipping the bench sweep", flush=True)
        return
    run_sweep(paths, formats=["csr", "closg"], workloads=["spmv"],
              impls=["xla"], out_dir=outdir,
              config=BenchConfig.from_env())


if __name__ == "__main__":
    main()
