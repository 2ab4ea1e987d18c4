#!/usr/bin/env python
"""Driver benchmark: CSR SpMV roofline fraction on the scircuit twin.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}

metric: fraction of the CSR-storage HBM roofline achieved by the best
SpMV implementation on a SuiteSparse-twin synthetic matrix (scircuit twin —
parameters from the reference's twin table,
``benchmark_code/BENCH/config.sh:399-455``). At 171k rows and ~0.96M nnz the
matrix is about 10 MB: it stays in the H200's 50 MB L2, so this cell is
L2-resident, not an HBM measurement.

vs_baseline = value / 0.80 (the BASELINE.md 1-chip target: ≥80% of the
CSR HBM roofline).

Every candidate (CSR/xla and each engine ``build_best`` builds, through its
XLA lowering) is timed through ONE dynamic-k differential chain, and compile
time is reported per candidate. A candidate that fails makes the run fail
(non-zero exit, no JSON line).
``detail.device`` names the card (platform, kind, count, and ``nvidia-smi``
name and power limit).
"""

import json
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


SCIRCUIT_LINE = ("170998 170998 5.6 4.39 normal random 0.297 61.9 0.803 "
                 "0.633 14 scircuit_twin")


def bench_candidates(line, name, cfg):
    """The benchmark's path for one twin: generator line → RCM if it
    narrows the band → CSR plus every engine ``build_best`` builds → one
    ``bench_spmv`` per candidate through its XLA lowering.

    Returns ``(host, [(name, impl, BenchResult, convert_info), ...])``; a
    candidate that fails, or misses the fp32 accuracy gate, raises (naming
    it), so no run reports a partial table as a result."""
    import jax.numpy as jnp

    from spmv_research_tpu.gen import generate_from_line
    from spmv_research_tpu.convert import build_csr
    from spmv_research_tpu.convert.build_pallas import build_best
    from spmv_research_tpu.convert.reorder import rcm_if_beneficial
    from spmv_research_tpu.harness import bench_spmv
    from spmv_research_tpu.harness.metrics import FP32_MAPE_GATE

    t_all = time.time()
    host, _ = generate_from_line(line)
    log(f"# {name}: generated m={host.m} nnz={host.nnz} "
        f"({time.time() - t_all:.1f}s)")
    t0 = time.time()
    host, _ = rcm_if_beneficial(host)
    log(f"# {name}: rcm-if-beneficial ({time.time() - t0:.1f}s)")

    dtype = jnp.float32
    t0 = time.time()
    fmts = {"CSR": (build_csr(host, dtype=dtype),
                    {"build_s": 0.0, "cold_build_s": 0.0,
                     "from_cache": False})}
    fmts.update(build_best(host, dtype=dtype))
    log(f"# {name}: formats built: {sorted(fmts)} ({time.time() - t0:.1f}s)")

    out = []
    for fmt, (A, info) in fmts.items():
        try:
            r = bench_spmv(host, A, config=cfg, impl="xla", matrix_name=name,
                           time_convert=info["build_s"],
                           time_convert_cold=info["cold_build_s"])
        except Exception as e:
            raise RuntimeError(f"{name}: candidate {fmt}/xla failed: "
                               f"{type(e).__name__}: {e}") from e
        if not r.metrics.mape <= FP32_MAPE_GATE:
            raise RuntimeError(f"{name}: candidate {fmt}/xla mape "
                               f"{r.metrics.mape:.3e} exceeds the fp32 gate "
                               f"{FP32_MAPE_GATE:g}")
        out.append((fmt, "xla", r, info))
        log(f"# {name} {fmt}/xla: {r.nnz_per_s / 1e9:.6g} Gnnz/s "
            f"median={r.time_iter_median * 1e6:.6g}us "
            f"mape={r.metrics.mape:.3e} compile={r.time_compile:.3f}s "
            f"convert={info['build_s']:.3f}s "
            f"convert_cold={info['cold_build_s']:.3f}s")
    return host, out


def main():
    from spmv_research_tpu.utils.runtime import device_record, enable_compile_cache

    enable_compile_cache()
    from spmv_research_tpu.harness import BenchConfig
    from spmv_research_tpu.utils import roofline as rl

    device = device_record()
    if device["platform"] != "gpu":
        log(f"# no GPU: JAX runs on {device['platform']!r}; refusing to "
            "report a device number")
        return 1
    log(f"# device: {device}")

    t_all = time.time()
    cfg = BenchConfig(min_num_loops=64, min_time_s=1.0)
    host, results = bench_candidates(SCIRCUIT_LINE, "scircuit_twin", cfg)
    sol_nnz_s = rl.csr_roofline_nnz_per_s(host.nnz, host.m, host.n,
                                          np.dtype("float32").itemsize,
                                          rl.device_spec())

    best = max(results, key=lambda t: t[2].nnz_per_s)
    name, impl, r, _ = best
    base = next(t[2] for t in results if t[0] == "CSR")
    frac = r.nnz_per_s / sol_nnz_s
    print(json.dumps({
        "metric": "csr_spmv_roofline_frac",
        "value": frac,
        "unit": "fraction_of_hbm_roofline",
        "vs_baseline": frac / 0.80,
        "detail": {
            "matrix": "scircuit_twin", "m": host.m, "nnz": host.nnz,
            "best_format": name, "best_impl": impl,
            "nnz_per_s": r.nnz_per_s,
            "time_iter_median_s": r.time_iter_median,
            "gflops": r.gflops,
            "roofline_nnz_per_s": sol_nnz_s,
            "device": device,
            "mape": r.metrics.mape,
            "time_compile_s": r.time_compile,
            "time_convert_s": r.time_convert,
            "time_convert_cold_s": r.time_convert_cold,
            "total_runtime_s": time.time() - t_all,
            "speedup_vs_csr_xla": r.nnz_per_s / base.nnz_per_s,
            "candidates": {f"{n}/{i}": c.nnz_per_s
                           for (n, i, c, _) in results},
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
