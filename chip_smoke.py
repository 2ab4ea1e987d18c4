#!/usr/bin/env python
"""Smoke run of the SpMV main path on NVIDIA GPUs, in one process.

Usage:
  python chip_smoke.py              # one card: phases 1-4
  python chip_smoke.py --cards 4    # four cards: the distributed path only

One card:
  1. bench.py's own path on the scircuit twin (171k rows, ~0.96M nnz, about
     10 MB of CSR, so it stays in the 50 MB L2): RCM if it narrows the band,
     CSR plus every engine ``build_best`` builds, ``bench_spmv`` for each.
  2. An HBM-resident SpMV: the ldoor twin (952,203 rows, ~46M nnz, ~0.55 GB
     of fp32 CSR on the device) through ``build_csr`` -> ``spmv(impl="xla")``
     -> ``bench_spmv`` against the longdouble gold.
  3. The other workloads on the scircuit twin, each against a host fp64
     reference: SpMM and SDDMM through CSR/xla at K=64, Jacobi-CG on the SPD
     analog to its tolerance, and the double-single CSRDS fp64 SpMV. Then
     BTILE's SpMM and SDDMM at K=64 beside CSR/xla's on the cant twin (a
     FEM matrix dense enough to fill (8,128) tiles; scircuit is not).
  4. The engines' XLA lowerings on a column-locality twin (mac_econ_fwd500)
     beside CSR/xla, with the engine/CSR time ratio.

Four cards: row-sharded CSR SpMV (allgather, ring, psum_scatter) and
distributed Jacobi-CG on the cage15 twin (5.15M rows, ~99M nnz), each
compared with the one-card CSR result and with scipy; then
``__graft_entry__.dryrun_multichip(4)`` on the real cards.

Every phase prints one line: sizes, error next to the gate it is held to
(with the precision), compile time and steady-state time. A phase that fails
ends the run with a non-zero exit and no ``ok`` line; so does a JAX that
finds no GPU. The last line of a passing run is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TWINS = os.path.join(REPO, "datasets", "validation_twins.txt")

# Gates and why (fp32 results are judged on aggregates — see
# harness.metrics.FP32_MAPE_GATE; fp64 results on the reference's strict
# per-element gate).
FP64_GATE = 1e-10        # max rel err, fp64 (double-single) kernels
CG_RTOL = 1e-6           # the reference's fp32 CG tolerance (bench_cg.cpp)
CG_TRUE_RES_GATE = 1e-5  # true fp64 residual of the fp32 iterate: the
                         # implicit residual drifts from the true one by
                         # fp32 rounding of x (~1e-7 relative) times the
                         # small condition number of the diagonally
                         # dominant SPD analog
DIST_GATE = 1e-5         # normwise rel err vs fp64 scipy and vs one card:
                         # fp32 sums in a different order on each path


class PhaseFailure(RuntimeError):
    pass


def log(msg):
    print(msg, flush=True)


def twin_line(name: str) -> str:
    """The generator line of a validation twin, by its name."""
    with open(TWINS) as f:
        for ln in f:
            parts = ln.split()
            if parts and not ln.startswith("#") and parts[-1] == name:
                return ln.strip()
    raise KeyError(f"no twin {name!r} in {TWINS}")


def rel_errors(ref, got):
    """(max elementwise rel err over |ref| > 1e-30, normwise inf rel err)."""
    ref = np.asarray(ref, np.float64).reshape(-1)
    got = np.asarray(got, np.float64).reshape(-1)
    if ref.shape != got.shape:
        raise PhaseFailure(f"shape {got.shape} != reference {ref.shape}")
    if not np.all(np.isfinite(got)):
        raise PhaseFailure("non-finite values in the result")
    diff = np.abs(got - ref)
    sig = np.abs(ref) > 1e-30
    max_rel = float((diff[sig] / np.abs(ref[sig])).max()) if sig.any() else 0.0
    norm_rel = float(diff.max() / max(np.abs(ref).max(), 1e-300))
    return max_rel, norm_rel


def gate(phase: str, value: float, limit: float, what: str):
    if not value <= limit:          # also catches nan
        raise PhaseFailure(f"{phase}: {what} {value:.3e} > gate {limit:g}")


def first_call_s(fn, *args):
    """Seconds of the first call (trace, compile, one run)."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0


def timed(fn, *args, reps: int = 5):
    """(first-call seconds incl. compile, median steady seconds, output);
    host clock around block_until_ready."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    t_first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return t_first, float(np.median(ts)), out


def report(phase, **kv):
    log(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()))


def spmv_line(phase, name, fmt, r):
    """One line for a bench_spmv result (differential device timing)."""
    from spmv_research_tpu.harness.metrics import FP32_MAPE_GATE
    report(phase, matrix=name, m=r.m, nnz=r.nnz, format=f"{fmt}/{r.impl}",
           precision="fp32", mape=f"{r.metrics.mape:.3e}",
           mape_gate=FP32_MAPE_GATE,
           max_rel_err=f"{r.metrics.max_rel_err:.3e}",
           compile_s=f"{r.time_compile:.3f}",
           median_us=f"{r.time_iter_median * 1e6:.6g}",
           gnnz_s=f"{r.nnz_per_s / 1e9:.6g}",
           roofline_frac=f"{r.roofline_frac:.4f}")


# --------------------------------------------------------------- one card

def phase_bench_path(cfg, line=None, name="scircuit_twin", phase="1"):
    from bench import SCIRCUIT_LINE, bench_candidates
    host, results = bench_candidates(line or SCIRCUIT_LINE, name, cfg)
    for fmt, _, r, _ in results:
        spmv_line(phase, name, fmt, r)
    return host, results


def phase_hbm(cfg, line, name):
    import jax.numpy as jnp
    from spmv_research_tpu.gen import generate_from_line
    from spmv_research_tpu.convert import build_csr
    from spmv_research_tpu.harness import bench_spmv
    from spmv_research_tpu.harness.metrics import FP32_MAPE_GATE

    host, _ = generate_from_line(line)
    A = build_csr(host, dtype=jnp.float32)
    dev_bytes = sum(a.size * a.dtype.itemsize
                    for a in (A.data, A.indices, A.rows, A.indptr))
    r = bench_spmv(host, A, config=cfg, impl="xla", matrix_name=name)
    spmv_line("2", name, "CSR", r)
    report("2", device_bytes=dev_bytes, gold="longdouble (no Kahan)")
    gate("2", r.metrics.mape, FP32_MAPE_GATE, "mape")
    return r


def workload_line(cfg, host, A, workload, name, K):
    """SpMM or SDDMM of format A at width K through its XLA lowering:
    differential-chain time and mape against the harness's fp64 host
    reference (``harness.workloads``)."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from spmv_research_tpu.harness.metrics import FP32_MAPE_GATE
    from spmv_research_tpu.harness.workloads import bench_sddmm, bench_spmm
    from spmv_research_tpu.ops import sddmm, spmm

    Xn = jnp.ones((host.n, K), jnp.float32)
    if workload == "spmm":
        t_c = first_call_s(jax.jit(lambda A_, X_: spmm(A_, X_, impl="xla")),
                           A, Xn)
        run = bench_spmm
    else:
        Xm = jnp.ones((host.m, K), jnp.float32)
        t_c = first_call_s(jax.jit(
            lambda A_, a, b: sddmm(A_, a, b, impl="xla")), A, Xm, Xn)
        run = bench_sddmm
    r = run(host, A, config=dataclasses.replace(cfg, k_dim=K), impl="xla",
            matrix_name=name)
    report("3", workload=workload, matrix=name, format=f"{A.format_name}/xla",
           m=host.m, nnz=host.nnz, K=K, precision="fp32",
           mape=f"{r.mape:.3e}", mape_gate=FP32_MAPE_GATE,
           max_abs_err=f"{r.max_ae:.3e}", compile_s=f"{t_c:.3f}",
           median_us=f"{r.time_iter_median * 1e6:.6g}",
           gflops=f"{r.gflops:.6g}")
    gate(f"3 {workload} {A.format_name}", r.mape, FP32_MAPE_GATE, "mape")
    return r


def phase_tiles(cfg, line, name, K=64):
    """BTILE's tile-matmul SpMM/SDDMM beside CSR/xla's on one matrix."""
    import jax.numpy as jnp
    from spmv_research_tpu.convert import build_csr
    from spmv_research_tpu.gen import generate_from_line
    from spmv_research_tpu.ops import build_btile

    host, _ = generate_from_line(line)
    A = build_csr(host, dtype=jnp.float32)
    B = build_btile(host)
    for workload in ("spmm", "sddmm"):
        rc = workload_line(cfg, host, A, workload, name, K)
        rb = workload_line(cfg, host, B, workload, name, K)
        report("3", workload=workload, matrix=name, engine="BTILE/xla",
               ratio_engine_over_csr=f"{rb.time_iter_median / rc.time_iter_median:.4g}",
               ntiles=B.ntiles, slots_per_nnz=f"{B.ntiles * 1024 / host.nnz:.3g}")


def phase_workloads(cfg, host, K=64):
    import jax
    import jax.numpy as jnp
    from spmv_research_tpu.convert import build_csr, make_spd
    from spmv_research_tpu.harness import bench_spmv
    from spmv_research_tpu.ops import build_csrds
    from spmv_research_tpu.solvers import cg
    from spmv_research_tpu.solvers.cg import _jacobi_inv_diag

    rng = np.random.default_rng(11)
    A = build_csr(host, dtype=jnp.float32)
    workload_line(cfg, host, A, "spmm", "scircuit_twin", K)
    workload_line(cfg, host, A, "sddmm", "scircuit_twin", K)

    spd = make_spd(host)
    Aspd = build_csr(spd, dtype=jnp.float32)
    b = rng.uniform(0, 1, spd.m)
    inv_diag = _jacobi_inv_diag(spd, jnp.float32)
    f = jax.jit(lambda A_, b_, d_: cg(A_, b_, inv_diag=d_, max_iters=1000,
                                      rtol=CG_RTOL, impl="xla"))
    t_c, t_s, (x, info) = timed(f, Aspd, jnp.asarray(b, jnp.float32),
                                inv_diag, reps=3)
    xh = np.asarray(x, np.float64)
    true_res = float(np.linalg.norm(spd.to_scipy() @ xh - b)
                     / np.linalg.norm(b))
    iters = int(info["iterations"])
    report("3", workload="cg_jacobi", m=spd.m, nnz=spd.nnz,
           precision="fp32", iterations=iters,
           converged=bool(info["converged"]), rtol=CG_RTOL,
           true_rel_residual=f"{true_res:.3e}", gate=CG_TRUE_RES_GATE,
           compile_s=f"{t_c:.3f}", solve_ms=f"{t_s * 1e3:.6g}")
    if not bool(info["converged"]):
        raise PhaseFailure(f"3 cg: no convergence in {iters} iterations")
    gate("3 cg", true_res, CG_TRUE_RES_GATE, "true relative residual")

    r = bench_spmv(host, build_csrds(host), impl="xla",
                   matrix_name="scircuit_twin")
    report("3", workload="spmv_f64_csrds", m=host.m, nnz=host.nnz,
           precision="fp64 (double-single)",
           max_rel_err=f"{r.metrics.max_rel_err:.3e}", gate=FP64_GATE,
           compile_s=f"{r.time_compile:.3f}",
           median_us=f"{r.time_iter_median * 1e6:.6g}")
    gate("3 csrds", r.metrics.max_rel_err, FP64_GATE, "max rel err")


def engine_table(phase, name, results):
    """Engine XLA lowering vs CSR/xla on the same matrix."""
    csr = next(r for fmt, _, r, _ in results if fmt == "CSR")
    for fmt, _, r, _ in results:
        if fmt == "CSR":
            continue
        report(phase, matrix=name, engine=f"{fmt}/xla",
               engine_median_us=f"{r.time_iter_median * 1e6:.6g}",
               csr_xla_median_us=f"{csr.time_iter_median * 1e6:.6g}",
               ratio_engine_over_csr=f"{r.time_iter_median / csr.time_iter_median:.4g}",
               engine_max_rel_err=f"{r.metrics.max_rel_err:.3e}",
               engine_mape=f"{r.metrics.mape:.3e}")


def run_one_card(bench_line=None, hbm_line=None, locality_line=None,
                 tile_line=None, cfg=None):
    """Phases 1-4; the lines default to the real twins (smaller ones let
    the same code be rehearsed on the CPU)."""
    from spmv_research_tpu.harness import BenchConfig

    cfg = cfg or BenchConfig(min_num_loops=64, min_time_s=1.0)
    t0 = time.time()
    host, results = phase_bench_path(cfg, bench_line)
    engine_table("4", "scircuit_twin", results)
    log(f"# phase 1 done ({time.time() - t0:.1f}s)")

    t0 = time.time()
    phase_hbm(cfg, hbm_line or twin_line("ldoor"), "ldoor_twin")
    log(f"# phase 2 done ({time.time() - t0:.1f}s)")

    t0 = time.time()
    phase_workloads(cfg, host)
    phase_tiles(cfg, tile_line or twin_line("cant"), "cant_twin")
    log(f"# phase 3 done ({time.time() - t0:.1f}s)")

    t0 = time.time()
    _, loc = phase_bench_path(cfg,
                              locality_line or twin_line("mac_econ_fwd500"),
                              "mac_econ_fwd500_twin", phase="4")
    engine_table("4", "mac_econ_fwd500_twin", loc)
    if not any(fmt == "SELLW" for fmt, _, _, _ in loc):
        raise PhaseFailure("4: SELLW did not build on the locality twin")
    log(f"# phase 4 done ({time.time() - t0:.1f}s)")


# ------------------------------------------------------------- four cards

def run_four_cards(n_cards: int, line=None):
    import dataclasses
    import jax
    import jax.numpy as jnp
    from spmv_research_tpu.convert import build_csr, make_spd
    from spmv_research_tpu.gen import generate_from_line
    from spmv_research_tpu.ops import spmv
    from spmv_research_tpu.parallel import make_sparse_mesh
    from spmv_research_tpu.parallel.dist import (
        build_col_sharded_csr, build_sharded_csr, distributed_spmv,
        distributed_spmv_psum_scatter)
    from spmv_research_tpu.solvers import cg
    from spmv_research_tpu.solvers.cg import _jacobi_inv_diag

    if len(jax.devices()) < n_cards:
        raise PhaseFailure(f"need {n_cards} GPUs, JAX sees "
                           f"{len(jax.devices())}")
    t0 = time.time()
    host, _ = generate_from_line(line or twin_line("cage15"))
    log(f"# cage15 twin m={host.m} nnz={host.nnz} ({time.time() - t0:.1f}s)")
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, host.n)
    S = host.to_scipy()
    y_sp = S @ x

    A1 = build_csr(host, dtype=jnp.float32)
    f1 = jax.jit(lambda A_, v: spmv(A_, v, impl="xla"))
    t_c, t_s, y1 = timed(f1, A1, jnp.asarray(x, jnp.float32))
    y1 = np.asarray(y1, np.float64)
    _, e_sp = rel_errors(y_sp, y1)
    report("4c", path="one_card_csr", m=host.m, nnz=host.nnz,
           precision="fp32", err_vs_scipy=f"{e_sp:.3e}", gate=DIST_GATE,
           compile_s=f"{t_c:.3f}", median_us=f"{t_s * 1e6:.6g}")
    gate("4c one card", e_sp, DIST_GATE, "normwise rel err vs scipy")
    del A1

    mesh = make_sparse_mesh(n_cards)
    t0 = time.time()
    Ar = build_sharded_csr(host, mesh)
    Ac = build_col_sharded_csr(host, mesh)
    log(f"# sharded builds ({time.time() - t0:.1f}s)")
    arr_fields = ("data", "cols", "rows", "data_blk", "cols_blk", "rows_blk")

    def row_fn(strategy):
        # the sharded arrays are jit ARGUMENTS (closed-over arrays would be
        # baked into the program as constants)
        def f(arrs, v):
            return distributed_spmv(dataclasses.replace(Ar, **arrs), v,
                                    strategy)
        return jax.jit(f)

    arrs = {k: getattr(Ar, k) for k in arr_fields
            if getattr(Ar, k) is not None}
    xp = Ar.pad_vector(x)
    for strategy in ("allgather", "ring"):
        t_c, t_s, y = timed(row_fn(strategy), arrs, xp)
        y = Ar.unpad_vector(y).astype(np.float64)
        _, e_sp = rel_errors(y_sp, y)
        _, e_1 = rel_errors(y1, y)
        report("4c", path=f"rows_{strategy}", cards=n_cards, m=host.m,
               nnz=host.nnz, precision="fp32", err_vs_scipy=f"{e_sp:.3e}",
               err_vs_one_card=f"{e_1:.3e}", gate=DIST_GATE,
               compile_s=f"{t_c:.3f}", median_us=f"{t_s * 1e6:.6g}")
        gate(f"4c {strategy}", max(e_sp, e_1), DIST_GATE, "normwise rel err")

    cols_arrs = {k: getattr(Ac, k) for k in ("data", "cols", "rows")}
    fps = jax.jit(lambda a, v: distributed_spmv_psum_scatter(
        dataclasses.replace(Ac, **a), v))
    t_c, t_s, y = timed(fps, cols_arrs, Ac.pad_x(x))
    y = Ac.unpad_y(y).astype(np.float64)
    _, e_sp = rel_errors(y_sp, y)
    _, e_1 = rel_errors(y1, y)
    report("4c", path="cols_psum_scatter", cards=n_cards, m=host.m,
           nnz=host.nnz, precision="fp32", err_vs_scipy=f"{e_sp:.3e}",
           err_vs_one_card=f"{e_1:.3e}", gate=DIST_GATE,
           compile_s=f"{t_c:.3f}", median_us=f"{t_s * 1e6:.6g}")
    gate("4c psum_scatter", max(e_sp, e_1), DIST_GATE, "normwise rel err")
    del Ar, Ac, arrs, cols_arrs

    # distributed Jacobi-CG on the SPD analog, vs one card and scipy
    t0 = time.time()
    spd = make_spd(host)
    log(f"# SPD analog nnz={spd.nnz} ({time.time() - t0:.1f}s)")
    b = rng.uniform(0, 1, spd.m)
    inv_diag = np.asarray(_jacobi_inv_diag(spd, jnp.float32), np.float64)
    As = build_csr(spd, dtype=jnp.float32)
    f1 = jax.jit(lambda A_, b_, d_: cg(A_, b_, inv_diag=d_, max_iters=1000,
                                       rtol=CG_RTOL, impl="xla"))
    t_c1, t_s1, (x1, info1) = timed(f1, As, jnp.asarray(b, jnp.float32),
                                    jnp.asarray(inv_diag, jnp.float32),
                                    reps=3)
    x1 = np.asarray(x1, np.float64)
    del As
    Ad = build_sharded_csr(spd, mesh)
    darrs = {k: getattr(Ad, k) for k in ("data", "cols", "rows")}

    def dist_cg(a, b_, d_):
        A_ = dataclasses.replace(Ad, **a)
        return cg(None, b_, inv_diag=d_, max_iters=1000, rtol=CG_RTOL,
                  spmv_fn=lambda v: distributed_spmv(A_, v, "allgather"))

    t_c, t_s, (xd, info) = timed(jax.jit(dist_cg), darrs,
                                 Ad.pad_vector(b), Ad.pad_vector(inv_diag),
                                 reps=3)
    xd = Ad.unpad_vector(xd).astype(np.float64)
    Sp = spd.to_scipy()
    res_d = float(np.linalg.norm(Sp @ xd - b) / np.linalg.norm(b))
    res_1 = float(np.linalg.norm(Sp @ x1 - b) / np.linalg.norm(b))
    _, e_1 = rel_errors(x1, xd)
    report("4c", path="cg_jacobi_allgather", cards=n_cards, m=spd.m,
           nnz=spd.nnz, precision="fp32", iterations=int(info["iterations"]),
           one_card_iterations=int(info1["iterations"]),
           true_rel_residual=f"{res_d:.3e}",
           one_card_true_rel_residual=f"{res_1:.3e}",
           x_err_vs_one_card=f"{e_1:.3e}", residual_gate=CG_TRUE_RES_GATE,
           compile_s=f"{t_c:.3f}", solve_ms=f"{t_s * 1e3:.6g}",
           one_card_solve_ms=f"{t_s1 * 1e3:.6g}")
    if not (bool(info["converged"]) and bool(info1["converged"])):
        raise PhaseFailure("4c cg: no convergence")
    gate("4c cg", max(res_d, res_1), CG_TRUE_RES_GATE,
         "true relative residual")
    gate("4c cg", e_1, DIST_GATE * 10, "solution diff vs one card")

    t0 = time.time()
    sys.path.insert(0, REPO)
    import __graft_entry__
    __graft_entry__.dryrun_multichip(n_cards)
    report("4c", path="dryrun_multichip", cards=n_cards, status="ok",
           seconds=f"{time.time() - t0:.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="1: the one-card phases; 4: the distributed path")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    from spmv_research_tpu.utils.runtime import (device_record,
                                                 enable_compile_cache,
                                                 nvidia_smi)
    log(nvidia_smi())
    enable_compile_cache()
    dev = device_record()
    log(f"# device: {dev}")
    if dev["platform"] != "gpu":
        log(f"# FAIL: JAX found no GPU (platform {dev['platform']!r})")
        return 2

    t0 = time.time()
    try:
        if args.cards == 4:
            run_four_cards(4)
        else:
            run_one_card()
    except PhaseFailure as e:
        log(f"# FAIL: {e}")
        return 1
    log(f"# all phases passed ({time.time() - t0:.1f}s)")
    log(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
