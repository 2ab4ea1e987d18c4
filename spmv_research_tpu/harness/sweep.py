"""Sweep driver — the run.sh / proc_run.sh analog (SURVEY.md §2.1).

Iterates (matrices × formats × impls × workloads), reproducing run.sh's
output discipline: per-format CSV files with a labels row first
(``run.sh:851-865``), human logs to stdout, idempotent append-per-pair records
so partial sweeps are usable (SURVEY.md §5.4), per-run conversion time
reported (``bench.cpp:600-603``), retry-on-error (``run.sh:672,740-744``).

Matrix sources:
* ``.mtx`` paths (real matrices),
* synthetic parameter lines (the 11-arg ``matrix_generation_parameters``
  format — twins files drive this unchanged).
"""

from __future__ import annotations

import os
import sys
import time
import traceback
from typing import Iterable, Optional, Sequence

import numpy as np
import jax.numpy as jnp

from ..core.host import HostCSR
from ..io import mtx_read
from ..convert import (coo_to_csr, build_csr, build_coo, build_ell,
                       build_sellcs, build_bsr, build_csc, build_csr_sym,
                       rcm_reorder, extract_features, fix_diagonal_zeros)
from ..gen import ArtificialParams, artificial_matrix_generation
from ..ops import available_impls, build_bfly
from ..ops.routing import RoutingError
from .config import BenchConfig
from .bench import (bench_spmv, csv_labels, csv_row_real, csv_row_synthetic,
                    emit)
from .workloads import bench_spmm, bench_sddmm, bench_cg, BenchGateError

FORMAT_BUILDERS = {
    "csr": build_csr,
    "coo": build_coo,
    "csc": build_csc,
    "ell": build_ell,
    "sellcs": build_sellcs,
    "bsr": lambda h, dtype: build_bsr(h, br=8, bc=128, dtype=dtype),
    "csr_sym": build_csr_sym,
    "csr_lut": None,  # set below (import cycle)
    "bfly": lambda h, dtype: __import__(
        "spmv_research_tpu.convert.cache", fromlist=["cached_build"]
    ).cached_build(build_bfly, h, "bfly", dtype=dtype),
}

from ..ops.value_compress import build_csr_lut as _build_csr_lut
FORMAT_BUILDERS["csr_lut"] = _build_csr_lut


def _cached(builder, key):
    from ..convert.cache import cached_build
    return lambda h, dtype: cached_build(builder, h, key, dtype=dtype)


from ..ops.clos import build_clos as _build_clos
from ..ops.clos_gather import build_clos_gather_auto as _build_closg
from ..ops.gatherk import build_sellg as _build_sellg
FORMAT_BUILDERS["clos"] = _cached(_build_clos, "clos")
FORMAT_BUILDERS["closg"] = _cached(_build_closg, "closg")
FORMAT_BUILDERS["sellg"] = lambda h, dtype: _build_sellg(h, dtype=dtype)
from ..ops.bsr_mxu import build_bsrg as _build_bsrg
FORMAT_BUILDERS["bsrg"] = lambda h, dtype: _build_bsrg(h, dtype=dtype)
from ..ops.sellw import build_sellw as _build_sellw
FORMAT_BUILDERS["sellw"] = _cached(_build_sellw, "sellw")
from ..ops.sellr import build_sellr as _build_sellr
FORMAT_BUILDERS["sellr"] = _cached(_build_sellr, "sellr")
from ..ops.btile import build_btile as _build_btile
FORMAT_BUILDERS["btile"] = _cached(_build_btile, "btile")
from ..ops.compensated import build_csrds as _build_csrds
FORMAT_BUILDERS["csrds"] = lambda h, dtype: _build_csrds(h)
from ..ops.sellw_ds import build_sellwds as _build_sellwds
FORMAT_BUILDERS["sellwds"] = _cached(_build_sellwds, "sellwds")
from ..ops.densemv import build_dense as _build_dense
FORMAT_BUILDERS["dense"] = lambda h, dtype: _build_dense(h, dtype=dtype)


def load_matrix(spec: str, cfg: BenchConfig):
    """spec: path to .mtx, or an 11-arg synthetic parameter line."""
    t0 = time.time()
    if spec.endswith(".mtx") or os.path.exists(spec):
        coo = mtx_read(spec, expand_symmetry=True)
        host = coo_to_csr(coo)
        name = os.path.splitext(os.path.basename(spec))[0]
        params = None
    else:
        params = ArtificialParams.from_args(spec.split())
        host, _ = artificial_matrix_generation(params)
        name = params.name or "synthetic"
    if cfg.matrix_transform:
        from ..convert import make_spd, make_diag_dominant
        tf = {"spd": make_spd, "dd": make_diag_dominant}[cfg.matrix_transform]
        host = tf(host)
        name = f"{name}_{cfg.matrix_transform}"   # honest labeling
    if cfg.fix_diagonal_zeros:
        host = fix_diagonal_zeros(host)
    if cfg.use_rcm_reordering == "auto":
        from ..convert.reorder import rcm_if_beneficial
        host, _ = rcm_if_beneficial(host)
    elif cfg.use_rcm_reordering:
        host, _ = rcm_reorder(host)
    t_read = time.time() - t0
    print(f"# read+transform {name}: m={host.m} nnz={host.nnz} "
          f"({t_read:.2f}s)", flush=True)
    return host, name, params


class SweepDoneLog:
    """Idempotent per-pair records (SURVEY §5.4): keys of completed
    (matrix, format, impl, workload) pairs, so a restarted sweep process
    skips finished work."""

    def __init__(self, out_dir):
        self.path = os.path.join(out_dir, "done.log")
        self.done = set()
        if os.path.exists(self.path):
            with open(self.path) as f:
                for ln in f:
                    tag, _, key = ln.strip().partition(" ")
                    if tag in ("DONE", "FAIL"):   # FAIL = gated garbage row:
                        self.done.add(key)        # permanent, don't re-run

    def skip(self, *key) -> bool:
        return "/".join(map(str, key)) in self.done

    def mark(self, tag, *key):
        with open(self.path, "a") as f:
            f.write(f"{tag} {'/'.join(map(str, key))}\n")
        if tag == "DONE":
            self.done.add("/".join(map(str, key)))


def run_sweep(matrices: Sequence[str], formats: Sequence[str] = ("csr", "bfly"),
              workloads: Sequence[str] = ("spmv",),
              impls: Optional[Sequence[str]] = None,
              out_dir: str = "out_logs",
              config: Optional[BenchConfig] = None,
              max_retries: int = 2) -> list:
    cfg = config or BenchConfig.from_env()
    os.makedirs(out_dir, exist_ok=True)
    dtype = jnp.dtype(cfg.dtype)
    results = []
    label_written = set()
    donelog = SweepDoneLog(out_dir)

    for spec in matrices:
        try:
            host, name, params = load_matrix(spec, cfg)
        except Exception as e:
            print(f"# SKIP {spec}: {e}", flush=True)
            continue
        feats = extract_features(host) if params is not None else None

        # format/impl-independent workloads run once per matrix
        for workload in [w for w in workloads
                         if w in ("spgemm", "trisolve")]:
            csv_path = os.path.join(out_dir, f"{workload}.csv")
            if donelog.skip(name, workload):
                continue
            try:
                r = _run_one(host, None, workload, None, cfg, name, 0.0)
                _gate_result(r, workload)
            except BenchGateError as e:
                donelog.mark("FAIL", name, workload)
                print(f"# GATE-FAIL {name}/{workload}: {e}", flush=True)
                continue
            except Exception as e:
                print(f"# {workload} failed on {name}: "
                      f"{type(e).__name__}: {e}", flush=True)
                continue
            results.append(r)
            with open(csv_path, "a") as f:
                if csv_path not in label_written and f.tell() == 0:
                    f.write(_labels_for(workload, params is not None) + "\n")
                label_written.add(csv_path)
                f.write(_row_for(r, workload, params, feats) + "\n")
            donelog.mark("DONE", name, workload)
            print(f"# {name} {workload}: {_summary(r)}", flush=True)
        workloads_fmt = [w for w in workloads
                         if w not in ("spgemm", "trisolve")]

        for fmt in formats:
            builder = FORMAT_BUILDERS[fmt]
            t0 = time.time()
            try:
                A = builder(host, dtype=dtype)
            except Exception as e:   # a builder bug must not kill the sweep
                print(f"# {fmt} build failed on {name}: "
                      f"{type(e).__name__}: {e}", flush=True)
                continue
            t_convert = time.time() - t0
            print(f"# convert {name} -> {fmt}: {t_convert:.2f}s", flush=True)

            for workload in workloads_fmt:
                table = workload if workload in ("spmv", "spmm", "sddmm") else "spmv"
                try:
                    have = available_impls(table, A.format_name)
                except KeyError:
                    continue
                fmt_impls = [i for i in (impls or have) if i in have]
                if not fmt_impls:
                    continue
                for impl in fmt_impls:
                    csv_path = os.path.join(out_dir, f"{fmt}_{workload}.csv")
                    if donelog.skip(name, fmt, impl, workload):
                        continue
                    for attempt in range(max_retries):
                        try:
                            r = _run_one(host, A, workload, impl, cfg, name,
                                         t_convert)
                            _gate_result(r, workload)
                            break
                        except BenchGateError as e:
                            donelog.mark("FAIL", name, fmt, impl, workload)
                            print(f"# GATE-FAIL {name}/{fmt}/{impl}/"
                                  f"{workload}: {e}", flush=True)
                            r = None
                            break
                        except Exception as e:
                            print(f"# retry {fmt}/{impl}/{workload}: "
                                  f"{type(e).__name__}: {e}", flush=True)
                            if attempt == max_retries - 1:
                                traceback.print_exc()
                                r = None
                    if r is None:
                        continue
                    results.append(r)
                    with open(csv_path, "a") as f:
                        if csv_path not in label_written and f.tell() == 0:
                            f.write(_labels_for(workload, params is not None)
                                    + "\n")
                        label_written.add(csv_path)
                        f.write(_row_for(r, workload, params, feats) + "\n")
                    donelog.mark("DONE", name, fmt, impl, workload)
                    print(f"# {name} {fmt}/{impl} {workload}: "
                          f"{_summary(r)}", flush=True)
            del A   # release the format's device buffers before the next
    return results


def _gate_result(r, workload):
    """NaN metrics or a non-progressing solve must be a loud FAILURE, not a
    committed CSV row."""
    mape = getattr(r, "mape", None)
    if mape is None and hasattr(r, "metrics"):
        mape = r.metrics.mape
    max_ae = getattr(r, "max_ae", None)
    if max_ae is None and hasattr(r, "metrics"):
        max_ae = r.metrics.max_ae
    for v, tag in ((mape, "mape"), (max_ae, "max_ae")):
        if v is not None and not np.isfinite(v):
            raise BenchGateError(f"{workload}: non-finite {tag} ({v})")
    if workload in ("cg", "bicgstab") and mape is not None and mape >= 0.9:
        raise BenchGateError(
            f"{workload}: residual {mape:.3g} — no convergence progress")


def _run_one(host, A, workload, impl, cfg, name, t_convert):
    if workload == "spmv":
        return bench_spmv(host, A, config=cfg, impl=impl, matrix_name=name,
                          time_convert=t_convert)
    if workload == "spmm":
        return bench_spmm(host, A, config=cfg, impl=impl, matrix_name=name)
    if workload == "sddmm":
        return bench_sddmm(host, A, config=cfg, impl=impl, matrix_name=name)
    if workload == "spgemm":
        from .workloads import bench_spgemm
        return bench_spgemm(host, config=cfg, matrix_name=name)
    if workload == "trisolve":
        from .workloads import bench_trisolve
        return bench_trisolve(host, config=cfg, matrix_name=name)
    if workload == "cg":
        return bench_cg(host, A, config=cfg, impl=impl, matrix_name=name,
                        precond=cfg.solver_precond)
    if workload == "bicgstab":
        return bench_cg(host, A, config=cfg, impl=impl, matrix_name=name,
                        bicgstab=True, precond=cfg.solver_precond)
    raise ValueError(f"unknown workload {workload}")


def _labels_for(workload, synthetic):
    if workload == "spmv":
        return csv_labels(synthetic=synthetic)
    return ("matrix_name,format_name,impl,K,time_iter_median,gflops,"
            "num_loops,mape,max_ae")


def _row_for(r, workload, params, feats):
    if workload == "spmv":
        if params is not None:
            return csv_row_synthetic(r, params, feats)
        return csv_row_real(r)
    return (f"{r.matrix_name},{r.format_name},{r.impl},{r.k},"
            f"{r.time_iter_median:.9f},{r.gflops:.4f},{r.num_loops},"
            f"{r.mape:.6g},{r.max_ae:.6g}")


def _summary(r):
    if hasattr(r, "nnz_per_s"):
        return (f"{r.nnz_per_s/1e9:.3f} Gnnz/s median="
                f"{r.time_iter_median*1e6:.0f}us mape={r.metrics.mape:.2e}")
    return (f"{r.gflops:.2f} GFLOPS median={r.time_iter_median*1e6:.0f}us "
            f"mape={r.mape:.2e}")
