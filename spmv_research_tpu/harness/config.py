"""Typed benchmark configuration.

Single-tier replacement for the reference's three-tier flag system
(compile-time -D macros + env vars + config.sh assoc array — SURVEY.md §5.6).
Every knob that is meaningful here keeps its reference name; env-var
overrides are honored for drop-in compatibility with reference run scripts.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


def _env(name, cast, default):
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return cast(v)
    except ValueError:
        return default


@dataclasses.dataclass
class BenchConfig:
    # --- timing protocol (reference bench_spmv.cpp:335-384,634-648) ---
    min_num_loops: int = 64
    min_time_s: float = 2.0
    warmup_iters: int = 20          # role of the GPU 1000-iter warmup (:287-294)
    inner_iters: Optional[int] = None  # spmv calls fused per timed step (auto)

    # --- numerics ---
    dtype: str = "float32"          # ValueType (f64 gold is always host-side)

    # --- matrix transforms (bench.cpp:588-598) ---
    # False | True | "auto" (rcm_if_beneficial: keep the reorder only when
    # mean row bandwidth drops — RCM scrambles generator-banded matrices,
    # DESIGN_NOTES "RCM policy"; the reference's flag is opt-in for the
    # same reason)
    use_rcm_reordering: object = False
    fix_diagonal_zeros: bool = False
    matrix_transform: Optional[str] = None  # spd | dd (solver-dataset analogs)

    # --- workloads ---
    k_dim: int = 128                # SDDMM/SpMM K (K_DIM env, config.sh:138-143)
    cg_max_num_iters: int = 50      # CG_MAX_NUM_ITERS (config.sh:110-112)
    solver_precond: str = "jacobi"  # jacobi | ic0 | ilu0

    # --- output ---
    print_statistics: bool = False
    csv_to_stderr: bool = True

    # --- distribution ---
    mesh_shape: Tuple[int, ...] = (1,)
    halo_strategy: str = "allgather"  # allgather | ring | psum_scatter

    @staticmethod
    def from_env() -> "BenchConfig":
        """Honor the reference's env-var names where meaningful here."""
        c = BenchConfig()
        rcm = os.environ.get("USE_RCM_REORDERING", "")
        c.use_rcm_reordering = ("auto" if rcm == "auto"
                                else bool(_env("USE_RCM_REORDERING", int, 0)))
        c.fix_diagonal_zeros = bool(_env("FIX_DIAGONAL_ZEROS", int, 0))
        c.k_dim = _env("K_DIM", int, c.k_dim)
        c.cg_max_num_iters = _env("CG_MAX_NUM_ITERS", int, c.cg_max_num_iters)
        c.min_num_loops = _env("MIN_NUM_LOOPS", int, c.min_num_loops)
        c.min_time_s = _env("MIN_TIME_S", float, c.min_time_s)
        c.print_statistics = bool(_env("PRINT_STATISTICS", int, 0))
        return c
