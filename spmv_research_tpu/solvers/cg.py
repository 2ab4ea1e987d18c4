"""Iterative solvers: Jacobi-preconditioned CG and BiCGStab.

Reimplements the reference's solver benchmarks on top of the format-dispatched
SpMV:

* CG — ``benchmark_code/BENCH/src/bench_cg.cpp:93`` ``preconditioned_cg``:
  Jacobi preconditioner K = diag(A) (``:116-135``), convergence
  ‖r‖ < rtol·‖b‖ with rtol = 1e-15 fp64 / 1e-6 fp32 (``:163-174``), periodic
  explicit-residual recomputation every ``check_every`` iterations with
  best-iterate tracking and divergence restart when the implicit and explicit
  residuals disagree by ×1e3 (``:191-238``).
* BiCGStab — ``bench_bicg.cpp:150`` ``preconditioned_bicgstab``: same shell,
  two SpMV per iteration.

All loops are ``lax.while_loop`` (compiled once; no host round-trips per
iteration) and work on any registered format, single-chip or via the
distributed SpMV wrappers.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import spmv as spmv_dispatch


@dataclasses.dataclass
class SolveResult:
    x: jnp.ndarray
    iterations: int
    residual: float        # final implicit residual norm
    explicit_residual: float
    converged: bool


def _jacobi_inv_diag(host_csr, dtype):
    """K⁻¹ = 1/diag(A) (reference ``bench_cg.cpp:116-135``); zero diagonals
    fall back to 1 (the harness normally runs fix_diagonal_zeros first)."""
    diag = np.zeros(host_csr.m)
    rows = np.repeat(np.arange(host_csr.m), host_csr.row_lengths())
    on_diag = rows == host_csr.ja
    diag[rows[on_diag]] = host_csr.a[on_diag]
    diag[diag == 0.0] = 1.0
    return jnp.asarray(1.0 / diag, dtype=dtype)


def cg(A, b: jnp.ndarray, *, inv_diag: Optional[jnp.ndarray] = None,
       max_iters: int = 50, rtol: float = 1e-6,
       x0: Optional[jnp.ndarray] = None,
       spmv_fn: Optional[Callable] = None, impl: Optional[str] = None,
       check_every: int = 100, divergence_factor: float = 1e3,
       precond_fn: Optional[Callable] = None):
    """Preconditioned CG. ``precond_fn(r) = M⁻¹ r`` (must be SPD); defaults
    to Jacobi via ``inv_diag``. Returns (x, info dict of device scalars)."""
    mv = spmv_fn or (lambda v: spmv_dispatch(A, v, impl=impl))
    if precond_fn is None and inv_diag is None:
        raise ValueError("provide inv_diag (Jacobi) or precond_fn "
                         "(identity: precond_fn=lambda r: r)")
    mz = precond_fn or (lambda r_: inv_diag * r_)
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else x0
    b_norm2 = jnp.vdot(b, b)
    tol2 = (rtol * rtol) * b_norm2

    # ensure the explicit-residual check fires at least once per solve even
    # for short runs (the reference's 100-iteration cadence with the default
    # 50-iteration cap would otherwise never execute it)
    check_every = max(min(check_every, max_iters), 1)

    r = b - mv(x)
    z = mz(r)
    p = z
    rho = jnp.vdot(r, z)
    rr = jnp.vdot(r, r)

    def cond(state):
        i, x, r, p, rho, rr, x_best, rr_best = state
        return (i < max_iters) & (rr > tol2)

    def body(state):
        i, x, r, p, rho, rr, x_best, rr_best = state
        Ap = mv(p)
        denom = jnp.vdot(p, Ap)
        alpha = rho / jnp.where(denom == 0, 1e-30, denom)
        x = x + alpha * p
        r_impl = r - alpha * Ap

        # periodic explicit residual + divergence restart (bench_cg.cpp:191-238)
        def with_check(r_impl, x):
            r_exp = b - mv(x)
            rr_exp = jnp.vdot(r_exp, r_exp)
            rr_imp = jnp.vdot(r_impl, r_impl)
            diverged = rr_exp > divergence_factor * jnp.maximum(rr_imp, 1e-300)
            r_new = jnp.where(diverged, r_exp, r_impl)
            return r_new, rr_exp
        do_check = (i % check_every) == (check_every - 1)
        r_new, rr_exp = jax.lax.cond(
            do_check, with_check, lambda r_, x_: (r_, jnp.vdot(r_, r_)),
            r_impl, x)

        z = mz(r_new)
        rho_new = jnp.vdot(r_new, z)
        beta = rho_new / jnp.where(rho == 0, 1e-30, rho)
        p = z + beta * p
        rr_new = jnp.vdot(r_new, r_new)
        better = rr_new < rr_best
        x_best = jnp.where(better, x, x_best)
        rr_best = jnp.where(better, rr_new, rr_best)
        return (i + 1, x, r_new, p, rho_new, rr_new, x_best, rr_best)

    init = (jnp.int32(0), x, r, p, rho, rr, x, rr)
    i, x, r, p, rho, rr, x_best, rr_best = jax.lax.while_loop(cond, body, init)
    return x_best, {"iterations": i, "rr": rr_best, "tol2": tol2,
                    "converged": rr_best <= tol2}


def bicgstab(A, b: jnp.ndarray, *, inv_diag: Optional[jnp.ndarray] = None,
             max_iters: int = 50, rtol: float = 1e-6,
             x0: Optional[jnp.ndarray] = None,
             spmv_fn: Optional[Callable] = None,
             impl: Optional[str] = None,
             precond_fn: Optional[Callable] = None):
    """Preconditioned BiCGStab (reference ``bench_bicg.cpp:150``);
    ``precond_fn(r) = M⁻¹ r`` defaults to Jacobi via ``inv_diag``."""
    mv = spmv_fn or (lambda v: spmv_dispatch(A, v, impl=impl))
    if precond_fn is None and inv_diag is None:
        raise ValueError("provide inv_diag (Jacobi) or precond_fn "
                         "(identity: precond_fn=lambda r: r)")
    mz = precond_fn or (lambda r_: inv_diag * r_)
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else x0
    tol2 = (rtol * rtol) * jnp.vdot(b, b)

    r = b - mv(x)
    r_hat = r
    rho = alpha = omega = jnp.asarray(1.0, b.dtype)
    v = p = jnp.zeros_like(b)

    def cond(state):
        i, x, r, rho, alpha, omega, v, p, x_best, rr_best = state
        return (i < max_iters) & (jnp.vdot(r, r) > tol2)

    def body(state):
        i, x, r, rho, alpha, omega, v, p, x_best, rr_best = state
        rho_new = jnp.vdot(r_hat, r)
        beta = (rho_new / jnp.where(rho == 0, 1e-30, rho)) * (
            alpha / jnp.where(omega == 0, 1e-30, omega))
        p = r + beta * (p - omega * v)
        p_hat = mz(p)
        v = mv(p_hat)
        denom = jnp.vdot(r_hat, v)
        alpha = rho_new / jnp.where(denom == 0, 1e-30, denom)
        s = r - alpha * v
        s_hat = mz(s)
        t = mv(s_hat)
        tt = jnp.vdot(t, t)
        omega = jnp.vdot(t, s) / jnp.where(tt == 0, 1e-30, tt)
        x = x + alpha * p_hat + omega * s_hat
        r = s - omega * t
        rr = jnp.vdot(r, r)
        better = rr < rr_best
        x_best = jnp.where(better, x, x_best)
        rr_best = jnp.where(better, rr, rr_best)
        return (i + 1, x, r, rho_new, alpha, omega, v, p, x_best, rr_best)

    init = (jnp.int32(0), x, r, rho, alpha, omega, v, p, x, jnp.vdot(r, r))
    out = jax.lax.while_loop(cond, body, init)
    i, x, r = out[0], out[1], out[2]
    x_best, rr_best = out[8], out[9]
    return x_best, {"iterations": i, "rr": rr_best, "tol2": tol2,
                    "converged": rr_best <= tol2}


def solve_cg(host_csr, A, b, dtype=jnp.float32, **kw):
    """Convenience wrapper building the Jacobi preconditioner from host CSR."""
    inv_diag = _jacobi_inv_diag(host_csr, dtype)
    return cg(A, jnp.asarray(b, dtype=dtype), inv_diag=inv_diag, **kw)


def solve_bicgstab(host_csr, A, b, dtype=jnp.float32, **kw):
    inv_diag = _jacobi_inv_diag(host_csr, dtype)
    return bicgstab(A, jnp.asarray(b, dtype=dtype), inv_diag=inv_diag, **kw)


def _ic0_precond(host_csr, dtype):
    """M⁻¹ = (L·Lᵀ)⁻¹ from IC(0): two level-scheduled trisolves per apply.

    No reference analog (bench_cg.cpp is Jacobi-only); BASELINE config #4
    adds IC0/trisolve as components, and this wires them into the solver.
    """
    from .ilu import ic0, build_level_schedule, sptrsv
    from ..core.host import HostCSR
    L = ic0(host_csr)
    Lt = HostCSR.from_scipy(L.to_scipy().T.tocsr())
    Ls = build_level_schedule(L, lower=True, dtype=dtype)
    Us = build_level_schedule(Lt, lower=False, dtype=dtype)
    return lambda r: sptrsv(Us, sptrsv(Ls, r))


def _ilu0_precond(host_csr, dtype):
    """M⁻¹ = (L·U)⁻¹ from ILU(0) (for BiCGStab on nonsymmetric systems)."""
    from .ilu import ilu0, build_level_schedule, sptrsv
    L, U = ilu0(host_csr)
    Ls = build_level_schedule(L, lower=True, dtype=dtype)
    Us = build_level_schedule(U, lower=False, dtype=dtype)
    return lambda r: sptrsv(Us, sptrsv(Ls, r))


def make_precond_state(host_csr, precond: str, dtype=jnp.float32):
    """Like :func:`make_precond` but returns ``(apply_fn, state)`` with the
    preconditioner's arrays in a pytree ``state``, so a benchmark can jit
    ``lambda A, b, state: cg(A, b, precond_fn=lambda r: apply_fn(state, r))``
    with the arrays as ARGUMENTS — closed-over arrays become program
    constants and re-trace on every call, which a timer would then count as
    "solve time"."""
    if precond == "jacobi":
        inv_diag = _jacobi_inv_diag(host_csr, dtype)
        return (lambda st, r: st * r), inv_diag
    from .ilu import ilu0, ic0, build_schedule, sptrsv
    from ..core.host import HostCSR
    if precond == "ic0":
        L = ic0(host_csr)
        Lt = HostCSR.from_scipy(L.to_scipy().T.tocsr())
        state = (build_schedule(L, lower=True, dtype=dtype),
                 build_schedule(Lt, lower=False, dtype=dtype))
        return (lambda st, r: sptrsv(st[1], sptrsv(st[0], r))), state
    if precond == "ilu0":
        L, U = ilu0(host_csr)
        state = (build_schedule(L, lower=True, dtype=dtype),
                 build_schedule(U, lower=False, dtype=dtype))
        return (lambda st, r: sptrsv(st[1], sptrsv(st[0], r))), state
    raise ValueError(f"unknown preconditioner {precond!r}")


def make_precond(host_csr, precond: str, dtype=jnp.float32):
    """Build the preconditioner apply-fn ONCE (host-side factorization +
    level schedules are one-time setup — benchmarks must exclude them from
    the timed solve and report setup separately)."""
    if precond == "jacobi":
        inv_diag = _jacobi_inv_diag(host_csr, dtype)
        return lambda r: inv_diag * r
    if precond == "ic0":
        return _ic0_precond(host_csr, dtype)
    if precond == "ilu0":
        return _ilu0_precond(host_csr, dtype)
    raise ValueError(f"unknown preconditioner {precond!r}")


def solve_cg_ic0(host_csr, A, b, dtype=jnp.float32, precond_fn=None, **kw):
    """IC(0)-preconditioned CG (SPD systems): M = L·Lᵀ on A's lower
    pattern, applied as two level-scheduled trisolves per iteration.
    Pass a prebuilt ``precond_fn`` (from :func:`make_precond`) to exclude
    the one-time factorization from timed regions."""
    return cg(A, jnp.asarray(b, dtype=dtype),
              precond_fn=precond_fn or _ic0_precond(host_csr, dtype), **kw)


def solve_bicgstab_ilu0(host_csr, A, b, dtype=jnp.float32, precond_fn=None,
                        **kw):
    """ILU(0)-preconditioned BiCGStab (general square systems)."""
    return bicgstab(A, jnp.asarray(b, dtype=dtype),
                    precond_fn=precond_fn or _ilu0_precond(host_csr, dtype),
                    **kw)
