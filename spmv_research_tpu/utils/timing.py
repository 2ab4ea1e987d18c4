"""Device timing under asynchronous dispatch, measured *differentially*:

    t_iter = (T(K_hi iterations) − T(K_lo iterations)) / (K_hi − K_lo)

where each T is wall time of a jitted chain of K dependent applications ending
in a scalar reduction that is transferred to host. The constant costs
(dispatch, launch, the device-to-host copy, the reduction) cancel in the
difference; the per-iteration loop overhead inside the chain does not.

This replaces the reference's simple ``time_it`` loop (``lib/time_it.h``),
whose synchronous-kernel assumption does not hold under async dispatch.
Taking kernel time from profiler device events instead is ROADMAP A.3.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp


def _sync(x) -> float:
    """Force completion; returns the scalar (host float)."""
    return float(np.asarray(x))


def make_chain_dyn(fn: Callable):
    """Jitted chain of k dependent applications of fn(x, *rest) -> array,
    ending in a scalar sum (the sync anchor). fn's output is folded back into
    x with a full-array dependency so no iteration can be dead-coded.

    ``k`` is a *dynamic* (traced) argument: one compile serves every chain
    length — the lo chain, the hi chain, and adaptive re-lengthening all hit
    the same executable (separate lo/hi compiles of a multi-kernel pipeline
    would multiply compile time)."""

    @jax.jit
    def chained(k, x, *rest):
        def body(_, v):
            r = fn(v, *rest)
            r = r.astype(v.dtype)
            if r.shape == v.shape:
                return v + r * 1e-30
            pad = jnp.resize(r.reshape(-1), v.shape)
            return v + pad * 1e-30
        x = jax.lax.fori_loop(0, k, body, x, unroll=False)
        return jnp.sum(x[:8])

    return chained


def make_chain(fn: Callable, k: int):
    """Fixed-k wrapper over :func:`make_chain_dyn` (compat shim; prefer the
    dynamic form so lo/hi share one compile)."""
    chained = make_chain_dyn(fn)

    def run(x, *rest):
        return chained(k, x, *rest)

    return run


def measure_op(fn: Callable, *args, k_lo: int = 4, k_hi: int = 36,
               reps: int = 5, warmup: int = 2) -> float:
    """Median differential per-iteration time of fn(*args) in seconds."""
    return float(np.median(measure_op_samples(
        fn, *args, k_lo=k_lo, k_hi=k_hi, reps=reps, warmup=warmup)))


def measure_op_samples(fn: Callable, *args, k_lo: int = 4, k_hi: int = 36,
                       reps: int = 9, warmup: int = 2) -> np.ndarray:
    """All differential samples (for min/median/max protocol columns).

    One dynamic-k chain serves both lengths (single compile)."""
    chain = make_chain_dyn(fn)
    for _ in range(warmup):
        _sync(chain(k_lo, *args))
        _sync(chain(k_hi, *args))
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(chain(k_lo, *args))
        t_lo = time.perf_counter() - t0
        t0 = time.perf_counter()
        _sync(chain(k_hi, *args))
        t_hi = time.perf_counter() - t0
        out.append((t_hi - t_lo) / (k_hi - k_lo))
    return np.array(out)
