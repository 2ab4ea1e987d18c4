"""Kernel registry and dispatch.

The analog of the reference's plugin contract: the reference binds one
format×kernel per *executable* at link time (``Makefile_in:47-564``); here
every (format, workload) pair maps to a named set of implementations chosen at
call time — ``spmv(A, x)`` picks the default for the current backend,
``spmv(A, x, impl="xla")`` forces one (the harness sweeps over impls the way
``run.sh`` sweeps over executables).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import jax

_SPMV: Dict[Tuple[str, str], Callable] = {}
_SPMM: Dict[Tuple[str, str], Callable] = {}
_SDDMM: Dict[Tuple[str, str], Callable] = {}

# Preference order per supported backend; first registered match wins.
_BACKEND_PREF = {
    "gpu": ("xla",),
    "cpu": ("xla",),
}


def backend() -> str:
    """The JAX backend this process computes on (``"gpu"`` or ``"cpu"``).

    The one place the program asks which device it runs on; any backend
    without a row in ``_BACKEND_PREF`` is an error, never a fallback."""
    b = jax.default_backend()
    if b not in _BACKEND_PREF:
        raise RuntimeError(f"unsupported JAX backend {b!r}; "
                           f"supported: {sorted(_BACKEND_PREF)}")
    return b


def _make_register(table, name):
    def register(fmt: str, impl: str):
        def deco(fn):
            table[(fmt, impl)] = fn
            return fn
        return deco

    register.__name__ = name
    return register


register_spmv = _make_register(_SPMV, "register_spmv")
register_spmm = _make_register(_SPMM, "register_spmm")
register_sddmm = _make_register(_SDDMM, "register_sddmm")


def _lookup(table, fmt: str, impl: Optional[str]):
    if impl is not None:
        key = (fmt, impl)
        if key not in table:
            raise KeyError(
                f"no impl {impl!r} for format {fmt!r}; have "
                f"{sorted(i for f, i in table if f == fmt)}"
            )
        return table[key]
    for cand in _BACKEND_PREF[backend()]:
        if (fmt, cand) in table:
            return table[(fmt, cand)]
    raise KeyError(f"no {backend()} implementation registered for format "
                   f"{fmt!r}; have {sorted(i for f, i in table if f == fmt)}")


def spmv(A, x, impl: Optional[str] = None):
    """y = A @ x."""
    return _lookup(_SPMV, A.format_name, impl)(A, x)


def spmm(A, X, impl: Optional[str] = None):
    """Y = A @ X (dense X of shape (n, k))."""
    return _lookup(_SPMM, A.format_name, impl)(A, X)


def sddmm(S, A, B, impl: Optional[str] = None):
    """Per-nnz values of (A @ Bᵀ) ∘ pattern(S); A: (m,k), B: (n,k)."""
    return _lookup(_SDDMM, S.format_name, impl)(S, A, B)


def available_impls(workload: str, fmt: str):
    table = {"spmv": _SPMV, "spmm": _SPMM, "sddmm": _SDDMM}[workload]
    return sorted(i for f, i in table if f == fmt)
