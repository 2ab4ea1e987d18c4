"""Long-row splitting: nnz-balanced row *sub*-division at build time.

The reference handles extreme row-length skew by splitting rows mid-row
across threads with a per-thread tail fixup ("perfect nnz balance",
``benchmark_code/BENCH/src/spmv_kernels/csr.cpp:96-108,655-710``) and by
work stealing (``DIV/div.cpp:991-1060``). Here the analog is a *build-time*
transform: rows longer than a threshold are cut into sub-rows of ≤ T nnz,
the engine runs on the split matrix (whose bounded row length keeps the
segmented scan at ≤ log2 T stages and lets a row span CLOSG chunks), and a
combine pass sums each heavy row's sub-row partials.

Layout: rows ``0..m-1`` of the split matrix are the original rows (heavy
rows keep their first ≤ T nnz in place); the extra sub-rows are appended at
``m..``, grouped contiguously per heavy row in row order and **padded with
empty sub-rows to a multiple of 128 per heavy row** (plus one final all-
empty 128-block as a gather target). Empty sub-rows contribute exact zeros,
so the combine is a *row-granular* gather of whole 128-partial blocks,
followed by a tree reduction. No global prefix sum
is involved: partials of different rows never mix, so fp32 accumulation
error stays O(eps·log) per row (a global fp32 cumsum over all extras
loses digits to cancellation on dense-row matrices such as the Chebyshev4
twin).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Tuple

import numpy as np
import jax.numpy as jnp

from ..core.host import HostCSR, INDEX_DTYPE
from . import dispatch
from .dispatch import register_spmv
from .clos import _register

DEFAULT_T = 256
_PB = 128     # extras padded per heavy row to a multiple of this


def split_long_rows(csr: HostCSR, T: int = DEFAULT_T,
                    threshold: int | None = None):
    """Cut every row longer than ``threshold`` (default: T) into sub-rows
    of ≤ T nnz.

    Returns ``(csr2, heavy_rows, seg_ptr)`` — or ``(csr, None, None)`` when
    no row exceeds the threshold. ``csr2`` has ``m + E + 128`` rows: the
    originals first (heavy rows truncated to their first T nnz), then per
    heavy row its extra sub-rows padded with empty rows to a multiple of
    128, then one all-empty 128-row block (combine gather target).
    ``seg_ptr[i]:seg_ptr[i+1]`` is heavy row i's (padded) extra range.
    """
    lengths = csr.row_lengths().astype(np.int64)
    heavy = np.flatnonzero(lengths > (T if threshold is None else threshold))
    if heavy.size == 0:
        return csr, None, None
    ia = csr.ia.astype(np.int64)
    m = csr.m
    l2 = lengths.copy()                              # new first-part lengths
    l2[heavy] = T                                    # only split rows truncate
    extra_parts = (lengths[heavy] - 1) // T          # live extras, ≥ 1 each
    padded = ((extra_parts + _PB - 1) // _PB) * _PB
    seg_ptr = np.zeros(heavy.size + 1, np.int64)
    np.cumsum(padded, out=seg_ptr[1:])
    E = int(seg_ptr[-1])

    # per-extra-sub-row (start, len) in the ORIGINAL nnz space; padding
    # sub-rows get length 0
    slot_of = np.repeat(np.arange(heavy.size), padded)
    rank = np.arange(E) - seg_ptr[slot_of]           # 0-based extra index
    live = rank < extra_parts[slot_of]
    ex_start = np.where(live, ia[heavy][slot_of] + (rank + 1) * T, 0)
    ex_len = np.where(
        live, np.minimum(lengths[heavy][slot_of] - (rank + 1) * T, T), 0)

    ia2 = np.zeros(m + E + _PB + 1, np.int64)
    ia2[1:m + 1] = np.cumsum(l2)
    ia2[m + 1:m + E + 1] = ia2[m] + np.cumsum(ex_len)
    ia2[m + E + 1:] = ia2[m + E]                     # trailing empty block

    # gather map: new nnz order -> old nnz order
    total = int(ia2[-1])
    starts_new = ia2[:-1]
    starts_old = np.concatenate(
        [ia[:-1], ex_start, np.zeros(_PB, np.int64)])
    lens_all = np.concatenate([l2, ex_len, np.zeros(_PB, np.int64)])
    nz = lens_all > 0
    row_of = np.repeat(np.arange(m + E + _PB)[nz], lens_all[nz])
    pos = np.arange(total) - starts_new[row_of]
    gmap = starts_old[row_of] + pos

    csr2 = HostCSR(a=csr.a[gmap], ia=ia2.astype(INDEX_DTYPE),
                   ja=csr.ja[gmap], m=m + E + _PB, n=csr.n,
                   nnz_expanded=csr.nnz_expanded)
    return csr2, heavy.astype(np.int64), seg_ptr


@partial(_register, data_fields=("inner", "heavy_rows", "gidx"),
         meta_fields=("shape", "nnz", "nnz_expanded", "n_extra"))
@dataclasses.dataclass(frozen=True)
class RowSplit:
    """Wrapper format: ``inner`` computes the split matrix's y; the combine
    row-gathers each heavy row's padded 128-partial blocks and tree-sums."""

    inner: Any               # child format pytree (m + n_extra + 128 rows)
    heavy_rows: jnp.ndarray  # (H,) int32 original row of each heavy row
    gidx: jnp.ndarray        # (H, kmax) int32 128-block ids into the extras
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    n_extra: int             # padded extra sub-rows (excl. the zero block)

    format_name = "RSPLIT"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mem_footprint_bytes(self) -> int:
        return (self.inner.mem_footprint_bytes()
                + self.heavy_rows.size * 4 + self.gidx.size * 4)

    @property
    def inner_format(self) -> str:
        return self.inner.format_name


def wrap_row_split(inner, csr_shape, nnz, nnz_expanded, heavy_rows,
                   seg_ptr) -> RowSplit:
    """Assemble the wrapper. ``seg_ptr`` entries are multiples of 128; the
    per-row gather rows point into extras2d = y[m:].reshape(-1,128), short
    rows padded with the final all-zero block."""
    H = heavy_rows.size
    E = int(seg_ptr[-1])
    blocks = (seg_ptr[1:] - seg_ptr[:-1]) // _PB
    kmax = max(int(blocks.max()), 1)
    zero_block = E // _PB                            # the trailing empty block
    gidx = np.full((H, kmax), zero_block, np.int64)
    for i in range(H):
        b0 = seg_ptr[i] // _PB
        gidx[i, : blocks[i]] = np.arange(b0, b0 + blocks[i])
    return RowSplit(inner=inner,
                    heavy_rows=jnp.asarray(heavy_rows, jnp.int32),
                    gidx=jnp.asarray(gidx, jnp.int32),
                    shape=csr_shape, nnz=nnz, nnz_expanded=nnz_expanded,
                    n_extra=E)


def _combine(A: RowSplit, y2: jnp.ndarray) -> jnp.ndarray:
    m = A.shape[0]
    ex2 = y2[m:].reshape(-1, _PB)                    # (E/128 + 1, 128)
    seg = ex2.at[A.gidx].get(mode="promise_in_bounds").sum(axis=(1, 2))
    return y2[:m].at[A.heavy_rows].add(seg)


def _spmv_rowsplit(A: RowSplit, x: jnp.ndarray, impl: str) -> jnp.ndarray:
    return _combine(A, dispatch.spmv(A.inner, x, impl=impl))


@register_spmv("RSPLIT", "xla")
def spmv_rowsplit_xla(A: RowSplit, x: jnp.ndarray) -> jnp.ndarray:
    return _spmv_rowsplit(A, x, "xla")


def _spmm_rowsplit(A: RowSplit, X: jnp.ndarray, impl: str) -> jnp.ndarray:
    """Column scan like clos_gather._spmm_scan (one compiled SpMV body)."""
    import jax

    def body(_, xk):
        return 0, _spmv_rowsplit(A, xk, impl)

    _, ys = jax.lax.scan(body, 0, jnp.transpose(X))
    return jnp.transpose(ys)


@dispatch.register_spmm("RSPLIT", "xla")
def spmm_rowsplit_xla(A: RowSplit, X: jnp.ndarray) -> jnp.ndarray:
    return _spmm_rowsplit(A, X, "xla")


def execute_rowsplit_numpy(A: RowSplit, y2: np.ndarray) -> np.ndarray:
    """float64 host reference of the combine (program semantics)."""
    m = A.shape[0]
    ex2 = np.asarray(y2)[m:].reshape(-1, _PB)
    seg = ex2[np.asarray(A.gidx)].sum(axis=(1, 2))
    y = np.asarray(y2)[:m].copy()
    np.add.at(y, np.asarray(A.heavy_rows), seg)
    return y
