"""XLA-native sparse ops — the portable baseline implementations.

These run on every backend (CPU tests, GPU benchmarks) and serve the role the
reference's "Naive_CSR_CPU" kernel plays (``spmv_kernels/csr.cpp:334-350``):
the always-correct implementation every optimized kernel is validated against.
CSR/xla is also the plain version every engine is timed against on the card.

fp32 contractions run at ``Precision.HIGHEST``: the GPU's default for an
fp32 matrix product is TF32, which keeps about three decimal digits.

All ops are pure functions over the format pytrees of
:mod:`spmv_research_tpu.core.formats` and are jit/vmap/grad-compatible.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import formats as F
from .dispatch import register_spmv, register_spmm, register_sddmm


# ------------------------------------------------------------------ CSR / COO

@register_spmv("CSR", "xla")
def spmv_csr(A: F.CSR, x: jnp.ndarray) -> jnp.ndarray:
    """y = A @ x via gather + segment-sum (padding rows land in segment m)."""
    prod = A.data * jnp.take(x, A.indices, indices_are_sorted=False)
    y = jax.ops.segment_sum(
        prod, A.rows, num_segments=A.m + 1, indices_are_sorted=True
    )
    return y[: A.m]


@register_spmv("COO", "xla")
def spmv_coo(A: F.COO, x: jnp.ndarray) -> jnp.ndarray:
    prod = A.data * jnp.take(x, A.cols)
    y = jax.ops.segment_sum(
        prod, A.rows, num_segments=A.m + 1, indices_are_sorted=True
    )
    return y[: A.m]


@register_spmm("CSR", "xla")
def spmm_csr(A: F.CSR, X: jnp.ndarray) -> jnp.ndarray:
    """Y = A @ X for dense X of shape (n, k)."""
    prod = A.data[:, None] * jnp.take(X, A.indices, axis=0)
    Y = jax.ops.segment_sum(
        prod, A.rows, num_segments=A.m + 1, indices_are_sorted=True
    )
    return Y[: A.m]


@register_sddmm("CSR", "xla")
def sddmm_csr(S: F.CSR, A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """C[j] = dot(A[row_j, :], B[col_j, :]) over the sparsity pattern of S
    (reference ``sddmm_kernels/csr.cpp:109-135``: C = (A·Bᵀ) ∘ S).

    A: (m, k) dense; B: (n, k) dense; returns per-nnz values (nnz_pad,).
    """
    a_rows = jnp.take(A, jnp.minimum(S.rows, S.m - 1), axis=0)
    b_cols = jnp.take(B, S.indices, axis=0)
    vals = jnp.sum(a_rows * b_cols, axis=-1)
    # zero padding lanes (rows == m)
    return jnp.where(S.rows < S.m, vals, 0.0)


@register_sddmm("COO", "xla")
def sddmm_coo(S: F.COO, A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    a_rows = jnp.take(A, jnp.minimum(S.rows, S.m - 1), axis=0)
    b_cols = jnp.take(B, S.cols, axis=0)
    vals = jnp.sum(a_rows * b_cols, axis=-1)
    return jnp.where(S.rows < S.m, vals, 0.0)


# ------------------------------------------------------------------ ELL / SELL

@register_spmv("ELL", "xla")
def spmv_ell(A: F.ELL, x: jnp.ndarray) -> jnp.ndarray:
    y = jnp.sum(A.data * jnp.take(x, A.cols), axis=1)
    return y[: A.m]


@register_spmm("ELL", "xla")
def spmm_ell(A: F.ELL, X: jnp.ndarray) -> jnp.ndarray:
    # (m_pad, w, k) contraction over w
    gathered = jnp.take(X, A.cols, axis=0)  # (m_pad, w, k)
    Y = jnp.einsum("mw,mwk->mk", A.data, gathered,
                   precision=jax.lax.Precision.HIGHEST)
    return Y[: A.m]


@register_spmv("SELL-C-s", "xla")
def spmv_sellcs(A: F.SellCS, x: jnp.ndarray) -> jnp.ndarray:
    """Slab SpMV: elementwise multiply (C, W) slab against gathered x, then
    segment-sum slab columns by slice id and scatter lanes to output rows."""
    contrib = A.data * jnp.take(x, A.cols)  # (C, W)
    per_slice = jax.ops.segment_sum(
        contrib.T, A.slice_of_col, num_segments=A.n_slices, indices_are_sorted=True
    )  # (n_slices, C)
    lane_vals = per_slice.reshape(-1)  # ordered (slice, lane)
    y = jnp.zeros(A.m + 1, dtype=lane_vals.dtype).at[A.lane_rows].add(lane_vals)
    return y[: A.m]


# ------------------------------------------------------------------ BSR / DIA / LDU

@register_spmv("BSR", "xla")
def spmv_bsr(A: F.BSR, x: jnp.ndarray) -> jnp.ndarray:
    """Per-block dense matvec + block-row segment sum."""
    n_pad = A.block_cols.shape[0]
    xpad = jnp.pad(x, (0, A.bc * ((A.n + A.bc - 1) // A.bc) - A.n))
    xblocks = xpad.reshape(-1, A.bc)
    xg = jnp.take(xblocks, A.block_cols, axis=0)  # (nb, bc)
    # (nb, br, bc) @ (nb, bc) -> (nb, br)
    yb = jnp.einsum("nrc,nc->nr", A.data, xg,
                    precision=jax.lax.Precision.HIGHEST)
    mb = (A.m + A.br - 1) // A.br
    Y = jax.ops.segment_sum(
        yb, A.block_rows, num_segments=mb + 1, indices_are_sorted=True
    )
    return Y[:mb].reshape(-1)[: A.m]


@register_spmm("BSR", "xla")
def spmm_bsr(A: F.BSR, X: jnp.ndarray) -> jnp.ndarray:
    k = X.shape[1]
    xpad = jnp.pad(X, ((0, A.bc * ((A.n + A.bc - 1) // A.bc) - A.n), (0, 0)))
    xblocks = xpad.reshape(-1, A.bc, k)
    xg = jnp.take(xblocks, A.block_cols, axis=0)  # (nb, bc, k)
    yb = jnp.einsum("nrc,nck->nrk", A.data, xg,
                    precision=jax.lax.Precision.HIGHEST)
    mb = (A.m + A.br - 1) // A.br
    Y = jax.ops.segment_sum(
        yb, A.block_rows, num_segments=mb + 1, indices_are_sorted=True
    )
    return Y[:mb].reshape(mb * A.br, k)[: A.m]


@register_spmv("Custom_DIA", "xla")
def spmv_dia(A: F.DIA, x: jnp.ndarray) -> jnp.ndarray:
    """Unrolled shifted axpys — fully gather-free, ideal for banded matrices."""
    m = A.m
    y = jnp.zeros(m, dtype=A.data.dtype)
    for d, off in enumerate(A.offsets):
        # y[i] += data[d, i] * x[i + off] for valid i
        lo = max(0, -off)
        hi = min(m, A.n - off)
        if hi <= lo:
            continue
        y = y.at[lo:hi].add(A.data[d, lo:hi] * jax.lax.dynamic_slice(
            x, (lo + off,), (hi - lo,)))
    return y


@register_spmv("LDU", "xla")
def spmv_ldu(A: F.LDU, x: jnp.ndarray) -> jnp.ndarray:
    y = A.diag * x[: A.m]
    y = y.at[A.owner].add(A.upper * jnp.take(x, A.neighbour))
    y = y.at[A.neighbour].add(A.lower * jnp.take(x, A.owner))
    return y


@register_spmv("CSC", "xla")
def spmv_csc(A: F.CSC, x: jnp.ndarray) -> jnp.ndarray:
    """Column-major SpMV: per-column broadcast of x then row scatter
    (unsorted segment-sum; the scatter role of the reference CSC adapters)."""
    prod = A.data * jnp.take(x, A.cols)
    y = jax.ops.segment_sum(prod, A.rows, num_segments=A.m + 1)
    return y[: A.m]


@register_spmm("SELL-C-s", "xla")
def spmm_sellcs(A: F.SellCS, X: jnp.ndarray) -> jnp.ndarray:
    """Slab SpMM: gather X rows per slab column, contract per slice."""
    k = X.shape[1]
    gathered = jnp.take(X, A.cols, axis=0)           # (C, W, k)
    contrib = A.data[..., None] * gathered           # (C, W, k)
    per_slice = jax.ops.segment_sum(
        jnp.swapaxes(contrib, 0, 1), A.slice_of_col,
        num_segments=A.n_slices, indices_are_sorted=True)   # (n_slices, C, k)
    lane_vals = per_slice.reshape(-1, k)
    Y = jnp.zeros((A.m + 1, k), dtype=lane_vals.dtype).at[A.lane_rows].add(lane_vals)
    return Y[: A.m]


@register_spmm("COO", "xla")
def spmm_coo(A: F.COO, X: jnp.ndarray) -> jnp.ndarray:
    prod = A.data[:, None] * jnp.take(X, A.cols, axis=0)
    Y = jax.ops.segment_sum(prod, A.rows, num_segments=A.m + 1,
                            indices_are_sorted=True)
    return Y[: A.m]


@register_spmv("CSR_SYM", "xla")
def spmv_csr_sym(A: F.CSRSym, x: jnp.ndarray) -> jnp.ndarray:
    """Symmetric SpMV from the stored lower triangle (reference
    ``csr_sym.cpp``): y += a·x[col] per stored entry, plus the transposed
    contribution y[col] += a·x[row] for strict off-diagonals."""
    xv = jnp.take(x, A.cols)
    prod = A.data * xv
    y = jax.ops.segment_sum(prod, A.rows, num_segments=A.m + 1,
                            indices_are_sorted=True)[: A.m]
    off = A.rows != A.cols
    x_rows = jnp.take(jnp.pad(x, (0, 1)), A.rows)
    prod_t = jnp.where(off, A.data * x_rows, 0.0)
    y_t = jax.ops.segment_sum(prod_t, A.cols, num_segments=A.m)
    return y + y_t


@register_spmv("CSR", "bcoo")
def spmv_csr_bcoo(A: F.CSR, x: jnp.ndarray) -> jnp.ndarray:
    """Adapter to jax.experimental.sparse BCOO — the "vendor library
    baseline" role of the reference's MKL/cuSPARSE adapters
    (``mkl_csr.cpp``, ``cusparse_csr.cu``): an external sparse implementation
    benchmarked through the same plugin interface."""
    from jax.experimental import sparse as jsparse

    indices = jnp.stack([A.rows, A.indices], axis=1)
    mat = jsparse.BCOO((A.data, indices), shape=(A.m + 1, A.n),
                       indices_sorted=True, unique_indices=True)
    return (mat @ x)[: A.m]
