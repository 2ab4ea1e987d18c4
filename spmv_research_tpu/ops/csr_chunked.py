"""Chunked CSR: an XLA gather SpMV whose every device op is bounded.

The plain ``CSR/xla`` baseline (one gather + one segment-sum over the whole
nnz stream, ``ops/reference.py``) materialises nnz-sized intermediates. The
reference's corpus loop carries a baseline row for every matrix its importer
accepts, up to kmer_V2a at ~118M nnz (``benchmark_code/BENCH/run.sh:137-191``).
Whether the H200 needs this bounded form at all is an open measurement.

This formulation bounds every device op: the nnz stream is split into
uniform ``B``-element blocks (merge-path style nnz balancing — the role of
the reference's nnz-balanced loop partitioner, ``lib/loop_partitioners``),
stacked on a leading chunk axis, and executed as one ``lax.scan``:

  per block:  prod = data*x[cols]  (B-gather)
              part = local segment-sum over row-in-block ids  (≤R segments)
              y[row0 : row0+R] += part   (dynamic-slice add — contiguous,
                                          no scatter)

``R`` = max rows any block spans (host-computed). Rows crossing block
boundaries accumulate across scan steps through the carried y. Program size
is constant in the matrix size; per-op footprint is O(B + R).

Storage IS CSR (values + column indices + row ids); the chunk table adds
O(C) ints. Rows are emitted with format_name "CSR" and impl "xlac" so they
read as the CSR/XLA baseline they are.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.host import HostCSR
from ..core.formats import _register
from .dispatch import register_spmv, register_spmm


@partial(_register,
         data_fields=("data", "cols", "lrow", "row0"),
         meta_fields=("shape", "nnz", "nnz_expanded", "R"))
@dataclasses.dataclass(frozen=True)
class CSRChunked:
    """CSR split into uniform nnz blocks (leading axis = block)."""

    data: jnp.ndarray      # (C, B) values; padding 0
    cols: jnp.ndarray      # (C, B) int32 column ids; padding 0
    lrow: jnp.ndarray      # (C, B) int32 row - row0[c], sorted; padding R
    row0: jnp.ndarray      # (C,) int32 first row of each block
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    R: int                 # max rows spanned by one block

    format_name = "CSR"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mem_footprint_bytes(self) -> int:
        """Reference CSR footprint model (spmv_kernel.h:21-24): the chunk
        table is metadata, the stream is values + indices + row ptr."""
        vb = self.data.dtype.itemsize
        return self.nnz * (vb + 4) + (self.m + 1) * 4


def build_csr_chunked(host: HostCSR, dtype=jnp.float32,
                      block: int = 1 << 21) -> CSRChunked:
    m = host.m
    nnz = host.nnz
    B = min(block, max(1 << 10, nnz))
    C = (nnz + B - 1) // B
    rows = np.repeat(np.arange(m, dtype=np.int32), host.row_lengths())

    row0 = rows[np.arange(C, dtype=np.int64) * B]
    last = rows[np.minimum((np.arange(C, dtype=np.int64) + 1) * B, nnz) - 1]
    R = int((last - row0 + 1).max()) if C else 1
    R = (R + 7) // 8 * 8

    pad = C * B - nnz
    data = np.pad(host.a.astype(np.dtype(dtype)), (0, pad))
    cols = np.pad(host.ja.astype(np.int32), (0, pad))
    lrow = np.pad(rows, (0, pad), constant_values=0)
    lrow = lrow.reshape(C, B) - row0[:, None]
    if pad:  # padding lands in the sliced-off overflow segment R
        lrow[-1, B - pad:] = R
    return CSRChunked(
        data=jnp.asarray(data.reshape(C, B)),
        cols=jnp.asarray(cols.reshape(C, B)),
        lrow=jnp.asarray(lrow.astype(np.int32)),
        row0=jnp.asarray(row0.astype(np.int32)),
        shape=(m, host.n), nnz=nnz, nnz_expanded=host.nnz_expanded, R=R)


@register_spmv("CSR", "xlac")
def spmv_csr_chunked(A: CSRChunked, x: jnp.ndarray) -> jnp.ndarray:
    R = A.R
    xp = jnp.asarray(x, A.data.dtype)

    def body(y, leaves):
        data, cols, lrow, row0 = leaves
        prod = data * xp.at[cols].get(mode="promise_in_bounds")
        part = jax.ops.segment_sum(prod, lrow, num_segments=R + 1,
                                   indices_are_sorted=True)[:R]
        cur = jax.lax.dynamic_slice(y, (row0,), (R,))
        return jax.lax.dynamic_update_slice(y, cur + part, (row0,)), None

    y0 = jnp.zeros(A.m + R, dtype=A.data.dtype)
    y, _ = jax.lax.scan(body, y0, (A.data, A.cols, A.lrow, A.row0))
    return y[: A.m]


@register_spmm("CSR", "xlac")
def spmm_csr_chunked(A: CSRChunked, X: jnp.ndarray) -> jnp.ndarray:
    def body(_, xk):
        return 0, spmv_csr_chunked(A, xk)

    _, ys = jax.lax.scan(body, 0, jnp.transpose(X))
    return jnp.transpose(ys)
