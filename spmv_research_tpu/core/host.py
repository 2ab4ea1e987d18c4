"""Canonical host-side sparse containers.

The reference keeps one canonical in-memory form — CSR with float64 values and
int32 indices (``benchmark_code/BENCH/src/bench_common.h:33-53``) — through which
every import (MatrixMarket, OpenFOAM, synthetic) and every format conversion is
routed.  We keep the same contract on the host side, as plain numpy arrays:
all readers/generators produce :class:`HostCOO` or :class:`HostCSR`; all device
formats are built *from* :class:`HostCSR`.

Host-side preprocessing (parsing, sorting, conversion) is numpy/C++; only the
final padded/tiled arrays are shipped to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

INDEX_DTYPE = np.int32
VALUE_DTYPE_REF = np.float64  # reference precision for golden checks


@dataclasses.dataclass
class HostCOO:
    """Coordinate-format triplets on host (analog of the reference's mtx triplet
    buffers produced by ``mtx_read`` — ``lib/storage_formats/matrix_market/matrix_market.c:258``)."""

    rows: np.ndarray  # (nnz,) int32
    cols: np.ndarray  # (nnz,) int32
    vals: np.ndarray  # (nnz,) float64
    m: int
    n: int
    symmetric: bool = False  # True if structurally symmetric *storage* (lower kept)

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def validate(self) -> None:
        assert self.rows.shape == self.cols.shape == self.vals.shape
        if self.nnz:
            assert self.rows.min() >= 0 and self.rows.max() < self.m
            assert self.cols.min() >= 0 and self.cols.max() < self.n


@dataclasses.dataclass
class HostCSR:
    """Canonical compressed-sparse-row matrix on host.

    Mirrors the reference's ``struct CSR_reference_s`` (``bench_common.h:33-53``):
    float64 values `a`, int32 `ia` (row pointer, len m+1), int32 `ja` (column
    indices), plus symmetry bookkeeping used by the GFLOPS accounting
    (``bench_spmv.cpp:404`` uses nnz *expanded* for symmetric inputs).
    """

    a: np.ndarray  # (nnz,) values, float64 canonical (float32 allowed)
    ia: np.ndarray  # (m+1,) int32 row pointer
    ja: np.ndarray  # (nnz,) int32 column indices
    m: int
    n: int
    # nnz of the symmetric-expanded matrix (== nnz when not stored symmetric)
    nnz_expanded: Optional[int] = None
    symmetric_storage: bool = False  # lower-triangle-only storage

    def __post_init__(self):
        if self.nnz_expanded is None:
            self.nnz_expanded = self.nnz

    @property
    def nnz(self) -> int:
        return int(self.ja.shape[0])

    @property
    def shape(self):
        return (self.m, self.n)

    def row_lengths(self) -> np.ndarray:
        return (self.ia[1:] - self.ia[:-1]).astype(np.int64)

    def mem_footprint_bytes(self, value_bytes: int = 8, index_bytes: int = 4) -> int:
        """CSR memory footprint — the reference's baseline for `mem_ratio`
        (``spmv_kernel.h:21-24``): nnz*(val+idx) + (m+1)*idx."""
        return self.nnz * (value_bytes + index_bytes) + (self.m + 1) * index_bytes

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix((self.a, self.ja, self.ia), shape=(self.m, self.n))

    @staticmethod
    def from_scipy(mat) -> "HostCSR":
        mat = mat.tocsr()
        mat.sort_indices()
        return HostCSR(
            a=np.asarray(mat.data, dtype=VALUE_DTYPE_REF),
            ia=np.asarray(mat.indptr, dtype=INDEX_DTYPE),
            ja=np.asarray(mat.indices, dtype=INDEX_DTYPE),
            m=int(mat.shape[0]),
            n=int(mat.shape[1]),
        )

    def spmv_gold(self, x: np.ndarray, dtype=np.longdouble) -> np.ndarray:
        """Extended-precision golden SpMV — the analog of the reference's
        ``_Float128`` Kahan-compensated gold (``bench_spmv.cpp:150-171``).

        numpy longdouble is 80-bit extended on x86 / 128-bit on some platforms;
        combined with Kahan compensation this exceeds the fp64 gate's needs.
        """
        a = self.a.astype(dtype)
        xx = x.astype(dtype)
        y = np.zeros(self.m, dtype=dtype)
        c = np.zeros(self.m, dtype=dtype)  # Kahan compensation per row
        ia, ja = self.ia, self.ja
        for i in range(self.m):
            s = dtype(0)
            comp = dtype(0)
            for j in range(ia[i], ia[i + 1]):
                t = a[j] * xx[ja[j]]
                yy = t - comp
                tmp = s + yy
                comp = (tmp - s) - yy
                s = tmp
            y[i] = s
            c[i] = comp
        return y

    def spmv_gold_fast(self, x: np.ndarray) -> np.ndarray:
        """Vectorized longdouble gold (no Kahan) — used for large matrices where
        the per-element python loop is too slow; longdouble headroom over the
        fp32/fp64 gates makes compensation unnecessary in practice."""
        prod = self.a.astype(np.longdouble) * x.astype(np.longdouble)[self.ja]
        # segment sum over rows via reduceat (ia may have empty rows)
        y = np.zeros(self.m, dtype=np.longdouble)
        np.add.at(y, np.repeat(np.arange(self.m), self.row_lengths()), prod)
        return y
