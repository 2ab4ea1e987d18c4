"""Device-side sparse formats as JAX pytrees.

Each format is a frozen dataclass registered as a pytree: array leaves live on
device; sizes/padding metadata are static (hashable) so jitted kernels
specialize on them.  This is the analog of the reference's
``Matrix_Format`` plugin structs (``benchmark_code/BENCH/src/spmv_kernels/
spmv_kernel.h:8-28``): one class per storage format, each knowing its memory
footprint, built from canonical host CSR by :mod:`spmv_research_tpu.convert.build`.

Formats are padded to tile multiples at build time (XLA requires
static shapes); the true ``nnz``/``m``/``n`` are kept as metadata and all
padding lanes are arranged to contribute zero to results.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp


def _register(cls, data_fields, meta_fields):
    jax.tree_util.register_dataclass(cls, data_fields=list(data_fields),
                                     meta_fields=list(meta_fields))
    return cls


@partial(_register,
         data_fields=("data", "indices", "rows", "indptr"),
         meta_fields=("shape", "nnz", "nnz_expanded"))
@dataclasses.dataclass(frozen=True)
class CSR:
    """Padded CSR (+ explicit per-nnz row ids for segment reductions).

    ``data/indices/rows`` have length ``nnz_pad`` (a tile multiple); padding
    entries have value 0, column 0, row ``m`` (an overflow segment sliced off).
    """

    data: jnp.ndarray      # (nnz_pad,) values
    indices: jnp.ndarray   # (nnz_pad,) int32 column indices
    rows: jnp.ndarray      # (nnz_pad,) int32 row indices (sorted)
    indptr: jnp.ndarray    # (m+1,) int32
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int

    format_name = "CSR"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    @property
    def nnz_pad(self):
        return self.data.shape[0]

    def mem_footprint_bytes(self) -> int:
        """True (unpadded) footprint, reference model ``spmv_kernel.h:21-24``."""
        vb = self.data.dtype.itemsize
        return self.nnz * (vb + 4) + (self.m + 1) * 4


@partial(_register,
         data_fields=("data", "rows", "cols"),
         meta_fields=("shape", "nnz", "nnz_expanded"))
@dataclasses.dataclass(frozen=True)
class COO:
    """Padded COO triplets (row-major sorted). Padding: value 0, row m, col 0."""

    data: jnp.ndarray  # (nnz_pad,)
    rows: jnp.ndarray  # (nnz_pad,) int32
    cols: jnp.ndarray  # (nnz_pad,) int32
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int

    format_name = "COO"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mem_footprint_bytes(self) -> int:
        return self.nnz * (self.data.dtype.itemsize + 8)


@partial(_register,
         data_fields=("data", "cols"),
         meta_fields=("shape", "nnz", "nnz_expanded", "width"))
@dataclasses.dataclass(frozen=True)
class ELL:
    """ELLPACK: rows padded to the max row length (reference ``ell.cpp``).

    Stored row-major ``(m_pad, width)``; padding entries value 0, column 0.
    """

    data: jnp.ndarray  # (m_pad, width)
    cols: jnp.ndarray  # (m_pad, width) int32
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    width: int

    format_name = "ELL"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mem_footprint_bytes(self) -> int:
        m_pad, w = self.data.shape
        return m_pad * w * (self.data.dtype.itemsize + 4)


@partial(_register,
         data_fields=("data", "cols", "perm", "slice_of_col", "lane_rows"),
         meta_fields=("shape", "nnz", "nnz_expanded", "C", "sigma", "n_slices",
                      "total_width"))
@dataclasses.dataclass(frozen=True)
class SellCS:
    """SELL-C-σ in a 2-D "slab" layout.

    Rows are σ-sorted by length (windowed), grouped into slices of C rows, and
    each slice padded to its own max length L_s (reference ``sell.cpp`` /
    ``sell_sorted.cpp``). Instead of a ragged list of slices we store one dense
    slab of shape ``(C, total_width)`` where slice s occupies the column range
    ``[off_s, off_s + L_s)`` — every column of the slab is one "step" of C rows
    processed in lockstep.

    ``slice_of_col[t]`` gives the slice owning slab column t;
    ``lane_rows[s*C + c] = perm_row`` gives the output row of lane c in slice s
    (= m for padding lanes, sliced off after segment reduction).
    """

    data: jnp.ndarray          # (C, total_width)
    cols: jnp.ndarray          # (C, total_width) int32
    perm: jnp.ndarray          # (m,) int32 σ-sort permutation (new ← old)
    slice_of_col: jnp.ndarray  # (total_width,) int32
    lane_rows: jnp.ndarray     # (n_slices * C,) int32 output row per (slice, lane)
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    C: int
    sigma: int
    n_slices: int
    total_width: int

    format_name = "SELL-C-s"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mem_footprint_bytes(self) -> int:
        c, w = self.data.shape
        return c * w * (self.data.dtype.itemsize + 4) + self.m * 4


@partial(_register,
         data_fields=("data", "block_cols", "block_rowptr", "block_rows"),
         meta_fields=("shape", "nnz", "nnz_expanded", "br", "bc", "n_blocks"))
@dataclasses.dataclass(frozen=True)
class BSR:
    """Block-sparse rows: dense (br × bc) blocks (role of the
    reference's MKL-BSR adapters, block sizes 2..64 — ``Makefile_in:363-374``).

    ``data``: (n_blocks_pad, br, bc); ``block_cols``: block-column index;
    ``block_rows``: block-row index per block (sorted); padding blocks are
    all-zero with block_row = mb.
    """

    data: jnp.ndarray          # (n_blocks_pad, br, bc)
    block_cols: jnp.ndarray    # (n_blocks_pad,) int32
    block_rowptr: jnp.ndarray  # (mb+1,) int32
    block_rows: jnp.ndarray    # (n_blocks_pad,) int32
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    br: int
    bc: int
    n_blocks: int

    format_name = "BSR"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mem_footprint_bytes(self) -> int:
        return (self.n_blocks * self.br * self.bc * self.data.dtype.itemsize
                + self.n_blocks * 4
                + (self.block_rowptr.shape[0]) * 4)


@partial(_register,
         data_fields=("data",),
         meta_fields=("shape", "nnz", "nnz_expanded", "offsets"))
@dataclasses.dataclass(frozen=True)
class DIA:
    """Diagonal storage (reference ``dia.cpp``): ``data[d, i] = A[i, i+off_d]``.

    Offsets are static metadata so the SpMV unrolls into shifted axpys.
    """

    data: jnp.ndarray  # (n_diags, m)
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    offsets: Tuple[int, ...]

    format_name = "Custom_DIA"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mem_footprint_bytes(self) -> int:
        return self.data.size * self.data.dtype.itemsize + len(self.offsets) * 4


@partial(_register,
         data_fields=("diag", "lower", "upper", "owner", "neighbour"),
         meta_fields=("shape", "nnz", "nnz_expanded"))
@dataclasses.dataclass(frozen=True)
class LDU:
    """OpenFOAM-style lower/diagonal/upper split storage (reference ``ldu.cpp``):
    one diagonal value per row plus per-face (owner, neighbour) coefficient
    pairs: y[o] += u[f]·x[n]; y[n] += l[f]·x[o]."""

    diag: jnp.ndarray       # (m,)
    lower: jnp.ndarray      # (n_faces_pad,)
    upper: jnp.ndarray      # (n_faces_pad,)
    owner: jnp.ndarray      # (n_faces_pad,) int32
    neighbour: jnp.ndarray  # (n_faces_pad,) int32
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int

    format_name = "LDU"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mem_footprint_bytes(self) -> int:
        vb = self.diag.dtype.itemsize
        return self.m * vb + self.lower.shape[0] * (2 * vb + 8)


@partial(_register,
         data_fields=("data", "rows", "cols"),
         meta_fields=("shape", "nnz", "nnz_expanded"))
@dataclasses.dataclass(frozen=True)
class CSC:
    """Compressed-sparse-column stored as padded column-major triplets
    (role of the reference's MKL_CSC adapter). SpMV scatters per-column
    contributions: the portable impl uses an unsorted segment-sum over rows.
    Padding: value 0, row m, col 0."""

    data: jnp.ndarray  # (nnz_pad,) column-major sorted
    rows: jnp.ndarray  # (nnz_pad,) int32 row indices
    cols: jnp.ndarray  # (nnz_pad,) int32 column indices (sorted)
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int

    format_name = "CSC"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mem_footprint_bytes(self) -> int:
        return self.nnz * (self.data.dtype.itemsize + 4) + (self.n + 1) * 4


@partial(_register,
         data_fields=("data", "rows", "cols"),
         meta_fields=("shape", "nnz", "nnz_expanded"))
@dataclasses.dataclass(frozen=True)
class CSRSym:
    """Symmetric SpMV on lower-triangle storage (reference ``csr_sym.cpp``
    "CSR_SYM_CPU"): y = L·x + strict(L)ᵀ·x computed from the stored triangle
    only — half the value/index traffic of expanded storage.

    Triplets are row-major sorted; padding: value 0, row m, col 0.
    """

    data: jnp.ndarray  # (nnz_pad,) lower-triangle values (incl. diagonal)
    rows: jnp.ndarray  # (nnz_pad,) int32
    cols: jnp.ndarray  # (nnz_pad,) int32
    shape: Tuple[int, int]
    nnz: int           # stored (triangle) nonzeros
    nnz_expanded: int

    format_name = "CSR_SYM"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mem_footprint_bytes(self) -> int:
        return self.nnz * (self.data.dtype.itemsize + 4) + (self.m + 1) * 4
