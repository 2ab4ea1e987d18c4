"""Builders: canonical host CSR → padded device formats.

The analog of the reference's per-format ``csr_to_format()`` factories
(``spmv_kernel.h:28``; e.g. ``csr.cpp:221``, ``sell_sorted.cpp``). All builders
copy out of the canonical arrays (the reference *reallocates* the canonical CSR
after conversion to prove formats made private copies — ``bench.cpp:605-629``;
here jnp.asarray always copies host numpy to device).

Conversion is host-side numpy; returned structs hold device arrays.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.host import HostCSR, INDEX_DTYPE
from ..core import formats as F
from .reorder import sigma_sort_rows
from .coo_csr import csr_row_permute


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _pad1(arr: np.ndarray, size: int, fill) -> np.ndarray:
    out = np.full(size, fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def build_csr(csr: HostCSR, dtype=jnp.float32, nnz_align: int = 1024) -> F.CSR:
    nnz_pad = max(round_up(csr.nnz, nnz_align), nnz_align)
    rows = np.repeat(np.arange(csr.m, dtype=INDEX_DTYPE), csr.row_lengths())
    return F.CSR(
        data=jnp.asarray(_pad1(csr.a.astype(np.dtype(dtype)), nnz_pad, 0), dtype=dtype),
        indices=jnp.asarray(_pad1(csr.ja, nnz_pad, 0)),
        rows=jnp.asarray(_pad1(rows, nnz_pad, csr.m)),
        indptr=jnp.asarray(csr.ia),
        shape=(csr.m, csr.n),
        nnz=csr.nnz,
        nnz_expanded=csr.nnz_expanded,
    )


def build_coo(csr: HostCSR, dtype=jnp.float32, nnz_align: int = 1024) -> F.COO:
    nnz_pad = max(round_up(csr.nnz, nnz_align), nnz_align)
    rows = np.repeat(np.arange(csr.m, dtype=INDEX_DTYPE), csr.row_lengths())
    return F.COO(
        data=jnp.asarray(_pad1(csr.a.astype(np.dtype(dtype)), nnz_pad, 0), dtype=dtype),
        rows=jnp.asarray(_pad1(rows, nnz_pad, csr.m)),
        cols=jnp.asarray(_pad1(csr.ja, nnz_pad, 0)),
        shape=(csr.m, csr.n),
        nnz=csr.nnz,
        nnz_expanded=csr.nnz_expanded,
    )


def build_ell(csr: HostCSR, dtype=jnp.float32, row_align: int = 8,
              width_align: int = 1) -> F.ELL:
    lengths = csr.row_lengths()
    width = max(round_up(int(lengths.max()) if csr.m else 1, width_align), 1)
    m_pad = max(round_up(csr.m, row_align), row_align)
    vals = np.zeros((m_pad, width), dtype=np.dtype(dtype))
    cols = np.zeros((m_pad, width), dtype=INDEX_DTYPE)
    # scatter row slices into the padded 2-D layout
    pos = np.arange(csr.nnz) - np.repeat(csr.ia[:-1].astype(np.int64), lengths)
    rows = np.repeat(np.arange(csr.m), lengths)
    vals[rows, pos] = csr.a
    cols[rows, pos] = csr.ja
    return F.ELL(
        data=jnp.asarray(vals),
        cols=jnp.asarray(cols),
        shape=(csr.m, csr.n),
        nnz=csr.nnz,
        nnz_expanded=csr.nnz_expanded,
        width=width,
    )


def build_sellcs(csr: HostCSR, C: int = 8, sigma: int = 4096,
                 dtype=jnp.float32, width_align: int = 128) -> F.SellCS:
    """SELL-C-σ slab layout (see :class:`spmv_research_tpu.core.formats.SellCS`).

    σ-sorting (reference ``sell_sorted.cpp:184``) bounds padding waste; the slab
    width of each slice is rounded to `width_align`.
    """
    perm = sigma_sort_rows(csr, sigma)
    p = csr_row_permute(csr, perm, permute_columns=False)
    lengths = p.row_lengths()
    m = csr.m
    n_slices = max((m + C - 1) // C, 1)
    m_pad = n_slices * C
    lengths_pad = np.zeros(m_pad, dtype=np.int64)
    lengths_pad[:m] = lengths
    slice_len = lengths_pad.reshape(n_slices, C).max(axis=1)
    slice_len = np.maximum(round_up_vec(slice_len, width_align), width_align)
    offsets = np.zeros(n_slices + 1, dtype=np.int64)
    np.cumsum(slice_len, out=offsets[1:])
    total_width = int(offsets[-1])

    vals = np.zeros((C, total_width), dtype=np.dtype(dtype))
    cols = np.zeros((C, total_width), dtype=INDEX_DTYPE)
    # place permuted row r (= slice r//C, lane r%C) at slab row lane,
    # columns [offsets[slice], offsets[slice]+len)
    rows_of_nnz = np.repeat(np.arange(m), lengths)
    lane = rows_of_nnz % C
    slc = rows_of_nnz // C
    pos = np.arange(p.nnz) - np.repeat(p.ia[:-1].astype(np.int64), lengths)
    slab_col = offsets[slc] + pos
    vals[lane, slab_col] = p.a
    cols[lane, slab_col] = p.ja

    slice_of_col = np.repeat(np.arange(n_slices, dtype=INDEX_DTYPE), slice_len)
    lane_rows = np.full(n_slices * C, m, dtype=INDEX_DTYPE)
    lane_rows[: m] = perm.astype(INDEX_DTYPE)  # (slice s, lane c) ↦ perm[s*C+c]

    return F.SellCS(
        data=jnp.asarray(vals),
        cols=jnp.asarray(cols),
        perm=jnp.asarray(perm.astype(INDEX_DTYPE)),
        slice_of_col=jnp.asarray(slice_of_col),
        lane_rows=jnp.asarray(lane_rows),
        shape=(csr.m, csr.n),
        nnz=csr.nnz,
        nnz_expanded=csr.nnz_expanded,
        C=C,
        sigma=sigma,
        n_slices=n_slices,
        total_width=total_width,
    )


def round_up_vec(x: np.ndarray, mult: int) -> np.ndarray:
    return ((x + mult - 1) // mult) * mult


def build_bsr(csr: HostCSR, br: int = 8, bc: int = 128, dtype=jnp.float32,
              block_align: int = 8) -> F.BSR:
    """Blocked rows: every (br × bc) tile containing ≥1 nonzero is stored dense.
    SpMV becomes a stream of small dense matvecs with one block gather."""
    mb = (csr.m + br - 1) // br
    rows = np.repeat(np.arange(csr.m, dtype=np.int64), csr.row_lengths())
    brow = rows // br
    bcol = csr.ja.astype(np.int64) // bc
    key = brow * ((csr.n + bc - 1) // bc) + bcol
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, first = np.unique(key_s, return_index=True)
    n_blocks = uniq.size
    nbc = (csr.n + bc - 1) // bc
    block_of_nnz = np.searchsorted(uniq, key)
    nb_pad = max(round_up(max(n_blocks, 1), block_align), block_align)
    # fill guard: BSR densifies blocks; refuse pathological blow-ups
    dense_bytes = nb_pad * br * bc * np.dtype(dtype).itemsize
    csr_bytes = max(csr.mem_footprint_bytes(np.dtype(dtype).itemsize), 1)
    if dense_bytes > 16 * csr_bytes and dense_bytes > 64 * 2**20:
        raise ValueError(
            f"BSR fill too low: {csr.nnz / max(n_blocks * br * bc, 1):.4f} "
            f"({dense_bytes/2**20:.0f} MiB vs CSR {csr_bytes/2**20:.0f} MiB); "
            "use a gather-based format for this matrix")
    data = np.zeros((nb_pad, br, bc), dtype=np.dtype(dtype))
    lr = rows - (rows // br) * br
    lc = csr.ja.astype(np.int64) - bcol * bc
    data[block_of_nnz, lr, lc] = csr.a
    block_rows_np = (uniq // nbc).astype(INDEX_DTYPE)
    block_cols_np = (uniq % nbc).astype(INDEX_DTYPE)
    block_rowptr = np.zeros(mb + 1, dtype=np.int64)
    np.add.at(block_rowptr, block_rows_np + 1, 1)
    np.cumsum(block_rowptr, out=block_rowptr)
    return F.BSR(
        data=jnp.asarray(data),
        block_cols=jnp.asarray(_pad1(block_cols_np, nb_pad, 0)),
        block_rowptr=jnp.asarray(block_rowptr.astype(INDEX_DTYPE)),
        block_rows=jnp.asarray(_pad1(block_rows_np, nb_pad, mb)),
        shape=(csr.m, csr.n),
        nnz=csr.nnz,
        nnz_expanded=csr.nnz_expanded,
        br=br,
        bc=bc,
        n_blocks=n_blocks,
    )


def build_dia(csr: HostCSR, dtype=jnp.float32, max_diags: int = 512) -> F.DIA:
    rows = np.repeat(np.arange(csr.m, dtype=np.int64), csr.row_lengths())
    offs = csr.ja.astype(np.int64) - rows
    uniq = np.unique(offs)
    if uniq.size > max_diags:
        raise ValueError(
            f"matrix has {uniq.size} distinct diagonals (> {max_diags}); "
            "DIA is unsuitable"
        )
    d_of = np.searchsorted(uniq, offs)
    data = np.zeros((max(uniq.size, 1), csr.m), dtype=np.dtype(dtype))
    data[d_of, rows] = csr.a
    return F.DIA(
        data=jnp.asarray(data),
        shape=(csr.m, csr.n),
        nnz=csr.nnz,
        nnz_expanded=csr.nnz_expanded,
        offsets=tuple(int(o) for o in uniq),
    )


def build_ldu(csr: HostCSR, dtype=jnp.float32, face_align: int = 1024) -> F.LDU:
    """Split square matrix into diagonal + strictly-lower/upper face pairs.
    Requires structural symmetry of the off-diagonal pattern (OpenFOAM meshes
    guarantee it); asymmetric leftovers raise."""
    if csr.m != csr.n:
        raise ValueError("LDU requires square matrix")
    rows = np.repeat(np.arange(csr.m, dtype=np.int64), csr.row_lengths())
    cols = csr.ja.astype(np.int64)
    vals = csr.a
    diag = np.zeros(csr.m, dtype=np.dtype(dtype))
    dmask = rows == cols
    diag[rows[dmask]] = vals[dmask]
    upper_mask = rows < cols
    lower_mask = rows > cols
    # faces keyed by (min,max) pair
    uo, un, uv = rows[upper_mask], cols[upper_mask], vals[upper_mask]
    lo_, ln_, lv = cols[lower_mask], rows[lower_mask], vals[lower_mask]
    ukey = uo * csr.n + un
    lkey = lo_ * csr.n + ln_
    uorder = np.argsort(ukey, kind="stable")
    lorder = np.argsort(lkey, kind="stable")
    if not np.array_equal(ukey[uorder], lkey[lorder]):
        raise ValueError("LDU requires structurally symmetric off-diagonal pattern")
    owner = uo[uorder]
    neigh = un[uorder]
    upper = uv[uorder]
    lower = lv[lorder]
    nf = owner.size
    nf_pad = max(round_up(max(nf, 1), face_align), face_align)
    return F.LDU(
        diag=jnp.asarray(diag),
        lower=jnp.asarray(_pad1(lower.astype(np.dtype(dtype)), nf_pad, 0)),
        upper=jnp.asarray(_pad1(upper.astype(np.dtype(dtype)), nf_pad, 0)),
        owner=jnp.asarray(_pad1(owner.astype(INDEX_DTYPE), nf_pad, 0)),
        neighbour=jnp.asarray(_pad1(neigh.astype(INDEX_DTYPE), nf_pad, 0)),
        shape=(csr.m, csr.n),
        nnz=csr.nnz,
        nnz_expanded=csr.nnz_expanded,
    )


def build_csc(csr: HostCSR, dtype=jnp.float32, nnz_align: int = 1024) -> F.CSC:
    """Column-major (CSC) device format via a host-side transpose sort."""
    rows = np.repeat(np.arange(csr.m, dtype=np.int64), csr.row_lengths())
    order = np.lexsort((rows, csr.ja))
    nnz_pad = max(round_up(csr.nnz, nnz_align), nnz_align)
    return F.CSC(
        data=jnp.asarray(_pad1(csr.a[order].astype(np.dtype(dtype)), nnz_pad, 0),
                         dtype=dtype),
        rows=jnp.asarray(_pad1(rows[order].astype(INDEX_DTYPE), nnz_pad, csr.m)),
        cols=jnp.asarray(_pad1(csr.ja[order], nnz_pad, 0)),
        shape=(csr.m, csr.n),
        nnz=csr.nnz,
        nnz_expanded=csr.nnz_expanded,
    )


def build_csr_sym(csr: HostCSR, dtype=jnp.float32, nnz_align: int = 1024) -> F.CSRSym:
    """Symmetric format from lower-triangle-stored CSR (or any CSR — the
    upper triangle is dropped first, assuming A symmetric)."""
    if csr.m != csr.n:
        raise ValueError("CSR_SYM requires a square (symmetric) matrix")
    if not csr.symmetric_storage:
        from .coo_csr import csr_drop_upper

        sp = csr.to_scipy()
        asym = abs(sp - sp.T)
        if asym.nnz and asym.max() > 1e-12 * max(abs(sp).max(), 1e-300):
            raise ValueError("CSR_SYM requires a numerically symmetric matrix")
        csr = csr_drop_upper(csr)
    rows = np.repeat(np.arange(csr.m, dtype=INDEX_DTYPE), csr.row_lengths())
    nnz_pad = max(round_up(csr.nnz, nnz_align), nnz_align)
    return F.CSRSym(
        data=jnp.asarray(_pad1(csr.a.astype(np.dtype(dtype)), nnz_pad, 0),
                         dtype=dtype),
        rows=jnp.asarray(_pad1(rows, nnz_pad, csr.m)),
        cols=jnp.asarray(_pad1(csr.ja, nnz_pad, 0)),
        shape=(csr.m, csr.n),
        nnz=csr.nnz,
        nnz_expanded=csr.nnz_expanded,
    )
