"""CLOSG: row-gather + lane-pick front end on the Clos SpMV pipeline.

Replaces the exact-CLOS widen+fill networks (3 shuffle layers + 2
transposes + fill stages) with two cheap steps, built on a *row-granular*
gather (whole 128-wide x rows, not single elements):

  1. slots are laid out in **column-sorted order, padded so every sublane row
     of 128 slots draws from one 128-column block** of x
     (sublane s ↔ x2d row ``rowidx[s]``);
  2. ``wins = x2d[rowidx]`` (XLA row-gather) materializes each sublane's
     x window;
  3. one ``take_along_axis(axis=1)`` lane-pick (per-slot λ = col mod 128 —
     duplication is free, no routing constraints) + multiply by the
     column-sorted value array.

The products then run the exact-Clos perm network (column-sorted → CSR slot
order), the segmented row scan, and the compaction network, unchanged from
``clos.py``. Everything is exactly routable — no spills, no coloring
saturation (unlike the multicast engine ``clos_mcast.py``, which this
supersedes on low-reuse matrices).

Capacity: needs Σ_i ceil(nnz_i/128) ≤ N/128 sublanes, where nnz_i counts
nonzeros with col ∈ [128i, 128(i+1)) — i.e. ~nnz + 64·(n/128) slots.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.host import HostCSR
from .dispatch import register_spmv, register_spmm
from .clos_route import BLK, LANES, SUB, ClosRoutingError, route_clos
from .clos import (LANE2_SHIFT, ROT_SHIFT, SPARE_BITS, SPARE_SHIFT,
                   _pack, _register, _stage_bit, _invreg_xla, _t_fwd, _t_bwd)


@partial(_register,
         data_fields=("rowidx", "vals_cs",
                      "perm_r1", "perm_r2", "perm_r3",
                      "ycand", "ysel", "scan_hi"),
         meta_fields=("shape", "nnz", "nnz_expanded", "N", "V", "x_rows",
                      "scan_stages", "C", "use_vlut"))
@dataclasses.dataclass(frozen=True)
class ClosG:
    """Window-gather + Clos SpMV program (packed words as in ``clos.Clos``).

    Front end: ``rowidx[s]`` = x2d row feeding sublane s; the per-slot source
    lane λ = col mod 128 rides in ``perm_r1``'s spare bits [17,24) — the r1
    word is co-located with the column-sorted slot, so one plane read feeds
    both the window lane-pick and the r1 layer (saves a 4 MB λ array on the
    HBM-bound pipeline). Back end (y extraction, replacing a third
    Clos network): each 128-row y group draws its row-end slots from at most
    ``C`` scan-output rows — ``ycand[c·m_rows + j]`` names them; ``ysel``
    packs, per y slot, the candidate id (bits [7,14)) and the source lane
    (bits [0,7)); C ≤ 128, since a group has 128 row ends. ``perm_r3``
    spare bits carry the scan guards."""

    rowidx: jnp.ndarray       # (8V,) int32
    vals_cs: jnp.ndarray      # (8V, 128) values in padded column-sorted order
    perm_r1: jnp.ndarray
    perm_r2: jnp.ndarray
    perm_r3: jnp.ndarray      # spare bits: scan guards (low stages)
    ycand: jnp.ndarray        # (m_rows·C,) int32 scan-output row ids
    ysel: jnp.ndarray         # (m_rows, 128) int32: lane | cand<<7
    scan_hi: jnp.ndarray
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    N: int
    V: int
    x_rows: int
    scan_stages: Tuple[int, ...]
    C: int
    use_vlut: bool = False    # values are a 128-entry dict, idx in r1 spare

    format_name = "CLOSG"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mem_footprint_bytes(self) -> int:
        leaves = (self.rowidx, self.vals_cs, self.perm_r1, self.perm_r2,
                  self.perm_r3, self.ycand, self.ysel, self.scan_hi)
        return int(sum(l.size * l.dtype.itemsize for l in leaves))


@partial(_register, data_fields=("chunks",),
         meta_fields=("shape", "nnz", "nnz_expanded", "row_split"))
@dataclasses.dataclass(frozen=True)
class ClosGChunked:
    """Row-chunked CLOSG: one Clos program per ≤2^20-slot row block.

    The radix-1024 Clos construction caps a single program at N = 2^20
    slots (the middle stage needs V ≤ 1024 switches), so larger matrices
    are split into row-contiguous chunks, each compiled independently; the
    dense x is shared (each chunk's window front end reads the same x2d)
    and y is the concatenation of per-chunk outputs."""

    chunks: Tuple[ClosG, ...]
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    row_split: Tuple[int, ...]   # chunk row boundaries, len = len(chunks)+1

    format_name = "CLOSG"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mem_footprint_bytes(self) -> int:
        return int(sum(c.mem_footprint_bytes() for c in self.chunks))


def _rows_slice(csr: HostCSR, r0: int, r1: int) -> HostCSR:
    lo, hi = int(csr.ia[r0]), int(csr.ia[r1])
    return HostCSR(ia=(csr.ia[r0:r1 + 1] - csr.ia[r0]).astype(csr.ia.dtype),
                   ja=csr.ja[lo:hi], a=csr.a[lo:hi],
                   m=r1 - r0, n=csr.n)


def _closg_need(csr: HostCSR, r0: int, r1: int) -> int:
    """Exact slot need of rows [r0, r1) (mirrors build_clos_gather)."""
    lo, hi = int(csr.ia[r0]), int(csr.ia[r1])
    nnz_c = hi - lo
    n_blocks = (csr.n + LANES - 1) // LANES
    cnt = np.bincount(csr.ja[lo:hi] // LANES, minlength=n_blocks)
    s_needed = int(((cnt + LANES - 1) // LANES).sum())
    return max(nnz_c + 1, r1 - r0, s_needed * LANES, 8 * BLK)


SPLIT_ROW_NNZ = 16384    # rows past this are split (scan depth, chunking)


def build_clos_gather_auto(csr: HostCSR, dtype=jnp.float32,
                           max_N: int = 1 << 20, value_lut: bool = False,
                           max_chunks: int = 12, split_rows: bool = True):
    """build_clos_gather with automatic row chunking past the 2^20 cap.

    ``max_chunks`` bounds the fused program size: every chunk adds its
    own pipeline to one jitted SpMV, so past it the XL scan-over-chunks
    program (one compiled chunk body) takes over.

    Extreme-skew matrices (a few mega-rows among light ones — webbase/
    ASIC_680k/rajat30 twins) are routed through the long-row split first:
    rows > ``SPLIT_ROW_NNZ`` become ≤-256-nnz sub-rows, which bounds the
    segmented scan's depth (CLOSGX chunks carry at most 14 guard stages)
    and lets a single original row span chunk boundaries. The split is
    skipped when more than 4096 rows are heavy: a mass split would add a
    sub-row combine over most of the matrix."""
    if split_rows:
        from .rowsplit import split_long_rows, wrap_row_split, DEFAULT_T
        lengths = csr.row_lengths()
        heavy_n = int((lengths > SPLIT_ROW_NNZ).sum())
        if 0 < heavy_n <= 4096:
            csr2, heavy, seg_ptr = split_long_rows(
                csr, DEFAULT_T, threshold=SPLIT_ROW_NNZ)
            inner = build_clos_gather_auto(csr2, dtype=dtype, max_N=max_N,
                                           value_lut=value_lut,
                                           max_chunks=max_chunks,
                                           split_rows=False)
            return wrap_row_split(inner, (csr.m, csr.n), csr.nnz,
                                  csr.nnz_expanded, heavy, seg_ptr)
    if _closg_need(csr, 0, csr.m) <= max_N:
        return build_clos_gather(csr, dtype=dtype, max_N=max_N,
                                 value_lut=value_lut)
    est_chunks = _closg_need(csr, 0, csr.m) / (0.9 * max_N) + 1
    if est_chunks > max_chunks:
        # XL path: lax.scan over stacked uniform chunk programs — program
        # size constant in the chunk count
        from .clos_xl import build_clos_gather_xl
        return build_clos_gather_xl(csr, dtype=dtype, chunk_N=max_N)
    splits = [0]
    r0 = 0
    nnz_per_row = max(csr.nnz / max(csr.m, 1), 1e-9)
    while r0 < csr.m:
        r1 = min(csr.m, r0 + max(int(0.8 * max_N / nnz_per_row), 1))
        while _closg_need(csr, r0, r1) > max_N:
            r1 = r0 + max((r1 - r0) * 3 // 4, 1)
        while r1 < csr.m:
            r_try = min(csr.m, r1 + max((r1 - r0) // 8, 1))
            if _closg_need(csr, r0, r_try) > max_N:
                break
            r1 = r_try
        if _closg_need(csr, r0, r1) > max_N:
            raise ClosRoutingError(
                f"rows [{r0},{r1}) exceed a single clos-gather program")
        splits.append(r1)
        r0 = r1
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as _ex:
        chunks = tuple(_ex.map(
            lambda i: build_clos_gather(
                _rows_slice(csr, splits[i], splits[i + 1]),
                dtype=dtype, max_N=max_N, value_lut=value_lut),
            range(len(splits) - 1)))
    return ClosGChunked(chunks=chunks, shape=(csr.m, csr.n), nnz=csr.nnz,
                        nnz_expanded=csr.nnz_expanded,
                        row_split=tuple(splits))


def build_clos_gather(csr: HostCSR, dtype=jnp.float32,
                      max_N: int = 1 << 20, value_lut: bool = False,
                      force_N: int = 0, host_arrays: bool = False) -> ClosG:
    """``force_N``: pad the program to exactly N=force_N slots (the XL
    scan-over-chunks path needs uniform chunk shapes); ``host_arrays``:
    keep numpy leaves (XL stacks them before one device put)."""
    dt = np.dtype(dtype)
    m, n, nnz = csr.m, csr.n, csr.nnz

    lengths = csr.row_lengths()
    rows = np.repeat(np.arange(m, dtype=np.int64), lengths)
    cols = csr.ja.astype(np.int64)

    # --- padded column-sorted layout: sublane-aligned column blocks --------
    css = np.lexsort((rows, cols))          # nnz ids in (col, row) order
    blk_of = cols[css] // LANES             # x2d row of each sorted nnz
    n_blocks = (n + LANES - 1) // LANES
    cnt = np.bincount(blk_of, minlength=n_blocks)
    subl_per_blk = (cnt + LANES - 1) // LANES        # sublanes per block
    subl_per_blk = np.maximum(subl_per_blk, 0)
    sub_start = np.concatenate([[0], np.cumsum(subl_per_blk)])
    S_needed = int(sub_start[-1])

    # nnz+1: slot `nnz` must exist as an always-zero padding slot (empty rows
    # read it during y extraction)
    need = max(nnz + 1, m, S_needed * LANES, 8 * BLK)
    N = 1 << int(need - 1).bit_length()
    if force_N:
        if need > force_N:
            raise ClosRoutingError(
                f"chunk needs {need} slots > forced N={force_N}")
        N = force_N
    if N > max_N:
        raise ClosRoutingError(f"matrix too large for clos-gather (N={N})")
    V = N // BLK
    S = SUB * V

    # slot of sorted-nnz j: block b starts at sublane sub_start[b]
    within = np.arange(nnz) - np.concatenate([[0], np.cumsum(cnt)])[blk_of]
    cs_slot = (sub_start[blk_of] * LANES + within).astype(np.int64)

    rowidx = np.zeros(S, np.int32)
    for_blocks = np.repeat(np.arange(n_blocks), subl_per_blk)
    rowidx[: S_needed] = for_blocks
    lam = np.zeros(N, np.uint32)
    lam[cs_slot] = (cols[css] % LANES).astype(np.uint32)

    vals_cs = np.zeros(N, dtype=dt)
    vals_cs[cs_slot] = csr.a[css].astype(dt)

    # --- value LUT (DIV / CSR_CV compressed-value role) ---------------------
    # When the matrix has ≤ 128 distinct values (pattern / quantized
    # matrices), the per-slot value is a 7-bit dictionary index riding in
    # perm_r1's remaining spare bits [24,31) and the 4 MB value plane
    # disappears from both the footprint and the streamed pipeline; the
    # program pays one extra lane-pick from the dict. Opt-in — a footprint
    # codec, like the reference's CV formats.
    # Reference role: DIV/div.cpp value RLE + csr_cv_block codecs.
    lut = False
    if value_lut:
        uniq = np.unique(vals_cs)            # includes the 0.0 padding value
        if uniq.shape[0] <= LANES:
            lut = True
            vidx = np.searchsorted(uniq, vals_cs).astype(np.uint32)
            lam |= vidx << 7                  # spare payload: lam | vidx<<7
            dict_pad = np.zeros(LANES, dt)
            dict_pad[: uniq.shape[0]] = uniq
            vals_cs = np.broadcast_to(dict_pad, (SUB, LANES)).copy()

    # --- perm: padded column-sorted slot -> CSR slot -----------------------
    perm = route_clos(cs_slot, css.astype(np.int64), N)

    # --- scan guards over CSR slot space (as clos.build_clos) --------------
    starts = csr.ia[:-1].astype(np.int64)
    row_start = np.zeros(N, dtype=np.int64)
    row_start[:nnz] = np.repeat(starts, lengths)
    reach_v = np.arange(N, dtype=np.int64) - row_start
    reach_v[nnz:] = 0
    max_reach = int(reach_v[:nnz].max()) if nnz else 0
    scan_guards = np.zeros(N, dtype=np.uint32)
    scan_stages = tuple(range(max_reach.bit_length()))
    for k in scan_stages:
        scan_guards |= ((reach_v >= (1 << k)).astype(np.uint32) << k)

    # --- y extraction: row-gather of end-slot rows + per-slot select -------
    # empty rows read slot nnz (a padding slot that stays exactly 0)
    end_slot = np.full(m, nnz, np.int64)
    ne = lengths > 0
    end_slot[ne] = csr.ia[1:].astype(np.int64)[ne] - 1
    m_rows = (m + LANES - 1) // LANES
    end_pad = np.full(m_rows * LANES, nnz, np.int64)
    end_pad[:m] = end_slot
    src_row = (end_pad // LANES).reshape(m_rows, LANES)
    ycand_l, cidx = [], np.zeros((m_rows, LANES), np.uint32)
    C = 1
    for j in range(m_rows):
        u, inv = np.unique(src_row[j], return_inverse=True)
        ycand_l.append(u)
        cidx[j] = inv.astype(np.uint32)
        C = max(C, len(u))
    # stored candidate-major (C, m_rows): one row gather yields the
    # (C, m_rows, 128) candidate planes
    ycand = np.zeros((C, m_rows), np.int32)
    for j, u in enumerate(ycand_l):
        ycand[: len(u), j] = u
        ycand[len(u):, j] = u[-1] if len(u) else 0
    ysel = ((end_pad % LANES).astype(np.uint32).reshape(m_rows, LANES)
            | (cidx << 7))  # bits [7,14): candidate id (C <= 128)

    spare_mask = (1 << SPARE_BITS) - 1
    dummy = np.zeros((SUB, LANES), np.int32)
    scan_hi = (scan_guards >> SPARE_BITS).astype(np.uint32)

    # XL stacking consumes numpy leaves; skip the per-chunk device put
    conv = np.asarray if host_arrays else jnp.asarray

    return ClosG(
        rowidx=conv(rowidx),
        vals_cs=conv(vals_cs if lut else vals_cs.reshape(S, LANES)),
        perm_r1=conv(_pack(perm.r1, lam)),
        perm_r2=conv(_pack(perm.r2)),
        perm_r3=conv(_pack(perm.r3, scan_guards & spare_mask)),
        ycand=conv(ycand.reshape(-1)),
        ysel=conv(ysel.view(np.int32)),
        scan_hi=conv(scan_hi.view(np.int32).reshape(S, LANES)
                     if scan_hi.any() else dummy),
        shape=(m, n), nnz=nnz, nnz_expanded=csr.nnz_expanded,
        N=N, V=V, x_rows=int((n + LANES - 1) // LANES),
        scan_stages=scan_stages, C=C, use_vlut=lut,
    )


def _windows(A: ClosG, x):
    """wins[s] = x2d[rowidx[s]] via XLA row-gather."""
    n_rows = A.x_rows
    x2d = jnp.pad(x.astype(A.vals_cs.dtype),
                  (0, n_rows * LANES - x.shape[0])).reshape(n_rows, LANES)
    return x2d.at[A.rowidx].get(mode="promise_in_bounds")


def _extract_y_xla(A: ClosG, v):
    """Row-gather the ≤C candidate scan rows per 128-row y group, lane-pick
    each, select by candidate id."""
    C = A.C
    m_rows = A.ycand.shape[0] // C
    cands = v.at[A.ycand].get(mode="promise_in_bounds").reshape(
        C, m_rows, LANES)
    lam = A.ysel & 0x7F
    cid = (A.ysel >> 7) & 0x7F
    y = jnp.zeros((m_rows, LANES), v.dtype)
    for c in range(C):
        pick = jnp.take_along_axis(cands[c], lam, axis=1)
        y = jnp.where(cid == c, pick, y)
    return y.reshape(-1)[: A.m]


@register_spmv("CLOSG", "xla")
def spmv_closg_xla(A, x: jnp.ndarray) -> jnp.ndarray:
    if isinstance(A, ClosGChunked):
        return jnp.concatenate([spmv_closg_xla(c, x) for c in A.chunks])
    N, V = A.N, A.V
    wins = _windows(A, x)
    lam = (A.perm_r1 >> SPARE_SHIFT) & 0x7F
    g = jnp.take_along_axis(wins, lam, axis=1)
    if A.use_vlut:
        drow = jnp.broadcast_to(A.vals_cs[0:1, :], lam.shape)
        vals = jnp.take_along_axis(
            drow, (A.perm_r1 >> (SPARE_SHIFT + 7)) & 0x7F, axis=1)
    else:
        vals = A.vals_cs
    v = g * vals
    v = _invreg_xla(v, A.perm_r1)
    v = _t_fwd(v, V)
    v = _invreg_xla(v, A.perm_r2)
    v = _t_bwd(v, V)
    v = _invreg_xla(v, A.perm_r3)
    for k in A.scan_stages:
        guard = _stage_bit(k, A.perm_r3, A.scan_hi)
        shifted = jnp.roll(v.reshape(-1), 1 << k).reshape(v.shape)
        v = v + jnp.where(guard, shifted, 0.0)
    return _extract_y_xla(A, v)


def execute_closg_numpy(A, x: np.ndarray) -> np.ndarray:
    """float64-capable host reference of the compiled program."""
    if isinstance(A, ClosGChunked):
        return np.concatenate([execute_closg_numpy(c, x) for c in A.chunks])
    from .clos_route import InVregPlanes, apply_invreg_numpy, ClosPerm
    from .clos_route import apply_clos_numpy

    def unpack(leaf):
        w = np.asarray(leaf).view(np.uint32)
        return InVregPlanes(lane1=(w & 0x7F).astype(np.int64),
                            subrot=((w >> ROT_SHIFT) & 0x7).astype(np.int64),
                            lane2=((w >> LANE2_SHIFT) & 0x7F).astype(np.int64))

    N, V = A.N, A.V
    n_rows = A.x_rows
    x2d = np.zeros((n_rows * LANES,), np.float64)
    x2d[: x.shape[0]] = x
    x2d = x2d.reshape(n_rows, LANES)
    wins = x2d[np.asarray(A.rowidx)]
    r1w = np.asarray(A.perm_r1).view(np.uint32)
    lam = (r1w >> SPARE_SHIFT) & 0x7F
    w = np.take_along_axis(wins, lam.astype(np.int64), axis=1)
    if A.use_vlut:
        drow = np.asarray(A.vals_cs)[0].astype(np.float64)
        vals = drow[((r1w >> (SPARE_SHIFT + 7)) & 0x7F).astype(np.int64)]
    else:
        vals = np.asarray(A.vals_cs).astype(np.float64)
    w = (w * vals).reshape(-1)
    w = apply_clos_numpy(w, ClosPerm(V=V, r1=unpack(A.perm_r1),
                                     r2=unpack(A.perm_r2),
                                     r3=unpack(A.perm_r3)))
    sg = (np.asarray(A.perm_r3).view(np.uint32).reshape(-1)
          >> SPARE_SHIFT).astype(np.uint64)
    hi = np.asarray(A.scan_hi).view(np.uint32).reshape(-1)
    if hi.shape[0] == sg.shape[0]:
        sg |= hi.astype(np.uint64) << SPARE_BITS
    for k in A.scan_stages:
        d = 1 << k
        guard = ((sg >> k) & 1) == 1
        sh = np.zeros_like(w)
        sh[d:] = w[:-d]
        w = w + np.where(guard, sh, 0.0)
    C = A.C
    w2 = w.reshape(-1, LANES)
    m_rows = np.asarray(A.ycand).shape[0] // C
    cands = w2[np.asarray(A.ycand)].reshape(C, m_rows, LANES)
    sel = np.asarray(A.ysel).view(np.uint32)
    lam_y = (sel & 0x7F).astype(np.int64)
    cid = (sel >> 7) & 0x7F
    y = np.zeros((m_rows, LANES))
    for c in range(C):
        pick = np.take_along_axis(cands[c], lam_y, axis=1)
        y = np.where(cid == c, pick, y)
    return y.reshape(-1)[: A.m]


# ------------------------------------------------------------------- SpMM

def _spmm_scan(A, X: jnp.ndarray, impl: str) -> jnp.ndarray:
    """Y = A @ X as a ``lax.scan`` over X's columns: the SpMV pipeline
    compiles ONCE regardless of K (an unrolled K-loop would grow the
    program K-fold; the scan keeps it at one chunk set). Reference role:
    bench_spmm.cpp
    K_DIM sweep (``config.sh:138-143``)."""
    from . import dispatch

    def body(_, xk):
        return 0, dispatch.spmv(A, xk, impl=impl)

    _, ys = jax.lax.scan(body, 0, jnp.transpose(X))
    return jnp.transpose(ys)


@register_spmm("CLOSG", "xla")
def spmm_closg_xla(A, X: jnp.ndarray) -> jnp.ndarray:
    return _spmm_scan(A, X, "xla")
