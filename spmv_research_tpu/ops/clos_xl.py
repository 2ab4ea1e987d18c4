"""CLOSGX: XL matrices via ``lax.scan`` over uniform CLOSG chunk programs.

The fused multi-chunk CLOSG program grows with its chunk count (one
pipeline per chunk in one program). This module keeps the program size
constant: every chunk is built with a FORCED uniform shape (N = 2^20
slots, padded), the per-chunk plane arrays are stacked on a leading chunk
axis, and execution is one ``jax.lax.scan`` whose body is a single compiled
chunk pipeline — each chunk's planes are read once (they are scanned xs).

Uniformity requirements and how they are met (host-side, at build):
  * N, V           — ``build_clos_gather(force_N=2^20)`` pads every chunk.
  * scan stages    — the canonical stage count is the max over chunks —
    extra stages on shorter chunks are identity (their guard bits are
    zero). Stages ≤ 14 always (the auto router long-row-splits rows past
    16k nnz), so guards fit r3's 15 spare bits and the scan_hi plane is
    never needed.
  * y-extraction   — ``yslot`` names each y row's end slot in its chunk's
    scan output (-1: empty row or padding), padded to the largest chunk's
    row count; extraction is one element gather per y row.
  * row alignment  — chunk row boundaries are multiples of 128, so the
    final y assembly is one row-granular gather over the stacked
    (n_chunks·mrp, 128) output.

Reference role: this is what lets the single-chip engine cover the
reference's largest validation matrices (audikw_1/cage15/kmer_V2a class,
50–120M nnz — ``run.sh:137-191``) rather than only the ≤12M-slot ones.
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
from .clos import _register
from .clos_route import BLK, LANES, SUB, ClosRoutingError


@partial(_register,
         data_fields=("rowidx", "vals", "r1", "r2", "r3", "yslot", "ymap"),
         meta_fields=("shape", "nnz", "nnz_expanded", "N", "V", "x_rows",
                      "stages", "mrp"))
@dataclasses.dataclass(frozen=True)
class ClosGX:
    """Stacked uniform CLOSG chunk programs (leading axis = chunk)."""

    rowidx: jnp.ndarray    # (C, S) int32
    vals: jnp.ndarray      # (C, S, 128)
    r1: jnp.ndarray        # (C, S, 128) int32 packed (λ in spare bits)
    r2: jnp.ndarray
    r3: jnp.ndarray        # spare bits: scan guards
    yslot: jnp.ndarray     # (C, mrp, 128) int32 end slot per row, -1 = none
    ymap: jnp.ndarray      # (R,) int32 rows into the stacked (C·mrp) output
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    N: int
    V: int
    x_rows: int
    stages: int            # canonical scan stage count (= max over chunks)
    mrp: int               # 128-row y groups per chunk (uniform)

    format_name = "CLOSGX"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    @property
    def n_chunks(self):
        return int(self.rowidx.shape[0])

    def mem_footprint_bytes(self) -> int:
        leaves = (self.rowidx, self.vals, self.r1, self.r2, self.r3,
                  self.yslot, self.ymap)
        return int(sum(l.size * l.dtype.itemsize for l in leaves))


def build_clos_gather_xl(csr: HostCSR, dtype=jnp.float32,
                         chunk_N: int = 1 << 20,
                         max_chunks: int = 1024) -> ClosGX:
    """Build stacked uniform chunk programs for a matrix too large for the
    fused chunked path. Chunk row boundaries are 128-aligned."""
    from .clos_gather import build_clos_gather, _closg_need, _rows_slice

    m, n = csr.m, csr.n
    est = _closg_need(csr, 0, m) / (0.88 * chunk_N) + 1
    if est > max_chunks:
        raise ClosRoutingError(f"~{est:.0f} chunks exceed the XL cap "
                               f"({max_chunks})")
    nnz_per_row = max(csr.nnz / max(m, 1), 1e-9)
    splits = [0]
    r0 = 0
    while r0 < m:
        r1 = min(m, r0 + max(int(0.8 * chunk_N / nnz_per_row), 128))
        r1 = r0 + max((r1 - r0) // LANES * LANES, LANES)
        r1 = min(r1, m)
        while _closg_need(csr, r0, r1) > chunk_N and r1 - r0 > LANES:
            r1 = r0 + max((r1 - r0) * 3 // 4 // LANES * LANES, LANES)
        while r1 < m:
            step = max((r1 - r0) // 8 // LANES * LANES, LANES)
            r_try = min(m, r1 + step)
            if _closg_need(csr, r0, r_try) > chunk_N:
                break
            r1 = r_try
        if _closg_need(csr, r0, r1) > chunk_N:
            raise ClosRoutingError(
                f"rows [{r0},{r1}) exceed one XL chunk (a single 128-row "
                "band needs more than 2^20 slots — split rows first)")
        splits.append(r1)
        r0 = r1
        if len(splits) - 1 > max_chunks:   # fast-fail mid-split
            raise ClosRoutingError(
                f"more than {max_chunks} chunks after "
                f"{r1}/{m} rows — XL cap exceeded")
        # early plane-byte projection so scattered blow-ups (delaunay
        # class: ~128-row chunks) fail in seconds, not after a full
        # split — the binding limit is HBM plane bytes, not chunk count
        # (xl160m legitimately needs ~290 chunks at 4.6 GB)
        if len(splits) - 1 == 64 and r1 < m:
            proj = 64 * m / max(r1, 1) * 4 * chunk_N * 4
            if proj > 12 << 30:
                raise ClosRoutingError(
                    f"projected CLOSGX planes ~{proj / 1e9:.0f} GB from "
                    f"the first 64 chunks ({r1}/{m} rows) — scattered "
                    "slot blow-up, outside the engine")

    # plane-budget guard BEFORE any chunk builds: on ultra-sparse wide
    # matrices (delaunay_n22 class: ~5 nnz/row over n=4M) the column-block
    # padding inflates slots ~4x and yslot pads every chunk to the max
    # row count, so the stacked arguments exceed HBM at compile (observed
    # 17.6 GB on a 16 GB part after an 18-minute build). Fail fast with
    # the cost model instead; the chunked CSR baseline covers the class.
    C_est = len(splits) - 1
    if C_est > max_chunks:
        # the nnz-based estimate can be wildly optimistic on scattered
        # matrices (the per-chunk column-block padding forces ~128-row
        # chunks); enforce the cap on the REAL split
        raise ClosRoutingError(
            f"{C_est} chunks after splitting exceed the XL cap "
            f"({max_chunks})")
    mrp_est = max(splits[i + 1] - splits[i]
                  for i in range(C_est)) // LANES + 1
    plane_b = C_est * (4 * chunk_N * 4 + mrp_est * LANES * 4)
    if plane_b > 8 << 30:
        raise ClosRoutingError(
            f"CLOSGX stacked planes ~{plane_b / 1e9:.1f} GB "
            f"({C_est} chunks x mrp {mrp_est}; "
            f"{C_est * chunk_N / max(csr.nnz, 1):.1f} slots/nnz) exceed "
            "the HBM budget — ultra-sparse wide matrix outside the engine")

    # chunk programs are independent; the native coloring releases the GIL
    # and the numpy passes mostly do too, so two build threads overlap the
    # cache-miss-bound routing work (XL conversion was serial-rate-bound)
    from concurrent.futures import ThreadPoolExecutor

    def _one(i):
        return build_clos_gather(_rows_slice(csr, splits[i], splits[i + 1]),
                                 dtype=dtype, max_N=chunk_N, force_N=chunk_N,
                                 host_arrays=True)

    with ThreadPoolExecutor(2) as ex:
        chunks = list(ex.map(_one, range(len(splits) - 1)))
    if any(len(c.scan_stages) > 14 for c in chunks):
        raise ClosRoutingError("XL chunk needs > 14 scan stages "
                               "(row longer than 16k nnz unsplit?)")

    C = len(chunks)
    stages = max(len(c.scan_stages) for c in chunks)
    rows_c = [splits[i + 1] - splits[i] for i in range(C)]
    mrp = max((r + LANES - 1) // LANES for r in rows_c)
    S = SUB * chunks[0].V

    V = chunks[0].V
    rowidx = np.zeros((C, S), np.int32)
    vals = np.zeros((C, S, LANES), np.dtype(dtype))
    r1 = np.zeros((C, S, LANES), np.int32)
    r2 = np.zeros((C, SUB * BLK, V // SUB), np.int32)  # middle-stage shape
    r3 = np.zeros((C, S, LANES), np.int32)
    yslot = np.full((C, mrp * LANES), -1, np.int32)
    ymaps = []
    for ci, c in enumerate(chunks):
        rowidx[ci] = np.asarray(c.rowidx)
        vals[ci] = np.asarray(c.vals_cs)
        r1[ci] = np.asarray(c.perm_r1)
        r2[ci] = np.asarray(c.perm_r2)
        r3[ci] = np.asarray(c.perm_r3)
        # the scan leaves each row's total at its last CSR slot
        ia = csr.ia[splits[ci]: splits[ci + 1] + 1].astype(np.int64)
        yslot[ci, : rows_c[ci]] = np.where(ia[1:] > ia[:-1],
                                           ia[1:] - 1 - ia[0], -1)
        ymaps.append(ci * mrp + np.arange((rows_c[ci] + LANES - 1) // LANES,
                                          dtype=np.int64))
    ymap = np.concatenate(ymaps).astype(np.int32)

    return ClosGX(
        rowidx=jnp.asarray(rowidx), vals=jnp.asarray(vals),
        r1=jnp.asarray(r1), r2=jnp.asarray(r2), r3=jnp.asarray(r3),
        yslot=jnp.asarray(yslot.reshape(C, mrp, LANES)),
        ymap=jnp.asarray(ymap),
        shape=(m, n), nnz=csr.nnz, nnz_expanded=csr.nnz_expanded,
        N=chunk_N, V=chunk_N // BLK,
        x_rows=(n + LANES - 1) // LANES,
        stages=stages, mrp=mrp)


# ---------------------------------------------------------------- execution

@register_spmv("CLOSGX", "xla")
def spmv_closgx_xla(A: ClosGX, x: jnp.ndarray) -> jnp.ndarray:
    """XLA lowering of the stacked program: one ``lax.scan`` over the
    chunk axis, one compiled chunk body."""
    from .clos import LANE2_SHIFT, ROT_SHIFT, SPARE_SHIFT

    x2d = jnp.pad(x.astype(A.vals.dtype),
                  (0, A.x_rows * LANES - x.shape[0])).reshape(
                      A.x_rows, LANES)

    def invreg(v, w):
        S = v.shape[0]
        t1 = jnp.take_along_axis(v, w & 0x7F, axis=1)
        rot = (w >> ROT_SHIFT) & 0x7
        s_in = jnp.arange(S, dtype=jnp.int32)[:, None] % SUB
        blk0 = jnp.arange(S, dtype=jnp.int32)[:, None] // SUB * SUB
        src = blk0 + (s_in + rot) % SUB
        t2 = jnp.take_along_axis(t1, jnp.broadcast_to(src, v.shape), axis=0)
        return jnp.take_along_axis(t2, (w >> LANE2_SHIFT) & 0x7F, axis=1)

    def body(carry, leaves):
        rowidx, vals, r1, r2, r3, yslot = leaves
        V = A.V
        wins = x2d.at[rowidx].get(mode="promise_in_bounds")
        g = jnp.take_along_axis(wins, (r1 >> SPARE_SHIFT) & 0x7F, axis=1)
        v = invreg(g * vals, r1)
        v = jnp.transpose(v.reshape(V, BLK)).reshape(SUB * BLK, V // SUB)
        v = invreg(v, r2)
        v = jnp.transpose(v.reshape(BLK, V)).reshape(SUB * V, LANES)
        v = invreg(v, r3)
        flat = v.reshape(-1)
        for k in range(A.stages):
            guard = ((r3.reshape(-1) >> (SPARE_SHIFT + k)) & 1) != 0
            sh = jnp.roll(flat, 1 << k)
            flat = flat + jnp.where(guard, sh, 0.0)
        y = flat.at[jnp.maximum(yslot, 0)].get(mode="promise_in_bounds")
        return carry, jnp.where(yslot >= 0, y, 0.0)

    _, ys = jax.lax.scan(
        body, 0, (A.rowidx, A.vals, A.r1, A.r2, A.r3, A.yslot))
    rows = ys.reshape(A.n_chunks * A.mrp, LANES)
    y = rows.at[A.ymap].get(mode="promise_in_bounds")
    return y.reshape(-1)[: A.m]


def _spmm_scan_xl(A, X, impl):
    from . import dispatch

    def body(_, xk):
        return 0, dispatch.spmv(A, xk, impl=impl)

    _, ys = jax.lax.scan(body, 0, jnp.transpose(X))
    return jnp.transpose(ys)


@register_spmm("CLOSGX", "xla")
def spmm_closgx_xla(A: ClosGX, X: jnp.ndarray) -> jnp.ndarray:
    return _spmm_scan_xl(A, X, "xla")
