"""BTILE: dense-(8,128)-tile matmul engine for SpMM and SDDMM.

The reference treats the K dimension as a first-class sweep
(``benchmark_code/BENCH/config.sh:138-143``, K=16-256) but its SpMM is a stub
(``bench_spmm.cpp:268-280`` still calls spmv) and its SDDMM kernels are
element-wise dot loops (``sddmm_kernels/csr.cpp:109-135``).  The K
dimension is a matrix-unit opportunity: sparse A is packed into dense
(8,128) tiles and every tile becomes one row-slab of a large matmul, so the
A plane is streamed once per K-block instead of once per column (a
``lax.scan`` of K SpMVs costs K× the SpMV). A tensor-core kernel for this
layout is a candidate for Hopper (ROADMAP), to be driven by a trace.

Layout
------
* tile (8,128) at (rowblock rb = row>>3, colblock cb = col>>7); only
  nonempty tiles are stored, as dense fp32 slabs.
* row-band g = 1024 rows (128 rowblocks).
* step = up to TG tiles sharing one (g, cb); steps sorted g-major.

SpMM (``spmm_btile_xla``): ``P = tiles (TG*8,128) @ X[cb] (128,K)`` per
step as one batched einsum, then a segment-sum of the (8, K) tile rows into
their global row blocks.

SDDMM (``sddmm_btile_xla``): gathers each step's TG*8 A rows, multiplies
against ``B[cb]^T`` and masks with the tile pattern.

Both contractions run at ``Precision.HIGHEST`` (fp32, not TF32).

Applicability: tile fill ≥ ``1/max_slots_per_nnz`` (scattered matrices
degenerate to 1 nnz/tile — they route to the gather engines instead).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.host import HostCSR
from .dispatch import register_spmm, register_sddmm
from .clos import _register

TILE_R = 8
TILE_C = 128
BAND = 1024                  # rows per band (= 128 rowblocks)
RB_PER_BAND = BAND // TILE_R


class BTileBuildError(ValueError):
    pass


@partial(_register, data_fields=("tiles", "patt", "tgt", "step_g", "step_cb",
                                 "step_t0", "step_nt", "tile_rb", "tile_cb"),
         meta_fields=("shape", "nnz", "nnz_expanded", "ntiles", "nsteps",
                      "tg", "ngroups", "ncb"))
@dataclasses.dataclass(frozen=True)
class BTile:
    tiles: jnp.ndarray    # (nsteps*TG*8, 128) fp32 dense tile slabs
    patt: jnp.ndarray     # (nsteps*TG*8, 128) int8 structural pattern (1 at
                          # stored nnz, incl. explicit zeros)
    tgt: jnp.ndarray      # (nsteps, TG*8) int32 local target row in band
    step_g: jnp.ndarray   # (nsteps,) int32 band of each step
    step_cb: jnp.ndarray  # (nsteps,) int32 column block of each step
    step_t0: jnp.ndarray  # (nsteps,) int32 first tile id of the step
    step_nt: jnp.ndarray  # (nsteps,) int32 live tile count of the step
    tile_rb: jnp.ndarray  # (ntiles,) int32 global rowblock (XLA/gold path)
    tile_cb: jnp.ndarray  # (ntiles,) int32 global colblock (XLA/gold path)
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    ntiles: int
    nsteps: int
    tg: int               # tiles per step
    ngroups: int          # row bands
    ncb: int              # column blocks

    format_name = "BTILE"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mem_footprint_bytes(self) -> int:
        return int(self.tiles.size * self.tiles.dtype.itemsize
                   + self.patt.size + self.tgt.size * 4
                   + self.step_g.size * 16 + self.tile_rb.size * 8)


def build_btile(csr: HostCSR, dtype=jnp.float32, tg: int = 32,
                max_slots_per_nnz: float = 64.0) -> BTile:
    """Compile host CSR into a BTILE program.

    Raises :class:`BTileBuildError` when tile fill is too low (slots/nnz
    above ``max_slots_per_nnz``) — the tile stream would be HBM-wasteful.
    """
    dt = np.dtype(dtype)
    m, n, nnz = csr.m, csr.n, csr.nnz
    if m == 0 or nnz == 0:
        raise BTileBuildError("empty matrix")
    ia = csr.ia.astype(np.int64)
    ja = csr.ja.astype(np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64),
                     np.diff(ia).astype(np.int64))
    rb = rows >> 3
    cb = ja >> 7
    g = rows >> 10
    ngroups = (m + BAND - 1) // BAND
    ncb = max((n + TILE_C - 1) // TILE_C, 1)

    key = (g * ncb + cb) * (1 + ((m - 1) >> 3)) + rb   # g-major, cb, rb
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    first = np.ones(nnz, bool)
    first[1:] = key_s[1:] != key_s[:-1]
    tile_of_sorted = np.cumsum(first) - 1
    ntiles = int(tile_of_sorted[-1]) + 1
    if ntiles * (TILE_R * TILE_C) > max_slots_per_nnz * nnz:
        raise BTileBuildError(
            f"{ntiles * TILE_R * TILE_C / nnz:.0f} slots/nnz "
            "(tile fill too low — not a BTILE matrix)")

    t_first = np.flatnonzero(first)
    tile_rb = rb[order][t_first]
    tile_cb = cb[order][t_first]
    tile_g = g[order][t_first]

    # dense tile slabs + structural pattern (explicit-zero values must not
    # change tile liveness or the SDDMM mask)
    tiles = np.zeros((ntiles, TILE_R, TILE_C), dt)
    tiles[tile_of_sorted, rows[order] & 7, ja[order] & 127] = \
        csr.a[order].astype(dt)
    patt = np.zeros((ntiles, TILE_R, TILE_C), np.int8)
    patt[tile_of_sorted, rows[order] & 7, ja[order] & 127] = 1

    # steps: split each (g, cb) run into ceil(run/TG) steps
    run_key = tile_g * ncb + tile_cb
    run_first = np.ones(ntiles, bool)
    run_first[1:] = run_key[1:] != run_key[:-1]
    run_starts = np.flatnonzero(run_first)
    run_ends = np.append(run_starts[1:], ntiles)

    step_g_l, step_cb_l, step_tiles_l = [], [], []
    for s, e in zip(run_starts, run_ends):
        for t0 in range(s, e, tg):
            step_g_l.append(int(tile_g[s]))
            step_cb_l.append(int(tile_cb[s]))
            step_tiles_l.append((t0, min(t0 + tg, e)))
    # every band needs >= 1 step (unvisited out blocks stay garbage)
    present = np.zeros(ngroups, bool)
    present[np.array(step_g_l, np.int64)] = True
    for gg in np.flatnonzero(~present):
        step_g_l.append(int(gg))
        step_cb_l.append(0)
        step_tiles_l.append((0, 0))
    o = np.argsort(np.array(step_g_l), kind="stable")   # keep g-major
    step_g_a = np.array(step_g_l, np.int32)[o]
    step_cb_a = np.array(step_cb_l, np.int32)[o]
    step_tiles_l = [step_tiles_l[i] for i in o]

    nsteps = len(step_tiles_l)
    tiles_p = np.zeros((nsteps, tg, TILE_R, TILE_C), dt)
    patt_p = np.zeros((nsteps, tg, TILE_R, TILE_C), np.int8)
    tgt = np.zeros((nsteps, tg * TILE_R), np.int32)
    step_t0 = np.zeros(nsteps, np.int32)
    step_nt = np.zeros(nsteps, np.int32)
    for i, (t0, t1) in enumerate(step_tiles_l):
        k = t1 - t0
        step_t0[i], step_nt[i] = t0, k
        if k == 0:
            continue
        tiles_p[i, :k] = tiles[t0:t1]
        patt_p[i, :k] = patt[t0:t1]
        loc = (tile_rb[t0:t1] - step_g_a[i] * RB_PER_BAND).astype(np.int32)
        tgt[i, : k * TILE_R] = (np.repeat(loc, TILE_R) * TILE_R
                                + np.tile(np.arange(TILE_R,
                                                    dtype=np.int32), k))

    return BTile(
        tiles=jnp.asarray(tiles_p.reshape(nsteps * tg * TILE_R, TILE_C)),
        patt=jnp.asarray(patt_p.reshape(nsteps * tg * TILE_R, TILE_C)),
        tgt=jnp.asarray(tgt),
        step_g=jnp.asarray(step_g_a),
        step_cb=jnp.asarray(step_cb_a),
        step_t0=jnp.asarray(step_t0),
        step_nt=jnp.asarray(step_nt),
        tile_rb=jnp.asarray(tile_rb.astype(np.int32)),
        tile_cb=jnp.asarray(tile_cb.astype(np.int32)),
        shape=(m, n), nnz=nnz, nnz_expanded=csr.nnz_expanded,
        ntiles=ntiles, nsteps=nsteps, tg=tg, ngroups=ngroups, ncb=ncb)


# ---------------------------------------------------------------- SpMM

def _x_blocks(A: BTile, X: jnp.ndarray, dtype) -> jnp.ndarray:
    n, k = X.shape
    return jnp.pad(X.astype(dtype),
                   ((0, A.ncb * TILE_C - n), (0, 0)))


@register_spmm("BTILE", "xla")
def spmm_btile_xla(A: BTile, X: jnp.ndarray) -> jnp.ndarray:
    """XLA lowering of the same tile program (correctness reference)."""
    xp = _x_blocks(A, X, jnp.float32)
    k = X.shape[1]
    tiles = A.tiles.reshape(A.nsteps, A.tg, TILE_R, TILE_C)
    xb = xp.reshape(A.ncb, TILE_C, k)
    xg = xb[A.step_cb]                                    # (nsteps, 128, K)
    p = jnp.einsum("stij,sjk->stik", tiles, xg,
                   precision=jax.lax.Precision.HIGHEST)   # (nsteps,TG,8,K)
    # scatter by global row block
    loc_rb = A.tgt.reshape(A.nsteps, A.tg, TILE_R)[:, :, 0] // TILE_R
    grb = A.step_g[:, None] * RB_PER_BAND + loc_rb        # (nsteps, TG)
    nrb = A.ngroups * RB_PER_BAND
    y = jax.ops.segment_sum(
        p.reshape(A.nsteps * A.tg, TILE_R * k),
        grb.reshape(-1), num_segments=nrb)
    return y.reshape(nrb * TILE_R, k)[: A.m]


def execute_btile_numpy(A: BTile, X: np.ndarray) -> np.ndarray:
    """float64 host reference of the compiled program semantics."""
    n, k = X.shape
    xp = np.zeros((A.ncb * TILE_C, k))
    xp[:n] = X
    xb = xp.reshape(A.ncb, TILE_C, k)
    tiles = np.asarray(A.tiles, np.float64).reshape(
        A.nsteps, A.tg, TILE_R, TILE_C)
    y = np.zeros((A.ngroups * BAND, k))
    sg = np.asarray(A.step_g)
    scb = np.asarray(A.step_cb)
    tgt = np.asarray(A.tgt).reshape(A.nsteps, A.tg, TILE_R)
    for i in range(A.nsteps):
        p = tiles[i] @ xb[scb[i]]                 # (TG, 8, K)
        base = sg[i] * BAND
        for t in range(A.tg):
            y[base + tgt[i, t, 0]: base + tgt[i, t, 0] + TILE_R] += p[t]
    return y[: A.m]


# ---------------------------------------------------------------- SDDMM

@register_sddmm("BTILE", "xla")
def sddmm_btile_xla(A: BTile, Am: jnp.ndarray, Bm: jnp.ndarray
                    ) -> jnp.ndarray:
    k = Am.shape[1]
    ap = jnp.pad(Am.astype(jnp.float32),
                 ((0, A.ngroups * BAND - Am.shape[0]), (0, 0)))
    bp = jnp.pad(Bm.astype(jnp.float32),
                 ((0, A.ncb * TILE_C - Bm.shape[0]), (0, 0)))
    tgt = A.tgt.reshape(A.nsteps, A.tg * TILE_R)
    grow = A.step_g[:, None] * BAND + tgt                 # (nsteps, TG*8)
    a_rows = ap[grow.reshape(-1)]                         # (nsteps*TG*8, K)
    bb = bp.reshape(A.ncb, TILE_C, k)[A.step_cb]          # (nsteps, 128, K)
    prod = jnp.einsum(
        "sik,sjk->sij",
        a_rows.reshape(A.nsteps, A.tg * TILE_R, k), bb,
        precision=jax.lax.Precision.HIGHEST)
    mask = (A.patt != 0).astype(jnp.float32)
    return prod.reshape(A.nsteps * A.tg * TILE_R, TILE_C) * mask


def sddmm_slab_to_csr_values(A: BTile, slab: jnp.ndarray,
                             csr: HostCSR) -> np.ndarray:
    """Extract per-nnz values (CSR order) from the slab layout (host)."""
    sl = np.asarray(slab).reshape(A.nsteps, A.tg, TILE_R, TILE_C)
    # rebuild the nnz -> (step, tile slot, r, c) map exactly as build did
    ia = csr.ia.astype(np.int64)
    ja = csr.ja.astype(np.int64)
    rows = np.repeat(np.arange(csr.m, dtype=np.int64),
                     np.diff(ia).astype(np.int64))
    rb = rows >> 3
    cb = ja >> 7
    g = rows >> 10
    key = (g * A.ncb + cb) * (1 + ((csr.m - 1) >> 3)) + rb
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    first = np.ones(csr.nnz, bool)
    first[1:] = key_s[1:] != key_s[:-1]
    tile_of = np.cumsum(first) - 1
    # tile -> (step, slot): structural, from the build's recorded per-step
    # tile ranges (value-inferred liveness broke on explicit zeros)
    t0s = np.asarray(A.step_t0, np.int64)
    nts = np.asarray(A.step_nt, np.int64)
    tile_ids = (np.repeat(t0s, nts)
                + (np.arange(int(nts.sum())) - np.repeat(
                    np.cumsum(nts) - nts, nts)))
    step_of_tile = np.empty(A.ntiles, np.int64)
    slot_of_tile = np.empty(A.ntiles, np.int64)
    step_of_tile[tile_ids] = np.repeat(np.arange(A.nsteps), nts)
    slot_of_tile[tile_ids] = (np.arange(int(nts.sum()))
                              - np.repeat(np.cumsum(nts) - nts, nts))
    out = np.empty(csr.nnz)
    out[order] = sl[step_of_tile[tile_of], slot_of_tile[tile_of],
                    (rows[order] & 7), (ja[order] & 127)]
    return out
