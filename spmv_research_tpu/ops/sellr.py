"""SELLR: group-pure sublane-bound SpMV program.

Third-generation locality engine (successor to SELLW, ``sellw.py``): the
reference role is still the SELL-C-σ / column-locality format family
(``benchmark_code/BENCH/src/spmv_kernels/sell_sorted.cpp``,
``spv8.cpp:243-299``), designed around three constraints:

* a streamed program of 8 B/slot with no serialized scatter;
* no per-chunk dynamic read-modify-write of y;
* slots/nnz (packing density) multiplies directly into time: SELLW's
  G=2 block grouping wastes 2–4× in sublane slack.

Layout
------
Rows are cut into **groups** of 1024 (= 8 y2d rows of 128 lanes).  Within a
group, nnz are binned by x2d row (``col >> 7``); a bin's *parts* (maximal
(row, x2d-row) runs, split at 128) are packed into **sublane lists** of 128
slots bound to that x2d row.  Chunks = 8 sublane lists of one group (group-
pure).  Density: one bin per (group, x2d row) — slack only at each bin's
last sublane, ~1.05–1.2 slots/nnz on banded matrices.

Per-slot word (int32):
  [0,7)    lane pick  (col & 127)
  [7,14)   scan guard bits (stage k at bit 7+k; part pos d: bit k = d≥2^k)
  [14,21)  eidx — the *source* lane of this target's part end, stored at the
           target lane (row & 127) of the part's own sublane
  [21]     emask — live part end at this (sublane, lane)
  [22,25)  roll r   = (tsrow - sublane) mod 8   (tsrow = (row>>7) & 7)
  [25]     wrap     = sublane + r >= 8

Program (``sellr_xla_raw``)
---------------------------
row-gather wins (per-sublane (1,128) x2d rows) → lane-pick gather →
multiply → segmented lane scan → eidx pick → emask → masked sublane rolls
place each part sum at (tsrow, row&127) of its chunk plane → chunk planes
summed into their group's (8,128) y rows.

Applicability: column locality (banded / post-RCM / generated diagonal).
The builder raises :class:`SellRBuildError` for scattered matrices
(estimated slots/nnz too high) — those route to CLOSG.
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
from .clos_route import LANES, SUB

GROUP = SUB * LANES          # 1024 rows per group
NB = 64                      # chunks per metadata step
META_BLK = 1024              # int32 per-step metadata block
_MAX_STAGES = 7


class SellRBuildError(ValueError):
    pass


@partial(_register, data_fields=("word", "vals", "smeta"),
         meta_fields=("shape", "nnz", "nnz_expanded", "nchunks", "x_rows",
                      "y_rows", "stages", "rolls"))
@dataclasses.dataclass(frozen=True)
class SellR:
    word: jnp.ndarray    # (8·nch_pad, 128) int32 packed per-slot word
    vals: jnp.ndarray    # (8·nch_pad, 128) fp32 values (0 in padding)
    smeta: jnp.ndarray   # (nsteps·1024,) int32: per step, [0,512) wrow per
                         # sublane; [512,576) per-chunk first y2d row
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    nchunks: int         # live chunks
    x_rows: int          # x2d rows (≥ 1)
    y_rows: int          # y2d rows incl. pad to multiple of 8
    stages: int          # segmented-scan stages
    rolls: Tuple[Tuple[int, int], ...]  # static (r, wrap) roll set, r>0

    format_name = "SELLR"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mem_footprint_bytes(self) -> int:
        return int(self.word.size * 4
                   + self.vals.size * self.vals.dtype.itemsize
                   + self.smeta.size * 4)


def _guard_bits(k: int) -> np.ndarray:
    d = np.arange(k, dtype=np.uint32)
    g = np.zeros(k, np.uint32)
    for kk in range(_MAX_STAGES):
        g |= ((d >= (1 << kk)).astype(np.uint32) << kk)
    return g


def build_sellr(csr: HostCSR, dtype=jnp.float32,
                max_slot_factor: float = 3.0) -> SellR:
    """Compile host CSR into a SELLR program.

    Raises :class:`SellRBuildError` when the matrix has no column locality
    (estimated slots/nnz > ``max_slot_factor``).
    """
    dt = np.dtype(dtype)
    m, n, nnz = csr.m, csr.n, csr.nnz
    if m == 0 or nnz == 0:
        raise SellRBuildError("empty matrix")
    x_rows = max((n + LANES - 1) // LANES, 1)
    ngroups = (m + GROUP - 1) // GROUP
    y_rows = ngroups * SUB
    ia = csr.ia.astype(np.int64)
    ja = csr.ja.astype(np.int64)

    # fast suitability precheck (sampled): slots/group ≈ Σ_bins
    # (binlen + 64): scattered matrices degenerate to ~128 slots/nnz.
    est_slots = est_nnz = 0
    for g in range(0, ngroups, max(ngroups // 64, 1)):
        e0 = int(ia[g * GROUP])
        e1 = int(ia[min((g + 1) * GROUP, m)])
        if e0 == e1:
            continue
        xr, cnt = np.unique(ja[e0:e1] // LANES, return_counts=True)
        est_slots += int(np.ceil(cnt / LANES).sum()) * LANES
        est_nnz += e1 - e0
    if est_nnz and est_slots > max_slot_factor * est_nnz:
        raise SellRBuildError(
            f"estimated {est_slots / est_nnz:.1f} slots/nnz "
            "(no column locality — not a SELLR matrix)")

    gb_cache = {k: _guard_bits(k) for k in range(1, LANES + 1)}
    word_l, vals_l, wrow_l = [], [], []       # per sublane (128,) arrays
    chunk_of = []                             # per chunk: group id
    max_part = 1

    a32 = csr.a.astype(dt)
    for g in range(ngroups):
        r0, r1 = g * GROUP, min((g + 1) * GROUP, m)
        e0, e1 = int(ia[r0]), int(ia[r1])
        if e0 == e1:
            continue
        cols = ja[e0:e1]
        vals_b = a32[e0:e1]
        lens = (ia[r0 + 1:r1 + 1] - ia[r0:r1]).astype(np.int64)
        rowl = np.repeat(np.arange(r1 - r0, dtype=np.int64), lens)
        xrow = cols >> 7
        lane = (cols & 127).astype(np.uint32)
        # parts: maximal runs of (rowl, xrow), split at 128
        brk = np.flatnonzero(np.r_[True, (np.diff(rowl) != 0)
                                   | (np.diff(xrow) != 0)])
        pstart = brk
        pend = np.append(brk[1:], cols.size)
        plen = pend - pstart
        # split long parts
        if plen.max(initial=0) > LANES:
            ps, pe = [], []
            for s, e in zip(pstart, pend):
                while e - s > LANES:
                    ps.append(s)
                    pe.append(s + LANES)
                    s += LANES
                ps.append(s)
                pe.append(e)
            pstart = np.array(ps, np.int64)
            pend = np.array(pe, np.int64)
            plen = pend - pstart
        # bin by xrow; within bin by target sublane (tsrow) so sublane
        # lists come out tsrow-pure (dist 0 after modal assignment), then
        # longest-first
        order = np.lexsort((-plen, rowl[pstart] >> 7, xrow[pstart]))
        # allocator state: per open sublane of current bin
        sub_words, sub_vals, sub_wrow = [], [], []   # this group's sublanes
        sub_tcnt = []                                # tsrow histogram
        open_pos, open_taken, open_idx = [], [], []  # current bin's subs
        cur_xrow = -1
        for t in order:
            p, e = int(pstart[t]), int(pend[t])
            k = e - p
            xr = int(xrow[p])
            rl = int(rowl[p])
            tlane = rl & 127
            tsrow = rl >> 7
            if xr != cur_xrow:
                cur_xrow = xr
                open_pos, open_taken, open_idx = [], [], []
            s = -1
            # restrict first-fit to the newest 2 open sublanes: backtracking
            # into older tails mixes tsrows into one list, which grows the
            # roll set (one masked pass over the planes per roll)
            for q in range(max(0, len(open_pos) - 2), len(open_pos)):
                if open_pos[q] + k <= LANES and not (
                        open_taken[q] >> tlane) & 1:
                    s = q
                    break
            if s < 0:
                open_pos.append(0)
                open_taken.append(0)
                open_idx.append(len(sub_words))
                sub_words.append(np.zeros(LANES, np.uint32))
                sub_vals.append(np.zeros(LANES, dt))
                sub_wrow.append(xr)
                sub_tcnt.append([0] * SUB)
                s = len(open_pos) - 1
            si = open_idx[s]
            pos = open_pos[s]
            # |= : bits [0,14) (slot data) are written once per slot; the
            # eidx/emask/roll bits [14,26) of other parts may already live
            # at these lanes and must be preserved
            sub_words[si][pos:pos + k] |= lane[p:e] | (gb_cache[k] << 7)
            sub_vals[si][pos:pos + k] = vals_b[p:e]
            # eidx entry at the target lane (may be inside another part's
            # slot range — word bits [14,26) are disjoint from [0,14))
            sub_words[si][tlane] |= np.uint32(((pos + k - 1) << 14)
                                              | (1 << 21))
            open_pos[s] = pos + k
            open_taken[s] |= 1 << tlane
            max_part = max(max_part, k)
            sub_tcnt[si][tsrow] += 1
            # roll bits depend on final sublane position in chunk: record
            # tsrow now, fix at pack time
            sub_words[si][tlane] |= np.uint32(tsrow << 22)  # staging: tsrow
        # pack this group's sublane lists into group-pure chunks; within a
        # chunk, assign each list to the sublane of its modal tsrow when
        # free (dist becomes 0 for tsrow-pure lists -> the roll set stays
        # small on banded matrices)
        nsub = len(sub_words)
        # order lists so each chunk sees ~one list per modal tsrow: bucket
        # by modal tsrow, emit round-robin
        buckets = [[] for _ in range(SUB)]
        for si in range(nsub):
            buckets[int(np.argmax(sub_tcnt[si]))].append(si)
        rr_order = []
        bi = [0] * SUB
        while len(rr_order) < nsub:
            for b in range(SUB):
                if bi[b] < len(buckets[b]):
                    rr_order.append(buckets[b][bi[b]])
                    bi[b] += 1
        for c0 in range(0, nsub, SUB):
            members = [rr_order[q] for q in range(c0, min(c0 + SUB, nsub))]
            modal = {si: int(np.argmax(sub_tcnt[si])) for si in members}
            slot_of = {}
            taken_s = [False] * SUB
            for si in sorted(members, key=lambda q: -max(sub_tcnt[q])):
                want = modal[si]
                for d in range(SUB):
                    s = (want + d) % SUB
                    if not taken_s[s]:
                        taken_s[s] = True
                        slot_of[si] = s
                        break
            for s in range(SUB):
                si = next((q for q in members if slot_of[q] == s), None)
                if si is not None:
                    wd = sub_words[si]
                    # rewrite bits [22,26): r = (tsrow - s) mod 8, wrap
                    em = (wd >> 21) & 1
                    tsrow_v = (wd >> 22) & 0x7
                    r = (tsrow_v - s) % 8
                    wrap = ((s + r) >= SUB).astype(np.uint32)
                    wd = (wd & np.uint32((1 << 22) - 1)) | (r << 22) \
                        | (wrap << 25)
                    wd &= np.uint32(0x03FFFFFF)
                    # dead eidx entries keep bits zero
                    wd = np.where(em == 1, wd,
                                  wd & np.uint32(~(0xFFF << 14) & 0xFFFFFFFF))
                    word_l.append(wd)
                    vals_l.append(sub_vals[si])
                    wrow_l.append(sub_wrow[si])
                else:
                    word_l.append(np.zeros(LANES, np.uint32))
                    vals_l.append(np.zeros(LANES, dt))
                    wrow_l.append(0)
            chunk_of.append(g)

    nchunks = len(chunk_of)
    if nchunks == 0:
        raise SellRBuildError("no chunks built")

    if nchunks * SUB * LANES > max_slot_factor * max(nnz, 1) * 4 + 65536:
        raise SellRBuildError(
            f"{nchunks * SUB * LANES / nnz:.1f} slots/nnz after build")
    nsteps = (nchunks + NB - 1) // NB
    nch_pad = nsteps * NB
    word = np.zeros((nch_pad * SUB, LANES), np.uint32)
    vals = np.zeros((nch_pad * SUB, LANES), dt)
    word[: nchunks * SUB] = np.stack(word_l)
    vals[: nchunks * SUB] = np.stack(vals_l)
    wrow = np.zeros(nch_pad * SUB, np.int32)
    wrow[: nchunks * SUB] = np.array(wrow_l, np.int32)

    # roll set (static, from live eidx entries)
    em = (word >> 21) & 1
    rcode_all = np.where(em == 1, ((word >> 22) & 0xF), 0)
    pairs = sorted({(int(c & 7), int(c >> 3))
                    for c in np.unique(rcode_all).tolist()} - {(0, 0)})
    rolls = tuple(pairs)

    # smeta: per step 1024 ints: [0,512) sublane wrows; [512,576) chunk meta
    smeta = np.zeros(nsteps * META_BLK, np.int32)
    cmeta = np.zeros(nch_pad, np.int32)
    cmeta[:nchunks] = np.asarray(chunk_of, np.int32) * SUB
    for i in range(nsteps):
        smeta[i * META_BLK: i * META_BLK + NB * SUB] = \
            wrow[i * NB * SUB: (i + 1) * NB * SUB]
        smeta[i * META_BLK + NB * SUB: i * META_BLK + NB * SUB + NB] = \
            cmeta[i * NB: (i + 1) * NB]

    return SellR(word=jnp.asarray(word.view(np.int32)),
                 vals=jnp.asarray(vals), smeta=jnp.asarray(smeta),
                 shape=(m, n), nnz=nnz, nnz_expanded=csr.nnz_expanded,
                 nchunks=nchunks, x_rows=x_rows, y_rows=y_rows,
                 stages=int(max_part - 1).bit_length(), rolls=rolls)


# ---------------------------------------------------------------- execution

def _x_plane(A: SellR, x, dtype):
    return jnp.pad(x.astype(dtype),
                   (0, A.x_rows * LANES - x.shape[0])).reshape(
                       A.x_rows, LANES)


def sellr_xla_raw(word, vals, smeta, x2d, *, stages, rolls, x_rows,
                  y_rows):
    """Raw-array SELLR program: x2d (x_rows, 128) -> y2d (y_rows, 128).

    Takes the program as plain arrays so the SPMD distributed layer can
    pass stacked per-shard programs through ``shard_map``."""
    del x_rows                        # implied by x2d's shape
    nch = word.shape[0] // SUB
    nsteps = nch // NB
    meta = smeta.reshape(nsteps, META_BLK)
    wrow = meta[:, : NB * SUB].reshape(-1)
    cmeta = meta[:, NB * SUB: NB * SUB + NB].reshape(-1)
    w = word
    wins = x2d.at[wrow].get(mode="promise_in_bounds")
    v = jnp.take_along_axis(wins, w & 0x7F, axis=1) * vals
    for k in range(stages):
        guard = ((w >> (7 + k)) & 1) != 0
        v = v + jnp.where(guard, jnp.roll(v, 1 << k, axis=1), 0.0)
    E = jnp.take_along_axis(v, (w >> 14) & 0x7F, axis=1)
    live = ((w >> 21) & 1) != 0
    P = jnp.where(live, E, 0.0)
    # place at (tsrow, lane) within each chunk: roll per (r, wrap)
    rcode = (w >> 22) & 0xF
    R = jnp.where(live & (rcode == 0), P, 0.0)
    for (r, wrap) in rolls:
        mask = live & (rcode == (r | (wrap << 3)))
        Q3 = jnp.where(mask, P, 0.0).reshape(nch, SUB, LANES)
        R = R + jnp.roll(Q3, r, axis=1).reshape(nch * SUB, LANES)
    # scatter chunk planes to y groups (dead chunks carry all-zero planes)
    seg = jnp.repeat(cmeta // SUB, SUB) * SUB + jnp.tile(
        jnp.arange(SUB), nch)
    return jax.ops.segment_sum(R, seg, num_segments=y_rows)


@register_spmv("SELLR", "xla")
def spmv_sellr_xla(A: SellR, x: jnp.ndarray) -> jnp.ndarray:
    y2 = sellr_xla_raw(A.word, A.vals, A.smeta, _x_plane(A, x, A.vals.dtype),
                       stages=A.stages, rolls=A.rolls, x_rows=A.x_rows,
                       y_rows=A.y_rows)
    return y2.reshape(-1)[: A.m]


def execute_sellr_numpy(A: SellR, x: np.ndarray) -> np.ndarray:
    """float64 host reference of the compiled program semantics."""
    nch = int(A.word.shape[0]) // SUB
    nsteps = nch // NB
    smeta = np.asarray(A.smeta).reshape(nsteps, META_BLK)
    wrow = smeta[:, : NB * SUB].reshape(-1)
    cmeta = smeta[:, NB * SUB: NB * SUB + NB].reshape(-1)
    x2d = np.zeros(A.x_rows * LANES)
    x2d[: x.shape[0]] = x
    x2d = x2d.reshape(A.x_rows, LANES)
    w = np.asarray(A.word).view(np.uint32)
    wins = x2d[wrow]
    v = (np.take_along_axis(wins, (w & 0x7F).astype(np.int64), axis=1)
         * np.asarray(A.vals).astype(np.float64))
    for k in range(A.stages):
        guard = ((w >> (7 + k)) & 1) != 0
        v = v + np.where(guard, np.roll(v, 1 << k, axis=1), 0.0)
    E = np.take_along_axis(v, ((w >> 14) & 0x7F).astype(np.int64), axis=1)
    live = ((w >> 21) & 1) != 0
    P = np.where(live, E, 0.0)
    rcode = (w >> 22) & 0xF
    R = np.where(live & (rcode == 0), P, 0.0)
    for (r, wrap) in A.rolls:
        mask = live & (rcode == (r | (wrap << 3)))
        Q = np.where(mask, P, 0.0).reshape(nch, SUB, LANES)
        R = R + np.roll(Q, r, axis=1).reshape(nch * SUB, LANES)
    y2 = np.zeros((A.y_rows, LANES))
    for c in range(nch):
        yb = int(cmeta[c])
        y2[yb: yb + SUB] += R[c * SUB: (c + 1) * SUB]
    return y2.reshape(-1)[: A.m]


@register_spmm("SELLR", "xla")
def spmm_sellr_xla(A: SellR, X: jnp.ndarray) -> jnp.ndarray:
    return jnp.stack([spmv_sellr_xla(A, X[:, k])
                      for k in range(X.shape[1])], axis=1)
