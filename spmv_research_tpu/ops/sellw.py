"""SELLW: sublane-bound SpMV — the per-slot gather is ONE lane-pick.

A routed answer to the reference's SELL-C-σ / window-locality formats
(``benchmark_code/BENCH/src/spmv_kernels/sell_sorted.cpp``,
``spv8.cpp:243-299`` x-gather role) for matrices with column locality
(banded, generated diagonal/low-bandwidth placement, FEM meshes).

Layout (v2 — per-sublane x2d rows)
----------------------------------
The matrix is cut into **chunks** of 8×128 = 1024 slots. Each chunk serves
one *y block* of 128 consecutive rows; **each sublane s of a chunk is bound
to one arbitrary ``x2d`` row** ``wrow[c·8+s]`` (x reshaped (n/128, 128)):
every nnz with column ``c`` is placed in a sublane bound to ``c // 128``.
The per-slot x-gather therefore needs NO cross-sublane routing — it is a
single ``take_along_axis`` lane-pick. (v1 resolved arbitrary (sublane,
lane) picks inside an 8-row window with a conflict-free rot-select over all
8 groupwise rotations — ~36 full-array passes; binding sublanes at *build*
time deletes all of them, and hot x2d rows simply get several sublanes.)

Rows are packed as contiguous *parts*: a row's nnz on one x2d row form one
part (CSR keeps them consecutive), placed whole into some sublane of that
x2d row's allocation; one row may own parts in several sublanes (one per
x2d row it touches) plus spill chunks of the same block, so no nnz is ever
unrepresentable. ``y = Σ_k out[yidx[k]]`` row-gathers sum the per-chunk
partial y rows.

**Block grouping:** a chunk actually serves a group of ``G`` adjacent y
blocks (``bid`` = log2(G) bits select which; G output planes, one per group
member). For banded matrices adjacent blocks touch mostly the same x2d
rows, so merging their bins amortizes the per-bin last-sublane slack — the
dominant waste (bins of ~80 nnz against 128-slot sublanes) — over G·bin
nnz: slots/nnz on the mac_econ twin 2.70 (G=1) → 2.06 (G=2) → 1.46 (G=4)
→ 1.33 (G=8) (a host-side count, device-independent). The tax is G masked sums in extraction. Lane
conflicts (rows of two grouped blocks with equal ``row mod 128`` ending in
one sublane) are resolved at build by first-fit over the bin's open
sublanes.

Program (``spmv_sellw_xla``, all chunks batched)
------------------------------------------------
1. sublane fill: ``wins[8j+s] = x2d[wrow[8j+s]]`` (a row gather of (1,128)
   x2d rows);
2. gather: ``acc = take_along_axis(wins, lane, axis=1)`` — one op;
3. multiply by the value plane; ``stages``-stage segmented lane scan
   (per-slot guard bits; parts never cross the 128-lane rows, and stages =
   ceil(log2(max part length)) is *adaptive* — banded matrices with short
   rows pay 3 stages, not 7);
4. extraction: per-slot lane-pick of each part's end total (``eidx`` keyed
   by (sublane, row-within-block)), masked sum over the 8 sublanes → one
   (1,128) y-partial row per chunk.

Program bytes: one int32 word + one fp32 value per slot (8 B), plus x and
the tiny per-chunk outputs — against the CLOSG pipeline's ~14 B/slot over
9 passes.

Word bit layout (int32, per slot (s, l) of a chunk):
  [0,7)    lane pick  b     = col mod 128
  [7,14)   scan guard bits  (stage k at bit 7+k)
  [14,21)  eidx             end lane of the part of row l in sublane s
  [21]     emask            (s, l) holds a live part end
  [22,25)  bid              group member the part's row belongs to (< G ≤ 8)
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

_MAX_STAGES = 7         # parts ≤ 128 lanes


class SellWBuildError(ValueError):
    pass


@partial(_register, data_fields=("word", "vals", "wrow", "yidx"),
         meta_fields=("shape", "nnz", "nnz_expanded", "nchunks", "x_rows",
                      "K", "stages", "G"))
@dataclasses.dataclass(frozen=True)
class SellW:
    word: jnp.ndarray   # (8·max(nchunks, 1), 128) int32 packed per-slot word
    vals: jnp.ndarray   # (8·max(nchunks, 1), 128) values (0 in padding)
    wrow: jnp.ndarray   # (8·max(nchunks, 1),) int32 per-sublane x2d row
    yidx: jnp.ndarray   # (K, nblocks) int32 chunk id per y block (nchunks=0)
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    nchunks: int        # live chunks (≤ wrow.shape[0] // 8)
    x_rows: int         # x2d rows (≥ 1)
    K: int              # max chunks per y block
    stages: int         # segmented-scan stages = ceil(log2(max part len))
    G: int = 2          # y blocks grouped per chunk (bid bits = log2 G)

    format_name = "SELLW"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mem_footprint_bytes(self) -> int:
        return int(self.word.size * 4
                   + self.vals.size * self.vals.dtype.itemsize
                   + self.wrow.size * 4 + self.yidx.size * 4)


def _guard_bits(k: int) -> np.ndarray:
    d = np.arange(k, dtype=np.uint32)
    g = np.zeros(k, np.uint32)
    for kk in range(_MAX_STAGES):
        g |= ((d >= (1 << kk)).astype(np.uint32) << kk)
    return g


def build_sellw(csr: HostCSR, dtype=jnp.float32,
                max_chunk_factor: float = 4.0, group: int = 2,
                part_cap: int = 8, want_idx: bool = False) -> SellW:
    """Compile host CSR into a SELLW program.

    ``group`` = G adjacent y blocks share each chunk's bins (power of two
    ≤ 8; larger G amortizes last-sublane slack at the cost of G masked
    extraction sums). Raises :class:`SellWBuildError` when columns are so
    scattered that the slot count (≈ traffic blow-up) would exceed
    ``max_chunk_factor`` × nnz.

    ``part_cap`` (power of two ≤ 128) splits parts longer than the cap
    into sub-parts at build, each with its own extraction cell — the
    masked sublane-sum already adds sub-totals per (bid, lane), so the
    scan depth is bounded by ``log2(part_cap)`` with ZERO extra slots
    (parts pack contiguously; splitting adds no padding). Scan depth is a
    per-slot cost, so capping 64-128-long parts (stages 6-7) at 8
    (stages 3) is the "fewer scan stages for short rows" lever. Cost:
    sub-parts of one row need distinct
    sublanes with a free cell at the row's lane (first-fit handles;
    extreme rows fragment bins across chunks).
    """
    dt = np.dtype(dtype)
    G = int(group)
    cap = int(part_cap)
    if cap < 1 or cap > LANES or (cap & (cap - 1)):
        raise SellWBuildError(f"part_cap must be a power of two <= 128 ({cap})")
    if G not in (1, 2, 4, 8):
        raise SellWBuildError(f"group must be a power of two ≤ 8 ({G})")
    m, n, nnz = csr.m, csr.n, csr.nnz
    if m == 0 or nnz == 0:
        raise SellWBuildError("empty matrix")
    x_rows = max((n + LANES - 1) // LANES, 1)
    nblocks = (m + LANES - 1) // LANES
    ia = csr.ia.astype(np.int64)
    ja = csr.ja.astype(np.int64)

    # fast suitability precheck, sampled: chunks per block GROUP ≈
    # max(ceil(#distinct-x2d-rows / 8), ceil(nnz / 1024)) — scattered
    # matrices (1-2 nnz per x2d row) degenerate to ~128 slots/nnz
    est_slots = est_nnz = 0
    npairs_pre = (nblocks + G - 1) // G
    for b in range(0, npairs_pre, max(npairs_pre // 64, 1)):
        e0 = int(ia[b * G * LANES])
        e1 = int(ia[min((b + 1) * G * LANES, m)])
        if e0 == e1:
            continue
        nb = np.unique(ja[e0:e1] // LANES).size
        nch = max((nb + SUB - 1) // SUB,
                  (e1 - e0 + SUB * LANES - 1) // (SUB * LANES))
        est_slots += nch * SUB * LANES
        est_nnz += e1 - e0
    if est_nnz and est_slots > max_chunk_factor * 1.5 * est_nnz:
        raise SellWBuildError(
            f"estimated {est_slots / est_nnz:.1f} slots/nnz "
            "(no column locality — not a SELLW matrix)")

    chunk_cap = max(int(max_chunk_factor * (nnz / (SUB * LANES) + nblocks)
                        + 64), 64)

    # native packer tier (native/sparse_host.cpp sellw_pack — identical
    # algorithm, ~50x the Python loop; conversion time is a reported metric)
    from ..io import native as _native
    if (_native.have_sellw_pack(cap) and dt == np.float32 and G == 2
            and not (want_idx and not _native.have_sellw_pack(1))):
        packed = _native.sellw_pack_native(
            ia, csr.ja, csr.a.astype(np.float32), m, part_cap=cap,
            want_idx=want_idx)
        word_n, vals_n, wrow_n, pair_n, bids_n, max_part = packed[:6]
        idx_n = packed[6] if want_idx else None
        if pair_n.shape[0] > chunk_cap:
            raise SellWBuildError(
                f"chunk count {pair_n.shape[0]} exceeded {chunk_cap} "
                "(scattered columns)")
        return _emit_sellw(word_n.view(np.uint32), vals_n, wrow_n,
                           list(pair_n), [tuple(bool(b & (1 << g))
                                                for g in range(G))
                                          for b in bids_n],
                           max_part, m, n, nnz, csr.nnz_expanded, x_rows,
                           nblocks, dt, G, idx_u=idx_n)

    wrow_l, word_l, vals_l, idx_l = [], [], [], []
    chunk_pair, chunk_bids = [], []
    gb_cache = {k: _guard_bits(k) for k in range(1, LANES + 1)}
    max_part = 1
    npairs = (nblocks + G - 1) // G

    for pb in range(npairs):
        r0, r1 = pb * G * LANES, min((pb + 1) * G * LANES, m)
        e0, e1 = int(ia[r0]), int(ia[r1])
        if e0 == e1:
            continue
        cols_b = ja[e0:e1]
        vals_b = csr.a[e0:e1].astype(dt)
        lens = ia[r0 + 1:r1 + 1] - ia[r0:r1]
        rowl_b = np.repeat(np.arange(r1 - r0), lens)   # 0..G·128-1 in group
        blk_b = cols_b // LANES
        # parts = maximal runs of equal (row, x2d row); CSR keeps a row's
        # nnz on one x2d row consecutive. Order parts by (x2d row, length
        # desc) so each bin's sublanes fill first-fit with its big parts
        # first (less end-of-sublane slack).
        pstart = np.flatnonzero(np.r_[True, (np.diff(rowl_b) != 0)
                                      | (np.diff(blk_b) != 0)])
        pend = np.append(pstart[1:], cols_b.size)
        plen = pend - pstart
        if cap < LANES and plen.size and int(plen.max()) > cap:
            # split long parts into <= cap sub-parts (see docstring)
            n_pieces = (plen + cap - 1) // cap
            idx = np.repeat(np.arange(plen.size), n_pieces)
            within = (np.arange(idx.size)
                      - np.repeat(np.cumsum(n_pieces) - n_pieces, n_pieces))
            pstart = pstart[idx] + within * cap
            pend = np.minimum(pstart + cap, pend[idx])
            plen = pend - pstart
        porder = np.lexsort((-plen, blk_b[pstart]))
        queue = list(porder)
        while queue:
            wd = np.zeros((SUB, LANES), np.uint32)
            ex = np.zeros((SUB, LANES), np.uint32)  # eidx/emask (ORed last:
            vv = np.zeros((SUB, LANES), dt)         # lanes overlap slots)
            iv = np.full((SUB, LANES), -1, np.int32) if want_idx else None
            wr = np.zeros(SUB, np.int32)
            pos = [0] * SUB
            sub_of = {}         # x2d row -> open sublanes (in open order)
            next_s = 0
            bids = [False] * G
            defer = []
            for t in queue:
                p, q, k = int(pstart[t]), int(pend[t]), int(plen[t])
                r = int(blk_b[p])
                l = int(rowl_b[p])
                lane, bid = l & (LANES - 1), l >> 7
                s = -1
                for so in sub_of.get(r, ()):   # first fit, lane-conflict-free
                    if pos[so] + k <= LANES and not ex[so, lane]:
                        s = so
                        break
                if s < 0:
                    if next_s >= SUB:
                        defer.append(t)
                        continue
                    s, next_s = next_s, next_s + 1
                    sub_of.setdefault(r, []).append(s)
                    wr[s] = r
                wd[s, pos[s]:pos[s] + k] = (
                    (cols_b[p:q] % LANES).astype(np.uint32)
                    | (gb_cache[k] << 7))
                vv[s, pos[s]:pos[s] + k] = vals_b[p:q]
                if want_idx:
                    iv[s, pos[s]:pos[s] + k] = np.arange(e0 + p, e0 + q,
                                                         dtype=np.int32)
                ex[s, lane] = np.uint32(((pos[s] + k - 1) << 14)
                                        | (1 << 21) | (bid << 22))
                pos[s] += k
                bids[bid] = True
                max_part = max(max_part, k)
            wd |= ex
            wrow_l.append(wr)
            word_l.append(wd)
            vals_l.append(vv)
            if want_idx:
                idx_l.append(iv)
            chunk_pair.append(pb)
            chunk_bids.append(tuple(bids))
            queue = defer
            if len(wrow_l) > chunk_cap:
                raise SellWBuildError(
                    f"chunk count exceeded {chunk_cap} (scattered columns)")

    word_u = (np.concatenate(word_l, axis=0) if wrow_l
              else np.zeros((0, LANES), np.uint32))
    vals_u = (np.concatenate(vals_l, axis=0) if wrow_l
              else np.zeros((0, LANES), dt))
    wrow_u = (np.concatenate(wrow_l) if wrow_l
              else np.zeros(0, np.int32))
    idx_u = (np.concatenate(idx_l, axis=0) if want_idx and idx_l
             else (np.zeros((0, LANES), np.int32) if want_idx else None))
    return _emit_sellw(word_u, vals_u, wrow_u, chunk_pair, chunk_bids,
                       max_part, m, n, nnz, csr.nnz_expanded, x_rows,
                       nblocks, dt, G, idx_u=idx_u)


def _emit_sellw(word_u, vals_u, wrow_u, chunk_pair, chunk_bids, max_part,
                m, n, nnz, nnz_expanded, x_rows, nblocks, dt,
                G, idx_u=None):
    """Build yidx and assemble the pytree (shared tail of the native and
    Python packer tiers).

    With ``idx_u`` (per-slot source-nnz plane, -1 empty) returns
    ``(SellW, idx_padded)`` — the DS build (ops/sellw_ds.py) uses it to
    place fp64-pair value planes on the identical routing program."""
    nchunks = len(chunk_pair)
    npad = max(nchunks, 1)      # an empty program keeps one inert chunk
    word = np.zeros((npad * SUB, LANES), np.uint32)
    vals = np.zeros((npad * SUB, LANES), dt)
    wrow = np.zeros(npad * SUB, np.int32)
    word[: nchunks * SUB] = word_u
    vals[: nchunks * SUB] = vals_u
    wrow[: nchunks * SUB] = wrow_u
    idxp = None
    if idx_u is not None:
        idxp = np.full((npad * SUB, LANES), -1, np.int32)
        idxp[: nchunks * SUB] = idx_u

    # output rows: group-member g's partials live at [g·npad, (g+1)·npad),
    # the all-zero row at G·npad
    slot = np.zeros(max(nblocks, 1), np.int64)
    entries = []
    for c, (pb, bids) in enumerate(zip(chunk_pair, chunk_bids)):
        for bid in range(G):
            b = G * pb + bid
            if bids[bid] and b < nblocks:
                entries.append((b, c + bid * npad))
                slot[b] += 1
    K = max(int(slot.max()) if nblocks else 1, 1)
    if K > 64:
        raise SellWBuildError(f"y-block multiplicity {K} > 64")
    yidx = np.full((K, nblocks), G * npad, np.int32)   # G·npad = zero row
    slot[:] = 0
    for b, row in entries:
        yidx[slot[b], b] = row
        slot[b] += 1

    A = SellW(word=jnp.asarray(word.view(np.int32)),
              vals=jnp.asarray(vals), wrow=jnp.asarray(wrow),
              yidx=jnp.asarray(yidx), shape=(m, n), nnz=nnz,
              nnz_expanded=nnz_expanded, nchunks=nchunks,
              x_rows=x_rows, K=K,
              stages=int(max_part - 1).bit_length(),
              G=G)
    if idxp is not None:
        return A, idxp
    return A


# ---------------------------------------------------------------- execution

def _x_plane(A: SellW, x, dtype):
    return jnp.pad(x.astype(dtype),
                   (0, A.x_rows * LANES - x.shape[0])).reshape(
                       A.x_rows, LANES)


def _combine_y(A: SellW, planes):
    outp = jnp.concatenate(
        list(planes) + [jnp.zeros((1, LANES), planes[0].dtype)], axis=0)
    y2 = outp.at[A.yidx].get(mode="promise_in_bounds").sum(axis=0)
    return y2.reshape(-1)[: A.m]


@register_spmv("SELLW", "xla")
def spmv_sellw_xla(A: SellW, x: jnp.ndarray) -> jnp.ndarray:
    nch = A.wrow.shape[0] // SUB
    x2d = _x_plane(A, x, A.vals.dtype)
    wins = x2d.at[A.wrow].get(mode="promise_in_bounds")    # (nch·8, 128)
    w = A.word
    v = jnp.take_along_axis(wins, w & 0x7F, axis=1) * A.vals
    for k in range(A.stages):
        guard = ((w >> (7 + k)) & 1) != 0
        v = v + jnp.where(guard, jnp.roll(v, 1 << k, axis=1), 0.0)
    E = jnp.take_along_axis(v, (w >> 14) & 0x7F, axis=1)
    live = ((w >> 21) & 1) != 0
    bid = (w >> 22) & (A.G - 1)
    planes = [jnp.where(live & (bid == g), E, 0.0)
              .reshape(nch, SUB, LANES).sum(axis=1) for g in range(A.G)]
    return _combine_y(A, planes)


def execute_sellw_numpy(A: SellW, x: np.ndarray) -> np.ndarray:
    """float64 host reference of the compiled program (program semantics)."""
    nch = int(A.wrow.shape[0]) // SUB
    x2d = np.zeros(A.x_rows * LANES)
    x2d[: x.shape[0]] = x
    x2d = x2d.reshape(A.x_rows, LANES)
    w = np.asarray(A.word).view(np.uint32)
    wins = x2d[np.asarray(A.wrow)]
    v = (np.take_along_axis(wins, (w & 0x7F).astype(np.int64), axis=1)
         * np.asarray(A.vals).astype(np.float64))
    for k in range(A.stages):
        guard = ((w >> (7 + k)) & 1) != 0
        v = v + np.where(guard, np.roll(v, 1 << k, axis=1), 0.0)
    E = np.take_along_axis(v, ((w >> 14) & 0x7F).astype(np.int64), axis=1)
    live = ((w >> 21) & 1) != 0
    bid = (w >> 22) & (A.G - 1)
    planes = [np.where(live & (bid == g), E, 0.0)
              .reshape(nch, SUB, LANES).sum(axis=1) for g in range(A.G)]
    outp = np.concatenate(planes + [np.zeros((1, LANES))], axis=0)
    y2 = outp[np.asarray(A.yidx)].sum(axis=0)
    return y2.reshape(-1)[: A.m]


# ------------------------------------------------------------------- SpMM

@register_spmm("SELLW", "xla")
def spmm_sellw_xla(A: SellW, X: jnp.ndarray) -> jnp.ndarray:
    return jnp.stack([spmv_sellw_xla(A, X[:, k])
                      for k in range(X.shape[1])], axis=1)
