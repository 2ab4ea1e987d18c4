"""Build-time routed butterfly networks — the flagship unstructured-SpMV engine.

Why: the engine was designed for a machine without a usable fine-grained
gather or scatter, where the fast data-movement primitives are static
shifts (rolls) and selects (DESIGN_NOTES.md). So each sparse matrix is
compiled, at format-build time, into a *routing program*: sequences of butterfly exchange stages
(partner = position XOR 2^k) whose per-position take/keep decisions are
precomputed bit-masks. One SpMV call then executes:

    1. **gather network**: x (spread over the slot space) is multicast-routed
       to all nnz slots in CSR order. Built by routing the *reverse* graph
       (slot → its column's position) with merging allowed for equal targets
       — merges in reverse become broadcasts forward; the forward masks are
       the stage-wise transpose, applied in reverse stage order.
    2. multiply by the value array (slot order; padding slots hold 0, which
       also kills any un-routed garbage).
    3. **segmented inclusive scan** by row (Hillis–Steele with per-slot
       "reach" guards): row totals appear at each row's last slot.
    4. **compaction network**: last-slots are routed (injective, monotone) to
       spread y positions; a validity bit-plane zeroes empty-row positions.

Masks are packed as bit-planes of int32 words (bit k ↔ stage k), so the whole
routing program costs ~16-24 bytes/nnz of streaming traffic and ~6 vector
ops per slot per active stage. Elements that lose a routing conflict spill to an
additional additive pass (networks are linear operators, so passes sum).

This plays the role of the reference's per-format SpMV kernels
(``spmv_kernels/*.cpp``) — but where those encode per-ISA SIMD strategies,
this encodes the data movement itself in place of a hardware gather.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..core.host import HostCSR


class RoutingError(ValueError):
    pass


@dataclasses.dataclass
class PassMasks:
    """One network pass.

    ``A``/``B`` hold packed take-own / take-partner bit planes, one bit per
    emitted stage: shape (n_words, N) uint32. ``stages`` lists the emitted
    stages in execution order as (word, bit, k) — the exchange distance is
    2^k; the same k may appear twice (Beneš topology: descending then
    ascending sweep), hence per-stage bit allocation.
    """

    A: np.ndarray  # (n_words, N) uint32
    B: np.ndarray  # (n_words, N) uint32
    stages: Tuple[Tuple[int, int, int], ...]


def benes_order(L: int) -> List[int]:
    """Beneš/double-butterfly stage order: descending distances then
    ascending. Any blocked move gets a second chance at the bit's second
    occurrence, which empirically routes most permutations in 1-2 passes."""
    return list(range(L - 1, -1, -1)) + list(range(L))


def greedy_route(src: np.ndarray, tgt: np.ndarray, L: int, N: int,
                 allow_merge: bool, max_passes: int = 12) -> List[PassMasks]:
    """Route elements from distinct positions `src` to positions `tgt` through
    a Beneš-ordered exchange network, greedily; an element blocked at the
    final occurrence of a needed bit spills to the next (additive) pass. With
    ``allow_merge``, elements with equal targets merge when they meet (their
    values add — correct for reduction flows and reverse-multicast builds).

    Production SpMV programs use exact Waksman routing (zero passes wasted);
    this greedy router is kept as the only *merge-capable* router — the basis
    for future additive-reduction networks (e.g. routed SpGEMM numeric) — and
    as an independent reference for the network executors in tests.
    """
    src = np.asarray(src, np.int64)
    tgt = np.asarray(tgt, np.int64)
    E = src.size
    remaining = np.arange(E, dtype=np.int64)
    passes: List[PassMasks] = []
    order = benes_order(L)
    # is this the last occurrence of bit k in the order?
    is_final = [k not in order[i + 1:] for i, k in enumerate(order)]

    for _ in range(max_passes):
        if remaining.size == 0:
            break
        pos = src[remaining].copy()
        tg = tgt[remaining].copy()
        n_el = remaining.size
        alive = np.ones(n_el, dtype=bool)
        spilled = np.zeros(n_el, dtype=bool)
        # merge forest: when e merges into f, parent[e] = f. If a carrier
        # spills, its whole absorbed group respawns next pass (the merged
        # values die with the carrier's flow).
        parent = np.arange(n_el, dtype=np.int64)
        planes_A: List[np.ndarray] = []
        planes_B: List[np.ndarray] = []
        stage_list: List[Tuple[int, int, int]] = []

        for si, k in enumerate(order):
            d = np.int64(1) << k
            idx = np.nonzero(alive)[0]
            if idx.size == 0:
                break
            p = pos[idx]
            t = tg[idx]
            want = (((p ^ t) >> k) & 1).astype(bool)
            if not want.any():
                continue
            occ = np.full(N, -1, np.int64)
            occ[p] = np.arange(idx.size)
            pe = occ[p ^ d]  # local id of partner element, or -1
            has = pe >= 0
            pe_c = np.where(has, pe, 0)
            partner_want = np.where(has, want[pe_c], False)
            can_move = want & (~has | partner_want)
            if allow_merge:
                merge = want & has & ~partner_want & (t[pe_c] == t) & ~can_move
            else:
                merge = np.zeros(idx.size, dtype=bool)
            blocked = want & ~can_move & ~merge
            sp = blocked if is_final[si] else np.zeros_like(blocked)
            moved = can_move | merge
            new_p = np.where(moved, p ^ d, p)

            if moved.any() or sp.any():
                # a spill-only stage is still emitted: executing it zeroes the
                # spilled element's cell so the dead value can't leak
                bi = len(stage_list)
                w, b = divmod(bi, 32)
                if w == len(planes_A):
                    planes_A.append(np.zeros(N, np.uint32))
                    planes_B.append(np.zeros(N, np.uint32))
                bit = np.uint32(1 << b)
                planes_B[w][new_p[moved]] |= bit
                stay = ~moved & ~sp
                planes_A[w][p[stay]] |= bit
                stage_list.append((w, b, k))
            pos[idx] = new_p
            alive[idx[sp | merge]] = False
            spilled[idx[sp]] = True
            if merge.any():
                parent[idx[merge]] = idx[pe_c[merge]]

        live = np.nonzero(alive)[0]
        if not (pos[live] == tg[live]).all():
            raise RoutingError("bit-fixing failed to reach targets (internal)")
        A = np.stack(planes_A) if planes_A else np.zeros((0, N), np.uint32)
        B = np.stack(planes_B) if planes_B else np.zeros((0, N), np.uint32)
        passes.append(PassMasks(A=A, B=B, stages=tuple(stage_list)))
        # resolve merge roots (path halving); respawn groups whose root spilled
        root = parent.copy()
        while True:
            nxt = root[root]
            if (nxt == root).all():
                break
            root = nxt
        remaining = remaining[spilled[root]]

    if remaining.size:
        raise RoutingError(
            f"{remaining.size} elements unrouted after {max_passes} passes")
    return passes


def apply_pass_numpy(v: np.ndarray, p: PassMasks) -> np.ndarray:
    """Reference executor for one pass (flat XOR-partner form — provably
    equivalent to the kernel's roll/select form).

    Two stage semantics, keyed by the presence of the keep plane:
    * A present (greedy multi-pass nets): out = a·v + b·v[p^d] — unrouted
      cells zero out (kills spilled flows).
    * A absent (exact Waksman nets): default-keep select
      out = b ? v[p^d] : v (half the mask traffic; dead copies are benign
      because every consumer cell is overwritten by its own route).
    """
    N = v.shape[0]
    ix = np.arange(N, dtype=np.int64)
    keep_default = p.A.shape[0] == 0
    for (w, b, k) in p.stages:
        bb = (p.B[w] >> b) & 1
        if keep_default:
            v = np.where(bb == 1, v[ix ^ (1 << k)], v)
        else:
            a = (p.A[w] >> b) & 1
            v = a * v + bb * v[ix ^ (1 << k)]
    return v


# --------------------------------------------------------------------------
# The SpMV routing program
# --------------------------------------------------------------------------

@dataclasses.dataclass
class BflyProgramHost:
    """Host-side compiled routing program for one sparse matrix.

    Pipeline (one SpMV):
      1. ``widen``  — exact Beneš net: x (spread) → first slot of each
         column run in *column-sorted* slot space.
      2. ``fill``   — forward-fill within column runs (shift-select stages;
         take bit at stage k ⇔ highest set bit of run-reach is k).
      3. ``perm``   — exact Beneš net: column-sorted slots → CSR slot order.
      4. multiply by ``vals`` (CSR slot order; 0 on padding kills garbage).
      5. ``scan``   — segmented inclusive sum by row (shift-add, guards
         bit k ⇔ row-reach ≥ 2^k).
      6. ``compact``— exact Beneš net: each row's last slot → y position;
         ``out_valid`` zeroes empty-row positions.
    """

    N: int
    L: int
    m: int
    n: int
    nnz: int
    nnz_expanded: int
    sigma_x: int          # x[c] enters at position c << sigma_x
    sigma_y: int          # y[r] exits at position r << sigma_y
    widen: "PassMasks"
    fill_words: np.ndarray           # (N,) uint32 — bit k ⇔ take at stage k
    fill_stages: Tuple[int, ...]
    perm: "PassMasks"
    vals: np.ndarray                 # (N,) float32/float64, CSR slot order
    scan_guards: np.ndarray          # (N,) uint32 — bit k set ⇔ reach ≥ 2^k
    scan_stages: Tuple[int, ...]
    compact: "PassMasks"
    out_valid: np.ndarray            # (N,) uint8 — 1 at valid y positions

    def mem_footprint_bytes(self) -> int:
        vb = self.vals.dtype.itemsize
        words = (self.widen.A.shape[0] + self.perm.A.shape[0]
                 + self.compact.A.shape[0]) * 2 * 4
        return self.N * (vb + 4 + 4 + words) + self.N

    @property
    def total_stages(self) -> int:
        return (len(self.widen.stages) + len(self.fill_stages)
                + len(self.perm.stages) + len(self.scan_stages)
                + len(self.compact.stages))


def _next_pow2(x: int) -> int:
    return 1 << max(int(x - 1).bit_length(), 0)


def build_bfly_program(csr: HostCSR, dtype=np.float32,
                       max_N: int = 1 << 22) -> BflyProgramHost:
    from .waksman import route_waksman

    m, n, nnz = csr.m, csr.n, csr.nnz
    N = _next_pow2(max(nnz, n, m, 256))
    if N > max_N:
        raise RoutingError(f"matrix too large for single-block bfly (N={N})")
    L = N.bit_length() - 1

    lengths = csr.row_lengths()
    rows = np.repeat(np.arange(m, dtype=np.int64), lengths)
    cols = csr.ja.astype(np.int64)

    sigma_x = L - (_next_pow2(max(n, 1)).bit_length() - 1)
    sigma_y = L - (_next_pow2(max(m, 1)).bit_length() - 1)

    # --- column-sorted slot space -----------------------------------------
    css = np.lexsort((rows, cols))       # nnz ids in (col, row) order
    cols_css = cols[css]
    # run starts: first slot of each distinct column
    first = np.ones(nnz, dtype=bool)
    first[1:] = cols_css[1:] != cols_css[:-1]
    run_start_idx = np.nonzero(first)[0]
    distinct_cols = cols_css[run_start_idx]

    # 1. widen: x position → run start (both strictly increasing; injective)
    widen = route_waksman(distinct_cols << sigma_x, run_start_idx, L, N)

    # 2. fill: take at stage k ⇔ highest set bit of (p − run_start) is k
    run_start_of = np.zeros(N, dtype=np.int64)
    run_start_of[:nnz] = run_start_idx[np.cumsum(first) - 1]
    reach_f = np.arange(N, dtype=np.int64) - run_start_of
    reach_f[nnz:] = 0
    fill_words = np.zeros(N, np.uint32)
    max_rf = int(reach_f[:nnz].max()) if nnz else 0
    fill_stages = []
    for k in range(max_rf.bit_length()):
        hsb = (reach_f > 0) & ((reach_f >> k) == 1)
        if hsb.any():
            fill_words |= hsb.astype(np.uint32) << k
            fill_stages.append(k)

    # 3. perm: column-sorted slot j holds nnz css[j]; its CSR position is
    # css[j] itself (CSR order == input order)
    perm = route_waksman(np.arange(nnz, dtype=np.int64), css.astype(np.int64),
                         L, N) if nnz else route_waksman(
        np.zeros(0, np.int64), np.zeros(0, np.int64), L, N)

    # 4. values & 5. scan guards (CSR slot order) --------------------------
    vals = np.zeros(N, dtype=np.dtype(dtype))
    vals[:nnz] = csr.a.astype(np.dtype(dtype))
    starts = (csr.ia[:-1]).astype(np.int64)
    row_start = np.zeros(N, dtype=np.int64)
    row_start[:nnz] = np.repeat(starts, lengths)
    reach_v = np.arange(N, dtype=np.int64) - row_start
    reach_v[nnz:] = 0
    max_reach = int(reach_v[:nnz].max()) if nnz else 0
    scan_guards = np.zeros(N, dtype=np.uint32)
    scan_stages = tuple(range(max_reach.bit_length()))
    for k in scan_stages:
        scan_guards |= ((reach_v >= (1 << k)).astype(np.uint32) << k)

    # 6. compaction: last slot of each non-empty row → y position ----------
    nonempty = np.nonzero(lengths > 0)[0]
    last_slot = (csr.ia[1:].astype(np.int64) - 1)[nonempty]
    y_pos = nonempty.astype(np.int64) << sigma_y
    compact = route_waksman(last_slot, y_pos, L, N)

    out_valid = np.zeros(N, dtype=np.uint8)
    out_valid[y_pos] = 1

    return BflyProgramHost(
        N=N, L=L, m=m, n=n, nnz=nnz, nnz_expanded=csr.nnz_expanded,
        sigma_x=sigma_x, sigma_y=sigma_y,
        widen=widen, fill_words=fill_words, fill_stages=tuple(fill_stages),
        perm=perm, vals=vals,
        scan_guards=scan_guards, scan_stages=scan_stages,
        compact=compact, out_valid=out_valid,
    )


def execute_numpy(prog: BflyProgramHost, x: np.ndarray) -> np.ndarray:
    """Reference execution of the routing program (float64 capable)."""
    N = prog.N
    x_spread = np.zeros(N, dtype=np.float64)
    x_spread[np.arange(prog.n, dtype=np.int64) << prog.sigma_x] = x[: prog.n]

    v = apply_pass_numpy(x_spread, prog.widen)

    for k in prog.fill_stages:
        d = 1 << k
        take = ((prog.fill_words >> k) & 1) == 1
        shifted = np.zeros_like(v)
        shifted[d:] = v[:-d]
        v = np.where(take, shifted, v)

    v = apply_pass_numpy(v, prog.perm)
    v = v * prog.vals.astype(np.float64)

    for k in prog.scan_stages:
        d = 1 << k
        take = ((prog.scan_guards >> k) & 1) == 1
        shifted = np.zeros_like(v)
        shifted[d:] = v[:-d]
        v = v + np.where(take, shifted, 0.0)

    y = apply_pass_numpy(v, prog.compact)
    y = y * prog.out_valid
    return y[np.arange(prog.m, dtype=np.int64) << prog.sigma_y]
