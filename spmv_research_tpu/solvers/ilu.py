"""ILU(0) / IC(0) factorization and level-scheduled sparse triangular solves.

Required by BASELINE.json config #4 (beyond the reference's workloads; the
reference's preconditioning is Jacobi-only — ``bench_cg.cpp:116-135``).

Host/device split (SURVEY.md §7 "hard parts"):
* numeric factorization is inherently sequential along rows → host-side
  (numpy row sweep; a C++ implementation can swap in transparently),
* triangular solves are level-scheduled: the host computes the dependency
  levels (rows within a level are independent), pads each level to uniform
  (rows × row-length) tiles, and the device executes one `lax.scan` over
  levels — each step is a dense gather-multiply-reduce, no data-dependent
  control flow.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.host import HostCSR, INDEX_DTYPE


def ilu0(csr: HostCSR) -> Tuple[HostCSR, HostCSR]:
    """ILU(0): incomplete LU with zero fill-in on the pattern of A.

    Returns (L, U): L unit-lower-triangular (diagonal ones stored), U upper
    triangular. Host numeric (IKJ variant restricted to the sparsity
    pattern).
    """
    if csr.m != csr.n:
        raise ValueError("ILU0 requires square matrix")
    m = csr.m
    ia, ja = csr.ia.astype(np.int64), csr.ja.astype(np.int64)
    a = csr.a.astype(np.float64).copy()

    # column position lookup per row for pattern-restricted updates
    diag_ptr = np.full(m, -1, dtype=np.int64)
    for i in range(m):
        s, e = ia[i], ia[i + 1]
        row_cols = ja[s:e]
        # factor: for k in cols < i with a[ik] != 0
        for idx in range(s, e):
            k = ja[idx]
            if k >= i:
                break
            # a[i,k] /= u[k,k]
            dk = diag_ptr[k]
            if dk < 0 or a[dk] == 0.0:
                raise ZeroDivisionError(f"zero pivot at row {k}")
            a[idx] /= a[dk]
            lik = a[idx]
            # a[i,j] -= l[i,k] * u[k,j] for j > k on row i's pattern
            ks, ke = ia[k], ia[k + 1]
            k_cols = ja[ks:ke]
            sel = k_cols > k
            if not sel.any():
                continue
            u_cols = k_cols[sel]
            u_vals = a[ks:ke][sel]
            # match columns present in row i (pattern restriction)
            pos = np.searchsorted(row_cols, u_cols)
            pos = np.clip(pos, 0, row_cols.size - 1)
            hit = row_cols[pos] == u_cols
            a[s + pos[hit]] -= lik * u_vals[hit]
        dp = np.searchsorted(row_cols, i)
        if dp < row_cols.size and row_cols[dp] == i:
            diag_ptr[i] = s + dp
        else:
            raise ValueError(f"missing diagonal in row {i} (run fix_diagonal_zeros)")
        # pivot perturbation (SuperLU-style): a vanishing U diagonal makes
        # later L entries explode -> fp32 inf/NaN in the level schedule
        # (round-3: raefsky3 trisolve rows shipped mape=nan). Floor the
        # pivot at 1e-4 x the row scale; ILU0 is approximate anyway and a
        # perturbed preconditioner beats a NaN one.
        dv = a[diag_ptr[i]]
        row_scale = float(np.max(np.abs(a[s:e]))) or 1.0
        tiny = 1e-4 * row_scale
        if abs(dv) < tiny:
            a[diag_ptr[i]] = tiny if dv >= 0.0 else -tiny

    # split into L (strict lower + unit diag) and U (diag + upper)
    rows = np.repeat(np.arange(m, dtype=np.int64), csr.row_lengths())
    lower = rows > ja
    upper = rows <= ja
    L = _from_triplets(rows[lower], ja[lower], a[lower], m, add_unit_diag=True)
    U = _from_triplets(rows[upper], ja[upper], a[upper], m, add_unit_diag=False)
    return L, U


def ic0(csr: HostCSR) -> HostCSR:
    """IC(0): incomplete Cholesky on the lower-triangular pattern of SPD A.
    Returns L with A ≈ L·Lᵀ."""
    if csr.m != csr.n:
        raise ValueError("IC0 requires square matrix")
    m = csr.m
    Adense_cols = {}
    ia, ja = csr.ia.astype(np.int64), csr.ja.astype(np.int64)
    a = csr.a.astype(np.float64)
    # build per-row dicts of the lower pattern
    Lrows = [dict() for _ in range(m)]
    for i in range(m):
        for idx in range(ia[i], ia[i + 1]):
            j = ja[idx]
            if j <= i:
                Lrows[i][j] = a[idx]
    for i in range(m):
        for j in sorted(Lrows[i]):
            s = Lrows[i][j]
            for k in Lrows[i]:
                if k < j and k in Lrows[j]:
                    s -= Lrows[i][k] * Lrows[j][k]
            if j < i:
                Lrows[i][j] = s / Lrows[j][j]
            else:
                if s <= 0:
                    raise ValueError(f"IC0 breakdown at row {i} (not SPD enough)")
                Lrows[i][i] = np.sqrt(s)
    rows, cols, vals = [], [], []
    for i in range(m):
        for j, v in sorted(Lrows[i].items()):
            rows.append(i)
            cols.append(j)
            vals.append(v)
    return _from_triplets(np.array(rows, np.int64), np.array(cols, np.int64),
                          np.array(vals), m, add_unit_diag=False)


def _from_triplets(rows, cols, vals, m, add_unit_diag: bool) -> HostCSR:
    if add_unit_diag:
        rows = np.concatenate([rows, np.arange(m, dtype=np.int64)])
        cols = np.concatenate([cols, np.arange(m, dtype=np.int64)])
        vals = np.concatenate([vals, np.ones(m)])
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    ia = np.zeros(m + 1, dtype=np.int64)
    np.add.at(ia, rows + 1, 1)
    np.cumsum(ia, out=ia)
    return HostCSR(a=vals, ia=ia.astype(INDEX_DTYPE),
                   ja=cols.astype(INDEX_DTYPE), m=m, n=m)


# ---------------------------------------------------------------- trisolve

class SchedulePaddingError(ValueError):
    """Dense level schedule would exceed the padding budget."""


@dataclasses.dataclass
class LevelSchedule:
    """Level-scheduled triangular structure, padded uniform for `lax.scan`."""

    rows: jnp.ndarray      # (n_levels, R) row ids (pad: m)
    cols: jnp.ndarray      # (n_levels, R, W) off-diag column ids (pad: 0)
    vals: jnp.ndarray      # (n_levels, R, W) off-diag values (pad: 0)
    inv_diag: jnp.ndarray  # (n_levels, R) 1/diag per row (pad: 0)
    n_levels: int
    m: int
    lower: bool


jax.tree_util.register_dataclass(
    LevelSchedule, data_fields=["rows", "cols", "vals", "inv_diag"],
    meta_fields=["n_levels", "m", "lower"])


def build_level_schedule(T: HostCSR, lower: bool = True,
                         dtype=jnp.float32) -> LevelSchedule:
    """Compute dependency levels: level(i) = 1 + max(level(j)) over off-diag
    neighbours j of row i (j < i for lower, j > i for upper)."""
    m = T.m
    ia, ja = T.ia.astype(np.int64), T.ja.astype(np.int64)
    vals = T.a.astype(np.float64)
    level = np.zeros(m, dtype=np.int64)
    row_iter = range(m) if lower else range(m - 1, -1, -1)
    for i in row_iter:
        s, e = ia[i], ia[i + 1]
        nb = ja[s:e]
        nb = nb[nb < i] if lower else nb[nb > i]
        if nb.size:
            level[i] = level[nb].max() + 1
    n_levels = int(level.max()) + 1 if m else 1

    # group rows by level
    order = np.argsort(level, kind="stable")
    counts = np.bincount(level, minlength=n_levels)
    R = int(counts.max()) if m else 1
    lengths = T.row_lengths()
    offd = lengths - 1  # off-diagonal count per row (diag always present)
    W = max(int(offd.max()) if m else 0, 1)

    # the dense (n_levels, R, W) padding explodes on scattered matrices
    # with deep dependency chains (the scircuit twin's schedule reaches
    # tens of GB) — refuse with a clean error so build_schedule falls back to the
    # chunked formulation. Bound computed from the REAL dtypes (the old
    # (W+1)*8 estimate admitted ~3 GB schedules past a 2 GB guard).
    val_isz = np.dtype(dtype).itemsize
    idx_isz = np.dtype(INDEX_DTYPE).itemsize
    pad_bytes = n_levels * R * (W * (idx_isz + val_isz)
                                + 2 * idx_isz + val_isz)
    if pad_bytes > (1 << 28):
        raise SchedulePaddingError(
            f"level schedule too padded ({pad_bytes / 1e9:.1f} GB: "
            f"{n_levels} levels x {R} rows x {W} width) — use the chunked "
            "schedule (build_schedule falls back automatically)")

    rows_arr = np.full((n_levels, R), m, dtype=INDEX_DTYPE)
    cols_arr = np.zeros((n_levels, R, W), dtype=INDEX_DTYPE)
    vals_arr = np.zeros((n_levels, R, W), dtype=np.float64)
    invd_arr = np.zeros((n_levels, R), dtype=np.float64)
    fill = np.zeros(n_levels, dtype=np.int64)
    for i in order:
        lv = level[i]
        r = fill[lv]
        fill[lv] += 1
        rows_arr[lv, r] = i
        s, e = ia[i], ia[i + 1]
        w = 0
        diag = None
        for idx in range(s, e):
            j = ja[idx]
            if j == i:
                diag = vals[idx]
            else:
                cols_arr[lv, r, w] = j
                vals_arr[lv, r, w] = vals[idx]
                w += 1
        if diag is None or diag == 0.0:
            raise ValueError(f"missing/zero diagonal at row {i}")
        invd_arr[lv, r] = 1.0 / diag

    return LevelSchedule(
        rows=jnp.asarray(rows_arr),
        cols=jnp.asarray(cols_arr),
        vals=jnp.asarray(vals_arr.astype(np.dtype(dtype))),
        inv_diag=jnp.asarray(invd_arr.astype(np.dtype(dtype))),
        n_levels=n_levels,
        m=m,
        lower=lower,
    )


@dataclasses.dataclass
class ChunkSchedule:
    """Slot-chunked level schedule: memory bounded by nnz + n_levels·C.

    The dense ``LevelSchedule`` pads to (n_levels, max_rows, max_width) and
    explodes on scattered matrices with deep dependency chains (the
    scircuit twin's schedule reaches tens of GB). Here the solve
    is a ``lax.scan`` over fixed-size chunks of ``C`` slots, slots ordered
    (level, row); a level's slots are padded to whole chunks, rows wider
    than ``C`` straddle chunks via a scalar carry. Per-slot cost is 20 B.
    """

    cols: jnp.ndarray   # (n_chunks, C) int32 col ids (pad: m = zero sink)
    vals: jnp.ndarray   # (n_chunks, C) off-diag values (pad 0)
    sid: jnp.ndarray    # (n_chunks, C) int32 local segment id, sorted
    rows: jnp.ndarray   # (n_chunks, C) int32 target row per segment (pad m)
    invd: jnp.ndarray   # (n_chunks, C) 1/diag per segment (pad 0)
    cont: jnp.ndarray   # (n_chunks,) bool — segment 0 continues prev chunk
    tail: jnp.ndarray   # (n_chunks,) bool — last segment continues onward
    last_sid: jnp.ndarray  # (n_chunks,) int32 — last live segment id
    n_chunks: int
    m: int
    C: int
    lower: bool

    # dense-schedule interface parity (reporting)
    @property
    def n_levels(self):
        return self.n_chunks


jax.tree_util.register_dataclass(
    ChunkSchedule,
    data_fields=["cols", "vals", "sid", "rows", "invd", "cont", "tail",
                 "last_sid"],
    meta_fields=["n_chunks", "m", "C", "lower"])


def build_chunk_schedule(T: HostCSR, lower: bool = True, dtype=jnp.float32,
                         C: int = 512) -> ChunkSchedule:
    """Build the chunked level schedule (see :class:`ChunkSchedule`)."""
    m = T.m
    ia, ja = T.ia.astype(np.int64), T.ja.astype(np.int64)
    vals = T.a.astype(np.float64)
    level = np.zeros(m, dtype=np.int64)
    row_iter = range(m) if lower else range(m - 1, -1, -1)
    for i in row_iter:
        s, e = ia[i], ia[i + 1]
        nb = ja[s:e]
        nb = nb[nb < i] if lower else nb[nb > i]
        if nb.size:
            level[i] = level[nb].max() + 1
    n_levels = int(level.max()) + 1 if m else 1
    order = np.argsort(level, kind="stable")

    # per-row off-diag slots (>= 1: zero-offd rows get one dummy slot)
    dt = np.dtype(dtype)
    cols_l, vals_l, sid_l, rows_l, invd_l = [], [], [], [], []
    cont_l, tail_l, last_l = [], [], []

    cur_cols = []     # growing slot lists of the current chunk
    cur_vals = []
    cur_sid = []
    seg_rows = []     # (C,) per-segment row target / invd of current chunk
    seg_invd = []
    cur_cont = False
    nseg = 0

    def flush(tail):
        nonlocal cur_cols, cur_vals, cur_sid, seg_rows, seg_invd
        nonlocal cur_cont, nseg
        k = len(cur_cols)
        if k == 0 and not tail:
            return
        cols_l.append(np.pad(np.array(cur_cols, np.int64), (0, C - k),
                             constant_values=m))
        vals_l.append(np.pad(np.array(cur_vals, np.float64), (0, C - k)))
        sid_l.append(np.pad(np.array(cur_sid, np.int64), (0, C - k),
                            constant_values=max(nseg - 1, 0)))
        r = np.full(C, m, np.int64)
        d = np.zeros(C, np.float64)
        r[:len(seg_rows)] = seg_rows
        d[:len(seg_invd)] = seg_invd
        rows_l.append(r)
        invd_l.append(d)
        cont_l.append(cur_cont)
        tail_l.append(tail)
        last_l.append(max(nseg - 1, 0))
        cur_cols, cur_vals, cur_sid = [], [], []
        seg_rows, seg_invd = [], []
        cur_cont = tail
        nseg = 1 if tail else 0
        if tail:
            seg_rows.append(m)       # placeholder; final chunk sets real row
            seg_invd.append(0.0)

    prev_level = 0
    for i in order:
        lv = level[i]
        if lv != prev_level:
            flush(False)             # levels never share a chunk
            prev_level = lv
        s, e = ia[i], ia[i + 1]
        jj = ja[s:e]
        off = jj != i
        oc, ov = jj[off], vals[s:e][off]
        dsel = np.flatnonzero(~off)
        if dsel.size == 0 or vals[s + dsel[0]] == 0.0:
            raise ValueError(f"missing/zero diagonal at row {i}")
        dv = 1.0 / vals[s + dsel[0]]
        if oc.size == 0:             # zero-offd row: one dummy slot
            oc, ov = np.array([m], np.int64), np.array([0.0])
        if 0 < len(cur_cols) and len(cur_cols) + oc.size > C \
                and oc.size <= C:
            flush(False)             # small row starts a fresh chunk
        pos = 0
        sidv = None                  # this row's segment in current chunk
        while pos < oc.size:
            take = min(oc.size - pos, C - len(cur_cols))
            if sidv is None:
                if cur_cont and len(cur_cols) == 0:
                    sidv = 0         # tail flush pre-allocated segment 0
                else:
                    sidv = nseg
                    seg_rows.append(m)
                    seg_invd.append(0.0)
                    nseg += 1
            cur_cols.extend(oc[pos:pos + take].tolist())
            cur_vals.extend(ov[pos:pos + take].tolist())
            cur_sid.extend([sidv] * take)
            pos += take
            if pos < oc.size:        # straddles: carry to next chunk
                flush(True)
                sidv = None
            else:                    # final chunk of the row: completes here
                seg_rows[sidv] = i
                seg_invd[sidv] = dv
    flush(False)

    n_chunks = max(len(cols_l), 1)
    if not cols_l:
        cols_l = [np.full(C, m, np.int64)]
        vals_l = [np.zeros(C)]
        sid_l = [np.zeros(C, np.int64)]
        rows_l = [np.full(C, m, np.int64)]
        invd_l = [np.zeros(C)]
        cont_l, tail_l, last_l = [False], [False], [0]
    return ChunkSchedule(
        cols=jnp.asarray(np.stack(cols_l).astype(INDEX_DTYPE)),
        vals=jnp.asarray(np.stack(vals_l).astype(dt)),
        sid=jnp.asarray(np.stack(sid_l).astype(INDEX_DTYPE)),
        rows=jnp.asarray(np.stack(rows_l).astype(INDEX_DTYPE)),
        invd=jnp.asarray(np.stack(invd_l).astype(dt)),
        cont=jnp.asarray(np.array(cont_l)),
        tail=jnp.asarray(np.array(tail_l)),
        last_sid=jnp.asarray(np.array(last_l, INDEX_DTYPE)),
        n_chunks=n_chunks, m=m, C=C, lower=lower)


class BandScheduleError(ValueError):
    """Matrix outside the band-block formulation's budget."""


@dataclasses.dataclass
class BandBlockSchedule:
    """Band-block back-substitution: the dense-matmul trisolve for banded
    factors.

    The level-scheduled solves are latency-bound: every scan step does an
    element gather + segment sum over <= C slots. For banded factors (the RCM'd
    FEM class the solver set mostly is) there is a gather-free
    formulation: partition rows into B-row blocks; with bandwidth(T)
    <= Q*B, block k depends only on the Q preceding (following, for
    upper) blocks, so

        x_k = invD_k @ (b_k - C_k @ w_k)

    where D_k is the dense diagonal block (inverted at build, in fp64),
    C_k the dense (B, Q*B) coupling strip, and w_k the running window of
    the Q previous block solutions. The whole solve is one ``lax.scan``
    of two dense matmuls per step (fp32 at ``Precision.HIGHEST``), zero
    gathers. Densifying
    the band costs 4*m*(Q+1)*B bytes; the builder refuses matrices where
    that exceeds ``max_bytes`` (scattered factors keep the chunked scan).
    """

    invD: jnp.ndarray   # (K, B, B) inverted diagonal blocks
    C: jnp.ndarray      # (K, B, Q*B) coupling strips
    # outlier side-channel: entries beyond the Q*B band (generated twins
    # carry scattered tails that inflate max-bandwidth far past the bulk
    # band). They are gathered per block from the full solved prefix —
    # few by construction (build caps them at 2% of nnz), so the 15 ns/
    # element gather cost stays negligible. Empty (R_out=0) when the
    # whole matrix fits the band.
    olcols: jnp.ndarray  # (K, R_out) int32 carry-space x index (pad: sink)
    olvals: jnp.ndarray  # (K, R_out) values (pad 0)
    olrow: jnp.ndarray   # (K, R_out) int32 local row (pad: B)
    m: int
    B: int
    Q: int
    K: int
    lower: bool

    @property
    def n_levels(self):
        return self.K


jax.tree_util.register_dataclass(
    BandBlockSchedule, data_fields=["invD", "C", "olcols", "olvals",
                                    "olrow"],
    meta_fields=["m", "B", "Q", "K", "lower"])


def build_band_block_schedule(T: HostCSR, lower: bool = True,
                              dtype=jnp.float32, B: int = 512,
                              max_bytes: int = int(5e9)
                              ) -> BandBlockSchedule:
    # max_bytes 5 GB: the L+U pair of the widest banded solver twin
    # (mc2depi_dd: 4.8 + 3.3 GB) must fit HBM together with x/b; the
    # densified strips stream once per solve, so a 4.8 GB schedule still
    # solves in ~6 ms (~1.5 GFLOPS nominal) vs 0.05 on the chunked walk.
    m = T.m
    if m == 0:
        raise BandScheduleError("empty matrix")
    rows = np.repeat(np.arange(m, dtype=np.int64), T.row_lengths())
    ja = T.ja.astype(np.int64)
    dist = (rows - ja) if lower else (ja - rows)
    bw = max(int(dist.max()) if dist.size else 0, 0)
    K = (m + B - 1) // B
    Q = max((bw + B - 1) // B, 1)
    if 4 * K * B * B * (Q + 1) > max_bytes:
        # scattered tail inflates max-bandwidth: shrink the band to the
        # budget and push the out-of-band entries to the gather channel
        Q = max(int(max_bytes // (4 * K * B * B)) - 1, 1)
    need = 4 * K * B * B * (Q + 1)
    if need > max_bytes:
        raise BandScheduleError(
            f"band-block densification {need / 1e9:.1f} GB over budget "
            f"(bandwidth {bw}, Q={Q})")
    out = dist > Q * B
    n_out = int(out.sum())
    if n_out > max(0.02 * T.nnz, 0):
        raise BandScheduleError(
            f"{n_out / max(T.nnz, 1):.1%} of entries beyond the affordable "
            f"{Q}-block band — genuinely scattered, not a banded factor")

    k = rows // B
    li = rows - k * B
    D = np.zeros((K, B, B), np.float64)
    C = np.zeros((K, B, Q * B), np.float64)
    # column offset within [D | C] space: for lower, coupling cols are the
    # Q blocks BEFORE block k (ascending); for upper, the Q blocks after
    jrel = ja - (k - Q) * B if lower else ja - k * B
    dmask = (((jrel >= Q * B) & (jrel < (Q + 1) * B)) if lower
             else (jrel < B)) & ~out
    drel = np.where(dmask, (jrel - Q * B) if lower else jrel, 0)
    np.add.at(D, (k[dmask], li[dmask], drel[dmask]), T.a[dmask])
    cmask = ~dmask & ~out
    crel = jrel[cmask] if lower else jrel[cmask] - B
    np.add.at(C, (k[cmask], li[cmask], crel), T.a[cmask])

    # outlier side-channel (carry-space layout: see _sptrsv_band)
    if n_out:
        ko = k[out]
        cnt = np.bincount(ko, minlength=K)
        R_out = int(cnt.max() + 7) // 8 * 8
        if R_out > 8192:
            raise BandScheduleError(
                f"outlier row burst {cnt.max()} per block — too scattered")
        sink = K * B + Q * B
        olcols = np.full((K, R_out), sink, np.int64)
        olvals = np.zeros((K, R_out), np.float64)
        olrow = np.full((K, R_out), B, np.int64)
        slot = np.zeros(K, np.int64)
        off = Q * B if lower else 0
        jo, lio, vo = ja[out], li[out], T.a[out]
        for idx in range(n_out):
            kk = ko[idx]
            s = slot[kk]
            slot[kk] = s + 1
            olcols[kk, s] = off + jo[idx]
            olvals[kk, s] = vo[idx]
            olrow[kk, s] = lio[idx]
    else:
        R_out = 0
        olcols = np.zeros((K, 0), np.int64)
        olvals = np.zeros((K, 0), np.float64)
        olrow = np.zeros((K, 0), np.int64)

    # padding rows of the last block solve to 0 via a unit diagonal
    pad = K * B - m
    if pad:
        D[-1, B - pad:, B - pad:][np.diag_indices(pad)] = 1.0
    dz = np.abs(np.diagonal(D, axis1=1, axis2=2)).min()
    if dz == 0.0:
        raise ValueError("zero diagonal in band-block build")
    invD = np.linalg.inv(D)
    return BandBlockSchedule(
        invD=jnp.asarray(invD.astype(np.dtype(dtype))),
        C=jnp.asarray(C.astype(np.dtype(dtype))),
        olcols=jnp.asarray(olcols.astype(INDEX_DTYPE)),
        olvals=jnp.asarray(olvals.astype(np.dtype(dtype))),
        olrow=jnp.asarray(olrow.astype(INDEX_DTYPE)),
        m=m, B=B, Q=Q, K=K, lower=lower)


def _sptrsv_band(sched: BandBlockSchedule, b: jnp.ndarray) -> jnp.ndarray:
    """Carry-space layout: the carried x buffer is
    lower:  [Q*B zeros | block 0 ... block K-1 | sink]
    upper:  [block 0 ... block K-1 | Q*B zeros | sink]
    so block k's coupling window is always a contiguous Q*B slice and
    the outlier gather indexes solved blocks directly."""
    B, Q, K, m = sched.B, sched.Q, sched.K, sched.m
    dt = sched.invD.dtype
    b2 = jnp.pad(jnp.asarray(b, dt), (0, K * B - m)).reshape(K, B)
    has_out = sched.olvals.shape[1] > 0
    off = Q * B if sched.lower else 0

    def step(xf, xs):
        invD_k, C_k, b_k, kk, oc, ov, orw = xs
        wstart = kk * B if sched.lower else (kk + 1) * B
        w = jax.lax.dynamic_slice(xf, (wstart,), (Q * B,))
        t = b_k - jnp.dot(C_k, w, precision=jax.lax.Precision.HIGHEST)
        if has_out:
            g = ov * xf.at[oc].get(mode="promise_in_bounds")
            t = t - jax.ops.segment_sum(g, orw, num_segments=B + 1)[:B]
        x_k = jnp.dot(invD_k, t, precision=jax.lax.Precision.HIGHEST)
        xf = jax.lax.dynamic_update_slice(xf, x_k, (off + kk * B,))
        return xf, x_k

    xf0 = jnp.zeros(K * B + Q * B + 1, dt)
    ks = jnp.arange(K, dtype=jnp.int32)
    _, ys = jax.lax.scan(
        step, xf0,
        (sched.invD, sched.C, b2, ks, sched.olcols, sched.olvals,
         sched.olrow),
        reverse=not sched.lower)
    return ys.reshape(-1)[:m]


def build_schedule(T: HostCSR, lower: bool = True, dtype=jnp.float32,
                   band_block: bool = True):
    """Band-block matmul solve for banded factors; dense level schedule when
    its padding is modest; chunked-scan program otherwise."""
    if band_block:
        try:
            return build_band_block_schedule(T, lower=lower, dtype=dtype)
        except BandScheduleError:
            pass
    try:
        return build_level_schedule(T, lower=lower, dtype=dtype)
    except SchedulePaddingError:
        return build_chunk_schedule(T, lower=lower, dtype=dtype)


def _sptrsv_chunked(sched: ChunkSchedule, b: jnp.ndarray) -> jnp.ndarray:
    m, C = sched.m, sched.C
    b = jnp.asarray(b, sched.vals.dtype)
    x0 = jnp.zeros(m + 1, dtype=b.dtype)      # slot m = zero sink
    bp = jnp.pad(b, (0, 1))

    def step(state, chunk):
        x, carry = state
        cols, vals, sid, rows, invd, cont, tail, last_sid = chunk
        g = jnp.take(x, cols) * vals
        acc = jax.ops.segment_sum(g, sid, num_segments=C,
                                  indices_are_sorted=True)
        acc = acc.at[0].add(jnp.where(cont, carry, 0.0))
        xi = (jnp.take(bp, rows) - acc) * invd     # pad rows: invd=0 -> 0
        x = x.at[rows].set(xi, mode="drop")
        x = x.at[m].set(0.0)                       # keep the sink zero
        carry_out = jnp.where(tail, acc[last_sid], 0.0)
        return (x, carry_out), None

    (x, _), _ = jax.lax.scan(
        step, (x0, jnp.zeros((), b.dtype)),
        (sched.cols, sched.vals, sched.sid, sched.rows, sched.invd,
         sched.cont, sched.tail, sched.last_sid))
    return x[:m]


def sptrsv(sched, b: jnp.ndarray) -> jnp.ndarray:
    """Solve T x = b via the level schedule (device; one scan over levels)."""
    if isinstance(sched, BandBlockSchedule):
        return _sptrsv_band(sched, b)
    if isinstance(sched, ChunkSchedule):
        return _sptrsv_chunked(sched, b)
    m = sched.m
    b = jnp.asarray(b, sched.vals.dtype)
    x0 = jnp.zeros(m + 1, dtype=b.dtype)  # slot m = padding sink
    bp = jnp.pad(b, (0, 1))

    def step(x, lvl):
        rows, cols, vals, invd = lvl
        gathered = jnp.take(x, cols)                     # (R, W)
        acc = jnp.sum(vals * gathered, axis=1)           # (R,)
        xi = (jnp.take(bp, rows) - acc) * invd
        x = x.at[rows].set(jnp.where(rows < m, xi, x[rows]))
        return x, None

    x, _ = jax.lax.scan(step, x0,
                        (sched.rows, sched.cols, sched.vals, sched.inv_diag))
    return x[:m]


def ilu0_solve(L_sched: LevelSchedule, U_sched: LevelSchedule,
               b: jnp.ndarray) -> jnp.ndarray:
    """x = U⁻¹ L⁻¹ b — the ILU0 preconditioner application."""
    y = sptrsv(L_sched, b)
    return sptrsv(U_sched, y)
