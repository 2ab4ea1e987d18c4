"""SPMD distributed CLOSGX — the scattered-matrix multi-chip path.

Round-2 left scattered matrices on the MPMD ``device_put`` loop
(``dist_closg.py``): every shard's CLOSG program had its own shapes, so no
single SPMD program could run them. CLOSGX (``ops/clos_xl.py``) already
forces every *chunk* to one canonical shape; this module extends the same
trick across *shards*: each device's chunk stack is padded to the shard
maximum (dead chunks are inert — zero guards/values, ``yslot`` -1 on every
row, unreferenced by ``ymap``), every static (stages, mrp, C) is the
max over shards, and one ``shard_map`` program executes everywhere.

Strategy: rows are nnz-balanced across devices (128-aligned boundaries,
``partition_rows_nnz_balanced``); x is *sharded* on the device axis and
``all_gather``\\ed over the interconnect inside the step — the right exchange for
scattered matrices, whose column support spans the whole vector (the
reference's dense shared-memory x, SURVEY §2.8; ring column-blocks only
pay off with column locality, which is SELLR's domain —
``dist_sellr.py``).

Weak-scaling model (DESIGN_NOTES "Distributed scattered" section): per
step t ≈ max_d t_chip(nnz_d) + t_ag(n·4B over the links) with t_chip ≈
slots_d / rate_CLOSG; the builder records per-shard slots/nnz
(``DistClosGX.shard_slots`` / ``shard_nnz``) so the model runs on real
build outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..core.host import HostCSR
from ..ops.clos_xl import ClosGX, build_clos_gather_xl, spmv_closgx_xla
from ..ops.clos_route import LANES
from .dist import partition_rows_nnz_balanced

_LEAF_FIELDS = ("rowidx", "vals", "r1", "r2", "r3", "yslot", "ymap")


@dataclasses.dataclass(frozen=True)
class DistClosGX:
    """Per-device ClosGX programs stacked on a leading device axis."""

    leaves: dict               # name -> (k, ...) jnp array
    statics: dict              # uniform ClosGX meta fields
    mesh: Mesh
    axis: str
    row_starts: Tuple[int, ...]   # k+1 row boundaries (128-aligned)
    m: int
    n: int
    n_pad: int                 # x length padded to k*LANES multiple
    shard_nnz: Tuple[int, ...]
    shard_slots: Tuple[int, ...]  # live chunk slots per shard (C_live*N)
    # allgather-overlap variant: entries whose columns
    # fall in the device's OWN x shard are split out at build into a second
    # program family that runs on xloc BEFORE the all_gather result is
    # needed — XLA's latency-hiding scheduler overlaps the gather with
    # the local-column compute (no data dependence). None = un-overlapped.
    leaves_loc: dict = None       # local-column family (k, ...) arrays
    statics_loc: dict = None

    @property
    def k(self):
        return len(self.row_starts) - 1

    @property
    def overlapped(self):
        return self.leaves_loc is not None

    def mem_footprint_bytes(self) -> int:
        tot = sum(v.size * v.dtype.itemsize for v in self.leaves.values())
        if self.leaves_loc:
            tot += sum(v.size * v.dtype.itemsize
                       for v in self.leaves_loc.values())
        return int(tot)


def _rows_slice(csr: HostCSR, r0: int, r1: int) -> HostCSR:
    ia = csr.ia.astype(np.int64)
    e0, e1 = int(ia[r0]), int(ia[r1])
    return HostCSR(a=csr.a[e0:e1].copy(),
                   ia=(csr.ia[r0:r1 + 1] - csr.ia[r0]).astype(np.int32),
                   ja=csr.ja[e0:e1].copy(), m=r1 - r0, n=csr.n)


def _pad_family(shards, chunk_N, Rp_floor=0):
    """Pad a per-shard ClosGX program list to shard-uniform shapes;
    returns (leaves, statics, Rp)."""
    C = max(s.n_chunks for s in shards)
    stages = max(s.stages for s in shards)
    mrp = max(s.mrp for s in shards)
    Rp = max(max(s.ymap.shape[0] for s in shards), Rp_floor)
    S = shards[0].rowidx.shape[1]
    V = shards[0].V

    def pad_leaf(name):
        outs = []
        for s in shards:
            a = np.asarray(getattr(s, name))
            if name == "ymap":
                pad = np.zeros(Rp - a.shape[0], a.dtype)
                outs.append(np.concatenate([a, pad]))
                continue
            shape = list(a.shape)
            tgt = {"rowidx": (C, S), "vals": (C, S, LANES),
                   "r1": (C, S, LANES), "r2": (C,) + a.shape[1:],
                   "r3": (C, S, LANES), "yslot": (C, mrp, LANES)}[name]
            out = np.zeros(tgt, a.dtype)
            if name == "yslot":
                out[:] = -1           # padded rows read no slot
            sl = tuple(slice(0, d) for d in shape)
            out[sl] = a
            outs.append(out)
        return jnp.asarray(np.stack(outs))

    leaves = {f: pad_leaf(f) for f in _LEAF_FIELDS}
    n = shards[0].n
    statics = dict(shape=(Rp * LANES, n), nnz=0, nnz_expanded=0,
                   N=chunk_N, V=V, x_rows=(n + LANES - 1) // LANES,
                   stages=stages, mrp=mrp)
    return leaves, statics, Rp


def _nonempty(h: HostCSR) -> HostCSR:
    """ClosGX build needs >=1 nnz: inject one zero-value entry (inert)."""
    if h.nnz:
        return h
    ia = np.zeros(h.m + 1, np.int32)
    ia[1:] = 1
    return HostCSR(a=np.zeros(1), ia=ia, ja=np.zeros(1, np.int32),
                   m=h.m, n=h.n)


def _split_cols(h: HostCSR, lo: int, hi: int):
    """(local cols in [lo,hi) shifted to 0, remote cols unchanged)."""
    rows = np.repeat(np.arange(h.m), np.diff(h.ia.astype(np.int64)))
    loc = (h.ja >= lo) & (h.ja < hi)

    def mk(mask, ja, n):
        ia = np.zeros(h.m + 1, np.int64)
        np.add.at(ia, rows[mask] + 1, 1)
        np.cumsum(ia, out=ia)
        return HostCSR(a=h.a[mask].copy(), ia=ia.astype(np.int32),
                       ja=ja[mask].astype(np.int32), m=h.m, n=n)

    return (mk(loc, h.ja - lo, hi - lo), mk(~loc, h.ja, h.n))


def build_dist_closgx(csr: HostCSR, mesh: Mesh, axis: str = "d",
                      dtype=jnp.float32, chunk_N: int = 1 << 20,
                      max_chunks: int = 256,
                      overlap: bool = False) -> DistClosGX:
    k = mesh.shape[axis]
    m, n = csr.m, csr.n
    if m < k * LANES:
        raise ValueError(
            f"matrix too small for {k}-way 128-aligned sharding "
            f"(m={m} < {k * LANES}); use fewer devices or the single-chip "
            "path (collapsed zero-row shards fail obscurely)")
    # 128-aligned nnz-balanced row boundaries
    starts = partition_rows_nnz_balanced(csr, k)
    starts = [min((s + LANES - 1) // LANES * LANES, m) for s in starts]
    starts[0], starts[-1] = 0, m
    # guard against collapsed shards after alignment
    for i in range(1, k):
        if starts[i] <= starts[i - 1]:
            starts[i] = min(starts[i - 1] + LANES, m)
    n_pad = ((n + k * LANES - 1) // (k * LANES)) * (k * LANES)
    row_slices = [_rows_slice(csr, starts[d], starts[d + 1])
                  for d in range(k)]
    build = lambda h: build_clos_gather_xl(  # noqa: E731
        _nonempty(h), dtype=dtype, chunk_N=chunk_N, max_chunks=max_chunks)

    if not overlap:
        shards = [build(h) for h in row_slices]
        leaves, statics, _ = _pad_family(shards, chunk_N)
        return DistClosGX(
            leaves=leaves, statics=statics, mesh=mesh, axis=axis,
            row_starts=tuple(starts), m=m, n=n, n_pad=n_pad,
            shard_nnz=tuple(s.nnz for s in shards),
            shard_slots=tuple(s.n_chunks * chunk_N for s in shards))

    # overlap: per shard, split columns into the device's OWN x block
    # (computed from xloc, overlapping the gather) and the remote rest
    nloc = n_pad // k
    loc_h, rem_h = [], []
    for d, h in enumerate(row_slices):
        lo = d * nloc
        # pad local-program n to nloc even when it hangs past n
        l, r = _split_cols(h, lo, lo + nloc)
        l = HostCSR(a=l.a, ia=l.ia, ja=l.ja, m=l.m, n=nloc)
        loc_h.append(l)
        rem_h.append(r)
    shards_rem = [build(h) for h in rem_h]
    shards_loc = [build(h) for h in loc_h]
    _, _, Rp0 = _pad_family(shards_rem, chunk_N)
    _, _, Rp1 = _pad_family(shards_loc, chunk_N)
    Rp = max(Rp0, Rp1)           # shared y padding so the adds line up
    leaves, statics, _ = _pad_family(shards_rem, chunk_N, Rp_floor=Rp)
    leaves_l, statics_l, _ = _pad_family(shards_loc, chunk_N, Rp_floor=Rp)
    return DistClosGX(
        leaves=leaves, statics=statics, mesh=mesh, axis=axis,
        row_starts=tuple(starts), m=m, n=n, n_pad=n_pad,
        shard_nnz=tuple(h.nnz for h in row_slices),
        shard_slots=tuple(s.n_chunks * chunk_N
                          for s in shards_rem),
        leaves_loc=leaves_l, statics_loc=statics_l)


def _local_program(D: DistClosGX, local_leaves, statics=None) -> ClosGX:
    return ClosGX(**{f: local_leaves[i]
                     for i, f in enumerate(_LEAF_FIELDS)},
                  **(statics or D.statics))


def dist_spmv_closgx(D: DistClosGX, x_shards: jnp.ndarray) -> jnp.ndarray:
    """x_shards (k, n_pad//k) device-sharded -> stacked local y
    (k, Rp*LANES); assemble with :func:`assemble_y` (host) or slice by
    ``row_starts``."""
    mesh, ax = D.mesh, D.axis
    leaf_list = [D.leaves[f] for f in _LEAF_FIELDS]
    specs_in = (P(ax),) + tuple(P(ax) for _ in leaf_list)

    from functools import partial as _p

    if D.overlapped:
        leaf_list_l = [D.leaves_loc[f] for f in _LEAF_FIELDS]
        specs = specs_in + tuple(P(ax) for _ in leaf_list_l)

        @_p(shard_map, mesh=mesh, check_vma=False, in_specs=specs,
            out_specs=P(ax))
        def f2(xloc, *leaves):
            rem = leaves[: len(_LEAF_FIELDS)]
            loc = leaves[len(_LEAF_FIELDS):]
            # issue the gather FIRST, then the local-column program on
            # xloc — independent of the gather, so the transfer rides
            # under the compute (XLA latency-hiding scheduler)
            xfull = jax.lax.all_gather(xloc, ax, tiled=True)
            Al = _local_program(D, [lv[0] for lv in loc], D.statics_loc)
            y_loc = spmv_closgx_xla(Al, xloc.reshape(-1))
            Ar = _local_program(D, [lv[0] for lv in rem])
            y_rem = spmv_closgx_xla(Ar, xfull.reshape(-1)[: D.n])
            return (y_loc + y_rem)[None]

        return f2(x_shards, *leaf_list, *leaf_list_l)

    @_p(shard_map, mesh=mesh, check_vma=False, in_specs=specs_in,
        out_specs=P(ax))
    def f(xloc, *leaves):
        xfull = jax.lax.all_gather(xloc, ax, tiled=True)
        xfull = xfull.reshape(-1)[: D.n]
        A = _local_program(D, [lv[0] for lv in leaves])
        y = spmv_closgx_xla(A, xfull)
        return y[None]

    return f(x_shards, *leaf_list)


def shard_x(D: DistClosGX, x: np.ndarray) -> jnp.ndarray:
    xp = np.zeros(D.n_pad, np.float32)
    xp[: x.shape[0]] = x
    return jnp.asarray(xp.reshape(D.k, -1))


def assemble_y(D: DistClosGX, yk) -> np.ndarray:
    yk = np.asarray(yk)
    out = np.zeros(D.m, np.float64)
    for d in range(D.k):
        r0, r1 = D.row_starts[d], D.row_starts[d + 1]
        out[r0:r1] = yk[d, : r1 - r0]
    return out


def dist_spmv_closgx_host(D: DistClosGX, x: np.ndarray) -> np.ndarray:
    return assemble_y(D, dist_spmv_closgx(D, shard_x(D, x)))
