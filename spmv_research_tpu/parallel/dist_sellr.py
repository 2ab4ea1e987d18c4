"""SPMD distributed SELLR: shape-uniform per-shard engine programs.

Replaces the round-1 MPMD device_put loop (``dist_closg.py``) for the
flagship locality engine: every shard's compiled SELLR program is padded to
one canonical shape (dead chunks are inert by construction — zero emask
and values), so a single ``shard_map`` program executes on every device and
the whole step jits multi-host (SURVEY.md §2.8/§5.8; the reference has no
distributed backend — ``slurm*.sh`` launches independent jobs — so this
layer is new design surface).

Strategies (the reference-role halo-exchange triple, SURVEY §5.7/§5.8):

* ``allgather``: rows nnz-balanced across devices, x gathered whole per
  step — right for small n (the Ulysses-style gather).
* ``ring``: rows × column-blocks; device d holds x block d; at ring step j
  it multiplies its (row-shard × column-block (d+j) mod k) program against
  the x shard it currently holds, then ``ppermute``\\s the shard along the
  ring.  Per-step work is only that block's nnz — build-time column
  partitioning, not the O(k·nnz) masked re-reads of a masked CSR ring.
* ``psum_scatter``: column-sharded A, full-height partial y per device,
  ``psum_scatter`` over row blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map
from functools import partial

from ..core.host import HostCSR
from ..ops.sellr import (GROUP, NB, META_BLK, SellR, SellRBuildError,
                         build_sellr, sellr_xla_raw)
from ..ops.clos_route import LANES, SUB
from .dist import partition_rows_nnz_balanced


def _rows_slice(csr: HostCSR, r0: int, r1: int) -> HostCSR:
    ia = csr.ia.astype(np.int64)
    e0, e1 = int(ia[r0]), int(ia[r1])
    return HostCSR(a=csr.a[e0:e1].copy(),
                   ia=(csr.ia[r0:r1 + 1] - csr.ia[r0]).astype(np.int32),
                   ja=csr.ja[e0:e1].copy(), m=r1 - r0, n=csr.n)


def _cols_slice(csr: HostCSR, c0: int, c1: int) -> HostCSR:
    keep = (csr.ja >= c0) & (csr.ja < c1)
    rows = np.repeat(np.arange(csr.m, dtype=np.int64), csr.row_lengths())
    lens = np.bincount(rows[keep], minlength=csr.m)
    ia = np.zeros(csr.m + 1, np.int64)
    np.cumsum(lens, out=ia[1:])
    return HostCSR(a=csr.a[keep].copy(), ia=ia.astype(np.int32),
                   ja=(csr.ja[keep] - c0).astype(np.int32),
                   m=csr.m, n=c1 - c0)


def _empty_program(x_rows: int, y_rows: int, dtype) -> SellR:
    """One dead chunk: inert (emask 0, all-zero values)."""
    word = np.zeros((NB * SUB, LANES), np.int32)
    vals = np.zeros((NB * SUB, LANES), np.dtype(dtype))
    smeta = np.zeros(META_BLK, np.int32)
    return SellR(word=jnp.asarray(word), vals=jnp.asarray(vals),
                 smeta=jnp.asarray(smeta), shape=(y_rows * LANES,
                                                  x_rows * LANES),
                 nnz=0, nnz_expanded=0, nchunks=0, x_rows=x_rows,
                 y_rows=y_rows, stages=0, rolls=())


def _pad_program(F: SellR, nsteps_t: int, rolls_t: Tuple[Tuple[int, int],
                                                         ...]) -> SellR:
    """Pad to nsteps_t steps over the union roll set."""
    nsteps = F.word.shape[0] // SUB // NB
    word = np.zeros((nsteps_t * NB * SUB, LANES), np.int32)
    vals = np.zeros((nsteps_t * NB * SUB, LANES), np.asarray(F.vals).dtype)
    smeta = np.zeros(nsteps_t * META_BLK, np.int32)
    word[: F.word.shape[0]] = np.asarray(F.word)
    vals[: F.vals.shape[0]] = np.asarray(F.vals)
    smeta[: nsteps * META_BLK] = np.asarray(F.smeta)
    return dataclasses.replace(
        F, word=jnp.asarray(word), vals=jnp.asarray(vals),
        smeta=jnp.asarray(smeta), rolls=rolls_t)


def _uniformize(programs, x_rows: int, y_rows: int, dtype):
    """Pad a list of per-shard programs (or None) to one canonical shape;
    returns stacked (k, ...) arrays + the static meta."""
    progs = [p if p is not None else _empty_program(x_rows, y_rows, dtype)
             for p in programs]
    nsteps_t = max(p.word.shape[0] // SUB // NB for p in progs)
    rolls_t = tuple(sorted(set().union(*[set(p.rolls) for p in progs])))
    stages_t = max(p.stages for p in progs)
    padded = [_pad_program(p, nsteps_t, rolls_t) for p in progs]
    word = jnp.stack([p.word for p in padded])
    vals = jnp.stack([p.vals for p in padded])
    smeta = jnp.stack([p.smeta for p in padded])
    return word, vals, smeta, dict(stages=stages_t, rolls=rolls_t,
                                   x_rows=x_rows, y_rows=y_rows)


@dataclasses.dataclass(frozen=True)
class DistSellR:
    """Shape-uniform distributed SELLR program set."""

    word: jnp.ndarray     # allgather/psum: (k, S8, 128); ring: (k, k, S8, 128)
    vals: jnp.ndarray
    smeta: jnp.ndarray
    strategy: str
    mesh: Mesh
    row_splits: np.ndarray        # (k+1,) global row split
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    meta: dict                    # static kernel meta (stages/rolls/...)
    shard_nnz: np.ndarray         # per (shard[, block]) nnz — work accounting

    format_name = "SELLR_DIST"

    @property
    def k(self):
        return self.mesh.devices.size

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mem_footprint_bytes(self) -> int:
        return int(self.word.size * 4 + self.vals.size
                   * self.vals.dtype.itemsize + self.smeta.size * 4)


def build_dist_sellr(csr: HostCSR, mesh: Mesh, strategy: str = "ring",
                     dtype=jnp.float32,
                     max_slot_factor: float = 6.0) -> DistSellR:
    k = int(mesh.devices.size)
    x_rows_g = -(-csr.n // (k * LANES)) * k      # global x rows, k-divisible
    n_pad = x_rows_g * LANES

    def build(part):
        if part.nnz == 0:
            return None
        return build_sellr(part, dtype=dtype,
                           max_slot_factor=max_slot_factor)

    if strategy == "allgather":
        splits = partition_rows_nnz_balanced(csr, k)
        shards = [_rows_slice(csr, int(splits[j]), int(splits[j + 1]))
                  for j in range(k)]
        y_rows_t = max(-(-s.m // GROUP) * SUB for s in shards)
        progs = []
        for s in shards:
            p = build(s)
            if p is not None and p.x_rows != x_rows_g:
                p = dataclasses.replace(p, x_rows=x_rows_g)
            progs.append(p)
        word, vals, smeta, meta = _uniformize(progs, x_rows_g, y_rows_t,
                                              dtype)
        shard_nnz = np.array([s.nnz for s in shards])
    elif strategy == "ring":
        splits = partition_rows_nnz_balanced(csr, k)
        xw_rows = x_rows_g // k                   # x rows per block
        y_rows_t, blocks = 0, []
        for j in range(k):
            rs = _rows_slice(csr, int(splits[j]), int(splits[j + 1]))
            y_rows_t = max(y_rows_t, -(-rs.m // GROUP) * SUB)
            blocks.append([_cols_slice(rs, b * xw_rows * LANES,
                                       (b + 1) * xw_rows * LANES)
                           for b in range(k)])
        progs = [[build(blocks[j][b]) for b in range(k)] for j in range(k)]
        flat = [p for row in progs for p in row]
        word, vals, smeta, meta = _uniformize(flat, xw_rows, y_rows_t, dtype)
        word = word.reshape(k, k, *word.shape[1:])
        vals = vals.reshape(k, k, *vals.shape[1:])
        smeta = smeta.reshape(k, k, *smeta.shape[1:])
        shard_nnz = np.array([[blocks[j][b].nnz for b in range(k)]
                              for j in range(k)])
    elif strategy == "psum_scatter":
        splits = np.arange(k + 1) * 0  # unused for cols strategy
        xw_rows = x_rows_g // k
        y_rows_t = -(-(-(-csr.m // GROUP) * SUB) // k) * k  # k-divisible
        cols = [_cols_slice(csr, b * xw_rows * LANES,
                            (b + 1) * xw_rows * LANES) for b in range(k)]
        progs = []
        for c in cols:
            p = build(c)
            if p is not None and p.y_rows != y_rows_t:
                # extend the y plane (ybase indices stay valid)
                p = dataclasses.replace(p, y_rows=y_rows_t)
            progs.append(p)
        word, vals, smeta, meta = _uniformize(progs, xw_rows, y_rows_t,
                                              dtype)
        splits = (np.arange(k + 1) * (y_rows_t // k) * LANES)
        shard_nnz = np.array([c.nnz for c in cols])
    else:
        raise ValueError(f"unknown strategy {strategy!r}")

    return DistSellR(word=word, vals=vals, smeta=smeta, strategy=strategy,
                     mesh=mesh, row_splits=np.asarray(splits),
                     shape=(csr.m, csr.n), nnz=csr.nnz,
                     nnz_expanded=csr.nnz_expanded, meta=meta,
                     shard_nnz=shard_nnz)


def _pad_x(D: DistSellR, x: np.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    k = D.k
    if D.strategy == "allgather":
        n_pad = D.meta["x_rows"] * LANES
    else:
        n_pad = D.meta["x_rows"] * LANES * k
    xp = jnp.zeros(n_pad, dtype)
    return xp.at[: D.n].set(jnp.asarray(x, dtype))


def dist_spmv_sellr(D: DistSellR, x: jnp.ndarray) -> jnp.ndarray:
    """y = A @ x through the shard_map program; x is the padded vector from
    :func:`_pad_x` (callers may jit this whole function)."""
    mesh, k, meta = D.mesh, D.k, D.meta
    x_rows, y_rows = meta["x_rows"], meta["y_rows"]
    kern = partial(sellr_xla_raw, stages=meta["stages"],
                   rolls=meta["rolls"], x_rows=x_rows, y_rows=y_rows)

    if D.strategy == "allgather":
        @partial(shard_map, mesh=mesh, check_vma=False,
                 in_specs=(P("rows"), P("rows"), P("rows"), P("rows")),
                 out_specs=P("rows"))
        def f(word, vals, smeta, xloc):
            x_full = jax.lax.all_gather(xloc, "rows", tiled=True)
            y2 = kern(word[0], vals[0], smeta[0],
                      x_full.reshape(x_rows, LANES))
            return y2.reshape(1, -1)

        return f(D.word, D.vals, D.smeta, x)

    if D.strategy == "ring":
        perm = [(i, (i - 1) % k) for i in range(k)]

        @partial(shard_map, mesh=mesh, check_vma=False,
                 in_specs=(P("rows"), P("rows"), P("rows"), P("rows")),
                 out_specs=P("rows"))
        def f(word, vals, smeta, xloc):
            d = jax.lax.axis_index("rows")

            def body(j, carry):
                xcur, acc = carry
                b = (d + j) % k
                wj = jax.lax.dynamic_index_in_dim(word[0], b, 0, False)
                vj = jax.lax.dynamic_index_in_dim(vals[0], b, 0, False)
                sj = jax.lax.dynamic_index_in_dim(smeta[0], b, 0, False)
                acc = acc + kern(wj, vj, sj, xcur.reshape(x_rows, LANES))
                xnext = jax.lax.ppermute(xcur, "rows", perm)
                return (xnext, acc)

            acc0 = jnp.zeros((y_rows, LANES), vals.dtype)
            _, y2 = jax.lax.fori_loop(0, k, body, (xloc, acc0))
            return y2.reshape(1, -1)

        return f(D.word, D.vals, D.smeta, x)

    if D.strategy == "psum_scatter":
        @partial(shard_map, mesh=mesh, check_vma=False,
                 in_specs=(P("rows"), P("rows"), P("rows"), P("rows")),
                 out_specs=P("rows"))
        def f(word, vals, smeta, xloc):
            y2 = kern(word[0], vals[0], smeta[0],
                      xloc.reshape(x_rows, LANES))
            yflat = y2.reshape(-1)
            return jax.lax.psum_scatter(
                yflat, "rows", scatter_dimension=0, tiled=True
            ).reshape(1, -1)

        return f(D.word, D.vals, D.smeta, x)

    raise ValueError(D.strategy)


def dist_spmv_sellr_host(D: DistSellR, x: np.ndarray) -> np.ndarray:
    """Host convenience: pad x, run, reassemble the global y."""
    xp = _pad_x(D, x, D.vals.dtype)
    y = np.asarray(jax.block_until_ready(dist_spmv_sellr(D, xp)))
    k = D.k
    if D.strategy in ("allgather", "ring"):
        y2 = y.reshape(k, -1)
        out = np.zeros(D.m)
        for j in range(k):
            r0, r1 = int(D.row_splits[j]), int(D.row_splits[j + 1])
            out[r0:r1] = y2[j, : r1 - r0]
        return out
    return y.reshape(-1)[: D.m]


def dist_cg_step_sellr(D: DistSellR, b: np.ndarray):
    """One Jacobi-free CG-style step (SpMV + axpy/dot collectives) jitted
    over the mesh — the dryrun 'training step' on the flagship engine."""
    xp = _pad_x(D, b, D.vals.dtype)

    @jax.jit
    def step(x):
        y = dist_spmv_sellr(D, x)
        # vector ops ride the same sharding
        alpha = jnp.vdot(y, y) / jnp.maximum(jnp.vdot(x[:1], x[:1]), 1e-30)
        return y * (1.0 + alpha * 1e-30)

    return step, xp
