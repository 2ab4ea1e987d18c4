"""Multi-chip / multi-host distribution layer.

The reference is single-node (OpenMP + fork; SURVEY.md §5.8) — this layer is
the new design required by BASELINE.md: a 1-D device mesh over the cards of
a host (NVLink, all to all) and over hosts, rows partitioned nnz-balanced per device (the
prefix-sum partitioner of ``lib/parallel_util.h:156`` reused host-side), the
dense vector x sharded by the same row partition, and halo exchange of x via
collectives chosen by strategy:

* ``allgather`` — x gathered to every chip before the local SpMV (best for
  small n; the Ulysses-style gather analog),
* ``ring`` — x shards rotate around the ring via ``ppermute``; each step
  multiplies the matching column block (ring-attention analog; overlaps
  compute with the transfer),
* ``psum_scatter`` — column-partitioned A; partial y summed with
  ``psum_scatter`` (the 1.5-D variant).

All functions are mesh-shape-agnostic: tests run them on a virtual 8-device
CPU mesh; the driver's ``dryrun_multichip`` compiles the same code.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.host import HostCSR, INDEX_DTYPE


def make_sparse_mesh(n_devices: int, axis: str = "rows") -> Mesh:
    devs = jax.devices()[:n_devices]
    if len(devs) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devs)}")
    return Mesh(np.array(devs), (axis,))


def partition_rows_nnz_balanced(csr: HostCSR, k: int) -> np.ndarray:
    """Row split points (k+1,) equalizing nnz per part — the reference's
    ``loop_partitioner_balance_prefix_sums`` (binary search over the row
    pointer, ``parallel_util.h:156``) computed vectorized."""
    targets = (np.arange(k + 1) * (csr.nnz / k)).astype(np.int64)
    splits = np.searchsorted(csr.ia, targets, side="left")
    splits[0], splits[-1] = 0, csr.m
    return np.maximum.accumulate(splits.astype(np.int64))


@dataclasses.dataclass
class ShardedCSR:
    """Row-sharded padded CSR with columns remapped to the padded global
    index space (shard j's rows live at [j*rows_pad, j*rows_pad + rows_j))."""

    data: jnp.ndarray     # (k, nnz_pad)
    cols: jnp.ndarray     # (k, nnz_pad) int32, padded-global indices
    rows: jnp.ndarray     # (k, nnz_pad) int32, local row ids (rows_pad = pad)
    shape: Tuple[int, int]
    nnz: int
    k: int
    rows_pad: int
    row_splits: np.ndarray  # (k+1,) host
    mesh: Mesh
    axis: str
    # ring layout: per-shard entries grouped
    # by owner column block at BUILD time, so each ring step touches only
    # its block's slice — O(nnz + k·pad) total instead of the old
    # O(k·nnz) every-step full masking. None when the k²·pad blow-up
    # exceeds the budget (the masked body remains as fallback).
    data_blk: jnp.ndarray = None   # (k·k, Bmax) -> shard view (k, Bmax)
    cols_blk: jnp.ndarray = None   # block-local column ids (pad 0, data 0)
    rows_blk: jnp.ndarray = None   # local row ids (pad -> rows_pad)

    @property
    def m_pad(self) -> int:
        return self.k * self.rows_pad

    def pad_vector(self, x: np.ndarray, dtype=jnp.float32) -> jnp.ndarray:
        """Scatter a global vector (n,) into the padded sharded layout."""
        out = np.zeros(self.m_pad, dtype=np.dtype(dtype))
        for j in range(self.k):
            s, e = self.row_splits[j], self.row_splits[j + 1]
            out[j * self.rows_pad : j * self.rows_pad + (e - s)] = x[s:e]
        return jax.device_put(
            jnp.asarray(out), NamedSharding(self.mesh, P(self.axis)))

    def unpad_vector(self, y) -> np.ndarray:
        y = np.asarray(y)
        out = np.zeros(self.shape[0], dtype=y.dtype)
        for j in range(self.k):
            s, e = self.row_splits[j], self.row_splits[j + 1]
            out[s:e] = y[j * self.rows_pad : j * self.rows_pad + (e - s)]
        return out


def build_sharded_csr(csr: HostCSR, mesh: Mesh, axis: str = "rows",
                      dtype=jnp.float32, nnz_align: int = 256) -> ShardedCSR:
    if csr.m != csr.n:
        raise ValueError("distributed SpMV requires square matrices (x ≡ row space)")
    k = mesh.shape[axis]
    splits = partition_rows_nnz_balanced(csr, k)
    rows_pad = int(max(np.diff(splits).max(), 1))
    # remap global columns to padded-global index space
    owner = np.searchsorted(splits, csr.ja, side="right") - 1
    owner = np.clip(owner, 0, k - 1)
    cols_remap = owner * rows_pad + (csr.ja.astype(np.int64) - splits[owner])

    lengths = csr.row_lengths()
    grows = np.repeat(np.arange(csr.m, dtype=np.int64), lengths)
    nnz_per = np.diff(csr.ia[splits]).astype(np.int64)
    nnz_pad = int(((int(nnz_per.max()) + nnz_align - 1) // nnz_align) * nnz_align)
    nnz_pad = max(nnz_pad, nnz_align)

    data = np.zeros((k, nnz_pad), dtype=np.dtype(dtype))
    cols = np.zeros((k, nnz_pad), dtype=INDEX_DTYPE)
    rows = np.full((k, nnz_pad), rows_pad, dtype=INDEX_DTYPE)  # pad → overflow row
    for j in range(k):
        s, e = csr.ia[splits[j]], csr.ia[splits[j + 1]]
        cnt = e - s
        data[j, :cnt] = csr.a[s:e]
        cols[j, :cnt] = cols_remap[s:e]
        rows[j, :cnt] = grows[s:e] - splits[j]

    # ring-blocked layout: group each shard's entries by owner block
    data_blk = cols_blk = rows_blk = None
    counts = np.zeros((k, k), np.int64)
    for j in range(k):
        s_, e_ = csr.ia[splits[j]], csr.ia[splits[j + 1]]
        counts[j] = np.bincount(owner[s_:e_], minlength=k)
    Bmax = int(((counts.max() + nnz_align - 1) // nnz_align) * nnz_align)
    Bmax = max(Bmax, nnz_align)
    if k * Bmax <= 4 * nnz_pad:        # blow-up budget (skewed columns)
        data_blk = np.zeros((k * k, Bmax), dtype=np.dtype(dtype))
        cols_blk = np.zeros((k * k, Bmax), dtype=INDEX_DTYPE)
        rows_blk = np.full((k * k, Bmax), rows_pad, dtype=INDEX_DTYPE)
        for j in range(k):
            s_, e_ = csr.ia[splits[j]], csr.ia[splits[j + 1]]
            ow = owner[s_:e_]
            order = np.argsort(ow, kind="stable")   # rows stay sorted
            for b in range(k):
                sel = order[ow[order] == b]
                cnt = sel.size
                r0 = j * k + b
                data_blk[r0, :cnt] = csr.a[s_:e_][sel]
                cols_blk[r0, :cnt] = (cols_remap[s_:e_][sel]
                                      - b * rows_pad)
                rows_blk[r0, :cnt] = grows[s_:e_][sel] - splits[j]

    sharding = NamedSharding(mesh, P(axis))
    blk_kw = {}
    if data_blk is not None:
        blk_kw = dict(
            data_blk=jax.device_put(jnp.asarray(data_blk), sharding),
            cols_blk=jax.device_put(jnp.asarray(cols_blk), sharding),
            rows_blk=jax.device_put(jnp.asarray(rows_blk), sharding))
    return ShardedCSR(
        **blk_kw,
        data=jax.device_put(jnp.asarray(data), sharding),
        cols=jax.device_put(jnp.asarray(cols), sharding),
        rows=jax.device_put(jnp.asarray(rows), sharding),
        shape=(csr.m, csr.n),
        nnz=csr.nnz,
        k=k,
        rows_pad=rows_pad,
        row_splits=splits,
        mesh=mesh,
        axis=axis,
    )


def _local_spmv(data, cols, rows, x_full, rows_pad):
    """Local padded-CSR SpMV (portable XLA path; padding rows land in the
    overflow segment which is sliced off)."""
    prod = data * jnp.take(x_full, cols)
    y = jax.ops.segment_sum(prod, rows, num_segments=rows_pad + 1,
                            indices_are_sorted=True)
    return y[:rows_pad]


def _ring_body_blocked(A: "ShardedCSR"):
    """Ring body over the build-time block-grouped layout: step ``s``
    touches only the slice holding the owner's columns."""
    axis = A.axis

    def f(data_blk, cols_blk, rows_blk, xs):
        k = jax.lax.axis_size(axis)
        me = jax.lax.axis_index(axis)
        rp = A.rows_pad

        def body(step, carry):
            xblk, y = carry
            src = (me + step) % k           # owner of the held block
            d = data_blk[src]
            c = cols_blk[src]
            r = rows_blk[src]
            prod = d * jnp.take(xblk, c)    # pad: data 0 -> contributes 0
            y = y + jax.ops.segment_sum(
                prod, r, num_segments=rp + 1,
                indices_are_sorted=True)[:rp]
            xblk = jax.lax.ppermute(
                xblk, axis, [(i, (i - 1) % k) for i in range(k)])
            return xblk, y

        y0 = jax.lax.pcast(jnp.zeros((rp,), data_blk.dtype), axis,
                           to='varying')
        _, y = jax.lax.fori_loop(0, k, body, (xs, y0))
        return y

    return f


def _ring_body(A: "ShardedCSR"):
    """Ring halo-exchange local body: x shards rotate via ppermute; each step
    multiplies the matching column block (overlappable with compute)."""
    axis = A.axis

    def f(data, cols, rows, xs):
        k = jax.lax.axis_size(axis)
        me = jax.lax.axis_index(axis)
        rp = A.rows_pad

        def body(step, carry):
            xblk, y = carry
            src = (me + step) % k           # owner of the held block
            base = src * rp
            local_cols = cols[0] - base
            mask = (local_cols >= 0) & (local_cols < rp)
            xi = jnp.take(xblk, jnp.clip(local_cols, 0, rp - 1))
            prod = jnp.where(mask, data[0] * xi, 0.0)
            y = y + jax.ops.segment_sum(
                prod, rows[0], num_segments=rp + 1,
                indices_are_sorted=True)[:rp]
            xblk = jax.lax.ppermute(
                xblk, axis, [(i, (i - 1) % k) for i in range(k)])
            return xblk, y

        y0 = jax.lax.pcast(jnp.zeros((rp,), data.dtype), axis, to='varying')
        _, y = jax.lax.fori_loop(0, k, body, (xs, y0))
        return y

    return f


def distributed_spmv(A: ShardedCSR, x: jnp.ndarray,
                     strategy: str = "allgather") -> jnp.ndarray:
    """y = A @ x with x and y sharded by the row partition."""
    axis = A.axis

    if strategy == "allgather":
        def f(data, cols, rows, xs):
            x_full = jax.lax.all_gather(xs, axis, tiled=True)
            return _local_spmv(data[0], cols[0], rows[0], x_full, A.rows_pad)
    elif strategy == "ring":
        shard = partial(
            jax.shard_map, mesh=A.mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis)),
            out_specs=P(axis))
        if A.data_blk is not None:
            return shard(_ring_body_blocked(A))(
                A.data_blk, A.cols_blk, A.rows_blk, x)
        return shard(_ring_body(A))(A.data, A.cols, A.rows, x)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")

    shard = partial(
        jax.shard_map,
        mesh=A.mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
    )
    return shard(f)(A.data, A.cols, A.rows, x)


@dataclasses.dataclass
class ColShardedCSR:
    """Column-partitioned CSR: device j owns the column block
    [splits[j], splits[j+1]); rows stay global (padded). The 1.5-D variant:
    local partial y over all rows, combined with ``psum_scatter``."""

    data: jnp.ndarray   # (k, nnz_pad)
    cols: jnp.ndarray   # (k, nnz_pad) int32 LOCAL column ids (< cols_pad)
    rows: jnp.ndarray   # (k, nnz_pad) int32 global padded row ids
    shape: Tuple[int, int]
    nnz: int
    k: int
    rows_pad: int       # rows padded so k | m_pad (y scatter granularity)
    cols_pad: int
    col_splits: np.ndarray
    mesh: Mesh
    axis: str

    @property
    def m_pad(self):
        return self.k * self.rows_pad

    def pad_x(self, x: np.ndarray, dtype=jnp.float32) -> jnp.ndarray:
        out = np.zeros(self.k * self.cols_pad, dtype=np.dtype(dtype))
        for j in range(self.k):
            s, e = self.col_splits[j], self.col_splits[j + 1]
            out[j * self.cols_pad : j * self.cols_pad + (e - s)] = x[s:e]
        return jax.device_put(jnp.asarray(out),
                              NamedSharding(self.mesh, P(self.axis)))

    def unpad_y(self, y) -> np.ndarray:
        return np.asarray(y)[: self.shape[0]]


def build_col_sharded_csr(csr: HostCSR, mesh: Mesh, axis: str = "rows",
                          dtype=jnp.float32, nnz_align: int = 256) -> ColShardedCSR:
    """Partition nnz by column owner (nnz-balanced over a column prefix-sum)."""
    k = mesh.shape[axis]
    # nnz-balanced column splits via column-count prefix sums
    col_counts = np.bincount(csr.ja, minlength=csr.n)
    cum = np.concatenate([[0], np.cumsum(col_counts)])
    targets = (np.arange(k + 1) * (csr.nnz / k)).astype(np.int64)
    splits = np.searchsorted(cum, targets, side="left")
    splits[0], splits[-1] = 0, csr.n
    splits = np.maximum.accumulate(splits)
    cols_pad = int(max(np.diff(splits).max(), 1))
    rows_pad = ((csr.m + k - 1) // k)

    lengths = csr.row_lengths()
    grows = np.repeat(np.arange(csr.m, dtype=np.int64), lengths)
    owner = np.clip(np.searchsorted(splits, csr.ja, side="right") - 1, 0, k - 1)
    local_cols = csr.ja.astype(np.int64) - splits[owner]
    per = np.bincount(owner, minlength=k)
    nnz_pad = int(((int(per.max()) + nnz_align - 1) // nnz_align) * nnz_align)
    nnz_pad = max(nnz_pad, nnz_align)

    data = np.zeros((k, nnz_pad), dtype=np.dtype(dtype))
    cols = np.zeros((k, nnz_pad), dtype=INDEX_DTYPE)
    rows = np.full((k, nnz_pad), k * rows_pad, dtype=INDEX_DTYPE)
    fill = np.zeros(k, dtype=np.int64)
    order = np.argsort(owner, kind="stable")
    for j in range(k):
        sel = order[np.searchsorted(owner[order], j, "left"):
                    np.searchsorted(owner[order], j, "right")]
        cnt = sel.size
        data[j, :cnt] = csr.a[sel]
        cols[j, :cnt] = local_cols[sel]
        rows[j, :cnt] = grows[sel]

    sharding = NamedSharding(mesh, P(axis))
    return ColShardedCSR(
        data=jax.device_put(jnp.asarray(data), sharding),
        cols=jax.device_put(jnp.asarray(cols), sharding),
        rows=jax.device_put(jnp.asarray(rows), sharding),
        shape=(csr.m, csr.n), nnz=csr.nnz, k=k,
        rows_pad=rows_pad, cols_pad=cols_pad, col_splits=splits,
        mesh=mesh, axis=axis)


def distributed_spmv_psum_scatter(A: ColShardedCSR, x: jnp.ndarray) -> jnp.ndarray:
    """Column-partitioned SpMV: each device computes partial y over ALL rows
    from its column block; partials combined with ``psum_scatter`` so y comes
    out row-sharded (the 1.5-D / reduce-scatter variant)."""
    axis = A.axis
    m_pad = A.m_pad

    def f(data, cols, rows, xs):
        prod = data[0] * jnp.take(xs, cols[0])
        y_partial = jax.ops.segment_sum(prod, rows[0], num_segments=m_pad + 1,
                                        indices_are_sorted=False)[:m_pad]
        return jax.lax.psum_scatter(y_partial, axis, scatter_dimension=0,
                                    tiled=True)

    return jax.shard_map(
        f, mesh=A.mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
    )(A.data, A.cols, A.rows, x)


def distributed_cg_step(csr: HostCSR, mesh: Mesh, axis: str = "rows",
                        strategy: str = "allgather"):
    """One Jacobi-preconditioned CG iteration (the framework's 'training
    step') jitted over the mesh: SpMV + dots (psum) + axpys, all sharded.
    Returns a zero-arg callable that executes one step on tiny data."""
    A = build_sharded_csr(csr, mesh, axis=axis)
    rng = np.random.Generator(np.random.PCG64(0))
    b = A.pad_vector(rng.uniform(size=csr.n))
    x0 = A.pad_vector(np.zeros(csr.n))
    diag = np.ones(csr.n)  # Jacobi preconditioner placeholder on padded space
    Kinv = A.pad_vector(1.0 / diag)

    @jax.jit
    def step(data, cols, rows, b, x, Kinv):
        r = b - distributed_spmv_arrays(A, data, cols, rows, x, strategy)
        z = Kinv * r
        rho = jnp.vdot(r, z)
        p = z
        Ap = distributed_spmv_arrays(A, data, cols, rows, p, strategy)
        alpha = rho / jnp.maximum(jnp.vdot(p, Ap), 1e-30)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        return x_new, jnp.vdot(r_new, r_new)

    def run():
        return step(A.data, A.cols, A.rows, b, x0, Kinv)

    return run


def distributed_spmv_arrays(A: ShardedCSR, data, cols, rows, x,
                            strategy: str = "allgather") -> jnp.ndarray:
    """distributed_spmv over explicit arrays (for use inside jit)."""
    axis = A.axis

    if strategy == "allgather":
        def f(d, c, r, xs):
            x_full = jax.lax.all_gather(xs, axis, tiled=True)
            return _local_spmv(d[0], c[0], r[0], x_full, A.rows_pad)
    elif strategy == "ring":
        f = _ring_body(A)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")

    return jax.shard_map(
        f, mesh=A.mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
    )(data, cols, rows, x)
