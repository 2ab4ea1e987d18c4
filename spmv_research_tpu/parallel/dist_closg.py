"""Distributed CLOSG: nnz-balanced row shards, one routed program per chip.

The SPMD layer (``dist.py``) keeps per-shard data shape-uniform so a single
``shard_map`` program serves every device — right for plain CSR arrays, but
a compiled Clos routing program is *per-matrix static metadata* (N, scan
stages, extraction classes differ per shard), so the sharded flagship
engine runs MPMD-style instead: each device holds its own compiled program
for its row block and executes its own jitted SpMV; dispatch is
asynchronous, so the k per-device kernels run concurrently, and x is
broadcast to every device first (the ``allgather`` halo strategy; SURVEY.md
§2.8/§5.8 — hierarchy: nnz-balance across chips, Clos routing inside the
chip, grid/double-buffering inside the kernel).

y comes back as the concatenation of per-device outputs (row-contiguous by
construction of the nnz-balanced split, ``parallel_util.h:156`` analog).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.host import HostCSR
from ..ops.clos_gather import build_clos_gather_auto, _rows_slice
from ..ops.dispatch import spmv as spmv_dispatch
from .dist import partition_rows_nnz_balanced


@dataclasses.dataclass
class ShardedClosG:
    """Per-device compiled Clos programs over an nnz-balanced row split."""

    shards: Tuple[object, ...]          # ClosG / ClosGChunked, one per device
    devices: Tuple[object, ...]
    row_splits: np.ndarray              # (k+1,)
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int

    format_name = "CLOSG_DIST"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    @property
    def k(self):
        return len(self.shards)

    def mem_footprint_bytes(self) -> int:
        return int(sum(s.mem_footprint_bytes() for s in self.shards))


def build_sharded_closg(csr: HostCSR, devices: Sequence = None,
                        dtype=jnp.float32) -> ShardedClosG:
    devices = tuple(devices if devices is not None else jax.devices())
    k = len(devices)
    splits = partition_rows_nnz_balanced(csr, k)
    shards = []
    for j in range(k):
        part = _rows_slice(csr, int(splits[j]), int(splits[j + 1]))
        A = build_clos_gather_auto(part, dtype=dtype)
        shards.append(jax.device_put(A, devices[j]))
    return ShardedClosG(shards=tuple(shards), devices=devices,
                        row_splits=splits, shape=(csr.m, csr.n),
                        nnz=csr.nnz, nnz_expanded=csr.nnz_expanded)


def distributed_spmv_closg(A: ShardedClosG, x: jnp.ndarray) -> jnp.ndarray:
    """Broadcast x (allgather halo strategy), run the k per-device routed
    SpMVs concurrently (async dispatch), concatenate row blocks."""
    ys = []
    for j in range(A.k):
        xj = jax.device_put(x, A.devices[j])
        ys.append(spmv_dispatch(A.shards[j], xj))
    ys = [jax.device_put(y, A.devices[0]) for y in ys]
    return jnp.concatenate(ys)


def build_sharded_best(csr: HostCSR, devices: Sequence = None,
                       dtype=jnp.float32) -> ShardedClosG:
    """nnz-balanced row shards, each compiled to its *best* single-chip
    engine (SELLW where the shard has column locality, CLOSG otherwise —
    shards of one matrix may pick different engines). The reference's
    kernel-selection map (config.sh:458-661 ``progs``) applied per shard."""
    from ..ops.sellw import SellWBuildError, build_sellw

    devices = tuple(devices if devices is not None else jax.devices())
    k = len(devices)
    splits = partition_rows_nnz_balanced(csr, k)
    shards = []
    for j in range(k):
        part = _rows_slice(csr, int(splits[j]), int(splits[j + 1]))
        try:
            A = build_sellw(part, dtype=dtype)
        except SellWBuildError:
            A = build_clos_gather_auto(part, dtype=dtype)
        shards.append(jax.device_put(A, devices[j]))
    return ShardedClosG(shards=tuple(shards), devices=devices,
                        row_splits=splits, shape=(csr.m, csr.n),
                        nnz=csr.nnz, nnz_expanded=csr.nnz_expanded)
