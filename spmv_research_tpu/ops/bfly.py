"""BFLY device format and executors.

The routed-butterfly SpMV (see :mod:`spmv_research_tpu.ops.routing`): the
matrix is compiled into Beneš networks + scan masks at build time; runtime is
pure rolls/selects/adds — no gather, no scatter anywhere.

One executor, ``xla``: jnp.roll/where on flat (N,) arrays, on every
backend.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.host import HostCSR
from .dispatch import register_spmv
from .routing import BflyProgramHost, build_bfly_program



def _register(cls, data_fields, meta_fields):
    jax.tree_util.register_dataclass(cls, data_fields=list(data_fields),
                                     meta_fields=list(meta_fields))
    return cls


@partial(_register,
         data_fields=("widen_B", "fill_words", "perm_B",
                      "vals", "scan_guards", "compact_B",
                      "out_valid"),
         meta_fields=("shape", "nnz", "nnz_expanded", "N", "L", "sigma_x",
                      "sigma_y", "widen_stages", "fill_stages", "perm_stages",
                      "scan_stages", "compact_stages"))
@dataclasses.dataclass(frozen=True)
class Bfly:
    """Routed-butterfly SpMV program on device (flat (N,) leaves).

    All three networks are exact Waksman routes executed with default-keep
    select semantics (out = B ? partner : v), so only take-partner planes are
    stored — half the mask traffic of the keep/take encoding."""

    widen_B: jnp.ndarray     # (W, N) int32 take-partner bit planes
    fill_words: jnp.ndarray  # (N,) int32
    perm_B: jnp.ndarray
    vals: jnp.ndarray        # (N,) f32
    scan_guards: jnp.ndarray  # (N,) int32
    compact_B: jnp.ndarray
    out_valid: jnp.ndarray   # (N,) f32 0/1
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    N: int
    L: int
    sigma_x: int
    sigma_y: int
    widen_stages: Tuple[Tuple[int, int, int], ...]
    fill_stages: Tuple[int, ...]
    perm_stages: Tuple[Tuple[int, int, int], ...]
    scan_stages: Tuple[int, ...]
    compact_stages: Tuple[Tuple[int, int, int], ...]

    format_name = "BFLY"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mem_footprint_bytes(self) -> int:
        words = (self.widen_B.shape[0] + self.perm_B.shape[0]
                 + self.compact_B.shape[0]) * 4
        return self.N * (self.vals.dtype.itemsize + 8 + words) + self.N


def _planes(arr: np.ndarray) -> jnp.ndarray:
    if arr.shape[0] == 0:
        arr = np.zeros((1,) + arr.shape[1:], arr.dtype)
    return jnp.asarray(arr.view(np.int32))


def build_bfly(csr: HostCSR, dtype=jnp.float32, max_N: int = 1 << 22) -> Bfly:
    prog = build_bfly_program(csr, dtype=np.dtype(dtype), max_N=max_N)
    return Bfly(
        widen_B=_planes(prog.widen.B),
        fill_words=jnp.asarray(prog.fill_words.view(np.int32)),
        perm_B=_planes(prog.perm.B),
        vals=jnp.asarray(prog.vals.astype(np.dtype(dtype))),
        scan_guards=jnp.asarray(prog.scan_guards.view(np.int32)),
        compact_B=_planes(prog.compact.B),
        out_valid=jnp.asarray(prog.out_valid.astype(np.dtype(dtype))),
        shape=(prog.m, prog.n),
        nnz=prog.nnz,
        nnz_expanded=prog.nnz_expanded,
        N=prog.N,
        L=prog.L,
        sigma_x=prog.sigma_x,
        sigma_y=prog.sigma_y,
        widen_stages=prog.widen.stages,
        fill_stages=prog.fill_stages,
        perm_stages=prog.perm.stages,
        scan_stages=prog.scan_stages,
        compact_stages=prog.compact.stages,
    )


# ----------------------------------------------------------------- XLA path

def _xor_net_flat(v, B, stages, N):
    """Default-keep exchange network: out = B ? v[p^d] : v."""
    pos = jnp.arange(N, dtype=jnp.int32)
    for (w, b, k) in stages:
        d = 1 << k
        bit = (pos & d) != 0
        partner = jnp.where(bit, jnp.roll(v, d), jnp.roll(v, -d))
        bb = ((B[w] >> b) & 1) != 0
        v = jnp.where(bb, partner, v)
    return v


def _spread_x(x, n, N, sigma):
    stride = 1 << sigma
    xp = jnp.pad(x, (0, (N >> sigma) - x.shape[0]))
    return jnp.pad(xp[:, None], ((0, 0), (0, stride - 1))).reshape(N)


@register_spmv("BFLY", "xla")
def spmv_bfly_xla(A: Bfly, x: jnp.ndarray) -> jnp.ndarray:
    N = A.N
    v = _spread_x(x.astype(A.vals.dtype), A.n, N, A.sigma_x)
    v = _xor_net_flat(v, A.widen_B, A.widen_stages, N)
    for k in A.fill_stages:
        d = 1 << k
        take = ((A.fill_words >> k) & 1) != 0
        v = jnp.where(take, jnp.roll(v, d), v)
    v = _xor_net_flat(v, A.perm_B, A.perm_stages, N)
    v = v * A.vals
    for k in A.scan_stages:
        d = 1 << k
        guard = ((A.scan_guards >> k) & 1) != 0
        v = v + jnp.where(guard, jnp.roll(v, d), 0.0)
    v = _xor_net_flat(v, A.compact_B, A.compact_stages, N)
    v = v * A.out_valid
    return v.reshape(-1, 1 << A.sigma_y)[: A.m, 0]
