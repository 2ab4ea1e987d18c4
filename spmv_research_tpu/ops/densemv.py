"""DENSE fallback: densified matvec for dense-row scattered matrices.

The ultra-dense-row scattered class (human_gene1 ~5% density,
TSOPF_RS_b2383 ~1.3%, rail4284) is structurally outside every gather
engine here: group column windows exceed 64 octaves (CLOSG/CLOSGX
reject) and column locality is absent (SELLW rejects). The alternative
formulation for that class is to stop gathering: densify and ride a
full-width matvec at streaming bandwidth (the dense plane the reference
reserves for its tensor-core kernels —
``spmv_kernels/GPU_clean/dasp_cuda.cu`` role). At 5% density a dense
fp32 matvec reads 20 bytes per nnz, 20× what CSR reads per nnz; whether
the stream beats the gather is a measurement on the card.

The products run at ``Precision.HIGHEST`` (fp32, not the GPU's default
TF32).

The builder is budget-gated: it refuses matrices whose dense plane
exceeds ``max_bytes`` (rail4284's 18.8 GB plane stays with the CSR
baseline).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.host import HostCSR
from ..core.formats import _register
from .dispatch import register_spmv, register_spmm

_RB, _CB = 8, 128                       # fp32 tile multiples


class DenseBuildError(ValueError):
    """Matrix unsuitable for the dense fallback (plane over budget)."""


@partial(_register,
         data_fields=("mat",),
         meta_fields=("shape", "nnz", "nnz_expanded"))
@dataclasses.dataclass(frozen=True)
class DenseMV:
    """Row-major dense plane, padded to (8, 128) fp32 tiles."""

    mat: jnp.ndarray           # (m_pad, n_pad)
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int

    format_name = "DENSE"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mem_footprint_bytes(self) -> int:
        return int(self.mat.size) * self.mat.dtype.itemsize


def build_dense(host: HostCSR, dtype=jnp.float32,
                max_bytes: int = 6 << 30) -> DenseMV:
    m, n = host.m, host.n
    mp = (m + _RB - 1) // _RB * _RB
    npad = (n + _CB - 1) // _CB * _CB
    itemsize = jnp.dtype(dtype).itemsize
    need = mp * npad * itemsize
    if need > max_bytes:
        raise DenseBuildError(
            f"dense plane {need / 1e9:.1f} GB exceeds the "
            f"{max_bytes / 1e9:.1f} GB budget (m={m}, n={n})")
    dense = np.zeros((mp, npad), dtype=np.dtype(dtype))
    rows = np.repeat(np.arange(m), host.row_lengths())
    # sum duplicate (row, col) entries like the CSR gold does (plain
    # fancy-assignment keeps only the last duplicate)
    np.add.at(dense, (rows, host.ja), host.a.astype(dense.dtype))
    return DenseMV(mat=jnp.asarray(dense), shape=(m, n), nnz=host.nnz,
                   nnz_expanded=host.nnz_expanded)


def _pad_x(A: DenseMV, x: jnp.ndarray) -> jnp.ndarray:
    npad = A.mat.shape[1]
    return jnp.pad(x.astype(A.mat.dtype), (0, npad - x.shape[0]))


@register_spmv("DENSE", "xla")
def spmv_dense_xla(A: DenseMV, x: jnp.ndarray) -> jnp.ndarray:
    y = jnp.dot(A.mat, _pad_x(A, x),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
    return y[: A.m]


@register_spmm("DENSE", "xla")
def spmm_dense_xla(A: DenseMV, X: jnp.ndarray) -> jnp.ndarray:
    npad = A.mat.shape[1]
    Xp = jnp.pad(X.astype(A.mat.dtype),
                 ((0, npad - X.shape[0]), (0, 0)))
    return jnp.dot(A.mat, Xp, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)[: A.m]
