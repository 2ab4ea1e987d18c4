"""BSRG — width-classed block-sparse slabs: the dense-matmul path for
blocked matrices (SpMV / SpMM / SDDMM without any scatter).

The plain BSR impls (``ops/reference.py``) reduce per-block products with
``segment_sum`` (a scatter-add). BSRG removes the scatter the same way
SELLG does for scalar rows, one level up:

* block rows are sorted by block count into power-of-two width classes;
* a class is a dense (mc, w) slab of block-column ids + a (mc, w, br, bc)
  value slab (padding points at an appended zero X block);
* SpMV/SpMM: ``Y_c = einsum("mwrc,mwck->mrk", data, Xblocks[idx])`` — a
  batched matrix contraction per class; block-granular `take` is a
  row-granular gather;
* output block rows are de-sorted with one final row gather.

SDDMM on a block pattern needs no extraction at all: the output of
``C_blk = A_blk @ B_blkᵀ`` *is* the BSR value layout — one batched
matmul over the stored blocks, masked by the stored-pattern mask.

Every fp32 contraction here runs at ``Precision.HIGHEST``: the default on
the GPU is TF32 (about three decimal digits), which would miss the fp32
accuracy gate.

Reference roles: MKL-BSR adapters (``Makefile_in:363-374``) on the compute
side; ASpT/tiled SDDMM (``sddmm_kernels/aspt.cpp``) — dense-tile work on
the matrix units with the sparse remainder handled by the gather path
(pair BSRG with ``sddmm(..., impl="gather")`` on the non-blocked rest).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.host import HostCSR
from ..core.formats import BSR
from ..convert.build import build_bsr
from .dispatch import register_spmv, register_spmm, register_sddmm


def _register(cls, data_fields, meta_fields):
    jax.tree_util.register_dataclass(cls, data_fields=list(data_fields),
                                     meta_fields=list(meta_fields))
    return cls


@partial(_register,
         data_fields=("idx", "val", "inv_perm"),
         meta_fields=("shape", "nnz", "nnz_expanded", "br", "bc",
                      "n_blocks", "widths"))
@dataclasses.dataclass(frozen=True)
class BsrG:
    """Width-classed BSR slabs (dict keyed by class width w)."""

    idx: Dict[int, jnp.ndarray]   # (mc, w) int32 block-col ids (pad = nb_x)
    val: Dict[int, jnp.ndarray]   # (mc, w, br, bc)
    inv_perm: jnp.ndarray         # (mb,) position of block-row i in sort
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    br: int
    bc: int
    n_blocks: int
    widths: Tuple[int, ...]

    format_name = "BSRG"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mem_footprint_bytes(self) -> int:
        vb = next(iter(self.val.values())).dtype.itemsize if self.val else 4
        slots = sum(int(np.prod(a.shape)) for a in self.idx.values())
        return slots * (4 + self.br * self.bc * vb) + self.inv_perm.size * 4


def build_bsrg(csr: HostCSR, br: int = 8, bc: int = 128,
               dtype=jnp.float32) -> BsrG:
    """Build width-classed slabs from the BSR conversion (same fill guard)."""
    bsr = build_bsr(csr, br=br, bc=bc, dtype=dtype)
    mb = (csr.m + br - 1) // br
    rowptr = np.asarray(bsr.block_rowptr)[: mb + 1]
    counts = np.diff(rowptr)
    order = np.argsort(counts, kind="stable")
    inv_perm = np.empty(mb, np.int32)
    inv_perm[order] = np.arange(mb, dtype=np.int32)

    nb_x = (csr.n + bc - 1) // bc            # appended zero X block id
    data = np.asarray(bsr.data)
    bcols = np.asarray(bsr.block_cols)

    idx, val, widths = {}, {}, []
    Ls = counts[order]
    lo = 0
    while lo < mb:
        w = max(1, 1 << int(max(int(Ls[lo]), 1) - 1).bit_length())
        hi = max(int(np.searchsorted(Ls, w, side="right")), lo + 1)
        rows_c = order[lo:hi]
        mc = hi - lo
        ic = np.full((mc, w), nb_x, np.int32)
        vc = np.zeros((mc, w, br, bc), np.dtype(dtype))
        for t, rb in enumerate(rows_c):
            a, b = rowptr[rb], rowptr[rb + 1]
            ic[t, : b - a] = bcols[a:b]
            vc[t, : b - a] = data[a:b]
        idx[w] = jnp.asarray(ic)
        val[w] = jnp.asarray(vc)
        widths.append(w)
        lo = hi
    return BsrG(idx=idx, val=val, inv_perm=jnp.asarray(inv_perm),
                shape=(csr.m, csr.n), nnz=csr.nnz,
                nnz_expanded=csr.nnz_expanded, br=br, bc=bc,
                n_blocks=bsr.n_blocks, widths=tuple(widths))


def _x_blocks(A: BsrG, X: jnp.ndarray) -> jnp.ndarray:
    """(nb_x + 1, bc, k) dense blocks of X with a trailing zero block."""
    k = X.shape[1]
    nb_x = (A.n + A.bc - 1) // A.bc
    Xp = jnp.pad(X, ((0, nb_x * A.bc - A.n), (0, 0)))
    return jnp.concatenate(
        [Xp.reshape(nb_x, A.bc, k), jnp.zeros((1, A.bc, k), X.dtype)])


@register_spmm("BSRG", "xla")
def spmm_bsrg(A: BsrG, X: jnp.ndarray) -> jnp.ndarray:
    k = X.shape[1]
    xb = _x_blocks(A, X)
    outs = []
    for w in A.widths:
        ic, vc = A.idx[w], A.val[w]
        xg = xb.at[ic].get(mode="promise_in_bounds")   # (mc, w, bc, k)
        outs.append(jnp.einsum("mwrc,mwck->mrk", vc.astype(X.dtype), xg,
                               precision=jax.lax.Precision.HIGHEST))
    Yb = jnp.concatenate(outs, axis=0)                 # (mb, br, k)
    Yb = Yb.at[A.inv_perm].get(mode="promise_in_bounds")
    return Yb.reshape(-1, k)[: A.m]


@register_spmv("BSRG", "xla")
def spmv_bsrg(A: BsrG, x: jnp.ndarray) -> jnp.ndarray:
    return spmm_bsrg(A, x[:, None])[:, 0]


@register_sddmm("BSR", "xla")
def sddmm_bsr(S: BSR, A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Block-dense SDDMM: C_blk = A_blk @ B_blkᵀ per stored block — pure
    batched matmuls, no per-entry extraction (the block IS the output
    layout). Returns (n_blocks_pad·br·bc,) values aligned with ``S.data``,
    masked to the stored pattern (fill slots stay 0)."""
    br, bc, k = S.br, S.bc, A.shape[1]
    mb = (S.m + br - 1) // br
    nb_x = (S.n + bc - 1) // bc
    Ap = jnp.pad(A, ((0, mb * br - S.m), (0, 0))).reshape(mb, br, k)
    Bp = jnp.pad(B, ((0, nb_x * bc - S.n), (0, 0))).reshape(nb_x, bc, k)
    rows = jnp.minimum(S.block_rows, mb - 1)           # padding blocks
    cols = jnp.minimum(S.block_cols, nb_x - 1)
    Ag = Ap.at[rows].get(mode="promise_in_bounds")     # (nb, br, k)
    Bg = Bp.at[cols].get(mode="promise_in_bounds")     # (nb, bc, k)
    C = jnp.einsum("nrk,nck->nrc", Ag, Bg,
                   precision=jax.lax.Precision.HIGHEST)  # (nb, br, bc)
    mask = (S.data != 0) & (S.block_rows < mb)[:, None, None]
    return jnp.where(mask, C, 0.0).reshape(-1)
