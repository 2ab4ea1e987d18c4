"""Row-gather SpMM / SDDMM — the dense-k workloads as row gathers.

For SpMM/SDDMM every nonzero consumes a k-wide dense row, so the whole
gather problem is row-granular (contiguous k-wide rows instead of single
elements):

* **SpMM** (``SELLG`` format): rows are sorted by length into power-of-two
  width classes; within a class, padded (m_c, w_c) column-index and value
  slabs drive w_c steps of ``Y_c += val[:, j:j+1] * Xp[idx[:, j]]`` — one
  row-gather + FMA per step, all XLA. Total work Σ m_c·w_c·k ≤ ~2·nnz·k.
  Padding columns point at an appended zero row of X. Output rows are
  de-sorted with one final row-gather.

* **SDDMM** (plain CSR): ``C = Σ_k A[rows]·B[cols]`` — two (nnz, k)
  row-gathers and a lane reduction, chunked over nnz to bound the
  intermediate.

Role: the reference's ``spmm_kernels/`` and ``sddmm_kernels/`` trees
(``benchmark_code/BENCH/src/bench_sddmm.cpp:279-345``); K from the same
``K_DIM`` sweep.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.host import HostCSR
from .dispatch import register_spmm, register_sddmm


def _register(cls, data_fields, meta_fields):
    jax.tree_util.register_dataclass(cls, data_fields=list(data_fields),
                                     meta_fields=list(meta_fields))
    return cls


@partial(_register,
         data_fields=("idx", "val", "inv_perm"),
         meta_fields=("shape", "nnz", "nnz_expanded", "widths", "counts"))
@dataclasses.dataclass(frozen=True)
class SellG:
    """Width-classed gather slabs for SpMM.

    ``idx``/``val`` are dicts keyed by class width w: (m_w, w) arrays.
    ``inv_perm[r]`` = position of output row r in the sorted concatenation.
    Padding entries: idx = n (the appended zero row of X), val = 0.
    """

    idx: Dict[int, jnp.ndarray]
    val: Dict[int, jnp.ndarray]
    inv_perm: jnp.ndarray
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    widths: Tuple[int, ...]
    counts: Tuple[int, ...]

    format_name = "SELLG"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mem_footprint_bytes(self) -> int:
        tot = sum(int(np.prod(a.shape)) for a in self.idx.values())
        return tot * (4 + self.inv_perm.dtype.itemsize) + self.m * 4


def build_sellg(csr: HostCSR, dtype=jnp.float32) -> SellG:
    dt = np.dtype(dtype)
    m, n, nnz = csr.m, csr.n, csr.nnz
    lengths = csr.row_lengths()
    order = np.argsort(lengths, kind="stable")
    inv_perm = np.empty(m, np.int32)
    inv_perm[order] = np.arange(m, dtype=np.int32)

    idx, val, widths, counts = {}, {}, [], []
    lo = 0
    Ls = lengths[order]
    pos = 0
    while lo < m:
        w = max(1, 1 << int(max(int(Ls[lo]), 1) - 1).bit_length())
        hi = int(np.searchsorted(Ls, w, side="right"))
        hi = max(hi, lo + 1)
        rows_c = order[lo:hi]
        mc = hi - lo
        ic = np.full((mc, w), n, np.int32)
        vc = np.zeros((mc, w), dt)
        for t, r in enumerate(rows_c):
            a, b = csr.ia[r], csr.ia[r + 1]
            ic[t, : b - a] = csr.ja[a:b]
            vc[t, : b - a] = csr.a[a:b].astype(dt)
        idx[w] = jnp.asarray(ic)
        val[w] = jnp.asarray(vc)
        widths.append(w)
        counts.append(mc)
        lo = hi
    return SellG(idx=idx, val=val, inv_perm=jnp.asarray(inv_perm),
                 shape=(m, n), nnz=nnz, nnz_expanded=csr.nnz_expanded,
                 widths=tuple(widths), counts=tuple(counts))


@register_spmm("SELLG", "xla")
def spmm_sellg(A: SellG, X: jnp.ndarray) -> jnp.ndarray:
    k = X.shape[1]
    Xp = jnp.concatenate([X, jnp.zeros((1, k), X.dtype)], axis=0)
    outs = []
    for w in A.widths:
        ic, vc = A.idx[w], A.val[w]
        mc = ic.shape[0]

        def step(j, Y, ic=ic, vc=vc):
            col = jax.lax.dynamic_slice_in_dim(ic, j, 1, 1)[:, 0]
            v = jax.lax.dynamic_slice_in_dim(vc, j, 1, 1)
            g = Xp.at[col].get(mode="promise_in_bounds")
            return Y + v.astype(X.dtype) * g

        Y = jnp.zeros((mc, k), X.dtype)
        if w <= 4:
            for j in range(w):
                Y = step(j, Y)
        else:
            Y = jax.lax.fori_loop(0, w, step, Y)
        outs.append(Y)
    Yall = jnp.concatenate(outs, axis=0)
    return Yall.at[A.inv_perm].get(mode="promise_in_bounds")


@register_sddmm("CSR", "gather")
def sddmm_csr_gather(S, A: jnp.ndarray, B: jnp.ndarray,
                     chunk: int = 1 << 17) -> jnp.ndarray:
    """C[j] = dot(A[rows[j], :k], B[cols[j], :k]) via chunked row-gathers."""
    nnz_pad = S.rows.shape[0]
    k = A.shape[1]
    Ap = jnp.concatenate([A, jnp.zeros((1, k), A.dtype)], axis=0)
    rows = jnp.minimum(S.rows, A.shape[0])  # padding rows -> zero row

    def chunk_fn(r, c):
        ga = Ap.at[r].get(mode="promise_in_bounds")
        gb = B.at[c].get(mode="promise_in_bounds")
        return jnp.sum(ga * gb, axis=1)

    if nnz_pad <= chunk:
        return chunk_fn(rows, S.indices)
    n_chunks = (nnz_pad + chunk - 1) // chunk
    pad = n_chunks * chunk - nnz_pad
    rs = jnp.pad(rows, (0, pad), constant_values=A.shape[0]).reshape(
        n_chunks, chunk)
    cs = jnp.pad(S.indices, (0, pad)).reshape(n_chunks, chunk)
    out = jax.lax.map(lambda rc: chunk_fn(*rc), (rs, cs))
    return out.reshape(-1)[:nnz_pad]
