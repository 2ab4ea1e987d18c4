"""Double-single ("compensated fp32 pair") SpMV — the fp64-parity path.

The reference's headline dtype is double with a 1e-10 relative-error gate
against a ``_Float128`` Kahan gold (``benchmark_code/BENCH/src/
bench_spmv.cpp:61-64,114-119``). This path represents every fp64 operand
as an exact pair of fp32s (``hi + lo``, Dekker/Knuth double-single
arithmetic, ~2^-48 unit roundoff) and runs the whole SpMV in paired-fp32
(the H200 also runs fp64 natively; which of the two wins is open):

* TwoProd via Dekker splitting (no FMA primitive assumed);
* TwoSum accumulation along padded row segments;
* final ``hi + lo`` recombination in fp64 on host.

Error after an n-term row sum is O(n · 2^-48) relative — passes the 1e-10
gate for any realistic row degree (n ≲ 1e9 · ulp⁻¹ margin).

This is a *parity/accuracy* engine, not a throughput engine: the x-gather
uses the XLA path.  For fp64 end-to-end on the CPU backend (true float64),
use ``spmv(A, x, impl="xla")`` on a ``build_csr(host, dtype=float64)``
format inside ``jax.experimental.enable_x64``.

Layout: rows split into segments of ≤ ``SEG`` nnz; segments padded into a
``(nseg, SEG)`` plane (hi/lo value planes + column plane); per-row segment
lists padded into ``(m_pad, KSEG)``.  Both reductions are sequential
TwoSum folds (correct compensated order), vectorized across rows.
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
from .clos import _register

SEG = 64  # nnz per padded row segment


def _split_f64(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _two_sum(a, b):
    """Knuth TwoSum: a+b = s + e exactly (6 flops, branch-free)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split32(a):
    """Dekker split of fp32 into 12+12-bit halves (exact).

    Operand range: ``4097*a`` overflows fp32 for |a| ≥ ~8.3e34, silently
    turning TwoProd error terms into NaN — :func:`build_csrds` rejects
    matrices whose |values| exceed ``DS_MAX_ABS`` at build time."""
    c = jnp.float32(4097.0) * a  # 2^12 + 1
    ahi = c - (c - a)
    return ahi, a - ahi


def _two_prod(a, b):
    """Dekker TwoProd: a*b = p + e exactly in fp32 pairs (no FMA)."""
    p = a * b
    ahi, alo = _split32(a)
    bhi, blo = _split32(b)
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


@partial(_register,
         data_fields=("vhi", "vlo", "cols", "segrow", "xpad_mask"),
         meta_fields=("shape", "nnz", "nnz_expanded", "kseg"))
@dataclasses.dataclass(frozen=True)
class CsrDS:
    """Double-single padded-segment CSR (fp64-parity format)."""

    vhi: jnp.ndarray       # (nseg, SEG) fp32 value hi
    vlo: jnp.ndarray       # (nseg, SEG) fp32 value lo
    cols: jnp.ndarray      # (nseg, SEG) int32 column (0 where pad)
    segrow: jnp.ndarray    # (m_pad, KSEG) int32 segment id per row (-1 pad)
    xpad_mask: jnp.ndarray  # (nseg, SEG) fp32 1.0 live / 0.0 pad
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    kseg: int

    format_name = "CSRDS"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    def mem_footprint_bytes(self) -> int:
        return int(self.vhi.size * 4 + self.vlo.size * 4 + self.cols.size * 4
                   + self.segrow.size * 4 + self.xpad_mask.size * 4)


DS_MAX_ABS = 8.0e34   # Dekker-split overflow bound (see _split32)


def build_csrds(csr: HostCSR) -> CsrDS:
    """Compile host CSR (fp64 values) into the double-single format."""
    amax = float(np.max(np.abs(csr.a))) if csr.nnz else 0.0
    if amax >= DS_MAX_ABS:
        raise ValueError(
            f"CSRDS operand range exceeded: max|a| = {amax:.3g} >= "
            f"{DS_MAX_ABS:.1g} overflows the fp32 Dekker split (scale the "
            "matrix or use the fp64 CPU-backend path)")
    m, n = csr.m, csr.n
    ia = csr.ia.astype(np.int64)
    ja = csr.ja.astype(np.int64)
    a = csr.a.astype(np.float64)
    lens = np.diff(ia)
    nseg_per_row = np.maximum((lens + SEG - 1) // SEG, 0)
    kseg = max(int(nseg_per_row.max(initial=0)), 1)
    nseg = max(int(nseg_per_row.sum()), 1)

    vhi = np.zeros((nseg, SEG), np.float32)
    vlo = np.zeros((nseg, SEG), np.float32)
    cols = np.zeros((nseg, SEG), np.int32)
    mask = np.zeros((nseg, SEG), np.float32)
    segrow = np.full((m, kseg), -1, np.int64)

    hi_all, lo_all = _split_f64(a)
    s = 0
    for i in range(m):
        e0, e1 = int(ia[i]), int(ia[i + 1])
        k = 0
        for p in range(e0, e1, SEG):
            q = min(p + SEG, e1)
            w = q - p
            vhi[s, :w] = hi_all[p:q]
            vlo[s, :w] = lo_all[p:q]
            cols[s, :w] = ja[p:q]
            mask[s, :w] = 1.0
            segrow[i, k] = s
            s += 1
            k += 1
    # -1 pads point at a scratch segment of zeros (the last+1 is avoided by
    # clamping to 0 and relying on the zero mask of a dedicated pad row)
    pad_seg = nseg  # one extra all-zero segment
    vhi = np.vstack([vhi, np.zeros((1, SEG), np.float32)])
    vlo = np.vstack([vlo, np.zeros((1, SEG), np.float32)])
    cols = np.vstack([cols, np.zeros((1, SEG), np.int32)])
    mask = np.vstack([mask, np.zeros((1, SEG), np.float32)])
    segrow = np.where(segrow < 0, pad_seg, segrow)

    return CsrDS(vhi=jnp.asarray(vhi), vlo=jnp.asarray(vlo),
                 cols=jnp.asarray(cols), segrow=jnp.asarray(
                     segrow.astype(np.int32)),
                 xpad_mask=jnp.asarray(mask), shape=(m, n), nnz=csr.nnz,
                 nnz_expanded=csr.nnz_expanded, kseg=kseg)


def _ds_spmv_planes(A: CsrDS, xhi: jnp.ndarray, xlo: jnp.ndarray):
    """Per-segment compensated partial sums -> per-row pair (hi, lo)."""
    gx_hi = jnp.take(xhi, A.cols.reshape(-1), axis=0).reshape(A.cols.shape)
    gx_lo = jnp.take(xlo, A.cols.reshape(-1), axis=0).reshape(A.cols.shape)
    mask = A.xpad_mask
    # elementwise DS product: (vhi+vlo)*(xhi+xlo) = p + e
    p, e = _two_prod(A.vhi, gx_hi * mask)
    e = e + A.vhi * gx_lo * mask + A.vlo * gx_hi * mask
    # sequential TwoSum fold along the segment axis
    def fold(carry, col):
        s, err = carry
        ph, pe = col
        s, e1 = _two_sum(s, ph)
        err = err + e1 + pe
        return (s, err), None

    (s, err), _ = jax.lax.scan(
        fold,
        (jnp.zeros(p.shape[0], jnp.float32), jnp.zeros(p.shape[0],
                                                       jnp.float32)),
        (p.T, e.T))
    # per-row combine across segments (<= kseg, sequential TwoSum);
    # pad rows point at the dedicated all-zero segment appended by the build
    seg_s = s[A.segrow]
    seg_e = err[A.segrow]
    rs = jnp.zeros(A.segrow.shape[0], jnp.float32)
    re = jnp.zeros(A.segrow.shape[0], jnp.float32)
    for k in range(A.kseg):
        rs, e1 = _two_sum(rs, seg_s[:, k])
        re = re + e1 + seg_e[:, k]
    return rs, re


def spmv_csrds_pair(A: CsrDS, xhi: jnp.ndarray, xlo: jnp.ndarray):
    """Pair-in, pair-out SpMV (for iterative solvers staying in DS)."""
    rs, re = _ds_spmv_planes(A, xhi, xlo)
    s, e = _two_sum(rs, re)
    return s, e


@register_spmv("CSRDS", "xla")
def spmv_csrds_xla(A: CsrDS, x: jnp.ndarray) -> jnp.ndarray:
    """fp32-input convenience entry (x promoted with zero lo plane).

    For full fp64 fidelity call :func:`spmv_csrds_f64` from host with an
    fp64 x; this dispatch entry exists so the generic harness can drive
    the format with its fp32 vectors (the *values* still carry fp64
    precision, which is what the conversion-fidelity tests check).
    """
    xhi = x.astype(jnp.float32)
    xlo = jnp.zeros_like(xhi)
    s, e = spmv_csrds_pair(A, xhi, xlo)
    return s + e


def spmv_csrds_f64(A: CsrDS, x: np.ndarray) -> np.ndarray:
    """Host fp64 -> device DS pair -> host fp64 with ~2^-48 accuracy.

    The returned vector passes the reference's fp64 gate (1e-10 relative,
    ``bench_spmv.cpp:114-119``) against the longdouble Kahan gold.
    """
    xhi, xlo = _split_f64(np.asarray(x, np.float64))
    s, e = jax.jit(spmv_csrds_pair)(A, jnp.asarray(xhi), jnp.asarray(xlo))
    return (np.asarray(s, np.float64) + np.asarray(e, np.float64))[: A.m]


CsrDS.spmv_f64 = spmv_csrds_f64   # harness fp64-gate hook (bench_spmv)
