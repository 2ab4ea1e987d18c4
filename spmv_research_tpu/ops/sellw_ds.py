"""SELLWDS: fp64-parity SpMV *at speed* — double-single value planes on the
SELLW routing program.

The reference's headline dtype is double at full memory bandwidth
(``benchmark_code/BENCH/src/bench_spmv.cpp:61-64``, ``make.sh`` ``_d``
targets). CSRDS (ops/compensated.py) proves the 1e-10 gate with
XLA-gather double-single arithmetic. Here the SAME routing planes as SELLW
(word bits, sublane binding, stage classes, part capping — the coordinate
program does not care about the value dtype) carry an (hi, lo) fp32 pair
value plane, and the pipeline becomes:

* gather: two lane-picks (x hi/lo planes);
* product: Dekker TwoProd(vhi, xhi) + first-order cross terms;
* scan: guarded segmented **TwoSum** scan (the error plane rides along);
* extraction + per-block combine: sequential TwoSum folds (sublanes, then
  yidx chunks) — a plain fp32 sum here would throw away the 2^-48 margin.

Error after an n-term row: O(n·2^-48) relative — passes the reference's
fp64 gate (1e-10 vs longdouble-Kahan gold) like CSRDS, at engine speed
(~12 B/slot traffic, the same op classes as SELLW ×~2.5).

Operand range: the fp32 Dekker split overflows for |v| ≥ ~8e34 (see
ops/compensated.py DS_MAX_ABS) — build rejects such matrices.
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
from .clos_route import LANES, SUB
from .compensated import DS_MAX_ABS, _split_f64, _two_sum
from .sellw import SellW, SellWBuildError, build_sellw


@partial(_register, data_fields=("base", "vlo"), meta_fields=())
@dataclasses.dataclass(frozen=True)
class SellWDS:
    base: SellW          # routing program + hi value plane (base.vals)
    vlo: jnp.ndarray     # (8·nchunks_pad, 128) fp32 value lo plane

    format_name = "SELLWDS"

    # SellW interface passthrough (harness/dispatch introspection)
    @property
    def shape(self):
        return self.base.shape

    @property
    def m(self):
        return self.base.m

    @property
    def n(self):
        return self.base.n

    @property
    def nnz(self):
        return self.base.nnz

    @property
    def nnz_expanded(self):
        return self.base.nnz_expanded

    def mem_footprint_bytes(self) -> int:
        return int(self.base.mem_footprint_bytes() + self.vlo.size * 4)


def build_sellwds(csr: HostCSR, dtype=jnp.float32, group: int = 2,
                  part_cap: int = 8,
                  max_chunk_factor: float = 4.0) -> SellWDS:
    """Compile host CSR (fp64 values) into the DS program. ``dtype`` is
    accepted for builder-signature parity and must be float32."""
    if np.dtype(dtype) != np.float32:
        raise SellWBuildError("SELLWDS is an fp32-pair format")
    amax = float(np.max(np.abs(csr.a))) if csr.nnz else 0.0
    if amax >= DS_MAX_ABS:
        raise SellWBuildError(
            f"max|a| = {amax:.3g} overflows the fp32 Dekker split")
    base, idxp = build_sellw(csr, dtype=jnp.float32, group=group,
                             part_cap=part_cap,
                             max_chunk_factor=max_chunk_factor,
                             want_idx=True)
    hi = csr.a.astype(np.float32)
    lo = (csr.a.astype(np.float64) - hi.astype(np.float64)).astype(
        np.float32)
    vlo = np.zeros(idxp.shape, np.float32)
    live = idxp >= 0
    vlo[live] = lo[idxp[live]]
    return SellWDS(base=base, vlo=jnp.asarray(vlo))


# ---------------------------------------------------------------- kernels

def _split32(a):
    c = jnp.float32(4097.0) * a
    ahi = c - (c - a)
    return ahi, a - ahi


def _x_planes(A: SellWDS, xhi, xlo):
    B = A.base
    pad = B.x_rows * LANES - xhi.shape[0]
    xh = jnp.pad(xhi, (0, pad)).reshape(B.x_rows, LANES)
    xl = jnp.pad(xlo, (0, pad)).reshape(B.x_rows, LANES)
    return xh, xl


def _combine_y_ds(B: SellW, s_planes, e_planes):
    """Per-y-block combine of chunk partials: sequential TwoSum over the
    K yidx rows (a plain sum would drop to fp32 accuracy)."""
    z = jnp.zeros((1, LANES), jnp.float32)
    outs = jnp.concatenate(list(s_planes) + [z], axis=0)
    oute = jnp.concatenate(list(e_planes) + [z], axis=0)
    seg_s = outs.at[B.yidx].get(mode="promise_in_bounds")  # (K, nb, LANES)
    seg_e = oute.at[B.yidx].get(mode="promise_in_bounds")
    S = jnp.zeros(seg_s.shape[1:], jnp.float32)
    E = jnp.zeros(seg_s.shape[1:], jnp.float32)
    for k in range(B.K):
        S, e1 = _two_sum(S, seg_s[k])
        E = E + e1 + seg_e[k]
    return S.reshape(-1)[: B.m], E.reshape(-1)[: B.m]


def spmv_sellwds_xla_pair(A: SellWDS, xhi, xlo):
    """Pair-in, pair-out SpMV: (xhi, xlo) fp32 planes -> (s, e) planes."""
    B = A.base
    nch = B.wrow.shape[0] // SUB
    xh, xl = _x_planes(A, xhi, xlo)
    winh = xh.at[B.wrow].get(mode="promise_in_bounds")
    winl = xl.at[B.wrow].get(mode="promise_in_bounds")
    w = B.word
    lanepick = w & 0x7F
    gxh = jnp.take_along_axis(winh, lanepick, axis=1)
    gxl = jnp.take_along_axis(winl, lanepick, axis=1)

    p = B.vals * gxh
    ahi, alo = _split32(B.vals)
    bhi, blo = _split32(gxh)
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    e = e + B.vals * gxl + A.vlo * gxh
    s_, e_ = p, e
    for k in range(B.stages):
        g = ((w >> (7 + k)) & 1) != 0
        rs = jnp.roll(s_, 1 << k, axis=1)
        re = jnp.roll(e_, 1 << k, axis=1)
        rsg = jnp.where(g, rs, 0.0)
        t = s_ + rsg
        bb = t - s_
        err = (s_ - (t - bb)) + (rsg - bb)
        e_ = e_ + jnp.where(g, re, 0.0) + err
        s_ = t
    eidx = (w >> 14) & 0x7F
    Es = jnp.take_along_axis(s_, eidx, axis=1).reshape(nch, SUB, LANES)
    Ee = jnp.take_along_axis(e_, eidx, axis=1).reshape(nch, SUB, LANES)
    live = (((w >> 21) & 1) != 0).reshape(nch, SUB, LANES)
    bid = ((w >> 22) & (B.G - 1)).reshape(nch, SUB, LANES)
    s_planes, e_planes = [], []
    for gg in range(B.G):
        mask = live & (bid == gg)
        S = jnp.zeros((nch, LANES), jnp.float32)
        E = jnp.zeros((nch, LANES), jnp.float32)
        for si in range(SUB):
            v = jnp.where(mask[:, si], Es[:, si], 0.0)
            S, e1 = _two_sum(S, v)
            E = E + e1 + jnp.where(mask[:, si], Ee[:, si], 0.0)
        s_planes.append(S)
        e_planes.append(E)
    return _combine_y_ds(B, s_planes, e_planes)


def spmv_sellwds_f64(A: SellWDS, x: np.ndarray) -> np.ndarray:
    """Host fp64 -> device DS pair -> host fp64 (~2^-48 relative)."""
    xhi, xlo = _split_f64(np.asarray(x, np.float64))
    s, e = jax.jit(spmv_sellwds_xla_pair)(A, jnp.asarray(xhi),
                                          jnp.asarray(xlo))
    return np.asarray(s, np.float64) + np.asarray(e, np.float64)


@register_spmv("SELLWDS", "xla")
def spmv_sellwds_xla(A: SellWDS, x: jnp.ndarray) -> jnp.ndarray:
    s, e = spmv_sellwds_xla_pair(A, x.astype(jnp.float32),
                                 jnp.zeros_like(x))
    return s + e


SellWDS.spmv_f64 = spmv_sellwds_f64   # harness fp64-gate hook (bench_spmv)
