"""Radix-1024 Clos routing for the routed SpMV engines.

The BFLY engine (``routing.py``) executes arbitrary permutations as ~2·log2(N)
binary butterfly stages. This module replaces each Beneš network with a
3-level **Clos** factorization over blocks of 1024 slots (8 rows x 128
lanes, called a "vreg" below):

    perm = R1 ∘ T ∘ R2 ∘ T ∘ R3

where T is a (V,1024)-transpose and each R* is an independent *per-block*
permutation executed as 3 shuffle passes (lane-pick / row-pick /
lane-pick). Total: 9 shuffle passes + 2 transposes per network instead of
~39 roll stages.

Routing theory (all standard):
  * Global level: elements are edges of a bipartite multigraph between source
    vregs and destination vregs; a proper 1024-edge-coloring (exists by König:
    degrees are exactly 1024 after completing to a full permutation) assigns
    each element its intermediate position c; R1 brings it to position c of
    its source vreg, the transpose moves it to vreg c, R2 moves it to position
    v_dst, the second transpose to vreg v_dst, R3 to its final position.
  * In-vreg level: same theorem one level down — elements inside one vreg are
    edges between source sublanes and destination sublanes; a 128-coloring
    gives the intermediate *lane*; (lane-pick, sublane-pick, lane-pick).
  * Edge colorings are computed by Euler-split recursion (degree halving),
    fully vectorized: pair incident edges per vertex, 2-color the resulting
    alternating cycles by pointer-doubling orbit representatives.

Reference role: same as ``routing.py`` — the data-movement compiler replacing
the reference's per-ISA SpMV kernels (``benchmark_code/BENCH/src/spmv_kernels``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

BLK = 1024          # slots per vreg (8 sublanes x 128 lanes)
SUB = 8
LANES = 128


class ClosRoutingError(ValueError):
    pass


# --------------------------------------------------------------------------
# Euler-split bipartite edge coloring (vectorized)
# --------------------------------------------------------------------------

def _orbit_rep(perm: np.ndarray) -> np.ndarray:
    """Minimum index over each orbit of the permutation, via pointer doubling."""
    rep = np.arange(perm.shape[0], dtype=np.int64)
    p = perm.astype(np.int64)
    steps = max(int(perm.shape[0]).bit_length(), 1)
    for _ in range(steps):
        rep = np.minimum(rep, rep[p])
        p = p[p]
    return rep


def _pair_by_vertex(vertex: np.ndarray) -> np.ndarray:
    """Involution pairing edges that share a vertex: sort edges by vertex and
    pair consecutive entries. Every vertex degree must be even."""
    order = np.argsort(vertex, kind="stable")
    pair = np.empty_like(order)
    pair[order[0::2]] = order[1::2]
    pair[order[1::2]] = order[0::2]
    return pair


def euler_edge_color(left: np.ndarray, right: np.ndarray,
                     levels: int) -> np.ndarray:
    """Proper edge coloring of a bipartite multigraph with 2^levels colors.

    Every vertex (on both sides) must have degree exactly 2^levels. Returns
    per-edge colors in [0, 2^levels). Euler-split: at each level, pair edges
    at every vertex, 2-color the alternating pairing cycles, recurse on each
    half; vectorized by carrying the accumulated color as a vertex-id prefix.

    The native tier (cycle walking, O(E)/level) dominates CLOSG program
    build time; this numpy tier (argsort + pointer-doubling orbit reps,
    O(E log E)/level) is the always-available fallback.
    """
    from ..io.native import have_euler_edge_color, euler_edge_color_native
    if have_euler_edge_color():
        color = euler_edge_color_native(left, right, levels)
        if color is not None:
            return color
    E = left.shape[0]
    color = np.zeros(E, dtype=np.int64)
    left = left.astype(np.int64)
    right = right.astype(np.int64)
    for lvl in range(levels):
        # split every (color-class, vertex) independently: prefix the vertex
        # ids with the current color so classes don't interact
        pl = _pair_by_vertex(color * (left.max() + 1) + left)
        pr = _pair_by_vertex(color * (right.max() + 1) + right)
        g = pr[pl]                      # step by two links along the cycle
        rep = _orbit_rep(g)
        bit = (rep > rep[pl]).astype(np.int64)
        color = color * 2 + bit
    return color.astype(np.int32)


# --------------------------------------------------------------------------
# In-vreg 3-stage routing
# --------------------------------------------------------------------------

@dataclasses.dataclass
class InVregPlanes:
    """One per-vreg permutation layer as 3 shuffle planes (all int8).

    ``lane1[s, c] = l``   : stage 1 output (s, c) reads input (s, l)
    ``subrot[s', c] = r`` : stage 2 output (s', c) reads stage-1 (s'+r mod 8, c)
                            (rotation within the vreg's 8 sublanes)
    ``lane2[s', l'] = c`` : stage 3 output (s', l') reads stage-2 (s', c)
    Shapes are (8·n_vregs, n_lanes).
    """

    lane1: np.ndarray
    subrot: np.ndarray
    lane2: np.ndarray


def route_invreg(vreg: np.ndarray, pos_src: np.ndarray, pos_dst: np.ndarray,
                 n_vregs: int, n_lanes: int) -> InVregPlanes:
    """Route, within every vreg independently, the full permutation
    pos_src -> pos_dst (positions in [0, 8*n_lanes)). Every vreg must be
    fully covered (exactly 8*n_lanes elements, distinct src, distinct dst)."""
    if n_lanes & (n_lanes - 1):
        raise ClosRoutingError(f"n_lanes must be a power of two ({n_lanes})")
    s_src, l_src = pos_src // n_lanes, pos_src % n_lanes
    s_dst, l_dst = pos_dst // n_lanes, pos_dst % n_lanes
    c = euler_edge_color(vreg * SUB + s_src, vreg * SUB + s_dst,
                         n_lanes.bit_length() - 1)
    lane1 = np.empty((n_vregs * SUB, n_lanes), np.int8)
    subrot = np.empty((n_vregs * SUB, n_lanes), np.int8)
    lane2 = np.empty((n_vregs * SUB, n_lanes), np.int8)
    lane1[vreg * SUB + s_src, c] = l_src
    subrot[vreg * SUB + s_dst, c] = (s_src - s_dst) % SUB
    lane2[vreg * SUB + s_dst, l_dst] = c
    return InVregPlanes(lane1=lane1, subrot=subrot, lane2=lane2)


def apply_invreg_numpy(v: np.ndarray, p: InVregPlanes) -> np.ndarray:
    """Reference execution of one in-vreg layer on a (8·n_vregs, n_lanes)
    array (mirrors the XLA lowering ``clos._invreg_xla`` op-for-op)."""
    S, W = v.shape
    t1 = np.take_along_axis(v, p.lane1.astype(np.int64), axis=1)
    rows = np.arange(S)
    blk = rows // SUB * SUB
    src_rows = blk[:, None] + (rows[:, None] % SUB + p.subrot) % SUB
    t2 = t1[src_rows, np.arange(W)[None, :]]
    return np.take_along_axis(t2, p.lane2.astype(np.int64), axis=1)


# --------------------------------------------------------------------------
# Full 5-stage Clos permutation
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ClosPerm:
    """One N-slot permutation as R1 ∘ T ∘ R2 ∘ T ∘ R3 (N = V·1024)."""

    V: int
    r1: InVregPlanes   # planes (8V, 128)
    r2: InVregPlanes   # planes (8·1024, V/8)
    r3: InVregPlanes   # planes (8V, 128)


def _complete_permutation(src: np.ndarray, dst: np.ndarray, N: int):
    """Extend a partial injection src->dst to a full permutation of [N]."""
    used_s = np.zeros(N, bool)
    used_s[src] = True
    used_d = np.zeros(N, bool)
    used_d[dst] = True
    free_s = np.nonzero(~used_s)[0]
    free_d = np.nonzero(~used_d)[0]
    return (np.concatenate([src, free_s]), np.concatenate([dst, free_d]))


def route_clos(src: np.ndarray, dst: np.ndarray, N: int) -> ClosPerm:
    """Compile the partial injection src->dst (distinct positions in [0,N))
    into a 5-stage Clos program. N must be V·1024 with V a power of two."""
    V = N // BLK
    if V * BLK != N or (V & (V - 1)) or V < SUB:
        raise ClosRoutingError(f"N must be (power-of-two ≥ 8)·1024, got {N}")
    fsrc, fdst = _complete_permutation(np.asarray(src, np.int64),
                                       np.asarray(dst, np.int64), N)
    v_s, p_s = fsrc // BLK, fsrc % BLK
    v_d, p_d = fdst // BLK, fdst % BLK
    c = euler_edge_color(v_s, v_d, 10).astype(np.int64)
    # the three in-vreg routings are independent; the native coloring
    # releases the GIL, so threads cut the routing wall time ~2-3x
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(3) as ex:
        f1 = ex.submit(route_invreg, v_s, p_s, c, V, LANES)
        # after T1 the element sits in vreg c at position v_s ([0,V))
        f2 = ex.submit(route_invreg, c, v_s, v_d, BLK, V // SUB)
        # after T2 it sits in vreg v_d at position c
        f3 = ex.submit(route_invreg, v_d, c, p_d, V, LANES)
        r1, r2, r3 = f1.result(), f2.result(), f3.result()
    return ClosPerm(V=V, r1=r1, r2=r2, r3=r3)


def apply_clos_numpy(v: np.ndarray, perm: ClosPerm) -> np.ndarray:
    """Reference execution on a flat (N,) array."""
    V = perm.V
    w = apply_invreg_numpy(v.reshape(SUB * V, LANES), perm.r1)
    w = w.reshape(V, BLK).T.copy()                       # T1
    w = apply_invreg_numpy(w.reshape(SUB * BLK, V // SUB), perm.r2)
    w = w.reshape(BLK, V).T.copy()                       # T2
    w = apply_invreg_numpy(w.reshape(SUB * V, LANES), perm.r3)
    return w.reshape(-1)
