"""Row/column reordering: Reverse Cuthill–McKee and degree/σ sorting.

RCM is the reference's bandwidth-reduction pass (``lib/rcm/rcm_gen.c:127``
``reverse_cuthill_mckee``, applied when ``USE_RCM_REORDERING=1`` —
``bench.cpp:592-598``). Bandwidth reduction gives the column locality that
lets x-gathers hit cached x-blocks, and that the locality engines (SELLW,
SELLR) pack into dense slots. We use scipy's RCM when available (same BFS algorithm) with a numpy
fallback, and add σ-sorting (windowed sort of rows by length) used by SELL-C-σ.
"""

from __future__ import annotations

import numpy as np

from ..core.host import HostCSR
from .coo_csr import csr_row_permute


def reverse_cuthill_mckee(csr: HostCSR, symmetric: bool = True) -> np.ndarray:
    """Return the RCM permutation `perm` (new index i ← old index perm[i]).

    Tiers: scipy's C implementation → the native C++ BFS
    (native/sparse_host.cpp rcm) → pure-python fallback."""
    try:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee as _rcm

        mat = sp.csr_matrix((np.ones(csr.nnz), csr.ja, csr.ia), shape=(csr.m, csr.n))
        return np.asarray(_rcm(mat, symmetric_mode=symmetric), dtype=np.int64)
    except ImportError:  # pragma: no cover - scipy is baked in
        from ..io import native as _native

        if _native.have_native():
            return _native.rcm_native(csr.ia, csr.ja, csr.m)
        return _rcm_numpy(csr)


def _rcm_numpy(csr: HostCSR) -> np.ndarray:
    """BFS-based RCM (Cuthill–McKee then reverse), pure numpy/python."""
    m = csr.m
    deg = csr.row_lengths()
    visited = np.zeros(m, dtype=bool)
    order = []
    ia, ja = csr.ia, csr.ja
    for start in np.argsort(deg, kind="stable"):
        if visited[start]:
            continue
        queue = [int(start)]
        visited[start] = True
        while queue:
            u = queue.pop(0)
            order.append(u)
            nbrs = ja[ia[u] : ia[u + 1]]
            nbrs = [int(v) for v in nbrs if not visited[v]]
            nbrs.sort(key=lambda v: deg[v])
            for v in nbrs:
                visited[v] = True
                queue.append(v)
    return np.array(order[::-1], dtype=np.int64)


def rcm_reorder(csr: HostCSR) -> tuple[HostCSR, np.ndarray]:
    """Apply RCM symmetric permutation; returns (reordered_csr, perm)."""
    perm = reverse_cuthill_mckee(csr)
    return csr_row_permute(csr, perm, permute_columns=True), perm


def sigma_sort_rows(csr: HostCSR, sigma: int) -> np.ndarray:
    """σ-sorting permutation: within consecutive windows of `sigma` rows, sort
    rows by descending length (SELL-C-σ preprocessing; reference
    ``sell_sorted.cpp:184``). sigma <= 1 → identity; sigma >= m → global sort."""
    lengths = csr.row_lengths()
    m = csr.m
    if sigma <= 1:
        return np.arange(m, dtype=np.int64)
    perm = np.empty(m, dtype=np.int64)
    for w0 in range(0, m, sigma):
        w1 = min(w0 + sigma, m)
        local = np.argsort(-lengths[w0:w1], kind="stable")
        perm[w0:w1] = w0 + local
    return perm


def _mean_row_bandwidth(csr: HostCSR) -> float:
    """Mean per-row column span (the locality metric RCM optimizes)."""
    lens = csr.row_lengths()
    ne = lens > 0
    if not ne.any():
        return 0.0
    ja = csr.ja
    hi = np.maximum.reduceat(ja, csr.ia[:-1][ne])
    lo = np.minimum.reduceat(ja, csr.ia[:-1][ne])
    return float((hi - lo).mean())


def rcm_if_beneficial(csr: HostCSR) -> tuple[HostCSR, np.ndarray]:
    """RCM, kept only when it reduces mean row bandwidth.

    The reference gates RCM behind USE_RCM_REORDERING (bench.cpp:592) and
    leaves it off by default; generator matrices with low-bandwidth
    placement are *already* banded, and RCM on them scrambles the banding
    (mac_econ twin median row bw 405 → 1082, p90 → 135k), which
    starves the window-locality kernels (SELLW)."""
    bw0 = _mean_row_bandwidth(csr)
    reordered, perm = rcm_reorder(csr)
    if _mean_row_bandwidth(reordered) < bw0:
        return reordered, perm
    return csr, np.arange(csr.m, dtype=np.int64)
