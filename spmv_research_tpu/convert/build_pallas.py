"""Engine format selection for benchmarking.

Role of the reference's kernel-selection map (``config.sh:458-661`` ``progs``):
given a matrix, build the set of routed-engine formats worth benchmarking
beside CSR.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.host import HostCSR
from ..ops.bfly import build_bfly
from ..ops.clos import build_clos
from ..ops.clos_gather import build_clos_gather_auto as build_clos_gather
from ..ops.clos_route import ClosRoutingError
from ..ops.routing import RoutingError
from ..ops.sellr import SellRBuildError, build_sellr
from ..ops.sellw import SellWBuildError, build_sellw
from .cache import cached_build_timed


def build_best(host: HostCSR, dtype=jnp.float32) -> dict:
    """Return ``{name: (format, info)}`` candidates for this matrix, where
    ``info`` is the :func:`cached_build_timed` dict (per-format build time +
    recorded cold conversion time — timing ``build_best`` from outside
    would charge the first candidate with every build).

    SELLR/SELLW are the column-locality engines; their builders raise on
    matrices without locality. CLOSG is the general
    flagship (row-gather front end + Clos perm/compact); CLOS is the
    fallback when the column-block padding overflows the slot space; BFLY
    when even the exact-Clos slot space overflows its cap."""
    out = {}
    try:
        out["SELLR"] = cached_build_timed(build_sellr, host, "sellr",
                                          dtype=dtype)
    except SellRBuildError:
        pass
    try:
        out["SELLW"] = cached_build_timed(build_sellw, host, "sellw",
                                          dtype=dtype)
    except SellWBuildError:
        pass
    try:
        out["CLOSG"] = cached_build_timed(build_clos_gather, host, "closg",
                                          dtype=dtype)
        return out
    except ClosRoutingError:
        pass
    try:
        out["CLOS"] = cached_build_timed(build_clos, host, "clos",
                                         dtype=dtype)
    except ClosRoutingError:
        try:
            out["BFLY"] = cached_build_timed(build_bfly, host, "bfly",
                                             dtype=dtype)
        except RoutingError:
            pass
    return out
