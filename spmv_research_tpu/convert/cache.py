"""On-disk format cache.

The reference re-converts every matrix on every run and reports conversion
time as a metric (``bench.cpp:600-603``); SURVEY.md §5.4 calls out on-disk
caching of converted formats as the improvement to make. BFLY program
compilation in particular costs ~15 s per million nonzeros, so sweeps cache
built formats keyed by (matrix content hash, format name, build kwargs).

Device-format pytrees are stored as .npz of their array leaves + pickled
static metadata; loading re-creates the pytree with jnp.asarray (arrays land
on the default device).
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..core.host import HostCSR

DEFAULT_CACHE_DIR = os.environ.get("SPARSE_FORMAT_CACHE",
                                   os.path.join(".", ".format_cache"))


def matrix_digest(csr: HostCSR) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(csr.ia).tobytes())
    h.update(np.ascontiguousarray(csr.ja).tobytes())
    h.update(np.ascontiguousarray(csr.a).tobytes())
    h.update(f"{csr.m}x{csr.n}".encode())
    return h.hexdigest()[:24]


SCHEMA_VERSION = 20  # bump when any format pytree's field set changes
                     # (15: part_cap default 8; 19: SellW drops stream_wins;
                     # 20: SellW drops stage classes, ClosG its window and
                     # scan-cap planes, ClosGX gathers end slots)


def _key(csr: HostCSR, fmt_name: str, kwargs: dict) -> str:
    kv = "_".join(f"{k}={kwargs[k]}" for k in sorted(kwargs))
    kv = f"v{SCHEMA_VERSION}_{kv}"
    return f"{matrix_digest(csr)}_{fmt_name}_{hashlib.sha1(kv.encode()).hexdigest()[:8]}"


def save_format(path: str, fmt: Any) -> None:
    leaves, treedef = jax.tree_util.tree_flatten(fmt)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path + ".npz",  # uncompressed: large bit-planes decompress slower than they load
                        **{f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)})
    with open(path + ".tree", "wb") as f:
        pickle.dump(treedef, f)


def load_format(path: str) -> Any:
    with open(path + ".tree", "rb") as f:
        treedef = pickle.load(f)
    z = np.load(path + ".npz")
    leaves = [jnp.asarray(z[f"leaf_{i}"]) for i in range(len(z.files))]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def cached_build(builder: Callable, csr: HostCSR, fmt_name: str,
                 cache_dir: Optional[str] = None, **kwargs) -> Any:
    """build with on-disk caching: ``cached_build(build_bfly, host, "bfly")``."""
    fmt, _ = cached_build_timed(builder, csr, fmt_name,
                                cache_dir=cache_dir, **kwargs)
    return fmt


def cached_build_timed(builder: Callable, csr: HostCSR, fmt_name: str,
                       cache_dir: Optional[str] = None, **kwargs):
    """Like :func:`cached_build` but also returns
    ``{"build_s": wall seconds this call, "cold_build_s": cold conversion
    time (recorded at first build; a cache hit must not report the load
    time as the conversion cost), "from_cache": bool}``.
    """
    import time
    cache_dir = cache_dir or DEFAULT_CACHE_DIR
    path = os.path.join(cache_dir, _key(csr, fmt_name, kwargs))
    t0 = time.perf_counter()
    if os.path.exists(path + ".npz") and os.path.exists(path + ".tree"):
        try:
            fmt = load_format(path)
            cold = None
            try:
                with open(path + ".meta", "rb") as f:
                    cold = pickle.load(f).get("cold_build_s")
            except Exception:
                pass
            t = time.perf_counter() - t0
            return fmt, {"build_s": t,
                         "cold_build_s": cold if cold is not None else t,
                         "from_cache": True}
        except Exception:
            pass  # corrupt cache entry → rebuild
    fmt = builder(csr, **kwargs)
    t_cold = time.perf_counter() - t0
    try:
        save_format(path, fmt)
        with open(path + ".meta", "wb") as f:
            pickle.dump({"cold_build_s": t_cold}, f)
    except OSError:
        pass  # cache is best-effort
    return fmt, {"build_s": t_cold, "cold_build_s": t_cold,
                 "from_cache": False}
