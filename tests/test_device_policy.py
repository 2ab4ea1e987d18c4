"""Device policy on the CPU: which impl runs where, what may not be imported,
the compile cache's place, fp32 matmul precision, and chip_smoke.py's
refusal to run without a GPU."""

import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import random_host_csr
from spmv_research_tpu.ops import dispatch

REPO = pathlib.Path(__file__).resolve().parents[1]

_TABLES = {"spmv": dispatch._SPMV, "spmm": dispatch._SPMM,
           "sddmm": dispatch._SDDMM}
_FORMATS = sorted({(w, f) for w, t in _TABLES.items() for (f, _) in t})


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
@pytest.mark.parametrize("workload,fmt", _FORMATS)
def test_default_dispatch_picks_xla(monkeypatch, backend, workload, fmt):
    monkeypatch.setattr(dispatch.jax, "default_backend", lambda: backend)
    table = _TABLES[workload]
    assert dispatch._lookup(table, fmt, None) is table[(fmt, "xla")]


@pytest.mark.parametrize("backend", ["rocm", "METAL", "neuron"])
def test_unknown_backend_raises(monkeypatch, backend):
    monkeypatch.setattr(dispatch.jax, "default_backend", lambda: backend)
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        dispatch.backend()
    with pytest.raises(RuntimeError):
        dispatch._lookup(dispatch._SPMV, "CSR", None)


def test_explicit_impl_needs_no_backend(monkeypatch):
    monkeypatch.setattr(dispatch.jax, "default_backend", lambda: "rocm")
    assert (dispatch._lookup(dispatch._SPMV, "CSR", "xla")
            is dispatch._SPMV[("CSR", "xla")])


def _program_files():
    files = [REPO / "bench.py", REPO / "__graft_entry__.py",
             REPO / "chip_smoke.py"]
    for d in ("spmv_research_tpu", "tools"):
        files += sorted((REPO / d).rglob("*.py"))
    return files


@pytest.mark.parametrize("pattern", [
    # a Pallas import must name a GPU route (triton or mosaic_gpu)
    r"jax\.experimental\.pallas\.(?!triton\b|mosaic_gpu\b|ops\b)\w+",
    r"from\s+jax\.experimental\.pallas\s+import\s+"
    r"(?!triton\b|mosaic_gpu\b)\w+",
    r"interpret\s*=.*default_backend",
    r"default_backend\(\)\s*(not\s+)?in\s*\(",
])
def test_source_scan(pattern):
    """No module imports a non-GPU Pallas backend, and no interpret flag or
    impl choice is derived from the backend outside ops.dispatch."""
    rx = re.compile(pattern)
    hits = [f"{p.relative_to(REPO)}:{i + 1}"
            for p in _program_files()
            for i, ln in enumerate(p.read_text().splitlines())
            if rx.search(ln)]
    assert not hits, hits


def test_backend_pref_names_only_gpu_and_cpu():
    assert set(dispatch._BACKEND_PREF) == {"gpu", "cpu"}
    assert all(v == ("xla",) for v in dispatch._BACKEND_PREF.values())


@pytest.fixture
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_wins(monkeypatch, cache_config, tmp_path):
    from spmv_research_tpu.utils.runtime import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # set nothing


def test_compile_cache_default_is_repo_dir(monkeypatch, cache_config):
    from spmv_research_tpu.utils.runtime import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_device_record_names_the_cpu():
    from spmv_research_tpu.utils.runtime import device_record

    rec = device_record()
    assert rec["platform"] == "cpu" and rec["count"] >= 1
    assert isinstance(rec["nvidia_smi"], str) and rec["nvidia_smi"]


def test_chip_smoke_refuses_the_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_bench_refuses_the_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke
    return chip_smoke


def test_chip_smoke_comparison_helper(rng):
    cs = _chip_smoke()
    from spmv_research_tpu.convert import build_csr
    from spmv_research_tpu.ops import spmv

    h = random_host_csr(300, 200, 0.05, rng)
    x = rng.uniform(-1, 1, h.n)
    ref = h.to_scipy() @ x
    y = np.asarray(spmv(build_csr(h), jnp.asarray(x, jnp.float32),
                        impl="xla"))
    max_rel, norm_rel = cs.rel_errors(ref, y)
    assert 0 <= norm_rel <= max_rel and norm_rel < 1e-6
    cs.gate("t", norm_rel, cs.DIST_GATE, "err")
    with pytest.raises(cs.PhaseFailure):
        cs.gate("t", cs.rel_errors(ref, y * 1.01)[1], cs.DIST_GATE, "err")
    with pytest.raises(cs.PhaseFailure):
        cs.gate("t", float("nan"), 1.0, "err")
    with pytest.raises(cs.PhaseFailure):
        cs.rel_errors(ref, np.full_like(ref, np.nan))
    assert cs.twin_line("ldoor").split()[:2] == ["952203", "952203"]
    assert cs.twin_line("cage15").split()[0] == "5154859"


def test_chip_smoke_phases_rehearse_on_cpu():
    """The one-card phases at a tenth of the twins' rows (same code)."""
    cs = _chip_smoke()
    from spmv_research_tpu.harness import BenchConfig

    cfg = BenchConfig(min_num_loops=4, min_time_s=0.01, inner_iters=2)
    cs.run_one_card(
        bench_line="17099 17099 5.6 4.39 normal random 0.297 61.9 0.803 "
                   "0.633 14 scircuit_small",
        hbm_line="9522 9522 48.86 11.95 normal random 0.2042 0.576 1.797 "
                 "0.906 14 ldoor_small",
        locality_line="20650 20650 6.1665 4.4359 normal random 0.0019 "
                      "6.135 0.1767 0.3305 14 mac_econ_small",
        tile_line="6245 6245 64.17 14.06 normal random 0.0086 0.2156 "
                  "1.6158 0.9147 14 cant_small",
        cfg=cfg)


def test_chip_smoke_four_card_path_on_cpu_mesh():
    cs = _chip_smoke()
    cs.run_four_cards(4, line="20480 20480 19.24 5.737 normal random "
                              "0.2120 1.442 0.1975 0.7941 14 cage15_small")


# ------------------------------------------------- fp32 matmul precision

def _dot_precisions(jaxpr):
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", None)
                if inner is not None:
                    out += _dot_precisions(getattr(inner, "jaxpr", inner))
    return out


def _tf32_cases():
    from spmv_research_tpu.convert import build_bsr, build_ell
    from spmv_research_tpu.ops import reference as R
    from spmv_research_tpu.ops.bsr_mxu import build_bsrg, sddmm_bsr, spmm_bsrg
    from spmv_research_tpu.ops.densemv import (build_dense, spmm_dense_xla,
                                               spmv_dense_xla)
    from spmv_research_tpu.solvers.ilu import (_sptrsv_band,
                                               build_band_block_schedule)
    from spmv_research_tpu.core.host import HostCSR
    import scipy.sparse as sp

    h = random_host_csr(64, 160, 0.05, np.random.default_rng(3))
    x = jnp.ones(h.n, jnp.float32)
    X = jnp.ones((h.n, 4), jnp.float32)
    L = sp.tril(sp.random(300, 300, 0.02, random_state=2)) \
        + sp.identity(300) * 4.0
    band = build_band_block_schedule(HostCSR.from_scipy(L.tocsr()),
                                     lower=True, B=128)
    bsr = build_bsr(h, br=8, bc=128)
    dense = build_dense(h)
    return {
        "ell_spmm": (R.spmm_ell, (build_ell(h), X)),
        "bsr_spmv": (R.spmv_bsr, (bsr, x)),
        "bsr_spmm": (R.spmm_bsr, (bsr, X)),
        "dense_spmv": (spmv_dense_xla, (dense, x)),
        "dense_spmm": (spmm_dense_xla, (dense, X)),
        "bsrg_spmm": (spmm_bsrg, (build_bsrg(h), X)),
        "bsr_sddmm": (sddmm_bsr, (bsr, jnp.ones((h.m, 4)), X)),
        "band_trisolve": (_sptrsv_band, (band, jnp.ones(300, jnp.float32))),
    }


@pytest.mark.parametrize("case", ["ell_spmm", "bsr_spmv", "bsr_spmm",
                                  "dense_spmv", "dense_spmm", "bsrg_spmm",
                                  "bsr_sddmm", "band_trisolve"])
def test_fp32_matmuls_ask_for_highest_precision(case):
    """On the GPU an fp32 dot without a precision runs in TF32 (about three
    digits); every product that claims fp32 results must ask for HIGHEST."""
    fn, args = _tf32_cases()[case]
    precs = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert precs, "no dot_general traced"
    highest = jax.lax.Precision.HIGHEST
    assert all(p is not None and all(q == highest for q in p)
               for p in precs), precs
