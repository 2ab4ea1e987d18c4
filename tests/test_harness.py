"""Harness tests: metric formulas, accuracy gate, protocol plumbing (CPU)."""

import numpy as np
import pytest

from spmv_research_tpu.harness import (
    BenchConfig, bench_spmv, check_accuracy, error_metrics, csv_labels,
    csv_row_real,
)
from spmv_research_tpu.convert import build_csr
from conftest import random_host_csr


def test_error_metrics_exact_values():
    a = np.array([1.0, 2.0, -3.0, 4.0])
    f = np.array([1.1, 2.0, -2.9, 3.8])
    m = error_metrics(a, f, epsilon=1e-10)
    ae = np.abs(a - f)
    np.testing.assert_allclose(m.mae, ae.mean())
    np.testing.assert_allclose(m.max_ae, ae.max())
    np.testing.assert_allclose(m.mse, (ae ** 2).mean())
    np.testing.assert_allclose(m.mape, (ae / np.abs(a)).mean())
    np.testing.assert_allclose(m.smape, (ae / (np.abs(a) + np.abs(f))).mean())
    lnq = (np.log10(np.abs(f)) - np.log10(np.abs(a))).mean()
    np.testing.assert_allclose(m.lnQ_error, lnq)
    np.testing.assert_allclose(m.mlare, np.log10(np.abs(10 ** lnq - 1)), rtol=1e-6)
    np.testing.assert_allclose(m.gmare, 10 ** m.mlare, rtol=1e-6)
    assert not m.passed  # errors are huge vs 1e-10


def test_gate_ignores_small_gold():
    # gate only looks at entries with y_gold > epsilon (bench_spmv.cpp:178-185)
    a = np.array([1e-12, 5.0])
    f = np.array([1.0, 5.0])  # huge error where gold ~ 0 → ignored
    m = error_metrics(a, f, epsilon=1e-10)
    assert m.passed


def test_check_accuracy_passes_for_good_spmv(rng):
    h = random_host_csr(100, 100, 0.05, rng)
    x = rng.uniform(-1, 1, 100)
    y = np.asarray(h.to_scipy().astype(np.float64) @ x)
    m = check_accuracy(h, x, y, value_dtype=np.float64)
    assert m.passed, m


def test_check_accuracy_fails_for_bad_spmv(rng):
    h = random_host_csr(100, 100, 0.05, rng)
    x = rng.uniform(1, 2, 100)
    y = np.asarray(h.to_scipy() @ x) * 1.001
    m = check_accuracy(h, x, y, value_dtype=np.float32)
    assert not m.passed


def test_bench_spmv_protocol_runs(rng):
    h = random_host_csr(256, 256, 0.05, rng)
    A = build_csr(h)
    cfg = BenchConfig(min_num_loops=4, min_time_s=0.01, warmup_iters=2,
                      inner_iters=2)
    r = bench_spmv(h, A, config=cfg, impl="xla", matrix_name="unit")
    assert r.num_loops >= 4
    assert r.gflops > 0
    # fp32 kernel vs fp64 gold: the strict reference gate (1e-7 per-element
    # relative) is only attainable by fp64 kernels; fp32 parity is judged on
    # the aggregate metrics (reference precision study, bench_spmv.cpp:66-83:
    # float kernels show mape ~1e-8 while the strict gate warns).
    assert r.metrics.mape < 1e-6
    assert 0 < r.mem_ratio < 10
    row = csv_row_real(r)
    assert len(row.split(",")) == len(csv_labels().split(","))


def test_gold_kahan_vs_fast(rng):
    h = random_host_csr(200, 200, 0.1, rng)
    x = rng.uniform(-1, 1, 200)
    from spmv_research_tpu.harness.metrics import _gold_vec_kahan

    g1 = np.asarray(_gold_vec_kahan(h, x), dtype=np.float64)
    g2 = np.asarray(h.spmv_gold_fast(x), dtype=np.float64)
    np.testing.assert_allclose(g1, g2, rtol=1e-14, atol=1e-16)


def test_roofline_model_values():
    from spmv_research_tpu.utils import roofline as rl
    from spmv_research_tpu.convert import build_csr
    import sys
    sys.path.insert(0, "tests")
    from conftest import random_host_csr
    import numpy as np

    rng = np.random.Generator(np.random.PCG64(9))
    h = random_host_csr(200, 200, 0.05, rng)
    A = build_csr(h)
    spec = rl.DeviceSpec("test", hbm_bw=800e9, hbm_gb=16,
                         peak_fp32_tflops=100, peak_fp64_tflops=50)
    t = rl.spmv_roofline_time(A, spec)
    expected_bytes = h.nnz * 8 + 201 * 4 + 400 * 4
    np.testing.assert_allclose(t, expected_bytes / 800e9, rtol=1e-12)
    sol = rl.csr_roofline_nnz_per_s(h.nnz, 200, 200, 4, spec)
    assert sol > 0
    assert rl.roofline_fraction(A, t * 2, spec) == 0.5


def test_device_spec_detection():
    """The CPU has no row in the device table: asking for its peaks is an
    error, never a silent default."""
    from spmv_research_tpu.utils.roofline import device_spec

    with pytest.raises(ValueError, match="no published peaks"):
        device_spec()


def test_device_spec_h200():
    from types import SimpleNamespace
    from spmv_research_tpu.utils.roofline import device_spec

    spec = device_spec(SimpleNamespace(device_kind="NVIDIA H200"))
    assert spec.hbm_bw == 4.8e12 and spec.hbm_gb == 141.0
    assert spec.peak_fp32_tflops == 67.0 and spec.peak_fp64_tflops == 34.0
    assert "data sheet" in spec.source


@pytest.mark.parametrize("kind", ["NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100 80GB HBM3", "unknown"])
def test_device_spec_unknown_kind_raises(kind):
    from types import SimpleNamespace
    from spmv_research_tpu.utils.roofline import device_spec

    with pytest.raises(ValueError):
        device_spec(SimpleNamespace(device_kind=kind))


def test_bench_spmv_cpu_roofline_not_measured(rng):
    """On the CPU the roofline share is nan ("not measured"), not a number
    divided by some other device's bandwidth."""
    h = random_host_csr(128, 128, 0.05, rng)
    cfg = BenchConfig(min_num_loops=4, min_time_s=0.01, warmup_iters=2,
                      inner_iters=2)
    r = bench_spmv(h, build_csr(h), config=cfg, impl="xla")
    assert np.isnan(r.roofline_frac)
