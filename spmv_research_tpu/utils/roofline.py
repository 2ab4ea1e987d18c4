"""Per-format HBM roofline model and the device table it divides by.

The reference's ``mem_footprint`` / ``mem_ratio`` CSV columns
(``bench_spmv.cpp:479-480``) exist to support exactly this model: SpMV is
memory-bound, so speed-of-light time = bytes-touched / HBM bandwidth, and the
per-format bytes/nnz ratio decides which format wins.

bytes(SpMV) = format footprint (streamed once)
            + x read (n·vb; assumes each x element is read ~once from HBM —
              post-RCM/σ-sort locality keeps re-reads in cache)
            + y write (m·vb).
"""

from __future__ import annotations

import dataclasses

import jax


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    kind: str
    hbm_bw: float             # bytes/s
    hbm_gb: float             # device memory, GB (1e9 bytes)
    peak_fp32_tflops: float   # outside the tensor cores
    peak_fp64_tflops: float   # outside the tensor cores
    source: str = ""


# Published peaks, keyed by ``device.device_kind`` exactly as JAX reports it.
# A device that is not here is an error, never a default.
_DEVICES = {
    "NVIDIA H200": DeviceSpec(
        kind="NVIDIA H200", hbm_bw=4.8e12, hbm_gb=141.0,
        peak_fp32_tflops=67.0, peak_fp64_tflops=34.0,
        source="NVIDIA H200 Tensor Core GPU data sheet, SXM column "
               "(4.8 TB/s HBM3e, 141 GB, FP32 67 TFLOPS, FP64 34 TFLOPS)"),
}


def device_spec(device=None) -> DeviceSpec:
    """Published peaks of ``device`` (default: the first JAX device)."""
    if device is None:
        device = jax.devices()[0]
    kind = getattr(device, "device_kind", "unknown")
    try:
        return _DEVICES[kind]
    except KeyError:
        raise ValueError(f"no published peaks for device kind {kind!r}; "
                         f"known: {sorted(_DEVICES)}") from None


def spmv_bytes(format_obj, value_bytes: int | None = None) -> int:
    """Bytes touched by one SpMV in the streaming model."""
    if value_bytes is None:
        values = None
        for attr in ("data", "vals", "diag", "lut"):
            values = getattr(format_obj, attr, None)
            if values is not None and hasattr(values, "dtype"):
                break
            values = None
        value_bytes = values.dtype.itemsize if values is not None else 4
    return (format_obj.mem_footprint_bytes()
            + format_obj.n * value_bytes + format_obj.m * value_bytes)


def spmv_roofline_time(format_obj, spec: DeviceSpec | None = None) -> float:
    spec = spec or device_spec()
    return spmv_bytes(format_obj) / spec.hbm_bw


def roofline_fraction(format_obj, measured_time: float,
                      spec: DeviceSpec | None = None) -> float:
    """achieved / speed-of-light (∈ (0, 1]; >1 would mean the model undercounts
    reuse, e.g. x or the whole matrix held in the L2 cache)."""
    return spmv_roofline_time(format_obj, spec) / measured_time


def csr_roofline_nnz_per_s(nnz: int, m: int, n: int, value_bytes: int,
                           spec: DeviceSpec | None = None) -> float:
    """Speed-of-light nnz/s for *CSR storage*, independent of the format
    actually used."""
    spec = spec or device_spec()
    csr_bytes = nnz * (value_bytes + 4) + (m + 1) * 4 + (m + n) * value_bytes
    return nnz / (csr_bytes / spec.hbm_bw)
