#!/usr/bin/env python
"""Weak-scaling check: distributed SpMV over a virtual 8-device CPU mesh
(control flow and the efficiency bookkeeping; CPU times are not device
numbers — the four-card path is ``chip_smoke.py --cards 4``).

Writes out_logs/weak_scaling_cpu8.csv:
  strategy, devices, rows_per_device, nnz, time_iter_s, efficiency
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    from spmv_research_tpu.parallel import weak_scaling_efficiency

    rows = int(sys.argv[1]) if len(sys.argv) > 1 else 50_000
    out_dir = os.path.join(os.path.dirname(__file__), "..", "out_logs")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "weak_scaling_cpu8.csv")
    with open(out_path, "w") as f:
        f.write("strategy,devices,rows_per_device,nnz,time_iter_s,"
                "efficiency,efficiency_overhead\n")
        for strategy in ("allgather", "ring"):
            res = weak_scaling_efficiency(rows_per_device=rows,
                                          strategy=strategy)
            for k, r in res.items():
                f.write(f"{strategy},{k},{rows},{r['nnz']},"
                        f"{r['time']:.6f},{r['efficiency']:.4f},"
                        f"{r['efficiency_overhead']:.4f}\n")
                print(f"{strategy:12s} k={k}: t={r['time']*1e3:.2f} ms "
                      f"eff={r['efficiency']:.3f} "
                      f"eff_ovh={r['efficiency_overhead']:.3f}", flush=True)
    print(f"wrote {os.path.normpath(out_path)}")


if __name__ == "__main__":
    main()
