#!/usr/bin/env python
"""CLI sweep driver — the run.sh analog.

Usage:
  python tools/sweep.py --matrices twins.txt --formats csr bfly \
      --workloads spmv spmm --out out_logs
  python tools/sweep.py --matrix "2000 2000 10 3 normal random 0.3 2 0.5 0.3 14 demo"

Matrix list files: one entry per line — a .mtx path or an 11-arg synthetic
parameter line (matrix_generation_parameters format).
"""
import argparse
import sys

sys.path.insert(0, ".")


def _read_specs(path):
    with open(path) as f:
        return [ln.strip() for ln in f
                if ln.strip() and not ln.startswith("#")]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--matrices", help="file with one matrix spec per line")
    ap.add_argument("--matrix", action="append", default=[],
                    help="inline matrix spec (repeatable)")
    ap.add_argument("--formats", nargs="+", default=["csr", "bfly"])
    ap.add_argument("--workloads", nargs="+", default=["spmv"])
    ap.add_argument("--impls", nargs="+", default=None)
    ap.add_argument("--out", default="out_logs")
    ap.add_argument("--job", action="append", default=[],
                    help="semicolon-separated job spec run IN THIS process "
                         "(jobs share one device client and compile cache): "
                         "'mats=FILE;formats=a,b;workloads=x,y;impls=i,j"
                         ";kdim=64;out=DIR'. Repeatable; jobs run in order.")
    args = ap.parse_args()

    from spmv_research_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    from spmv_research_tpu.harness import run_sweep, BenchConfig

    if args.job:
        for js in args.job:
            kv = dict(part.split("=", 1) for part in js.split(";") if part)
            specs = _read_specs(kv["mats"])
            cfg = BenchConfig.from_env()
            if "kdim" in kv:
                cfg.k_dim = int(kv["kdim"])
            if kv.get("transform"):      # spd | dd (solver-dataset analogs)
                cfg.matrix_transform = kv["transform"]
            if kv.get("precond"):        # jacobi | ic0 | ilu0
                cfg.solver_precond = kv["precond"]
            if kv.get("maxiters"):
                cfg.cg_max_num_iters = int(kv["maxiters"])
            print(f"### job: {js}", flush=True)
            try:
                run_sweep(specs,
                          formats=kv["formats"].split(","),
                          workloads=kv["workloads"].split(","),
                          impls=kv["impls"].split(",") if kv.get("impls") else None,
                          out_dir=kv.get("out", args.out),
                          config=cfg)
            except Exception as e:
                print(f"### job failed: {type(e).__name__}: {e}",
                      flush=True)
        return

    specs = list(args.matrix)
    if args.matrices:
        specs += _read_specs(args.matrices)
    if not specs:
        ap.error("no matrices given")
    run_sweep(specs, formats=args.formats, workloads=args.workloads,
              impls=args.impls, out_dir=args.out,
              config=BenchConfig.from_env())


if __name__ == "__main__":
    main()
