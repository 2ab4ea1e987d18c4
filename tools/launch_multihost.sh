#!/usr/bin/env bash
# Multi-host launch example — the role of the reference's slurm*/pbs* scripts
# (which launch independent single-node jobs; here hosts form ONE distributed
# runtime via jax.distributed).
#
# On each host (or via your scheduler's per-node task):
#   COORDINATOR=<host0-ip>:8476 NUM_HOSTS=<N> HOST_ID=<rank> \
#       bash tools/launch_multihost.sh <script.py> [args...]
#
# Nothing on a bare GPU host tells JAX of a cluster: give all three values
# (COORDINATOR may be localhost:<free port> for processes of one host).
set -euo pipefail
SCRIPT="${1:?usage: launch_multihost.sh <script.py> [args...]}"
shift
python - "$SCRIPT" "$@" <<'PY'
import os, runpy, sys
from spmv_research_tpu.parallel import init_multihost

coord = os.environ.get("COORDINATOR")
n = os.environ.get("NUM_HOSTS")
pid = os.environ.get("HOST_ID")
init_multihost(coordinator_address=coord,
               num_processes=int(n) if n else None,
               process_id=int(pid) if pid else None)
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
PY
