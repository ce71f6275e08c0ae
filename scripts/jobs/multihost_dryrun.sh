#!/usr/bin/env bash
# 2-process jax.distributed CPU dryrun of the multi-host wiring.
#
# Spawns two local processes that form a jax.distributed cluster (the
# CPU stand-in for two pod hosts; the reference's analogue is a local
# `mpirun -np 2`, README.md:123-124) and runs the Newmark CLI with
# --distributed and per-device VTU pieces. Validates:
#   * jax.distributed.initialize via the JAX_* env channel
#     (tpuwave/parallel/sharding.py::init_distributed),
#   * rank-0-only console/CSV semantics (process 1 runs quiet),
#   * per-process VTU piece writing: each process emits only its local
#     shards' pieces, process 0 writes the .pvtu record referencing all.
#
# Usage: scripts/jobs/multihost_dryrun.sh [results_dir]
# Exit 0 iff both processes succeed and every .pvtu record references
# pieces from both processes.
set -uo pipefail

REPO="$(cd "$(dirname "$0")/../.." && pwd)"
OUT="${1:-$(mktemp -d /tmp/tpuwave-multihost.XXXXXX)}"
mkdir -p "$OUT"
PORT=$(( 20000 + RANDOM % 20000 ))
PARAMS="$OUT/params.json"

python - "$REPO/parameters/standing-mode-wsol.json" "$PARAMS" <<'EOF'
import json, sys
d = json.loads(open(sys.argv[1]).read())
d.update({"Nel": "8", "T": "0.03", "Dt": "0.01", "Log Every": "1",
          "Print Every": "1"})
open(sys.argv[2], "w").write(json.dumps(d))
EOF

run_proc() {
  local pid=$1
  JAX_PLATFORMS=cpu \
  XLA_FLAGS=--xla_force_host_platform_device_count=2 \
  JAX_COORDINATOR_ADDRESS="localhost:$PORT" \
  JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=$pid \
  python -m tpuwave.cli.newmark "$PARAMS" --distributed --vtu-pieces 0 \
      --results-root "$OUT/results" --mesh-root "$OUT/mesh" \
      > "$OUT/proc$pid.log" 2>&1
}

cd "$REPO"
run_proc 1 & P1=$!
run_proc 0 & P0=$!
wait "$P0"; RC0=$?
wait "$P1"; RC1=$?

echo "proc0 rc=$RC0 proc1 rc=$RC1 (logs in $OUT)"
if [ "$RC0" -ne 0 ] || [ "$RC1" -ne 0 ]; then
  tail -5 "$OUT"/proc*.log
  exit 1
fi

python - "$OUT" <<'EOF'
import re, sys
from pathlib import Path
out = Path(sys.argv[1])
pvtus = sorted(out.glob("results/*/run-*/solution_*.pvtu"))
assert pvtus, f"no .pvtu records under {out}/results"
bad = 0
for rec in pvtus:
    pieces = re.findall(r'Source="([^"]+\.vtu)"', rec.read_text())
    missing = [p for p in pieces if not (rec.parent / p).exists()]
    if len(pieces) < 2 or missing:
        print(f"FAIL {rec.name}: pieces={pieces} missing={missing}")
        bad += 1
assert not bad, f"{bad} bad records"
print(f"OK: {len(pvtus)} .pvtu records, each referencing "
      f"{len(pieces)} pieces, all piece files present "
      f"(written across 2 processes)")
EOF
