#!/usr/bin/env bash
# Strong-scaling sweep over device counts (equivalent of the reference's
# scripts/scalability_all.pbs p in {1,2,4,8,16,32} driver). On a multi-GPU
# host pass --devices 1 2 4 8; without GPUs use the virtual CPU mesh.
set -euo pipefail

REPO="$(cd "$(dirname "$0")/../.." && pwd)"
SCRATCH="${SCRATCH:-$(mktemp -d /tmp/tpuwave-scal-XXXX)}"
OUT="${OUT:-$REPO/analysis/data}"
mkdir -p "$OUT"

cd "$SCRATCH"
echo "Running scalability sweep in $SCRATCH"
python "$REPO/scripts/scalability_sweep.py" "$@"

cp scalability-results*.csv "$OUT"/ 2>/dev/null || true
echo "Results copied to $OUT"
