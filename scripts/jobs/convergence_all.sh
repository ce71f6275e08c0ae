#!/usr/bin/env bash
# Full convergence sweep (the batch-job equivalent of the reference's
# scripts/convergence_all.pbs: same 490-run grid, results staged into a
# scratch dir and archived). Run on a GPU host; add --f32 for speed or
# leave f64 for parity-grade errors.
set -euo pipefail

REPO="$(cd "$(dirname "$0")/../.." && pwd)"
SCRATCH="${SCRATCH:-$(mktemp -d /tmp/tpuwave-conv-XXXX)}"
OUT="${OUT:-$REPO/analysis/data}"
mkdir -p "$OUT"

cd "$SCRATCH"
echo "Running convergence sweep in $SCRATCH"
python "$REPO/scripts/convergence_sweep.py" "$@"

cp convergence-results*.csv convergence-runlog*.csv "$OUT"/ 2>/dev/null || true
tar czf "$OUT/convergence-logs.tar.gz" -C "$SCRATCH" . 2>/dev/null || true
echo "Results copied to $OUT"
