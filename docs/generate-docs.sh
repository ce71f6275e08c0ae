#!/usr/bin/env bash
# Generate API documentation (the counterpart of the reference's Doxygen
# setup, docs/generate-docs.sh + Doxyfile).
#
# Canonical, committed output: docs/api/*.md via
#   scripts/generate_api_docs.py   (markdown, walks the whole package)
# This script additionally renders stdlib-pydoc HTML (docs/api/*.html,
# gitignored) for local browsing; the module list is enumerated from the
# live package so new modules are never missed.
set -euo pipefail

REPO="$(cd "$(dirname "$0")/.." && pwd)"
OUT="$REPO/docs/api"
mkdir -p "$OUT"

export JAX_PLATFORMS=cpu

cd "$REPO"
python scripts/generate_api_docs.py

cd "$OUT"
PYTHONPATH="$REPO" python - <<'EOF'
import pkgutil
import pydoc

import tpuwave

names = ["tpuwave"] + [m.name for m in
                       pkgutil.walk_packages(tpuwave.__path__,
                                             prefix="tpuwave.")]
for name in sorted(set(names)):
    try:
        pydoc.writedoc(name)
    except Exception as e:  # keep going: one bad import != no docs
        print(f"WARN: pydoc failed for {name}: {e}")
EOF
echo "API docs written to $OUT (markdown committed, html local)"
