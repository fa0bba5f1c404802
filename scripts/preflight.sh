#!/bin/sh
# Pre-commit smoke.  Runs, in order:
#   1. the full CPU test suite on the 8-device virtual mesh,
#   2. the multi-device dryrun (dense + pcg paths) on 8 virtual CPU devices,
#   3. chip_smoke.py on the GPU (skipped with a note when there is none).
#
# Exits nonzero on the first failure.  Usage:  scripts/preflight.sh
set -e
cd "$(dirname "$0")/.." || exit 1

echo "== 1/3 CPU test suite =="
JAX_PLATFORMS=cpu timeout 4200 python3 -m pytest tests/ -q

echo "== 2/3 dryrun_multichip(8) =="
JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  timeout 900 python3 -c "import __graft_entry__ as g; g.dryrun_multichip(8)"

echo "== 3/3 chip_smoke.py (GPU) =="
if command -v nvidia-smi >/dev/null 2>&1; then
  timeout 1200 python3 chip_smoke.py
else
  echo "no nvidia-smi: skipped"
fi

echo "PREFLIGHT OK"
