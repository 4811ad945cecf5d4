#!/usr/bin/env bash
# CI gate for bcalm-tpu — the analog of the reference's committed CI
# definitions (/root/reference/.travis.yml, .circleci/config.yml, which
# build the binary and package it; tests there are manual).  Here the gate
# actually RUNS the test matrix:
#
#   1. build the native ingest library (C++ zlib streaming parser/packer)
#   2. full pytest suite on the CPU backend with 8 virtual devices
#      (multi-chip sharding logic included; see tests/conftest.py)
#   3. CLI smoke at the user surface (tiny end-to-end build + oracle)
#
# Usage: ./ci.sh [pytest-args...]
set -euo pipefail
cd "$(dirname "$0")"

echo "== native build =="
make -C native

echo "== pytest (cpu, 8 virtual devices) =="
JAX_PLATFORMS=cpu python -m pytest tests/ -q "$@"

echo "== CLI smoke =="
tmp=$(mktemp -d)
trap 'rm -rf "$tmp"' EXIT
python - "$tmp" <<'EOF'
import sys, numpy as np
rng = np.random.RandomState(7)
g = "".join("ACTG"[c] for c in rng.randint(0, 4, 400))
with open(sys.argv[1] + "/reads.fa", "w") as f:
    for i in range(0, 380, 10):
        for c in range(3):
            f.write(f">r{i}_{c}\n{g[i:i+40]}\n")
EOF
(cd "$tmp" && JAX_PLATFORMS=cpu PYTHONPATH="$OLDPWD" \
    python -m bcalm_tpu -in reads.fa -kmer-size 21 -abundance-min 2)
(cd "$tmp" && JAX_PLATFORMS=cpu PYTHONPATH="$OLDPWD" \
    python "$OLDPWD/scripts/unitig_evaluator.py" reads.unitigs.fa reads.fa 21 \
    | grep -q "FP 0  FN 0")
echo "CI OK"
