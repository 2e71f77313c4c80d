#!/bin/sh
# CI gate for goldrush-jax — the analog of the reference's CI pipeline
# (azure-pipelines.yml:1-87: build, --help smoke test, end-to-end demo).
#
#   sh tools/ci.sh          # CPU suite + CLI smoke, then the GPU steps
#   sh tools/ci.sh quick    # CPU unit suite only
#
# The GPU steps run one after another: a JAX process reserves most of the
# card's memory, so only one process may use the card at a time.
# Exit nonzero on any failure so a red HEAD cannot ship silently.
set -e
HERE=$(cd "$(dirname "$0")/.." && pwd)
cd "$HERE"

echo "== 1/4 test suite (CPU, 8-device virtual mesh) =="
JAX_PLATFORMS=cpu python -m pytest tests/ -x -q

if [ "$1" = "quick" ]; then
    echo "CI quick gate passed."
    exit 0
fi

echo "== 2/4 CLI smoke + multi-device dry run (virtual CPU devices) =="
python -m goldrush_jax.cli help > /dev/null
JAX_PLATFORMS=cpu \
XLA_FLAGS="--xla_force_host_platform_device_count=8" python - <<'EOF'
import __graft_entry__ as g
g.dryrun_multichip(8)
print("dryrun_multichip(8) ok")
EOF

echo "== 3/4 GPU smoke (engine + pipeline, GPU vs CPU byte parity) =="
timeout 1200 python chip_smoke.py

echo "== 4/4 GPU bench (one JSON line) =="
timeout 3600 python bench.py | tail -1 | python -c "
import json, sys
d = json.loads(sys.stdin.readline())
assert 'metric' in d and 'value' in d and d['device']['platform'] == 'gpu', d
print('bench ok:', d['metric'], d['value'], d['unit'])
"

echo "CI gate passed."
