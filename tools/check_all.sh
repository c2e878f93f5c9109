#!/bin/sh
# One-command release check on the CPU: tests, fuzzers, the multi-device
# dry run.  On a machine with an NVIDIA GPU, chip_smoke.py is the on-card
# check and bench.py the benchmark.
set -e
cd "$(dirname "$0")/.."
echo "== unit/golden/e2e suite =="
JAX_PLATFORMS=cpu python -m pytest tests/ -x -q
echo "== golden fuzz (200 fresh cases) =="
python tools/fuzz_golden.py 200 "$(date +%s)"
echo "== multi-host fuzz (10 fresh cases) =="
python tools/fuzz_multihost.py 10 "$(date +%s)"
echo "== adversarial DB-reader fuzz (50 fresh cases) =="
python tools/fuzz_blastdb.py 50 "$(date +%s)"
echo "== multi-device dry run (8 virtual CPU devices) =="
JAX_PLATFORMS=cpu python -c "import __graft_entry__ as g; g.dryrun_multichip(8)"
