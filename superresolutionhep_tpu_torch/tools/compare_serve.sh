#!/bin/bash
# Time the serve phase of chip_smoke.py for two checkouts on one card in one
# go, in the order old, new, new, old (a card may be power-limited or shared,
# so only numbers taken together compare).
#
#     bash superresolutionhep_tpu_torch/tools/compare_serve.sh <older checkout with chip_smoke.py>
#
# Run from the repository root on a machine with the card and nvcc.  Each
# checkout builds its own kernels into a temporary directory.  Prints, per
# run, the per-request device_ms of the serve line and its checks.
OLD=$(cd "$1" && pwd) || exit 9
ROOT=$(pwd)
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {  # label, directory, extra flags, run number
  cd "$2" || exit 9
  SRHEP_TORCH_BUILD_DIR="$WORK/build_$1" python3 chip_smoke.py --reps 3 $3 > "$WORK/$1.$4.txt" 2> "$WORK/$1.$4.err"
  echo "== $1 (run $4) exit=$?"
  grep '"phase": "serve"' "$WORK/$1.$4.txt" | python3 -c '
import sys, json
for line in sys.stdin:
    s = json.loads(line)
    print("  device_ms", [r["device_ms"] for r in s["requests"]], "ok", s["ok"])
'
  cd "$ROOT" || exit 9
}
# the newer chip_smoke.py also trains; --skip-train leaves its serve phase alone
run old "$OLD" "" 1
run new "$ROOT" "--skip-train" 1
run new "$ROOT" "--skip-train" 2
run old "$OLD" "" 2
