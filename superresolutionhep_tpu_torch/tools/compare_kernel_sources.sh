#!/bin/bash
# Time two versions of the CUDA kernel sources on one card in one go,
# in the order old, new, new, old (a card may be power-limited or shared, so
# only numbers taken together compare).
#
#     bash superresolutionhep_tpu_torch/tools/compare_kernel_sources.sh <dir with the older csrc/*.cu,*.cuh>
#
# Run from the repository root on a machine with the card and nvcc.  The older
# sources are overlaid on a copy of the package in a temporary directory; the
# repository is not touched.  Prints, per run, one line per kernel case of
# chip_smoke.py's kernel phase: kernel, dtype, L, time in ms.
OLD_SRC=$(cd "$1" && pwd) || exit 9
ROOT=$(pwd)
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
mkdir -p "$WORK/old" && cp -r "$ROOT/chip_smoke.py" "$ROOT/superresolutionhep_tpu_torch" "$WORK/old/" || exit 9
cp "$OLD_SRC"/*.cu "$OLD_SRC"/*.cuh "$WORK/old/superresolutionhep_tpu_torch/csrc/" || exit 9
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {  # label, directory
  cd "$2" || exit 9
  SRHEP_TORCH_BUILD_DIR="$WORK/build_$1" python3 chip_smoke.py --skip-serve --reps 20 > "$WORK/$1.$3.txt" 2> "$WORK/$1.$3.err"
  echo "== $1 (run $3) exit=$? (1 is expected: --skip-serve prints no ok line)"
  grep '"phase": "kernel_case"' "$WORK/$1.$3.txt" | python3 -c '
import sys, json
for line in sys.stdin:
    c = json.loads(line)
    if "ms" in c:
        print("  %-16s %-5s L=%-5s per_cell=%-5s ms=%.4f err=%.3g ok=%s" % (
            c["kernel"], c["dtype"], c["L"], c.get("per_cell", "-"), c["ms"], c["max_abs_err"], c["ok"]))
'
  tail -n 1 "$WORK/$1.$3.err" | cut -c 1-400
  cd "$ROOT" || exit 9
}
run old "$WORK/old" 1
run new "$ROOT" 1
run new "$ROOT" 2
run old "$WORK/old" 2
