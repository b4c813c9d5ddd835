#!/bin/bash
# Time two versions of the CUDA kernels on one card in one go, in the order
# old, new, new, old (a card may be power-limited or shared, so only numbers
# taken together compare).
#
#     bash superresolutionhep_tpu_torch/tools/compare_kernel_sources.sh <older checkout, or a dir with its csrc/*.cu,*.cuh> [output dir]
#
# Run from the repository root on a machine with the card and nvcc.  Given a
# checkout (a directory holding chip_smoke.py), the old runs are that
# checkout's own chip_smoke.py and package, as they are (needed where the
# kernels' C interface changed); given a directory of sources only, the older
# sources are overlaid on a copy of this package in a temporary directory.
# The repository is not touched.  Each run is chip_smoke.py --skip-serve
# (kernel cases, probes and the train phases; exit 1 by design).  Prints, per
# run, one line per timed kernel case (kernel, dtype, L, the probes' mode or
# exp dtype, mask and tile, time in ms, the library call's ms) and the
# torch.profiler readings of the train steps (the PF phase's also at the
# published bucket sizes): device ms per step, busy share, and the shares of
# the device time in the flash backward kernels and in the forward, dq and
# dk/dv kernels each; with an
# output directory, each run's full output is kept there as compare_<run>.txt.
OLD_SRC=$(cd "$1" && pwd) || exit 9
ROOT=$(pwd)
OUT_DIR=${2:+$(mkdir -p "$2" && cd "$2" && pwd)}
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
if [ -f "$OLD_SRC/chip_smoke.py" ]; then
  OLD_DIR="$OLD_SRC"
else
  OLD_DIR="$WORK/old"
  mkdir -p "$OLD_DIR" && cp -r "$ROOT/chip_smoke.py" "$ROOT/superresolutionhep_tpu_torch" "$OLD_DIR/" || exit 9
  cp "$OLD_SRC"/*.cu "$OLD_SRC"/*.cuh "$OLD_DIR/superresolutionhep_tpu_torch/csrc/" || exit 9
fi
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {  # label, directory, run number
  cd "$2" || exit 9
  SRHEP_TORCH_BUILD_DIR="$WORK/build_$1" python3 chip_smoke.py --skip-serve --reps 20 > "$WORK/$1.$3.txt" 2> "$WORK/$1.$3.err"
  echo "== $1 (run $3) exit=$? (1 is expected: --skip-serve prints no ok line)"
  python3 - "$WORK/$1.$3.txt" <<'EOF'
import json, sys
for line in open(sys.argv[1]):
    if not line.startswith("{"):
        continue
    c = json.loads(line)
    if c.get("phase") == "kernel_case" and "ms" in c:
        variant = c.get("mode", c.get("exp_bf16", "-"))  # the probes' mode or exp dtype, mask and tile
        lib = c.get("library_ms")
        print("  %-16s %-5s L=%-5s D=%-3s per_cell=%-5s probe=%s/%s/%s ms=%.4f lib=%s err=%.3g ok=%s" % (
            c["kernel"], c["dtype"], c["L"], c.get("D", "-"), c.get("per_cell", "-"), variant, c.get("mask", "-"),
            c.get("blocks", "-"), c["ms"], "-" if lib is None else "%.4f" % lib, c["max_abs_err"], c["ok"]))
    if c.get("phase") in ("train", "packed_train", "pf_train"):
        steps = c.get("train_step_ms")
        steps = (steps if isinstance(steps, list) else [steps]) + c.get("train_step_ms_budget", [])
        for st in steps:
            if not st or "profile" not in st:
                continue
            p = st["profile"]

            def share(key):
                return sum(t["share_of_device"] for t in p["top"] if key in t["name"])

            print("  %-12s (%s, %s) median_ms=%.1f device_ms_per_step=%.2f busy=%.3f kernels=%d bwd_share_of_device=%.3f"
                  " shares fwd/dq/dkv=%.3f/%.3f/%.3f"
                  % (c["phase"], st.get("B"), st.get("N"), st["median_ms"], p["device_ms_per_step"], p["busy_share"],
                     p["kernels_per_step"], share("flash_bwd"), share("flash_fwd"), share("flash_bwd_dq"),
                     share("flash_bwd_dkv")))
EOF
  tail -n 1 "$WORK/$1.$3.err" | cut -c 1-400
  [ -n "$OUT_DIR" ] && cp "$WORK/$1.$3.txt" "$OUT_DIR/compare_$1.$3.txt"
  cd "$ROOT" || exit 9
}
run old "$OLD_DIR" 1
run new "$ROOT" 1
run new "$ROOT" 2
run old "$OLD_DIR" 2
