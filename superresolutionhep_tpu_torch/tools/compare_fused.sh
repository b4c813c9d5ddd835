#!/bin/bash
# Compare the bf16 fused kernels K3/K4 of two checkouts on one card in one go
# (tools/compare_fused.py), in the order old, new, new, old (a card may be
# power-limited or shared, so only numbers taken together compare).
#
#     bash superresolutionhep_tpu_torch/tools/compare_fused.sh <older checkout with chip_smoke.py>
#
# Run from the repository root on a machine with the card and nvcc.  Each
# checkout builds its kernels into its own build/ first (both at once).
OLD=$(cd "$1" && pwd) || exit 9
ROOT=$(pwd)
TOOL="$ROOT/superresolutionhep_tpu_torch/tools/compare_fused.py"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for d in "$OLD" "$ROOT"; do
  (cd "$d" && SRHEP_TORCH_BUILD_DIR="$d/build" python3 -c "from superresolutionhep_tpu_torch.ops import kernels; kernels.build()") &
done
wait
status=0
for run in "$OLD old" "$ROOT new" "$ROOT new2" "$OLD old2"; do
  set -- $run
  python3 "$TOOL" "$1" "$2" || status=1
done
exit $status
