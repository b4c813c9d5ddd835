"""Multi-particle PF performance (counterpart of
notebooks/performance/performance_multipart_pf.ipynb +
performance_pf_ed.ipynb): per-cardinality accuracy tables, kinematic
residuals LR vs HR, and incidence-colored event displays.

  python -m superresolutionhep_tpu_torch.examples.performance_multipart_pf --sr <sr_pred> --lr <pf_lr_pred> --hr <pf_hr_pred>
"""

import argparse
import os

import numpy as np

from ..analysis.performance import PFPerformanceCOCOA


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sr", required=True, help="SR inference output")
    ap.add_argument("--lr", required=True, help="PF inference over LR cells")
    ap.add_argument("--hr", required=True, help="PF inference over SR-predicted HR cells")
    ap.add_argument("--out", "-o", default="plots")
    ap.add_argument("--res_factor", type=int, default=4)
    ap.add_argument("--n_displays", type=int, default=3)
    args = ap.parse_args(argv)
    import matplotlib

    matplotlib.use("Agg")
    os.makedirs(args.out, exist_ok=True)

    perf = PFPerformanceCOCOA(args.sr, args.lr, args.hr, res_factor=args.res_factor)

    # per-truth-cardinality accuracy table (notebook cells 12-16)
    print("cardinality accuracy by truth cardinality:")
    print("  truth_n   LR acc   HR acc   n_events")
    for n in range(1, perf.max_part + 1):
        sel = perf.truth_cardinality == n
        if not sel.sum():
            continue
        acc_lr = float((perf.low_cardinality[sel] == n).mean())
        acc_hr = float((perf.high_cardinality[sel] == n).mean())
        print(f"  {n:7d}   {acc_lr:6.3f}   {acc_hr:6.3f}   {int(sel.sum()):8d}")

    cm_lr, cm_hr = perf.cardinality_confusion()
    np.savetxt(os.path.join(args.out, "confusion_lr.txt"), cm_lr, fmt="%d")
    np.savetxt(os.path.join(args.out, "confusion_hr.txt"), cm_hr, fmt="%d")

    res = perf.kinematic_residuals()
    print("\nkinematic residual widths (IQR):")
    for k, v in res.items():
        if v.size:
            iqr = float(np.subtract(*np.percentile(v, [75, 25])))
            print(f"  {k:8s}  IQR={iqr:.4f}  sigma={v.std():.4f}")

    for i in range(min(args.n_displays, perf.n_events)):
        perf.plot_pf_event_display(i, dir=args.out)
    print(f"\nfigures in {args.out}/")


if __name__ == "__main__":
    main()
