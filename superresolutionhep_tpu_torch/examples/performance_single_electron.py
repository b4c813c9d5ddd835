"""Single-electron SR performance figures (counterpart of
notebooks/performance/performance_single_electron.ipynb): residual summaries,
event-display evolution panels, ensemble overlays and the ensemble-size sweep
over n in {2,5,10,25,50,100}.

  python -m superresolutionhep_tpu_torch.examples.performance_single_electron --pred <sr_inference_output> --out plots/
"""

import argparse
import os

from ..analysis.performance import PerformanceCOCOA


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pred", "-p", required=True, help="SR inference output file")
    ap.add_argument("--out", "-o", default="plots")
    ap.add_argument("--res_factor", type=int, default=2)
    ap.add_argument("--ensemble_sizes", nargs="+", type=int, default=[2, 5, 10, 25, 50, 100])
    args = ap.parse_args(argv)
    import matplotlib

    matplotlib.use("Agg")
    os.makedirs(args.out, exist_ok=True)

    perf = PerformanceCOCOA(args.pred, res_factor=args.res_factor)
    _, summary = perf.plot_residual_event(dir=args.out)
    perf.plot_residual_cell(dir=args.out)
    perf.plot_evolution(0, dir=args.out)
    perf.plot_evolution_raw_nn(0, dir=args.out)
    if perf.high_e_pred_raw_comp:
        perf.plot_residual_event_ens(dir=args.out)
        _, widths = perf.plot_ensemble_size_comparison(sizes=tuple(args.ensemble_sizes), dir=args.out)
        print("ensemble-size -> rel-residual IQR:", widths)
    print("event-sum summary:", {k: round(v, 4) for k, v in summary.items()})
    print(f"figures in {args.out}/")


if __name__ == "__main__":
    main()
