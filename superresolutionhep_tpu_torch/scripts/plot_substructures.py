"""Substructure closure figures + metrics from a merged substructures file.

The port's copy of the JAX package's ``scripts/plot_substructures.py``,
after the reference's notebook comparison of C2/C3/D2 between HR truth, SR
prediction, the naive LR split and the LR cells themselves.  Produces:

  * overlaid observable distributions (C2, C3, D2) for the four estimators;
  * per-event residual distributions (estimator - truth) for the SR
    prediction vs the naive split, with IQR/median annotations;
  * a metrics JSON gating on the SR prediction tracking truth better than
    the naive split (residual IQR ratio per observable).

Usage:
    python -m superresolutionhep_tpu_torch.scripts.plot_substructures \
        -i runs/closure_multi/substructures/substructures.h5 \
        --fig-dir docs/figures --json docs/closure_substructure.json
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data import root_io

OBS = ("c2", "c3", "d2")
EST = [
    ("high_truth", "HR truth", "black"),
    ("high_pred", "SR prediction", "tab:red"),
    ("low_split", "naive LR split", "tab:blue"),
    ("low", "LR cells", "tab:gray"),
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", "-i", required=True)
    ap.add_argument("--fig-dir", default="docs/figures")
    ap.add_argument("--json", default="docs/closure_substructure.json")
    ap.add_argument("--tag", default="closure_multi")
    args = ap.parse_args(argv)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    tree = root_io.read_tree(args.input, "substructures")
    data = {k: np.asarray(tree[k], np.float64) for k in tree}
    os.makedirs(args.fig_dir, exist_ok=True)

    def iqr(a):
        return float(np.subtract(*np.percentile(a, [75, 25])))

    # 1) distributions
    fig, axes = plt.subplots(1, 3, figsize=(13, 3.6), dpi=120)
    for ax, obs in zip(axes, OBS):
        finite = np.hstack([data[f"{obs}_{key}"] for key, _, _ in EST])
        finite = finite[np.isfinite(finite)]
        lo, hi = np.percentile(finite, [0.5, 99.5])
        bins = np.linspace(lo, hi, 40)
        for key, label, color in EST:
            v = data[f"{obs}_{key}"]
            v = v[np.isfinite(v)]
            ax.hist(v, bins=bins, histtype="step", lw=1.6, label=label, color=color)
        ax.set_xlabel(obs.upper())
        ax.set_ylabel("events")
    axes[0].legend(fontsize=8)
    fig.suptitle("Jet substructure: truth vs SR prediction vs naive split")
    fig.tight_layout()
    dist_path = os.path.join(args.fig_dir, f"{args.tag}_substructure_dist.png")
    fig.savefig(dist_path)
    plt.close(fig)

    # 2) residuals vs truth + metrics
    metrics = {"n_events": int(data["c2_high_truth"].size), "observables": {}}
    fig, axes = plt.subplots(1, 3, figsize=(13, 3.6), dpi=120)
    for ax, obs in zip(axes, OBS):
        truth = data[f"{obs}_high_truth"]
        pred = data[f"{obs}_high_pred"]
        split = data[f"{obs}_low_split"]
        ok = np.isfinite(truth) & np.isfinite(pred) & np.isfinite(split)
        r_pred = pred[ok] - truth[ok]
        r_split = split[ok] - truth[ok]
        lim = max(1e-12, np.percentile(np.abs(np.hstack([r_pred, r_split])), 99))
        bins = np.linspace(-lim, lim, 41)
        ax.hist(r_split, bins=bins, histtype="step", lw=1.6, color="tab:blue",
                label=f"naive split (IQR {iqr(r_split):.3g})")
        ax.hist(r_pred, bins=bins, histtype="step", lw=1.6, color="tab:red",
                label=f"SR pred (IQR {iqr(r_pred):.3g})")
        ax.set_xlabel(f"{obs.upper()} $-$ {obs.upper()}$_{{truth}}$")
        ax.set_ylabel("events")
        ax.legend(fontsize=8)
        metrics["observables"][obs] = {
            "n": int(ok.sum()),
            "pred_residual_iqr": iqr(r_pred),
            "split_residual_iqr": iqr(r_split),
            "iqr_ratio_split_over_pred": iqr(r_split) / max(iqr(r_pred), 1e-12),
            "pred_residual_median": float(np.median(r_pred)),
            "split_residual_median": float(np.median(r_split)),
        }
    fig.suptitle("Substructure residuals vs HR truth")
    fig.tight_layout()
    res_path = os.path.join(args.fig_dir, f"{args.tag}_substructure_residuals.png")
    fig.savefig(res_path)
    plt.close(fig)

    metrics["gate_pred_beats_split_all_obs"] = bool(
        all(m["iqr_ratio_split_over_pred"] > 1.0 for m in metrics["observables"].values())
    )
    metrics["figures"] = [dist_path, res_path]
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as fp:
        json.dump(metrics, fp, indent=2)
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
