"""Comparison figures for the HR-vs-LR PF closure.

The port's copy of the JAX package's ``scripts/plot_pf_hr_vs_lr.py``, after
the reference's pf_hr-vs-pf_lr comparison: matched kinematic residual
distributions and per-cardinality accuracy for the SAPF model trained on
measured LR cells (``resolution: low``) vs on SR-predicted HR cells
(``resolution: high``).  Consumes the outputs of ``closure_pf_hr_vs_lr``.

Usage:
    python -m superresolutionhep_tpu_torch.scripts.plot_pf_hr_vs_lr --outdir runs/closure_pf_hr \
        --figdir docs/figures
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data import root_io
from .closure_pf_suite import matched_residuals

# fixed entity colors across every panel (LR always blue, HR always red)
C_LR, C_HR = "tab:blue", "tab:red"


def residuals(pred_path):
    tree = root_io.read_tree(pred_path, "Particle_Tree")
    out = matched_residuals(tree, ("pt", "eta", "phi"))
    out["truth_card"] = np.asarray(tree["truth_card"])
    out["pred_card"] = np.asarray(tree["pred_card"])
    return out


def iqr(a):
    return float(np.subtract(*np.percentile(a, [75, 25])))


def main(argv=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="runs/closure_pf_hr")
    ap.add_argument("--figdir", default="docs/figures")
    args = ap.parse_args(argv)
    os.makedirs(args.figdir, exist_ok=True)

    lo = residuals(os.path.join(args.outdir, "pf_low", "pf_test_pred.h5"))
    hi = residuals(os.path.join(args.outdir, "pf_high", "pf_test_pred.h5"))
    with open(os.path.join(args.outdir, "closure_pf_hr_vs_lr.json")) as fp:
        metrics = json.load(fp)

    # --- matched kinematic residuals, LR-PF vs HR-PF --------------------
    fig, axes = plt.subplots(1, 3, figsize=(13, 3.6), dpi=120)
    spec = [("pt", r"$(p_T - p_T^{truth})/p_T^{truth}$", 1.2),
            ("eta", r"$\eta - \eta_{truth}$", 0.12),
            ("phi", r"$\phi - \phi_{truth}$", 0.05)]
    for ax, (name, xlabel, lim) in zip(axes, spec):
        bins = np.linspace(-lim, lim, 61)
        ax.hist(np.clip(lo[name], -lim, lim), bins=bins, histtype="step", lw=1.6,
                color=C_LR, label=f"LR-PF (IQR {iqr(lo[name]):.3g})")
        ax.hist(np.clip(hi[name], -lim, lim), bins=bins, histtype="step", lw=1.6,
                color=C_HR, label=f"HR-PF (IQR {iqr(hi[name]):.3g})")
        ax.set_xlabel(xlabel)
        ax.set_ylabel("matched particles")
        ax.legend(fontsize=8)
    fig.suptitle(
        "SAPF trained on measured LR cells vs SR-predicted HR cells "
        "(collimated 2-4 particle events, test split)", fontsize=10,
    )
    fig.tight_layout()
    p1 = os.path.join(args.figdir, "closure_pf_hr_vs_lr_residuals.png")
    fig.savefig(p1)
    plt.close(fig)

    # --- cardinality accuracy + summary ---------------------------------
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9.5, 3.6), dpi=120)
    ns = sorted(set(lo["truth_card"].tolist()))
    x = np.arange(len(ns))
    w = 0.38

    def acc(d, n):
        return float((d["pred_card"][d["truth_card"] == n] == n).mean())

    ax1.bar(x - w / 2, [acc(lo, n) for n in ns], w, color=C_LR, label="LR-PF")
    ax1.bar(x + w / 2, [acc(hi, n) for n in ns], w, color=C_HR, label="HR-PF")
    ax1.set_xticks(x, [str(n) for n in ns])
    ax1.set_xlabel("true particle count")
    ax1.set_ylabel("cardinality accuracy")
    ax1.set_ylim(0, 1.05)
    ax1.legend(fontsize=8)

    comp = metrics["comparison"]
    rows = [
        ("best val loss", comp["best_val_loss"]["low"], comp["best_val_loss"]["high"]),
        ("incidence MAE", comp["incidence_mae"]["low"], comp["incidence_mae"]["high"]),
        ("eta IQR", metrics["pf_low"]["residual_iqr"]["eta"], metrics["pf_high"]["residual_iqr"]["eta"]),
        ("pt rel IQR", metrics["pf_low"]["residual_iqr"]["pt_rel"], metrics["pf_high"]["residual_iqr"]["pt_rel"]),
    ]
    # a figure of PF files made without a training run has no val loss
    rows = [r for r in rows if r[1] is not None and r[2] is not None]
    y = np.arange(len(rows))[::-1]
    lo_v = np.array([r[1] for r in rows], np.float64)
    hi_v = np.array([r[2] for r in rows], np.float64)
    # normalize each row to the LR value so all rows share one axis
    ax2.barh(y + 0.19, np.ones_like(lo_v), 0.34, color=C_LR, label="LR-PF")
    ax2.barh(y - 0.19, hi_v / lo_v, 0.34, color=C_HR, label="HR-PF")
    for yi, (nm, lv, hv) in zip(y, rows):
        ax2.text(1.01, yi + 0.19, f"{lv:.4g}", va="center", fontsize=7)
        ax2.text(hv / lv + 0.01, yi - 0.19, f"{hv:.4g}", va="center", fontsize=7)
    ax2.set_yticks(y, [r[0] for r in rows], fontsize=8)
    ax2.set_xlabel("relative to LR-PF (lower is better)")
    ax2.axvline(1.0, color="gray", lw=0.8, ls="--")
    # room for the value labels; the entity colors are carried by ax1's
    # legend (same figure, fixed LR=blue / HR=red)
    ax2.set_xlim(0, 1.24)
    fig.suptitle("Two-stage closure: HR-PF vs LR-PF "
                 f"(gate={metrics['gate_hr_beats_lr']})", fontsize=10)
    fig.tight_layout()
    p2 = os.path.join(args.figdir, "closure_pf_hr_vs_lr_summary.png")
    fig.savefig(p2)
    plt.close(fig)
    print("wrote", p1, "and", p2)
    return p1, p2


if __name__ == "__main__":
    main()
