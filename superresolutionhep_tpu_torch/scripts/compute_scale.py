"""Offline transform-statistics computation.

Computes mean / std / min / max of the cell x/y/z (or other branches) over a
training file and prints YAML-ready ``var_transform`` blocks; with
``--target`` also the logit-ratio target statistics.  The port's copy of the
JAX package's ``scripts/compute_scale.py`` (numpy and the port's HDF5
reader):

    python -m superresolutionhep_tpu_torch.scripts.compute_scale -fp train.h5 --target
"""

from __future__ import annotations

import argparse

import numpy as np

from ..data import root_io


def compute_target_stats(file_path, f=1.2, alpha=1e-6, entry_stop=None):
    """logit-ratio target statistics over ECAL cells, ignoring saturated
    ratios (the reference's 'computed ignoring the zero ratios' convention,
    configs/single_e/model_and_var.yml target_transform comment)."""
    lo = root_io.read_tree(file_path, "Low_Tree", ["cell_e", "high_cell_to_low_cell_edge"], 0, entry_stop)
    hi = root_io.read_tree(file_path, "High_Tree", ["cell_e", "cell_layer"], 0, entry_stop)
    logits = []
    for i in range(len(lo["cell_e"])):
        r = lo["high_cell_to_low_cell_edge"][i].astype(int)
        e_hi = hi["cell_e"][i][r] * 1e-3
        rf2 = len(e_hi) // len(lo["cell_e"][i])
        e_lo = np.repeat(lo["cell_e"][i] * 1e-3, rf2)
        m = hi["cell_layer"][i][r] < 3
        ratio = np.clip(e_hi[m] / (e_lo[m] * f), 0, 1)
        ratio = alpha + (1 - 2 * alpha) * ratio
        val = np.log(ratio / (1 - ratio))
        logits.append(val[(ratio > 10 * alpha) & (ratio < 1 - 10 * alpha)])
    flat = np.hstack(logits)
    return float(flat.mean()), float(flat.std())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--file_path", "-fp", type=str, required=True)
    ap.add_argument("--tree", type=str, default="High_Tree")
    ap.add_argument("--branches", nargs="+", default=["cell_x", "cell_y", "cell_z"])
    ap.add_argument("--entry_stop", type=int, default=None)
    ap.add_argument("--target", action="store_true", help="also compute logit-ratio target stats")
    args = ap.parse_args(argv)

    if args.target:
        mean, std = compute_target_stats(args.file_path, entry_stop=args.entry_stop)
        print("target_transform: {")
        print('    "transformation": "logit_ratio",')
        print('    "f": 1.2, "alpha": 1.0e-6,')
        print('    "scale_mode": "standard",')
        print(f'    "mean": {mean:.7f}, "std": {std:.7f}')
        print("}")
        print()

    tree = root_io.read_tree(args.file_path, args.tree, args.branches, 0, args.entry_stop)
    for br in args.branches:
        flat = tree[br].flat if hasattr(tree[br], "flat") else np.hstack(list(tree[br]))
        name = br.replace("cell_", "")
        print(f"    {name}: {{")
        print('        "transformation": null,')
        print('        "scale_mode": "standard",')
        print(f'        "mean": {flat.mean():.3f}, "std": {flat.std():.3f},')
        print(f'        "min": {flat.min():.3f}, "max": {flat.max():.3f}, "range": [-1,1]}}')
        print()


if __name__ == "__main__":
    main()
