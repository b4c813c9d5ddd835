"""Substructure worker: one entry-range chunk -> npz of D2/C2/C3.

The port's copy of the JAX package's ``scripts/compute_substructures.py``:
reads LR measured / LR-split / HR truth / HR pred (ensemble average
recomputed from the first 10 components when the file has them) and writes
``substructures_{start}_{stop}.npz``.  numpy and h5py only: the fan-out
(``submit_substructures``) starts one process per chunk, so this module
imports no torch.

    python -m superresolutionhep_tpu_torch.scripts.compute_substructures -fp pred.h5 \
        -estart 0 -estop 10 -sd substructures/
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..analysis.substructure import calc_substructure
from ..data import root_io


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--file_path", "-fp", type=str, required=True)
    ap.add_argument("--entry_start", "-estart", type=int, required=True)
    ap.add_argument("--entry_stop", "-estop", type=int, required=True)
    ap.add_argument("--save_dir", "-sd", type=str, required=True)
    ap.add_argument("--res_factor", type=int, default=2)
    args = ap.parse_args(argv)

    lo = root_io.read_tree(args.file_path, "Low_Tree", ["phi", "eta_raw", "e_meas_raw"], args.entry_start,
                           args.entry_stop)
    hi_all = root_io.read_tree(args.file_path, "High_Tree", None, args.entry_start, args.entry_stop)
    n = len(lo["phi"])
    rf2 = args.res_factor**2

    low_e = [np.asarray(x) for x in lo["e_meas_raw"]]
    low_eta = [np.asarray(x) for x in lo["eta_raw"]]
    low_phi = [np.asarray(x) for x in lo["phi"]]
    low_e_split = [x.repeat(rf2) / rf2 for x in low_e]

    high_eta = [np.asarray(x) for x in hi_all["eta_raw"]]
    high_phi = [np.asarray(x) for x in hi_all["phi"]]
    high_e_truth = [np.asarray(x) for x in hi_all["e_truth_raw"]]

    comp_keys = sorted(k for k in hi_all if "e_pred_raw_comp" in k and int(k.split("_")[-1]) <= 9)
    if comp_keys:
        high_e_pred = [np.mean([np.asarray(hi_all[k][i]) for k in comp_keys], axis=0) for i in range(n)]
    else:
        high_e_pred = [np.asarray(x) for x in hi_all["e_pred_raw"]]

    d2_low, c2_low, c3_low = calc_substructure(low_e, low_eta, low_phi)
    d2_sp, c2_sp, c3_sp = calc_substructure(low_e_split, high_eta, high_phi)
    d2_t, c2_t, c3_t = calc_substructure(high_e_truth, high_eta, high_phi)
    d2_p, c2_p, c3_p = calc_substructure(high_e_pred, high_eta, high_phi)

    os.makedirs(args.save_dir, exist_ok=True)
    np.savez(
        os.path.join(args.save_dir, f"substructures_{args.entry_start}_{args.entry_stop}.npz"),
        d2_low=d2_low, c2_low=c2_low, c3_low=c3_low,
        d2_low_split=d2_sp, c2_low_split=c2_sp, c3_low_split=c3_sp,
        d2_high_truth=d2_t, c2_high_truth=c2_t, c3_high_truth=c3_t,
        d2_high_pred=d2_p, c2_high_pred=c2_p, c3_high_pred=c3_p,
    )


if __name__ == "__main__":
    main()
