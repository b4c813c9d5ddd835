"""Run SR inference with the shipped trained checkpoint through the standard
config-driven path (``model.checkpoint_path`` points straight at the
``.msgpack`` blob).

    python -m superresolutionhep_tpu_torch.examples.shipped_checkpoint_demo [--out demo_pred.h5] [--device cpu]

Generates a few events with the closure generator the checkpoint was trained
on (in memory), predicts, and prints the per-cell residual-IQR ratio vs the
naive flat split on those fresh events.  ``--out`` also writes the
prediction trees (needs h5py).
"""

import argparse
import os

from ..configs import CLOSURE_SR_CONFIG_MV, CLOSURE_SR_CONFIG_T, CLOSURE_SR_DIR
from ..data import root_io
from ..data.sr_dataset import SupResEvents
from ..data.synthetic import GeneratorConfig, generate_events
from ..inference.sr import SRInference
from ..scripts import REPO_ROOT
from ..scripts import closure_suite as cs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--n-events", type=int, default=16)
    ap.add_argument("--n-steps", type=int, default=25)
    ap.add_argument("--n-ensemble", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="torch device ('cuda' raises where there is no GPU)")
    args = ap.parse_args(argv)

    trees = generate_events(args.n_events, seed=777, config=GeneratorConfig(**cs.GEN))
    ds = SupResEvents.from_trees(trees["Low_Tree"], trees["High_Tree"], CLOSURE_SR_CONFIG_MV, make_low=True,
                                 make_particles=True)
    inf = SRInference(
        {"model": {
            "config_mv": CLOSURE_SR_CONFIG_MV, "config_t": CLOSURE_SR_CONFIG_T,
            "checkpoint_path": os.path.join(REPO_ROOT, CLOSURE_SR_DIR, "params.msgpack"),
            "n_steps": args.n_steps, "n_steps_to_store": 1,
        }}, device=args.device,
    )
    pred = inf.predict(ds, {"n_ensemble": args.n_ensemble, "batch_size": 16, "ode_method": "ab2",
                            "save_ensemble_components": False, "store_energy_incidence": False,
                            "max_particles": 1})
    if args.out:
        root_io.write_trees(args.out, pred)
    metrics = cs.closure_metrics(pred["High_Tree"])
    print(f"cells: {metrics['n_cells']}")
    print(f"naive flat-split residual IQR: {metrics['naive_iqr']:.3f}")
    print(f"SR prediction residual IQR:    {metrics['pred_iqr']:.4f}")
    print(f"IQR ratio: {metrics['iqr_ratio']:.1f}x")
    return metrics


if __name__ == "__main__":
    main()
