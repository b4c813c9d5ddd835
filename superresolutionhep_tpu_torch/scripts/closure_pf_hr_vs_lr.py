"""The two-stage scientific closure: does PF trained on SR-predicted HR cells
beat PF trained on the measured LR cells?

The port's copy of the JAX package's ``scripts/closure_pf_hr_vs_lr.py``.  It
reproduces the reference's headline result: its shipped pf_hr model (val
0.3318) beats pf_lr (0.4034), trained via ``resolution: low | high`` on the
chunked outputs of stage-1 inference.

Chain:
  1. generate collimated multi-particle events (particles within ~1.5 LR
     cells of a common axis, so showers overlap at LR pitch but separate at
     HR pitch, the regime where resolution matters for PF);
  2. train the SR flow model on them (the port's training CLI);
  3. run SR ensemble inference over train/val/test, writing the chunked
     ``*_pred_*_*.h5`` files with ``High_Tree/e_pred_raw`` and the
     per-particle energy-incidence branches on BOTH trees;
  4. train SAPF twice from those files, once ``resolution: low`` (measured
     LR cells), once ``resolution: high`` (SR-predicted HR cells);
  5. PF inference on the test split for both; report cardinality accuracy,
     matched kinematic residual IQRs and incidence MAE side by side.

Gate: HR-PF beats LR-PF on incidence MAE and on the eta/phi kinematic IQRs.
``pf_metrics`` is the evaluation on trees held in memory, ``evaluate`` the
same on the files.

Usage (from the repository root; ``--cpu`` runs on the CPU):
    python -m superresolutionhep_tpu_torch.scripts.closure_pf_hr_vs_lr --outdir runs/closure_pf_hr
    python -m superresolutionhep_tpu_torch.scripts.closure_pf_hr_vs_lr --outdir runs/closure_pf_hr --eval-only
"""

from __future__ import annotations

import argparse
import glob as globlib
import json
import os

import numpy as np

from ..data import root_io
from ..data.synthetic import GeneratorConfig, write_synthetic_file
from ..data.pf_dataset import _cell_tree_names
from . import REPO_ROOT
from .closure_pf_suite import _iqr, cardinality_metrics, incidence_keys, incidence_mae, matched_residuals

# jet-like events: 2-4 particles collimated within 1.5 LR cells, shower
# sigma 0.55 LR cells -> pair separations straddle the LR pitch (median
# ~1.1 LR cells = 2.2 HR cells), deterministic conditional split
GEN = dict(
    min_particles=2,
    max_particles=4,
    shower_sigma_cells=0.55,
    split_noise=0.0,
    noise_frac=0.005,
    window_lr_cells=2,
    e_min_gev=20.0,
    e_max_gev=100.0,
    collimate_delta_r_lr_cells=1.5,
)
MAX_PART = GEN["max_particles"]
E_THRESHOLD_MEV = 1.0
SPLIT_SEEDS = {"train": 31, "val": 32, "test": 33}


def generate(outdir, n_train, n_val, n_test):
    os.makedirs(os.path.join(outdir, "data"), exist_ok=True)
    paths = {}
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        p = os.path.join(outdir, "data", f"{split}.h5")
        if not os.path.exists(p):
            print(f"[gen] {split}: {n} events -> {p}")
            write_synthetic_file(p, n, seed=SPLIT_SEEDS[split], config=GeneratorConfig(**GEN))
        paths[split] = p
    return paths


def train_sr(outdir, paths, epochs, fourier, device="cuda"):
    from .closure_suite import train, write_configs

    mv_path = os.path.join(outdir, "model_and_var.yml")
    tr_path = os.path.join(outdir, "train.yml")
    if not os.path.exists(mv_path):
        mv_path, tr_path = write_configs(outdir, paths, epochs, fourier=fourier)
    if not os.path.exists(os.path.join(outdir, "run", "checkpoints")):
        train(mv_path, tr_path, outdir, device=device)
    return mv_path, tr_path


def sr_inference(outdir, paths, mv_path, tr_path, n_ensemble, n_steps, ode_method, device="cuda"):
    """Trained-SR inference over all three splits, writing the chunked
    prediction files stage 2 globs (the inference CLI's batch-mode names)."""
    from ..inference.sr import SRInference

    inf = SRInference(
        {"model": {"config_path_mv": mv_path, "config_path_t": tr_path,
                   "checkpoint_path": os.path.join(outdir, "run", "checkpoints"),
                   "n_steps": n_steps, "n_steps_to_store": 0}}, device=device,
    )
    globs = {}
    for split in ("train", "val", "test"):
        d = os.path.join(outdir, "sr_out", split)
        os.makedirs(d, exist_ok=True)
        n = root_io.num_entries(paths[split], "Low_Tree")
        pred = os.path.join(d, f"{split}_pred_0_{n}.h5")
        if not os.path.exists(pred):
            print(f"[sr-infer] {split}: {n} events -> {pred}")
            inf.run_pred(
                {"truth_path": paths[split], "pred_path": pred, "entry_start": 0,
                 "n_events": n, "n_ensemble": n_ensemble, "batch_size": 64,
                 "ode_method": ode_method, "save_ensemble_components": False,
                 "store_energy_incidence": True, "max_particles": MAX_PART}
            )
        globs[split] = os.path.join(d, f"{split}_pred_*_*.h5")
    return globs


def train_pf(outdir, globs, epochs, res, device="cuda"):
    import yaml

    with open(os.path.join(REPO_ROOT, "configs/pflow/model_and_var.yml")) as fp:
        cfg_mv = yaml.safe_load(fp)
    cfg_mv["pf_model"]["max_particles"] = MAX_PART
    with open(os.path.join(REPO_ROOT, "configs/pflow/train.yml")) as fp:
        cfg_t = yaml.safe_load(fp)
    cfg_t.update(
        resolution=res,
        energy_threshold=E_THRESHOLD_MEV,
        num_epochs=epochs,
        eval_every_n_epoch=max(epochs // 10, 1),
        train_glob_arg=globs["train"],
        val_glob_arg=globs["val"],
        base_root_dir=outdir,
        run_name=f"closure_pf_{res}",
        n_sq_sum_threshold_train="1024**2 * 24",
        n_sq_sum_threshold_val="1024**2 * 64",
    )
    tag = os.path.join(outdir, f"pf_{res}")
    os.makedirs(tag, exist_ok=True)
    mv_path = os.path.join(tag, "pf_mv.yml")
    t_path = os.path.join(tag, "pf_t.yml")
    with open(mv_path, "w") as fp:
        yaml.safe_dump(cfg_mv, fp)
    with open(t_path, "w") as fp:
        yaml.safe_dump(cfg_t, fp)

    run_dir = os.path.join(tag, "run")
    if not os.path.exists(os.path.join(run_dir, "checkpoints")):
        from ..cli.train_pf import main as pf_main

        pf_main(["-cmv", mv_path, "-ct", t_path, "--run_dir", run_dir, "--debug_mode", "--device", device])
    return mv_path, t_path, run_dir


def infer_pf(outdir, globs, mv_path, t_path, run_dir, res, device="cuda"):
    from ..inference.pf import PFInference

    pred_path = os.path.join(outdir, f"pf_{res}", "pf_test_pred.h5")
    if not os.path.exists(pred_path):
        inf = PFInference(
            {"model": {"config_path_mv": mv_path, "config_path_t": t_path,
                       "checkpoint_path": os.path.join(run_dir, "checkpoints")},
             "batch_size": 64}, device=device,
        )
        inf.run_pred({"glob_arg": globs["test"], "pred_path": pred_path, "store_inc_wt": True})
    return pred_path


def pf_metrics(tree, res, cell_tree=None):
    """Cardinality accuracy, matched kinematic residual IQRs and incidence
    MAE of one PF model's ``Particle_Tree``, against the truth in the SR
    output it read (``cell_tree``: its ``Low_Tree`` at res=low, its
    ``High_Tree`` at res=high), over the same threshold-cut cells the PF
    model saw."""
    out = {"res": res, **cardinality_metrics(tree)}
    r = matched_residuals(tree, ("pt", "eta", "phi", "e"))
    out["residual_iqr"] = {"pt_rel": _iqr(r["pt"]), "eta": _iqr(r["eta"]), "phi": _iqr(r["phi"]),
                           "e_rel": _iqr(r["e"])}
    inc_keys = incidence_keys(tree)
    out["n_incidence_branches"] = len(inc_keys)
    if inc_keys and cell_tree is not None:
        out["incidence_mae"] = incidence_mae(tree, cell_tree, _cell_tree_names(res)[1], E_THRESHOLD_MEV)
    return out


def evaluate(pred_path, sr_test_glob, res):
    """``pf_metrics`` on the PF prediction file and the first SR output file
    of ``sr_test_glob``, plus the best validation loss of the PF training
    run beside the prediction."""
    tree = root_io.read_tree(pred_path, "Particle_Tree")
    n_part = len(incidence_keys(tree))
    cell = None
    if n_part and globlib.glob(sr_test_glob):
        srf = sorted(globlib.glob(sr_test_glob))[0]
        name, e_branch = _cell_tree_names(res)
        cell = root_io.read_tree(srf, name, [e_branch] + [f"e_part_{i}" for i in range(n_part)])
    out = pf_metrics(tree, res, cell)

    # best val loss from the training run's metric log
    run_metrics = os.path.join(os.path.dirname(pred_path), "run", "metrics.jsonl")
    if os.path.exists(run_metrics):
        best = None
        with open(run_metrics) as fp:
            for line in fp:
                v = json.loads(line).get("val_loss_to_optimize_on")
                if v is not None:
                    best = v if best is None else min(best, v)
        out["best_val_loss_to_optimize_on"] = best
    return out


def compare(lo, hi):
    """The side-by-side block and the gate of the two PF models' metrics."""
    comparison = {
        "cardinality_accuracy": {"low": lo["cardinality_accuracy"], "high": hi["cardinality_accuracy"]},
        "eta_iqr_ratio_low_over_high": lo["residual_iqr"]["eta"] / hi["residual_iqr"]["eta"],
        "phi_iqr_ratio_low_over_high": lo["residual_iqr"]["phi"] / hi["residual_iqr"]["phi"],
        "pt_iqr_ratio_low_over_high": lo["residual_iqr"]["pt_rel"] / hi["residual_iqr"]["pt_rel"],
        "incidence_mae": {"low": lo.get("incidence_mae"), "high": hi.get("incidence_mae")},
        "best_val_loss": {"low": lo.get("best_val_loss_to_optimize_on"),
                          "high": hi.get("best_val_loss_to_optimize_on")},
    }
    gate = bool(
        hi.get("incidence_mae", np.inf) < lo.get("incidence_mae", np.inf)
        and hi["residual_iqr"]["eta"] < lo["residual_iqr"]["eta"]
        and hi["residual_iqr"]["phi"] < lo["residual_iqr"]["phi"]
    )
    return comparison, gate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="runs/closure_pf_hr")
    ap.add_argument("--n-train", type=int, default=8192)
    ap.add_argument("--n-val", type=int, default=512)
    ap.add_argument("--n-test", type=int, default=512)
    ap.add_argument("--sr-epochs", type=int, default=120)
    ap.add_argument("--pf-epochs", type=int, default=100)
    ap.add_argument("--n-ensemble", type=int, default=10)
    ap.add_argument("--n-steps", type=int, default=25)
    ap.add_argument("--ode-method", default="ab2e")
    ap.add_argument("--fourier", type=int, default=9)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (without it: the card, or raise)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    os.makedirs(args.outdir, exist_ok=True)
    paths = generate(args.outdir, args.n_train, args.n_val, args.n_test)
    globs = {s: os.path.join(args.outdir, "sr_out", s, f"{s}_pred_*_*.h5") for s in ("train", "val", "test")}
    results = {}
    if not args.eval_only:
        mv_path, tr_path = train_sr(args.outdir, paths, args.sr_epochs, args.fourier, device)

        # SR quality sanity on the test split (the stage-1 closure gate)
        from .closure_suite import evaluate as sr_evaluate

        globs = sr_inference(args.outdir, paths, mv_path, tr_path, args.n_ensemble, args.n_steps,
                             args.ode_method, device)
        sr_pred = sorted(globlib.glob(globs["test"]))[0]
        results["sr_closure"] = sr_evaluate(paths["test"], sr_pred)
        print(f"[sr] IQR ratio vs naive split: {results['sr_closure']['iqr_ratio']:.2f}")

        for res in ("low", "high"):
            mvp, tp, run_dir = train_pf(args.outdir, globs, args.pf_epochs, res, device)
            infer_pf(args.outdir, globs, mvp, tp, run_dir, res, device)

    for res in ("low", "high"):
        pred = os.path.join(args.outdir, f"pf_{res}", "pf_test_pred.h5")
        results[f"pf_{res}"] = evaluate(pred, globs["test"], res)

    results["comparison"], gate = compare(results["pf_low"], results["pf_high"])
    results["generator"] = GEN
    results["gate_hr_beats_lr"] = gate
    out_path = os.path.join(args.outdir, "closure_pf_hr_vs_lr.json")
    with open(out_path, "w") as fp:
        json.dump(results, fp, indent=2)
    print(json.dumps(results, indent=2, default=float))
    print(f"[closure-pf-hr-vs-lr] wrote {out_path}")
    return results


if __name__ == "__main__":
    from ..utils.hostmem import ensure_tuned

    ensure_tuned()  # glibc malloc tunables, by one re-exec of this command
    main()
