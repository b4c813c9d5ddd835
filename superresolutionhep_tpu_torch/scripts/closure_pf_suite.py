"""End-to-end PF (stage-2) physics-closure experiment.

The port's copy of the JAX package's ``scripts/closure_pf_suite.py``, the
counterpart of ``closure_suite.py`` for the particle-flow stage: does SAPF,
trained through the training pipeline on synthetic multi-particle events,
reconstruct the particles?  Gates on:

  * cardinality accuracy (predicted particle count == truth count),
  * matched kinematic residual IQRs (pt / eta / phi),
  * predicted-incidence quality vs the truth incidence (mean |dw| per cell
    on matched particles).

Pipeline: generate multipart truth -> stage-1 inference in LR-passthrough
mode (the Low_Tree of the SR output file carries the measured cells and the
per-particle energy-incidence branches the PF dataset trains on; the HR
branches are not used at res='low') -> train SAPF with the port's PF
training CLI -> PF inference -> metrics JSON.  ``pf_closure_metrics`` is the
evaluation on a ``Particle_Tree`` and the SR output's ``Low_Tree`` held in
memory (what ``PFInference.predict`` and ``SRInference.predict`` return),
``evaluate`` the same on the files.

Usage (from the repository root; ``--cpu`` runs on the CPU):
    python -m superresolutionhep_tpu_torch.scripts.closure_pf_suite --outdir runs/closure_pf --epochs 80
    python -m superresolutionhep_tpu_torch.scripts.closure_pf_suite --outdir runs/closure_pf --eval-only
"""

from __future__ import annotations

import argparse
import glob as globlib
import json
import os

import numpy as np

from ..data import root_io
from ..data.synthetic import GeneratorConfig, write_synthetic_file
from . import REPO_ROOT

GEN = dict(
    min_particles=1,
    max_particles=4,
    shower_sigma_cells=0.8,
    split_noise=0.1,
    noise_frac=0.01,
    window_lr_cells=2,
    e_min_gev=10.0,
    e_max_gev=100.0,
)

# generator seed of each split
SPLIT_SEEDS = {"train": 21, "val": 22, "test": 23}
# the stage-1 passthrough's run settings: the HR prediction is irrelevant at
# res='low', so a random-weight model at 2 steps, one member
PASSTHROUGH_ITEM = {"n_ensemble": 1, "batch_size": 64, "ode_method": "euler", "save_ensemble_components": False,
                    "store_energy_incidence": True, "max_particles": GEN["max_particles"]}
PASSTHROUGH_T = {"res_factor": 2, "detector": "COCOA", "dataset": "closure_pf", "learningrate": 1e-3,
                 "lr_scheduler": None, "num_epochs": 1}
# the PF dataset's MeV cell threshold
E_CUT_MEV = 1.0


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


def passthrough_inference(config_mv, device="cuda"):
    """``SRInference`` of the LR passthrough: a random-weight FlowModel of
    ``config_mv`` (res_factor 2) at 2 steps, storing one intermediate step."""
    from ..inference.sr import SRInference
    from ..tools.convert import init_params_jax_layout, params_from_jax

    mv = dict(config_mv, res_factor=2)
    params = params_from_jax(init_params_jax_layout(mv["flow_model"], seed=0), mv["flow_model"])
    return SRInference({"model": {"config_mv": mv, "config_t": PASSTHROUGH_T, "checkpoint_path": None,
                                  "n_steps": 2, "n_steps_to_store": 1}}, params=params, device=device)


def sr_passthrough(outdir, paths, device="cuda"):
    """Produce SR-output-schema files: Low_Tree measured cells + e_part_i
    incidence branches (what PF res='low' trains on)."""
    import yaml

    with open(os.path.join(REPO_ROOT, "configs/single_e/model_and_var_synth.yml")) as fp:
        mv = yaml.safe_load(fp)
    inf = passthrough_inference(mv, device)
    out = {}
    for split in ("train", "val", "test"):
        d = os.path.join(outdir, "sr_out", split)
        os.makedirs(d, exist_ok=True)
        pred = os.path.join(d, f"{split}_pred_0_0.h5")
        if not os.path.exists(pred):
            n = root_io.num_entries(paths[split], "Low_Tree")
            inf.run_pred(dict(PASSTHROUGH_ITEM, truth_path=paths[split], pred_path=pred, entry_start=0, n_events=n))
        out[split] = os.path.join(d, f"{split}_pred_*_*.h5")
    return out


def train_pf(outdir, globs, epochs, device="cuda"):
    import yaml

    from ..cli.train_pf import main as pf_main

    with open(os.path.join(REPO_ROOT, "configs/pflow/model_and_var.yml")) as fp:
        cfg_mv = yaml.safe_load(fp)
    cfg_mv["pf_model"]["max_particles"] = GEN["max_particles"]
    with open(os.path.join(REPO_ROOT, "configs/pflow/train.yml")) as fp:
        cfg_t = yaml.safe_load(fp)
    cfg_t.update(
        num_epochs=epochs,
        eval_every_n_epoch=max(epochs // 8, 1),
        train_glob_arg=globs["train"],
        val_glob_arg=globs["val"],
        base_root_dir=outdir,
        run_name="closure_pf",
        n_sq_sum_threshold_train="1024**2 * 24",
        n_sq_sum_threshold_val="1024**2 * 64",
    )
    mv_path = os.path.join(outdir, "pf_mv.yml")
    t_path = os.path.join(outdir, "pf_t.yml")
    with open(mv_path, "w") as fp:
        yaml.safe_dump(cfg_mv, fp)
    with open(t_path, "w") as fp:
        yaml.safe_dump(cfg_t, fp)
    pf_main(["-cmv", mv_path, "-ct", t_path, "--run_dir", os.path.join(outdir, "run"), "--debug_mode",
             "--device", device])
    return mv_path, t_path


def infer_pf(outdir, globs, mv_path, t_path, device="cuda"):
    from ..inference.pf import PFInference

    pred_path = os.path.join(outdir, "pf_test_pred.h5")
    inf = PFInference(
        {"model": {"config_path_mv": mv_path, "config_path_t": t_path,
                   "checkpoint_path": os.path.join(outdir, "run", "checkpoints")},
         "batch_size": 64}, device=device,
    )
    inf.run_pred({"glob_arg": globs["test"], "pred_path": pred_path, "store_inc_wt": True})
    return pred_path


def _iqr(a):
    return float(np.subtract(*np.percentile(a, [75, 25]))) if a.size else None


def matched_residuals(tree, names=("pt", "eta", "phi")):
    """Truth - prediction per matched particle (rows of ``Particle_Tree``):
    phi wrapped to [-pi, pi), pt and e relative to the truth."""
    n_rows = len(np.asarray(tree["truth_card"]))
    res = {}
    for name in names:
        t_rows = tree[f"truth_{name}_raw" if name != "phi" else "truth_phi"]
        p_rows = tree[f"pred_{name}_raw" if name != "phi" else "pred_phi"]
        diffs = []
        for i in range(n_rows):
            t = np.asarray(t_rows[i], np.float64)
            p = np.asarray(p_rows[i], np.float64)
            k = min(t.size, p.size)
            d = t[:k] - p[:k]
            if name == "phi":
                d = (d + np.pi) % (2 * np.pi) - np.pi
            if name in ("pt", "e"):
                d = d / np.maximum(np.abs(t[:k]), 1e-9)  # relative residual
            diffs.append(d)
        res[name] = np.hstack(diffs) if diffs else np.zeros(0)
    return res


def incidence_keys(tree):
    """The ``pred_inc_wt_<i>`` branches in particle order (numeric sort:
    a lexicographic one would put ``_10`` before ``_2``)."""
    return sorted((k for k in tree if k.startswith("pred_inc_wt_")), key=lambda k: int(k.rsplit("_", 1)[1]))


def incidence_mae(tree, cell_tree, e_branch, e_cut=E_CUT_MEV):
    """Mean |w_pred - w_true| over (cell, matched particle) pairs: truth
    weights from the per-particle energy branches of the SR output the PF
    dataset read (``cell_tree``, rows by event index ``idx``), over the
    cells above the PF dataset's cut; PF inference aligns the predicted
    particle order to the truth through the matching."""
    inc_keys = incidence_keys(tree)
    n_part = len(inc_keys)
    truth_card = np.asarray(tree["truth_card"])
    idx = np.asarray(tree["idx"])
    abs_err, n_terms = 0.0, 0
    for row, ev in enumerate(idx):
        e = np.asarray(cell_tree[e_branch][ev], np.float64)
        keep = e > e_cut
        ep = np.stack([np.asarray(cell_tree[f"e_part_{i}"][ev], np.float64)[keep] for i in range(n_part)], axis=-1)
        tot = ep.sum(-1, keepdims=True)
        w_true = ep / np.maximum(tot, 1e-12)
        w_pred = np.stack([np.asarray(tree[k][row], np.float64) for k in inc_keys], axis=-1)
        if w_pred.shape[0] != w_true.shape[0]:
            continue
        ncard = int(truth_card[row])
        m = (tot[:, 0] > 0)[:, None] & (np.arange(n_part)[None, :] < ncard)
        abs_err += float(np.abs(w_pred - w_true)[m].sum())
        n_terms += int(m.sum())
    return abs_err / max(n_terms, 1)


def cardinality_metrics(tree):
    truth_card = np.asarray(tree["truth_card"])
    pred_card = np.asarray(tree["pred_card"])
    return {
        "n_events": int(truth_card.size),
        "cardinality_accuracy": float((truth_card == pred_card).mean()),
        "cardinality_accuracy_by_n": {
            str(n): float((pred_card[truth_card == n] == n).mean())
            for n in sorted(set(truth_card.tolist()))
        },
    }


def pf_closure_metrics(tree, low_tree=None):
    """The closure metrics of one PF prediction ``Particle_Tree``; the
    incidence MAE needs the SR output's ``Low_Tree`` (``e_meas_raw``,
    ``e_part_i``)."""
    out = cardinality_metrics(tree)
    res = matched_residuals(tree)
    out["residual_iqr"] = {"pt_rel": _iqr(res["pt"]), "eta": _iqr(res["eta"]), "phi": _iqr(res["phi"])}
    inc_keys = incidence_keys(tree)
    out["n_incidence_branches"] = len(inc_keys)
    if inc_keys and low_tree is not None:
        out["incidence_mae"] = incidence_mae(tree, low_tree, "e_meas_raw")
    return out


def evaluate(pred_path, sr_test_glob=None):
    """``pf_closure_metrics`` on the PF prediction file and the first SR
    output file of ``sr_test_glob``."""
    tree = root_io.read_tree(pred_path, "Particle_Tree")
    low = None
    n_part = len(incidence_keys(tree))
    if n_part and sr_test_glob and globlib.glob(sr_test_glob):
        srf = sorted(globlib.glob(sr_test_glob))[0]
        low = root_io.read_tree(srf, "Low_Tree", ["e_meas_raw"] + [f"e_part_{i}" for i in range(n_part)])
    return pf_closure_metrics(tree, low)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="runs/closure_pf")
    ap.add_argument("--n-train", type=int, default=3072)
    ap.add_argument("--n-val", type=int, default=256)
    ap.add_argument("--n-test", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=80)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (without it: the card, or raise)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    os.makedirs(args.outdir, exist_ok=True)
    paths = generate(args.outdir, args.n_train, args.n_val, args.n_test)
    pred_path = os.path.join(args.outdir, "pf_test_pred.h5")
    if not args.eval_only:
        globs = sr_passthrough(args.outdir, paths, device)
        mv_path, t_path = train_pf(args.outdir, globs, args.epochs, device)
        pred_path = infer_pf(args.outdir, globs, mv_path, t_path, device)

    metrics = evaluate(pred_path, sr_test_glob=os.path.join(args.outdir, "sr_out", "test", "test_pred_*_*.h5"))
    metrics["generator"] = GEN
    metrics["gate_cardinality_ge_0p8"] = metrics["cardinality_accuracy"] >= 0.8
    out_path = os.path.join(args.outdir, "closure_pf_metrics.json")
    with open(out_path, "w") as fp:
        json.dump(metrics, fp, indent=2)
    print(json.dumps(metrics, indent=2))
    print(f"[closure-pf] wrote {out_path}")
    return metrics


if __name__ == "__main__":
    from ..utils.hostmem import ensure_tuned

    ensure_tuned()  # glibc malloc tunables, by one re-exec of this command
    main()
