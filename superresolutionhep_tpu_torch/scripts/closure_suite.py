"""End-to-end SR physics-closure experiment.

The port's copy of the JAX package's ``scripts/closure_suite.py``: the
synthetic stand-in for the reference's validation on real COCOA data, which
must show super-resolution recovering subcell structure that the naive flat
split (proxy / res_factor^2, the reference's ``low_e_split`` baseline)
cannot.

Generator regime chosen for a decisive closure: sharp showers (sigma = 0.6 LR
cells, so subcell shares within a cell vary by factors of several), fully
deterministic conditional structure (split_noise = 0), low measurement noise,
single electron (no combinatoric shower overlaps confounding the
conditioning).

Pipeline: generate -> fit transform statistics -> write config pair -> train
(the port's training CLI) -> ensemble inference (``SRInference``) -> per-cell
residual IQR of the SR prediction vs the naive split, per layer and overall.
Writes closure_metrics.json; the gate is iqr_ratio (naive / SR) >= 1.5.
``closure_metrics`` is the evaluation on a ``High_Tree`` held in memory (what
``SRInference.predict`` returns), ``evaluate`` the same on the prediction
file.

Usage (from the repository root; ``--device cpu`` runs on the CPU):
    python -m superresolutionhep_tpu_torch.scripts.closure_suite --outdir runs/closure_v2 \
        --n-train 4096 --epochs 120
    python -m superresolutionhep_tpu_torch.scripts.closure_suite --outdir runs/closure_v2 --eval-only
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data import root_io
from ..data.synthetic import GeneratorConfig, write_synthetic_file
from . import REPO_ROOT

GEN = dict(
    single_electron=True,
    shower_sigma_cells=0.6,
    split_noise=0.0,
    noise_frac=0.005,
    window_lr_cells=3,
    e_min_gev=20.0,
    e_max_gev=100.0,
)

# hard mode: multiple overlapping showers per event (same sharp deterministic
# conditional structure; the model must separate superposed profiles)
GEN_MULTI = dict(
    single_electron=False,
    min_particles=2,
    max_particles=4,
    shower_sigma_cells=0.6,
    split_noise=0.0,
    noise_frac=0.005,
    window_lr_cells=2,
    e_min_gev=20.0,
    e_max_gev=100.0,
)

# generator seed of each split
SPLIT_SEEDS = {"train": 11, "val": 12, "test": 13}
# the suite's inference batch
INFER_BATCH = 64


def generate(outdir, n_train, n_val, n_test, gen=None):
    gen = gen or GEN
    os.makedirs(os.path.join(outdir, "data"), exist_ok=True)
    paths = {}
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        p = os.path.join(outdir, "data", f"{split}.h5")
        if not os.path.exists(p):
            print(f"[gen] {split}: {n} events -> {p}")
            write_synthetic_file(p, n, seed=SPLIT_SEEDS[split], config=GeneratorConfig(**gen))
        paths[split] = p
    return paths


def write_configs(outdir, paths, epochs, fourier=0, lr=1.0e-3, eval_every=None):
    import yaml

    from .compute_scale import compute_target_stats

    with open(os.path.join(REPO_ROOT, "configs/single_e/model_and_var_synth.yml")) as fp:
        mv = yaml.safe_load(fp)
    if fourier:
        # optional multi-scale geometry features (models/embed.py): resolves
        # the subcell-pitch structure a plain coordinate MLP cannot express
        mv["flow_model"]["etaphi_emb"]["fourier_features"] = int(fourier)
    mean, std = compute_target_stats(paths["train"], entry_stop=512)
    mv["target_transform"]["mean"] = round(mean, 6)
    mv["target_transform"]["std"] = round(std, 6)
    # x/y/z statistics over the training file (closure grid != real COCOA)
    hi = root_io.read_tree(paths["train"], "High_Tree", ["cell_x", "cell_y", "cell_z"], 0, 512)
    for br in ("cell_x", "cell_y", "cell_z"):
        flat = np.hstack(list(hi[br]))
        blk = mv["var_transform"][br.replace("cell_", "")]
        blk["mean"] = round(float(flat.mean()), 3)
        blk["std"] = round(float(flat.std()), 3)
        blk["min"] = round(float(flat.min()), 3)
        blk["max"] = round(float(flat.max()), 3)

    with open(os.path.join(REPO_ROOT, "configs/single_e/train_closure.yml")) as fp:
        tr = yaml.safe_load(fp)
    tr.update(
        num_epochs=epochs,
        run_name="closure_v2",
        base_root_dir=outdir,
        train_path=paths["train"],
        val_path=paths["val"],
        eval_every_n_epoch=eval_every if eval_every else max(epochs // 10, 1),
        batch_size_train=64,
        batch_size_val=64,
        learningrate=float(lr),
        # the sharp generator's saturated-logit tails produce occasional
        # huge-gradient batches; clip like the reference's PF stage does
        grad_clip_norm=1.0,
    )
    tr["lr_scheduler"] = dict(
        name="CustomLRScheduler",
        warm_start_epochs=0.03,
        cosine_epochs=0.9,
        eta_min=1.0e-5,
        last_epoch=-1,
        max_epochs="take_as_num_epochs",
    )
    mv_path = os.path.join(outdir, "model_and_var.yml")
    tr_path = os.path.join(outdir, "train.yml")
    with open(mv_path, "w") as fp:
        yaml.safe_dump(mv, fp)
    with open(tr_path, "w") as fp:
        yaml.safe_dump(tr, fp)
    return mv_path, tr_path


def train(mv_path, tr_path, outdir, device="cuda"):
    from ..cli.train_sr import main as train_main

    # --resume: no-op on a fresh run dir; after a crash a re-invocation with
    # the same args continues from the last checkpoint instead of epoch 0
    train_main(
        ["-cmv", mv_path, "-ct", tr_path, "--run_dir", os.path.join(outdir, "run"),
         "--debug_mode", "--resume", "--device", device]
    )


def infer_item(n_ensemble, ode_method="ab2e", max_particles=1):
    """The run settings of the suite's inference (fp32 and the robust
    attention: the model config sets no ``dtype`` and no ``fast_softmax``)."""
    return {"n_ensemble": n_ensemble, "ode_method": ode_method, "save_ensemble_components": False,
            "store_energy_incidence": False, "batch_size": INFER_BATCH, "max_particles": max_particles}


def infer_model_config(n_steps, checkpoint_path, **configs):
    """The ``model`` block of the suite's inference config; ``configs`` are
    ``config_path_mv``/``config_path_t`` or loaded ``config_mv``/``config_t``."""
    return dict(configs, checkpoint_path=checkpoint_path, n_steps=n_steps, n_steps_to_store=2)


def infer(mv_path, tr_path, outdir, paths, n_ensemble, n_steps, ode_method, max_particles=1, device="cuda"):
    from ..inference.sr import SRInference

    inf_cfg = {
        "dataset": "single_e",
        "batch_size": INFER_BATCH,
        "max_particles": max_particles,
        "model": infer_model_config(n_steps, os.path.join(outdir, "run", "checkpoints"),
                                    config_path_mv=mv_path, config_path_t=tr_path),
    }
    item = dict(infer_item(n_ensemble, ode_method=ode_method, max_particles=max_particles),
                info="closure test split", truth_path=paths["test"],
                pred_path=os.path.join(outdir, "pred_test.h5"), entry_start=0, n_events=10**6)
    SRInference(inf_cfg, device=device).run_pred(item)
    return item["pred_path"]


def closure_metrics(high_tree, rf=2, e_min_mev=1.0):
    """Per-HR-cell relative residuals, SR ensemble prediction vs naive flat
    split (e_proxy_raw / rf^2), ECAL layers only, from one prediction
    ``High_Tree`` (truth / proxy are copied through by the inference driver
    in the same LR-grouped cell order as the prediction).  Cells with truth
    below ``e_min_mev`` are excluded from BOTH estimators (identical
    denominators, so the comparison is estimator-only)."""
    pr = high_tree
    res_naive, res_pred, layers = [], [], []
    rf2 = rf * rf
    for j in range(len(pr["e_pred_raw"])):
        e_true = np.asarray(pr["e_truth_raw"][j], np.float64)  # MeV
        e_naive = np.asarray(pr["e_proxy_raw"][j], np.float64) / rf2
        e_pred = np.asarray(pr["e_pred_raw"][j], np.float64)
        lay = np.asarray(pr["layer"][j])
        sel = e_true > e_min_mev
        res_naive.append((e_naive[sel] - e_true[sel]) / e_true[sel])
        res_pred.append((e_pred[sel] - e_true[sel]) / e_true[sel])
        layers.append(lay[sel])

    res_naive = np.hstack(res_naive)
    res_pred = np.hstack(res_pred)
    layers = np.hstack(layers)

    def iqr(a):
        return float(np.subtract(*np.percentile(a, [75, 25])))

    out = {
        "n_cells": int(res_naive.size),
        "e_min_mev": e_min_mev,
        "naive_iqr": iqr(res_naive),
        "pred_iqr": iqr(res_pred),
        "iqr_ratio": iqr(res_naive) / iqr(res_pred),
        "naive_std": float(res_naive.std()),
        "pred_std": float(res_pred.std()),
        "per_layer": {},
    }
    for layer in (0, 1, 2):
        m = layers == layer
        if m.sum() < 10:
            continue
        out["per_layer"][str(layer)] = {
            "n": int(m.sum()),
            "naive_iqr": iqr(res_naive[m]),
            "pred_iqr": iqr(res_pred[m]),
            "iqr_ratio": iqr(res_naive[m]) / iqr(res_pred[m]),
        }
    return out


def evaluate(truth_path, pred_path, rf=2, e_min_mev=1.0):
    """``closure_metrics`` on the prediction file's ``High_Tree`` (every
    branch comes from the prediction file itself; ``truth_path`` is kept for
    the JAX package's signature)."""
    pr = root_io.read_tree(pred_path, "High_Tree", ["e_pred_raw", "e_truth_raw", "e_proxy_raw", "layer"])
    return closure_metrics(pr, rf=rf, e_min_mev=e_min_mev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="runs/closure_v2")
    ap.add_argument("--n-train", type=int, default=4096)
    ap.add_argument("--n-val", type=int, default=256)
    ap.add_argument("--n-test", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--n-ensemble", type=int, default=10)
    ap.add_argument("--n-steps", type=int, default=25)
    ap.add_argument("--ode-method", default="ab2e")
    ap.add_argument("--fourier", type=int, default=0, help="fourier_features octaves (0 = exact reference architecture)")
    ap.add_argument("--multipart", action="store_true", help="overlapping-shower generator (hard mode)")
    ap.add_argument("--train-glob", default=None, help="override train path (e.g. pre-generated multi-file set)")
    ap.add_argument("--lr", type=float, default=1.0e-3, help="peak learning rate (the localized vanilla runs diverge "
                    "at 1e-3: the circuit forms by epoch ~7, then a saturated-logit gradient spike wipes it; 3e-4 "
                    "is stable)")
    ap.add_argument(
        "--eval-every", type=int, default=None,
        help="val cadence in epochs (default epochs//10). The vanilla runs "
        "need a dense cadence: best-3 checkpointing keys on val/loss_raw, "
        "and a saturated-logit spike can wipe a freshly-formed circuit "
        "between two sparse evals, losing the best window entirely",
    )
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument(
        "--axis-jitter", type=float, default=None,
        help="localized-axis generator: shower centers confined to +/- this "
        "many layer-0 LR cells around a fixed (eta, phi) axis, so the "
        "subcell-parity sawtooth has only a handful of periods",
    )
    ap.add_argument(
        "--sigma", type=float, default=None,
        help="shower_sigma_cells override (LR-cell units): wider showers give a "
        "smoother subcell ratio field",
    )
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="torch device of training and inference ('cuda' raises where there is no GPU)")
    args = ap.parse_args(argv)

    os.makedirs(args.outdir, exist_ok=True)
    gen = GEN_MULTI if args.multipart else GEN
    if args.sigma is not None:
        gen = dict(gen, shower_sigma_cells=args.sigma)
    if args.axis_jitter is not None:
        gen = dict(gen, axis_eta=0.35, axis_phi=0.6, axis_jitter_lr_cells=args.axis_jitter)
    paths = generate(args.outdir, args.n_train, args.n_val, args.n_test, gen=gen)
    if args.train_glob:
        paths["train"] = args.train_glob
    mv_path = os.path.join(args.outdir, "model_and_var.yml")
    tr_path = os.path.join(args.outdir, "train.yml")
    pred_path = os.path.join(args.outdir, "pred_test.h5")

    if not args.eval_only:
        if not os.path.exists(mv_path):
            mv_path, tr_path = write_configs(
                args.outdir, paths, args.epochs, fourier=args.fourier, lr=args.lr,
                eval_every=args.eval_every,
            )
        if not args.skip_train:
            train(mv_path, tr_path, args.outdir, device=args.device)
        pred_path = infer(
            mv_path, tr_path, args.outdir, paths, args.n_ensemble, args.n_steps, args.ode_method,
            max_particles=gen.get("max_particles", 1), device=args.device,
        )

    metrics = evaluate(paths["test"], pred_path)
    metrics["generator"] = gen
    metrics["gate_iqr_ratio_ge_1p5"] = metrics["iqr_ratio"] >= 1.5
    out_path = os.path.join(args.outdir, "closure_metrics.json")
    with open(out_path, "w") as fp:
        json.dump(metrics, fp, indent=2)
    print(json.dumps(metrics, indent=2))
    print(f"[closure] wrote {out_path}")
    return metrics


if __name__ == "__main__":
    from ..utils.hostmem import ensure_tuned

    ensure_tuned()  # glibc malloc tunables, by one re-exec of this command
    main()
