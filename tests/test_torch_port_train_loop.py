"""PyTorch port, the SR training loop on the CPU: checkpoint retention
(best 3 by ``val/loss_raw`` + last) and restore, ``fit`` with dopri5
validation and resume, the non-finite-loss abort with its diagnostics, and
the entry points that must refuse (no card; options waiting for modules not
ported yet)."""

import json
import os

import numpy as np
import pytest
import torch

from superresolutionhep_tpu_torch.train.checkpoint import CheckpointManager
from superresolutionhep_tpu_torch.train.sr_trainer import SRTrainer

from test_torch_port_train import make_configs, make_dataset

torch.set_num_threads(1)


def test_checkpoint_best3_last_and_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), configs={"a": 1})
    losses = [5.0, 3.0, 4.0, 1.0, 2.0, 6.0]
    for step, loss in enumerate(losses):
        mgr.save(step, {"w": torch.full((2,), float(step))}, {"val/loss_raw": loss, "note": "x"})
    assert mgr.all_best_steps() == [1, 3, 4]  # the three lowest losses
    assert mgr.best_step() == 3 and mgr.latest_step() == 5
    assert float(mgr.restore(which="last")["w"][0]) == 5.0
    assert float(mgr.restore(which="best")["w"][0]) == 3.0
    meta = json.load(open(tmp_path / "ck" / "best_meta.json"))
    assert meta["best_step"] == 3 and len(meta["history"]) == 6
    assert json.load(open(tmp_path / "ck" / "configs.json")) == {"a": 1}
    # a new manager over the same directory keeps the history
    mgr2 = CheckpointManager(str(tmp_path / "ck"))
    mgr2.save(6, {"w": torch.zeros(2)}, {"val/loss_raw": 0.5})
    assert mgr2.all_best_steps() == [3, 4, 6]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_fit_validates_checkpoints_and_resumes(tmp_path):
    """Two epochs of ``fit`` on the CPU (dopri5 validation), then a new
    trainer resumes from the last checkpoint and trains a third epoch."""
    config_mv, config_t = make_configs()
    train_ds, val_ds = make_dataset(config_mv, 8, 1), make_dataset(config_mv, 2, 2)
    run = str(tmp_path / "run")
    tr = SRTrainer(config_mv, config_t, run_dir=run, seed=0, device="cpu")
    tr.fit(train_ds, val_ds)
    assert tr.epoch == 2 and tr.global_step == 4
    lines = [json.loads(l) for l in open(os.path.join(run, "metrics.jsonl"))]
    assert len(lines) == 2 and all(np.isfinite(l["train/loss"]) and np.isfinite(l["val/loss_raw"]) for l in lines)
    assert lines[0]["lr"] == pytest.approx(1e-5) and lines[1]["lr"] == pytest.approx(1e-3)
    saved = {k: v.clone() for k, v in tr.model.state_dict().items()}

    tr2 = SRTrainer(config_mv, dict(config_t, num_epochs=3), run_dir=run, seed=1, device="cpu")
    tr2.ckpt = CheckpointManager(os.path.join(run, "checkpoints"))
    tr2.load_state(tr2.ckpt.restore(which="last"))
    for k, v in tr2.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert tr2.opt.count == 4
    tr2.fit(train_ds, val_ds, resume=True)
    assert tr2.epoch == 3 and tr2.global_step == 2
    assert json.loads(open(os.path.join(run, "metrics.jsonl")).readlines()[-1])["step"] == 2


def test_nonfinite_loss_aborts_with_diagnostics(tmp_path):
    """A non-finite loss ends the epoch with ``FloatingPointError`` after a
    per-module report (parameter and activation statistics) is written."""
    config_mv, config_t = make_configs(num_epochs=1)
    run = str(tmp_path / "run")
    tr = SRTrainer(config_mv, config_t, run_dir=run, seed=0, device="cpu")
    with torch.no_grad():
        tr.model.feat_0_mlp.linears[0].bias.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="non-finite"):
        tr.fit(make_dataset(config_mv, 4, 1), None)
    report = json.load(open(os.path.join(run, "nonfinite_diagnostics.json")))
    assert report["epoch"] == 0 and "feat_0_mlp" in report["params"]
    assert report["activations"]["feat_0_mlp"]["n_nonfinite"] > 0


def test_entry_points_refuse_what_is_not_there(tmp_path):
    """Without a card, ``device='cuda'`` (the default of the trainer and the
    CLI) raises instead of training on the CPU; the options that once waited
    for unported modules build a trainer now."""
    from superresolutionhep_tpu_torch.cli import train_sr
    from superresolutionhep_tpu_torch.config import load_yaml

    config_mv, config_t = make_configs()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            SRTrainer(config_mv, config_t, run_dir=str(tmp_path / "a"))
        cfg_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "multipart")
        train_yml = tmp_path / "train.yml"
        train_yml.write_text(json.dumps(dict(load_yaml(os.path.join(cfg_dir, "train.yml")), n_event_displays=0)))
        with pytest.raises(RuntimeError, match="cuda"):
            train_sr.main(["-cmv", os.path.join(cfg_dir, "model_and_var.yml"), "-ct", str(train_yml),
                           "--precision", "bfloat16", "--run_dir", str(tmp_path / "cli")])
    # packed training is ported: the option builds a trainer (tests/test_torch_port_packed_model.py trains it)
    assert SRTrainer(config_mv, dict(config_t, packed=True), run_dir=str(tmp_path / "b"), device="cpu").config_t["packed"]
    # the live plots are ported (tests/test_torch_port_live.py draws them)
    tr = SRTrainer(config_mv, dict(config_t, n_event_displays=2), run_dir=str(tmp_path / "c"), device="cpu")
    assert tr.config_t["n_event_displays"] == 2


def test_profile_epoch_is_a_profiled_window(tmp_path):
    """``profile: true`` profiles the first epoch of ``fit`` in a
    ``tools/trace_summary.py::ProfiledWindow``: its record (with
    ``complete``) in ``profile/summary.json``, the Chrome trace exported at
    the window's end, readable, with the host's operators of the epoch."""
    config_mv, config_t = make_configs(num_epochs=1)
    run = str(tmp_path / "run")
    tr = SRTrainer(config_mv, dict(config_t, profile=True), run_dir=run, seed=0, device="cpu")
    tr.fit(make_dataset(config_mv, 4, 1), None)
    summary = json.load(open(os.path.join(run, "profile", "summary.json")))
    assert summary["label"] == "train profile epoch" and summary["complete"] is True
    assert summary["wall_ms"] > 0 and summary["launches"] == {}  # no hand kernel launches on the CPU
    trace = json.load(open(os.path.join(run, "profile", "trace.json")))
    ops = [e for e in trace["traceEvents"] if e.get("cat") == "cpu_op"]
    assert ops and all(e["dur"] >= 0 for e in ops) and any(e["name"].startswith("aten::") for e in ops)
    assert tr.metrics._profiler is None and tr.metrics.stop_profile() is None
