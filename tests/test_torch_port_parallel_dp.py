"""PyTorch port, data parallelism of both trainers (CPU): two ranks over
gloo, one spawn for the whole file, against the single-rank port in this
process (whose step the JAX package's ``_train_step_impl`` holds in
test_torch_port_train.py and test_torch_port_pf_loss_train.py).

The shards hold unequal cell (and real-event) counts, so a mean of per-rank
means (``DistributedDataParallel``'s) would not reproduce the single-rank
step: one ``SRTrainer`` step and one ``PFTrainer`` step (random particle
slots: the global noise draw) — loss, statistics, every gradient, the
parameters after AdamW; ``fit`` with ``grad_accum_steps: 2`` and an active
``grad_clip_norm`` for two epochs, written by rank 0 alone, then resumed on
both ranks for a third; a packed SR and a PF ``fit`` epoch, where each rank
reads and collates only its own rows of every batch.  Tolerances (fp32, the two shards' partial sums
added in another order): loss and statistics 1e-5 relative, each gradient
1e-5 of its own max (floored at 1e-3 of the largest gradient: the
kinematics stack's final-norm bias gradients are rounding noise of 1e-10),
parameters 1e-6 absolute where the gradient exceeds 1e-6 (elsewhere within
the step Adam can take, as test_torch_port_pf_loss_train.py holds them).
"""

import json
import os

import numpy as np
import pytest
import torch

from superresolutionhep_tpu_torch.parallel.launch import run_ranks

from _torch_parallel_ranks import dp_rank, fit_one_epoch, pf_step, sr_fit, sr_host_batch, sr_step
from test_torch_port_pf_loss_train import TRAIN_CFG as PF_TRAIN_CFG
from test_torch_port_pf_model import make_pf_batch, make_pf_trees, small_pf_config
from test_torch_port_train import make_configs

torch.set_num_threads(1)

RANK_TIMEOUT_S = 120
LR = 1e-3


def close_rel(got, want, tol, what, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), floor, 1e-12)
    assert float(np.abs(got - want).max()) <= tol * scale, what


def assert_step_equal(got, want, stats_key):
    for k, v in want[stats_key].items():
        close_rel(got[stats_key][k], v, 1e-5, f"{stats_key}[{k}]")
    assert set(got["grads"]) == set(want["grads"])
    top = max(float(np.abs(v).max()) for v in want["grads"].values())
    for k, v in want["grads"].items():
        close_rel(got["grads"][k], v, 1e-5, f"grad {k}", floor=1e-3 * top)
    for k, v in want["params"].items():
        # where the gradient is rounding noise Adam turns it into a step of up
        # to lr either way (test_torch_port_pf_loss_train.py)
        live = np.abs(want["grads"][k]) > 1e-6 if k in want["grads"] else np.ones(v.shape, bool)
        np.testing.assert_allclose(got["params"][k][live], v[live], rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got["params"][k], v, rtol=0, atol=2 * LR + 1e-6, err_msg=k)


def host(tree):
    """Tensors -> numpy (the ranks' results come back so)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [host(v) for v in tree]
    return tree


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    sr_cfgs = make_configs(lr_scheduler=None)
    pf_cfgs = (small_pf_config("random"), dict(PF_TRAIN_CFG))
    pf_batch = make_pf_batch(7, B=4, N=40, lens=(40, 33, 9, 5), cards=(4, 3, 1, 2))
    return dict(sr_cfgs=sr_cfgs, sr_batch=sr_host_batch(sr_cfgs[0]), pf_cfgs=pf_cfgs, pf_batch=pf_batch,
                pf_trees=make_pf_trees(10, seed=41), tmp=tmp_path_factory.mktemp("dp"))


@pytest.fixture(scope="module")
def ranks(setup):
    s = setup
    return run_ranks(dp_rank, 2, (s["sr_cfgs"], s["sr_batch"], s["pf_cfgs"], s["pf_batch"], s["pf_trees"],
                                  str(s["tmp"] / "ranks")), device="cpu", timeout_s=RANK_TIMEOUT_S)


def test_sr_step_equals_single_rank(setup, ranks):
    counts = setup["sr_batch"]["q_mask"].sum(1)
    assert counts[:2].sum() != counts[2:].sum()  # unequal shards: a mean of means would differ
    want = host(sr_step(*setup["sr_cfgs"], setup["sr_batch"], str(setup["tmp"] / "single_sr")))
    for r in ranks:
        assert_step_equal(r["sr_step"], want, "stats")


def test_pf_step_equals_single_rank(setup, ranks):
    real = setup["pf_batch"]["cell_mask"].any(1)
    assert real[:2].sum() == real[2:].sum() and setup["pf_batch"]["cell_mask"][:2].sum() != \
        setup["pf_batch"]["cell_mask"][2:].sum()
    want = host(pf_step(*setup["pf_cfgs"], setup["pf_batch"], str(setup["tmp"] / "single_pf")))
    for r in ranks:
        assert_step_equal(r["pf_step"], want, "logs")


@pytest.fixture(scope="module")
def single_fit(setup):
    cfg_mv, cfg_t = setup["sr_cfgs"]
    return host(sr_fit(cfg_mv, dict(cfg_t, grad_accum_steps=2, grad_clip_norm=0.05, bucket_quantum=256),
                       str(setup["tmp"] / "single_fit")))


def test_grad_accum_and_clip_fit_equals_single_rank(ranks, single_fit):
    """Two epochs of two batches, one accumulated update an epoch, clipped
    (the gradient norm exceeds 0.05 on every step)."""
    want = single_fit
    assert len(want["losses"]) == 4 and all(g > 0.05 for _, g in want["losses"])
    for r in ranks:
        close_rel(np.stack(r["fit"]["losses"]), np.stack(want["losses"]), 1e-5, "fit losses")
        for k, v in want["params"].items():
            np.testing.assert_allclose(r["fit"]["params"][k], v, rtol=0, atol=1e-6, err_msg=k)


def test_checkpoint_written_once_and_resumed_on_both_ranks(setup, ranks, single_fit):
    run = setup["tmp"] / "ranks" / "fit"
    lines = [json.loads(x) for x in open(run / "metrics.jsonl")]
    assert [x["step"] for x in lines] == [0, 1, 2]  # one writer: no line twice
    assert sorted(os.listdir(run / "checkpoints" / "last")) == ["2.pt"]
    want = single_fit
    for r in ranks:
        fit = r["fit"]
        assert fit["epoch_resumed"] == 3 and fit["opt_count"] == 3
        close_rel(np.stack(fit["losses_resumed"]), np.stack(want["losses_resumed"]), 1e-5, "resumed losses")
        for k, v in want["params_resumed"].items():
            np.testing.assert_allclose(fit["params_resumed"][k], v, rtol=0, atol=1e-6, err_msg=k)


def test_fits_collating_own_rows_equal_single_rank(setup, ranks):
    """Each rank reads and collates only its rows (its packed row, its events
    of a bucketed PF batch); the steps equal the single-rank run's."""
    s = setup
    cfg_mv, cfg_t = s["sr_cfgs"]
    wants = {
        "packed_fit": host(fit_one_epoch("sr", cfg_mv, dict(cfg_t, packed=True, pack_s=512, pack_rows=2), None,
                                         str(s["tmp"] / "single_packed"))),
        "pf_fit": host(fit_one_epoch("pf", *s["pf_cfgs"], s["pf_trees"], str(s["tmp"] / "single_pf_fit"))),
    }
    for kind, want in wants.items():
        n_steps = len(want["losses"])
        assert n_steps >= 2, kind
        for r in ranks:
            close_rel(np.stack(r[kind]["losses"]), np.stack(want["losses"]), 1e-5, f"{kind} losses")
            for k, v in want["params"].items():
                # as in assert_step_equal: elements whose gradient was rounding
                # noise on some step move by up to lr a step either way
                live = want["least_grad"][k] > 1e-6 if k in want["least_grad"] else np.ones(v.shape, bool)
                got = r[kind]["params"][k]
                np.testing.assert_allclose(got[live], v[live], rtol=0, atol=1e-6, err_msg=f"{kind} {k}")
                np.testing.assert_allclose(got, v, rtol=0, atol=2 * LR * n_steps + 1e-6, err_msg=f"{kind} {k}")


def test_trainer_refuses_a_mesh_beyond_data(ranks):
    assert all(r["refuses_seq_mesh"] for r in ranks)
