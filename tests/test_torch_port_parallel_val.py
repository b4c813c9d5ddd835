"""PyTorch port, validation split over data-parallel ranks (CPU): two ranks
over gloo, one spawn, against the single-rank trainers in this process
(whose ``evaluate`` the JAX package holds in test_torch_port_train.py,
test_torch_port_live.py and test_torch_port_pf_loss_train.py).

Each rank samples (SR) or runs (PF) its rows of every validation batch; the
sampler's noise and the random slots' are drawn for the global batch and cut
to the rank's rows, so both ranks' generators stay in step with the single
rank's; dopri5's error norms span both ranks' rows; the shards hold unequal
cell counts, and in the last SR batch one rank holds fillers alone.  Tolerances (fp32, the two
shards' partial sums added in another order, dopri5 taking the single
rank's steps): the losses 1e-5 relative, the live plots' summary scalars
1e-5 absolute (the residuals' ratios on the gathered predictions), the
cardinality accuracy exactly.  The plots are rank 0's alone.
"""

import numpy as np
import pytest
import torch

from superresolutionhep_tpu_torch.parallel.launch import run_ranks

from _torch_parallel_ranks import evaluations, val_rank
from test_torch_port_pf_loss_train import TRAIN_CFG as PF_TRAIN_CFG
from test_torch_port_pf_model import make_pf_trees, small_pf_config
from test_torch_port_train import make_configs

torch.set_num_threads(1)

RANK_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("val")
    args = (make_configs(lr_scheduler=None), (small_pf_config("random"), dict(PF_TRAIN_CFG)),
            make_pf_trees(10, seed=41))
    one = evaluations(*args, str(tmp / "one"))
    ranks = run_ranks(val_rank, 2, (*args, str(tmp / "two")), device="cpu", timeout_s=RANK_TIMEOUT_S)
    return one, ranks


def assert_metrics(got, want, rtol):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=0 if k.startswith("val") else 1e-5, err_msg=k)


def test_split_sr_evaluate_dopri5_matches_one_rank(runs):
    one, ranks = runs
    for r in ranks:
        assert_metrics(r["sr_dopri5"], one["sr_dopri5"], 1e-5)


def test_split_sr_evaluate_plots_on_rank_zero(runs):
    """The fixed-step sampler with the live plots: the summary scalars of
    the gathered predictions on both ranks, the figures from rank 0 only."""
    one, ranks = runs
    for r in ranks:
        assert_metrics(r["sr_plots"], one["sr_plots"], 1e-5)
    assert "res_event/pred_mean" in one["sr_plots"]
    assert ranks[0]["figures"] == one["figures"] and ranks[1]["figures"] == []


def test_split_pf_evaluate_matches_one_rank(runs):
    one, ranks = runs
    for r in ranks:
        assert_metrics({k: v for k, v in r["pf"].items() if k != "val/card_accuracy"},
                       {k: v for k, v in one["pf"].items() if k != "val/card_accuracy"}, 1e-5)
        assert r["pf"]["val/card_accuracy"] == one["pf"]["val/card_accuracy"]


def test_generators_stay_in_step(runs):
    """After the evaluations every rank's generators draw what the single
    rank's draw next: the noise was drawn for the global batches."""
    one, ranks = runs
    for r in ranks:
        for k in ("sr_next_draw", "pf_next_draw"):
            np.testing.assert_array_equal(r[k], one[k].numpy())
