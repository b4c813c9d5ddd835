"""PyTorch port, stage-2 losses and training against the JAX package (fp32,
CPU): the Hungarian assignment (exhaustive on the device at P = 4, scipy on
the host at P = 9), both set losses with their pad-cost masks and
event-weighted means, one ``PFTrainer`` step against the JAX trainer's
``_train_step_impl`` on the same weights and batch, and ``fit`` with resume.

Tolerances: assignments equal; losses and their components 1e-5 relative
(fp32, another summation order); the train step's loss 1e-5 relative, every
gradient 1e-4 of its own max (floored at 1e-3 of the largest gradient, for
the exactly-zero key-bias gradients), the parameters after AdamW 1e-6
absolute where the gradient exceeds 1e-6 (elsewhere Adam turns rounding
noise into a step of up to lr on either side, which is all that is checked
there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolutionhep_tpu.losses import set2set as jset2set
from superresolutionhep_tpu.train.pf_trainer import PFTrainer as JPFTrainer
from superresolutionhep_tpu_torch.data.pf_dataset import PflowEvents
from superresolutionhep_tpu_torch.losses import set2set
from superresolutionhep_tpu_torch.tools.convert import pf_params_from_jax, pf_params_to_jax
from superresolutionhep_tpu_torch.train.checkpoint import CheckpointManager
from superresolutionhep_tpu_torch.train.pf_trainer import PFTrainer

from test_torch_port_pf_model import jax_sapf, make_pf_batch, make_pf_trees, small_pf_config

torch.set_num_threads(1)

TRAIN_CFG = {"num_epochs": 2, "eval_every_n_epoch": 1, "batch_size_train": 4, "batch_size_val": 4,
             "bucket_quantum": 64, "learningrate": 1.0e-3, "lr_scheduler": None, "energy_threshold": 1.0,
             "resolution": "low", "loss_on_inc_wts": True, "card_loss_weight": 0.5, "grad_clip_norm": 1.0,
             "num_workers": 0, "epoch_end_plots": False}


def _rel(got, want, tol, what, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), floor, 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3g} > {tol} x {scale:.3g}"


@pytest.mark.parametrize("P", [4, 9])
def test_hungarian_matches_jax(P):
    """Random costs with the pad-cost masks of ragged particle counts: the
    on-device permutation argmin (P = 4) and the scipy path (P = 9)."""
    rng = np.random.default_rng(P)
    cost = rng.uniform(size=(8, P, P)).astype(np.float32)
    valid = np.arange(P)[None] < rng.integers(1, P + 1, size=(8, 1))
    not_q4, inf = jset2set.pad_cost_masks(jnp.asarray(valid))
    masked = np.asarray(jnp.asarray(cost) * not_q4 + inf)
    tq4, tinf = set2set.pad_cost_masks(torch.from_numpy(valid))
    np.testing.assert_array_equal(tq4.numpy(), np.asarray(not_q4))
    np.testing.assert_array_equal(tinf.numpy(), np.asarray(inf))
    want = np.asarray(jset2set.hungarian(jnp.asarray(masked)))
    got = set2set.hungarian(torch.from_numpy(masked.copy())).numpy()
    np.testing.assert_array_equal(got, want)


def test_set_losses_match_jax():
    """Incidence and kinematics variants, with a filler event (event_mask)."""
    batch = make_pf_batch(21, B=4, lens=(40, 23, 9, 0), cards=(4, 2, 1, 0))
    rng = np.random.default_rng(22)
    inc = rng.uniform(size=(4, 4, 40)).astype(np.float32)
    inc = inc / inc.sum(1, keepdims=True)
    kin = rng.normal(size=(4, 4, 4)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    em = batch["cell_mask"].any(-1)
    weights = {"pt_loss_wt": 0.0, "eta_loss_wt": 500.0, "phi_loss_wt": 5.0, "e_loss_wt": 1.0}
    cases = (
        (jset2set.set_to_set_incidence_loss(jnp.asarray(inc), jb, jnp.asarray(kin), jnp.asarray(em)),
         set2set.set_to_set_incidence_loss(torch.from_numpy(inc), tb, torch.from_numpy(kin), torch.from_numpy(em))),
        (jset2set.set_to_set_kinematics_loss(jnp.asarray(kin), jb, weights, jnp.asarray(em)),
         set2set.set_to_set_kinematics_loss(torch.from_numpy(kin), tb, weights, torch.from_numpy(em))),
    )
    for (jl, jc, ja), (tl, tc, ta) in cases:
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        _rel(float(tl), float(jl), 1e-5, "loss")
        assert sorted(tc) == sorted(jc)
        for k in jc:
            _rel(float(tc[k]), float(jc[k]), 1e-5, k)


def jax_pf_trainer(cfg, cfg_t):
    """The JAX package's PFTrainer without its ``__init__`` (whose eager init
    compiles each op on its own): the model, the loss settings and the optax
    chain, as ``__init__`` sets them."""
    import optax

    from superresolutionhep_tpu.models.pf.model_pf import SAPF as JSAPF
    from superresolutionhep_tpu.transforms import build_var_transforms

    jtr = JPFTrainer.__new__(JPFTrainer)
    jtr.config_mv, jtr.config_t = cfg, cfg_t
    jtr.max_part = int(cfg["pf_model"]["max_particles"])
    jtr.transforms = build_var_transforms(cfg["var_transform"])
    jtr.model = JSAPF(config_pf=cfg["pf_model"], transforms=jtr.transforms, attn_impl="xla")
    jtr.loss_on_inc = bool(cfg_t["loss_on_inc_wts"])
    jtr.card_weight = float(cfg_t["card_loss_weight"])
    jtr.tx = optax.chain(optax.clip_by_global_norm(1.0), optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8),
                         optax.add_decayed_weights(0.01), optax.scale(-1.0))
    return jtr


def test_pf_train_step_matches_jax(tmp_path):
    cfg = small_pf_config()
    batch = make_pf_batch(31, B=4, lens=(40, 23, 9, 0), cards=(4, 2, 1, 0))  # one filler event
    _, params = jax_sapf(cfg, batch, seed=3)
    jtr = jax_pf_trainer(cfg, TRAIN_CFG)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jtr._loss_for_grad, has_aux=True))(params, jb, key)
    jnew, _, _ = jax.jit(jtr._train_step_impl)(params, jtr.tx.init(params), jb, key, jnp.float32(1e-3))

    ttr = PFTrainer(cfg, TRAIN_CFG, run_dir=str(tmp_path), device="cpu", params=pf_params_from_jax(params,
                                                                                                   cfg["pf_model"]))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _, grads = ttr.loss_and_grads(tb)
    _rel(float(loss.detach()), float(jloss), 1e-5, "loss")
    named = {n: g for (n, _), g in zip(ttr.model.named_parameters(), grads)}
    tgrads = pf_params_to_jax(named, cfg["pf_model"])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(tgrads)[0])
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, jgrads))[0])
    assert sorted(map(str, flat_t)) == sorted(map(str, flat_j))
    # each leaf against max(its own max, 1e-3 of the largest leaf): the key
    # projection's bias has an exactly zero gradient (the softmax does not
    # see it), so both sides hold rounding noise of ~1e-9 there
    top = max(float(np.abs(g).max()) for g in flat_j.values())
    for path, want in flat_j.items():
        _rel(flat_t[path], want, 1e-4, jax.tree_util.keystr(path), floor=1e-3 * top)
    ttr.train_step(tb, lr=1e-3)
    flat_new = dict(jax.tree_util.tree_flatten_with_path(pf_params_to_jax(ttr.model.state_dict(), cfg["pf_model"]))[0])
    flat_old = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    for path, want in jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, jnew))[0]:
        # Adam's first step is ~lr * g / (|g| + 1e-8): where |g| is within a
        # few hundred eps of 0 the two sides' rounding noise moves it by up to
        # lr, so those elements are held to that bound only
        sure = np.abs(flat_j[path]) > 1e-6
        diff = np.abs(flat_new[path] - want)
        assert diff[sure].max(initial=0.0) <= 1e-6, jax.tree_util.keystr(path)
        assert np.abs(flat_new[path] - flat_old[path])[~sure].max(initial=0.0) <= 1.01e-3


def test_pf_fit_and_resume(tmp_path):
    """Two epochs with validation (the plots on), best-k and last
    checkpoints; a second trainer resumes from the last one for a third."""
    cfg = small_pf_config()
    trees = make_pf_trees(10, seed=41)
    ds = PflowEvents.from_trees(trees, cfg, energy_threshold=1.0, load_incidence=True)
    run = str(tmp_path / "pf")
    tr = PFTrainer(cfg, dict(TRAIN_CFG, epoch_end_plots=True), run_dir=run, device="cpu", seed=0)
    tr.fit(ds, ds)
    assert tr.epoch == 2 and tr.global_step > 0
    ck = CheckpointManager(f"{run}/checkpoints", monitor="val_loss_to_optimize_on")
    assert ck.latest_step() == 1 and len(ck.all_best_steps()) == 2
    last = {k: v.clone() for k, v in tr.model.state_dict().items()}
    import json
    import os

    lines = [json.loads(x) for x in open(f"{run}/metrics.jsonl")]
    assert all(np.isfinite(x["train/loss"]) and "val/card_accuracy" in x and "val_loss_to_optimize_on" in x
               for x in lines)
    assert len(os.listdir(f"{run}/figures")) == 4  # confusion matrix and residuals, per epoch

    tr2 = PFTrainer(cfg, dict(TRAIN_CFG, num_epochs=3), run_dir=run, device="cpu", seed=1)
    tr2.load_state(ck.restore(which="last"))
    assert all(torch.equal(tr2.model.state_dict()[k], v) for k, v in last.items())
    tr2 = PFTrainer(cfg, dict(TRAIN_CFG, num_epochs=3), run_dir=run, device="cpu", seed=1)
    tr2.fit(ds, ds, resume=True)
    assert tr2.epoch == 3 and tr2.opt.count == tr.opt.count + tr2.global_step
    assert CheckpointManager(f"{run}/checkpoints").latest_step() == 2
