"""PyTorch port, stage-2 (SAPF) sequence and tensor parallelism against the
JAX package (CPU).

Ranks over gloo: one spawn of eight, a (data 2, seq 4) mesh, for the
sequence-parallel forward and train step in gather and ring mode; one spawn
of four for the tensor-parallel ones on (data 2, model 2) and (data 1,
model 4).  The reference is the JAX package's single-device ``SAPF.apply``
and ``jax.grad`` of its loss (cardinality cross-entropy weighted 0.5 plus
the Hungarian-matched incidence KL, means over real events), built as
tests/test_{sequence,tensor}_parallel.py build it, on the same weights
(``tools/convert.py::pf_params_from_jax``).  The batch's second event has
8 cells, all on the first of the four seq shards: the other shards see none
of its cells, and it must still count as real.  Tolerances are the JAX
package's own: logits rtol 2e-5 / atol 2e-6, kinematics 2e-4 / 2e-5,
incidence 2e-5 / 2e-6, loss 2e-4 / 1e-5, gradients 3e-4 / 1e-5.
No JAX ``shard_map`` runs here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolutionhep_tpu.data.pf_dataset import collate_pf as jcollate_pf
from superresolutionhep_tpu.losses.set2set import set_to_set_incidence_loss as jincidence_loss
from superresolutionhep_tpu.models.pf.model_pf import SAPF as JSAPF
from superresolutionhep_tpu.train.pf_trainer import cross_entropy_int_labels as jcross_entropy
from superresolutionhep_tpu.transforms import build_var_transforms as jbuild_var_transforms
from superresolutionhep_tpu_torch.parallel.launch import run_ranks
from superresolutionhep_tpu_torch.tools.convert import pf_params_from_jax

from _torch_parallel_ranks import PF_TP_MESHES, pf_sp_rank, pf_tp_rank
from test_pf_pipeline import pf_config_mv

torch.set_num_threads(1)

RANK_TIMEOUT_S = 120
SP_SHAPE = {"data": 2, "seq": 4}
CONFIG_T = {"loss_on_inc_wts": True, "card_loss_weight": 0.5}
LENGTHS = (27, 8, 9, 32)  # 8: every cell on seq shard 0 of 4; 9: one cell on shard 1


def pf_sp_batch(N=32, Pmax=4, seed=13):
    """The JAX package's ``_pf_sp_batch`` (tests/test_sequence_parallel.py)
    with the incidence matrix and the cell counts ``LENGTHS``."""
    rng = np.random.default_rng(seed)
    events = []
    for n in LENGTHS:
        npart = int(rng.integers(1, Pmax + 1))
        ev = {
            "cell_e_raw": np.abs(rng.normal(20, 10, n)).astype(np.float32),
            "cell_eta_raw": rng.uniform(-2, 2, n).astype(np.float32),
            "cell_phi": rng.uniform(-3, 3, n).astype(np.float32),
            "cell_layer": rng.integers(0, 3, n).astype(np.int32),
            "n_particles": npart,
            "part_phi": rng.uniform(-3, 3, Pmax).astype(np.float32),
            "part_class": np.zeros(Pmax, np.int32),
        }
        ev["cell_cosphi"] = np.cos(ev["cell_phi"])
        ev["cell_sinphi"] = np.sin(ev["cell_phi"])
        ev["cell_e"] = (ev["cell_e_raw"] ** 0.5 - 7.35) / 15.65
        ev["cell_eta"] = ev["cell_eta_raw"] / 2.988
        for k in ["part_pt", "part_e", "part_eta", "part_dep_e",
                  "part_pt_raw", "part_e_raw", "part_eta_raw", "part_dep_e_raw"]:
            ev[k] = rng.normal(size=Pmax).astype(np.float32)
        inc = np.abs(rng.normal(size=(n, Pmax))).astype(np.float32)
        ev["incidence_matrix"] = inc / inc.sum(axis=1, keepdims=True)
        events.append(ev)
    return {k: np.asarray(v) for k, v in jcollate_pf(events, N, Pmax).items() if k != "idx"}


def port_tree(tree, config_pf):
    """A JAX SAPF parameter (or gradient) tree -> numpy in the port's
    ``state_dict`` names."""
    return {k[4:]: v.numpy() for k, v in pf_params_from_jax(tree, config_pf).items()}


@pytest.fixture(scope="module")
def setup():
    cfg = pf_config_mv()
    batch = pf_sp_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JSAPF(config_pf=cfg["pf_model"], transforms=jbuild_var_transforms(cfg["var_transform"]), attn_impl="xla")
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jb)
    ref = [np.asarray(x) for x in jax.jit(model.apply)(variables, jb)]
    ev_mask = jb["cell_mask"].any(-1)

    def loss_fn(p):
        logits, kin, inc = model.apply({"params": p}, jb)
        inc_loss, _, _ = jincidence_loss(inc, jb, kin, ev_mask)
        return CONFIG_T["card_loss_weight"] * jcross_entropy(logits, jb["cardinality"], ev_mask) + inc_loss

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    grads = jax.tree_util.tree_map(np.asarray, ref_grads)
    return dict(cfg=cfg, batch=batch, ref=ref, ref_loss=float(ref_loss), params=port_tree(params, cfg["pf_model"]),
                ref_grads=port_tree(grads, cfg["pf_model"]))


def _args(s):
    return (s["cfg"]["pf_model"], s["cfg"]["var_transform"], s["params"], CONFIG_T, s["batch"])


@pytest.fixture(scope="module")
def sp_ranks(setup):
    return run_ranks(pf_sp_rank, 8, (SP_SHAPE, *_args(setup)), device="cpu", timeout_s=RANK_TIMEOUT_S)


@pytest.fixture(scope="module")
def tp_ranks(setup):
    results = run_ranks(pf_tp_rank, 4, _args(setup), device="cpu", timeout_s=RANK_TIMEOUT_S)
    return {name: [r[name] for r in results] for name in PF_TP_MESHES}


def assemble(results, key, shape, ref):
    """The global (logits, kinematics, incidence) from each rank's block by
    its coords: rows over data; the incidence's cell axis (2) over seq,
    every seq rank holding the whole logits and kinematics (checked equal)."""
    B, N = ref[2].shape[0], ref[2].shape[2]
    Bl, Nl = B // shape.get("data", 1), N // shape.get("seq", 1)
    out = [np.full_like(x, np.nan) for x in ref]
    for r in results:
        (logits, kin, inc), d, s = r[key], r["coords"].get("data", 0), r["coords"].get("seq", 0)
        rows = slice(d * Bl, (d + 1) * Bl)
        for i, x in ((0, logits), (1, kin)):
            if np.isnan(out[i][rows]).all():
                out[i][rows] = x
            np.testing.assert_array_equal(out[i][rows], x)  # replicated over seq and model
        out[2][rows, :, s * Nl:(s + 1) * Nl] = inc
    return out


def assert_outputs(got, ref):
    for g, want, rtol, atol in zip(got, ref, (2e-5, 2e-4, 2e-5), (2e-6, 2e-5, 2e-6)):
        np.testing.assert_allclose(g, want, rtol=rtol, atol=atol)


def assert_step(loss, grads, setup):
    np.testing.assert_allclose(float(loss), setup["ref_loss"], rtol=2e-4, atol=1e-5)
    assert set(grads) == set(setup["ref_grads"])
    for k, want in setup["ref_grads"].items():
        np.testing.assert_allclose(grads[k], want, rtol=3e-4, atol=1e-5, err_msg=f"grad mismatch at {k}")


@pytest.mark.parametrize("mode", ["gather", "ring"])
def test_pf_sp_forward_matches_jax(setup, sp_ranks, mode):
    assert_outputs(assemble(sp_ranks, f"fwd_{mode}", SP_SHAPE, setup["ref"]), setup["ref"])


@pytest.mark.parametrize("mode", ["gather", "ring"])
def test_pf_sp_train_step_matches_jax(setup, sp_ranks, mode):
    """Loss and every gradient on every rank against single-device
    ``jax.grad``: a share not divided by the seq size, or gradients summed
    inside the differentiated function, is off by a factor of 4."""
    for r in sp_ranks:
        assert_step(r[f"loss_{mode}"], r[f"grads_{mode}"], setup)


@pytest.mark.parametrize("name", list(PF_TP_MESHES))
def test_pf_tp_forward_and_train_step_match_jax(setup, tp_ranks, name):
    """Heads and MLPs of both DiT stacks sharded over model; gradients summed
    over data alone."""
    assert_outputs(assemble(tp_ranks[name], "fwd", PF_TP_MESHES[name], setup["ref"]), setup["ref"])
    for r in tp_ranks[name]:
        assert_step(r["loss"], r["grads"], setup)
