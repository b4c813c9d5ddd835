"""PyTorch port, ``SRInference.run_pred`` and the inference CLI against the JAX
package (fp32, CPU): the three output trees of the same synthetic ``.h5``
file, the same weights and the JAX driver's own noise, over bucketed batches,
segment-packed rows, and packed rows whose largest events exceed ``pack_s``
and go through the bucketed mop-up.

The JAX driver draws each batch's ensemble noise as
``split(fold_in(PRNGKey(seed), bi), n_ensemble)``; the port takes it through
its ``noise(bi, shape)`` hook.  The mop-up restarts ``bi`` at 0 in both (so
there it reuses packed batch 0's keys, a quirk of the reference).

Branches copied from the input are held exactly; predictions within 1e-4 of
each branch's max (fp32 on both sides, dense attention, another summation
order)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from superresolutionhep_tpu.inference.sr import SRInference as JSRInference
from superresolutionhep_tpu_torch.cli import inference_sr
from superresolutionhep_tpu_torch.data import root_io
from superresolutionhep_tpu_torch.data.synthetic import GeneratorConfig, write_synthetic_file
from superresolutionhep_tpu_torch.inference.sr import SRInference
from superresolutionhep_tpu_torch.tools.convert import init_params_jax_layout, params_from_jax
from superresolutionhep_tpu_torch.train.checkpoint import CheckpointManager

from test_flow_model import small_flow_config
from test_torch_port_train import make_configs

torch.set_num_threads(1)
TREES = ("Low_Tree", "High_Tree", "Particle_Tree")
SEED = 3
INF = {"n_ensemble": 2, "ode_method": "ab2e", "seed": SEED, "batch_size": 4, "save_ensemble_components": True,
       "store_energy_incidence": True, "max_particles": 3}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("run_pred")
    fm = small_flow_config("DiT")
    config_mv, config_t = make_configs(fm)
    truth = str(d / "truth.h5")
    # 108-, 216- and 324-cell events
    write_synthetic_file(truth, 6, seed=21, config=GeneratorConfig(res_factor=2, max_particles=3, window_lr_cells=1))
    mv_path, t_path = str(d / "config_mv.yml"), str(d / "config_t.yml")
    yaml.safe_dump(config_mv, open(mv_path, "w"))
    yaml.safe_dump(config_t, open(t_path, "w"))
    tree = init_params_jax_layout(fm, seed=4)
    model = {"config_path_mv": mv_path, "config_path_t": t_path, "checkpoint_path": None, "n_steps": 4,
             "n_steps_to_store": 1}
    return d, truth, model, tree


def _jax_noise(bi, shape):
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(SEED), bi), shape[0])
    return np.stack([np.asarray(jax.random.normal(k, shape[1:], jnp.float32)) for k in keys])


def _read(path):
    return {t: root_io.read_tree(path, t) for t in TREES}


@pytest.mark.parametrize("mode", [dict(packed=False), dict(packed=True, pack_s=512, pack_rows=2),
                                  dict(packed=True, pack_s=256, pack_rows=2)],
                         ids=["bucketed", "packed", "packed_oversize"])
def test_run_pred_matches_jax(setup, mode):
    d, truth, model, tree = setup
    name = "_".join(f"{k}{v}" for k, v in mode.items())
    jpath, tpath = str(d / f"jax_{name}.h5"), str(d / f"torch_{name}.h5")
    JSRInference({"model": dict(model, **mode)}, params=jax.tree_util.tree_map(jnp.asarray, tree)).run_pred(
        dict(INF, truth_path=truth, pred_path=jpath))
    inf = SRInference({"model": dict(model, **mode)}, params=params_from_jax(tree, small_flow_config("DiT")),
                      device="cpu")
    inf.run_pred(dict(INF, truth_path=truth, pred_path=tpath), noise=_jax_noise)
    want, got = _read(jpath), _read(tpath)
    if mode.get("pack_s") == 256:  # the 324-cell events take the bucketed mop-up
        assert max(len(e) for e in want["High_Tree"]["e_proxy"]) > 256
    for t in TREES:
        assert set(got[t]) == set(want[t]), t
        for k in want[t]:
            a, b = got[t][k], want[t][k]
            assert np.array_equal(a.offsets, b.offsets), (t, k)
            if k.startswith(("e_pred", "raw_nn_pred")):
                scale = max(float(np.abs(b.flat).max()), 1e-12)
                assert np.abs(a.flat - b.flat).max() <= 1e-4 * scale, (t, k)
            else:
                assert a.flat.dtype == b.flat.dtype and np.array_equal(a.flat, b.flat), (t, k)


def _write_cli_configs(d, truth, model, tree):
    """A checkpoint of the port's trainer and the two inference YAMLs."""
    fm = small_flow_config("DiT")
    from superresolutionhep_tpu_torch.models.flow_model import FlowModel

    net = FlowModel(fm)
    net.load_reference_state_dict(params_from_jax(tree, fm))
    ck = CheckpointManager(str(d / "checkpoints"))
    ck.save(0, {"params": net.state_dict()}, {"val/loss_raw": 1.0})
    mcfg = dict(model, checkpoint_path=str(d / "checkpoints"), packed=True, pack_s=512, pack_rows=2)
    items = {"model": mcfg, "batch_size": 4, "max_particles": 3,
             "items": [dict(INF, truth_path=truth, run_pred=True), dict(INF, truth_path=truth, run_pred=False)]}
    batch = {"model": mcfg, "batch_size": 4, "inf_dict": dict(INF, truth_path=truth)}
    paths = str(d / "items.yml"), str(d / "batch.yml")
    for p, c in zip(paths, (items, batch)):
        yaml.safe_dump(c, open(p, "w"))
    return paths


def test_cli_items_and_batch_mode(setup):
    """``items`` mode writes ``<stem>_pred.h5`` beside the configs for every
    item with ``run_pred``; batch mode writes the entry range's events under
    ``_{start}_{stop}``, equal in their copied branches to the items run's."""
    d, truth, model, tree = setup
    items_yml, batch_yml = _write_cli_configs(d, truth, model, tree)
    out_dir = os.path.join(os.path.dirname(model["config_path_mv"]), "inference")
    inference_sr.main(["-i", items_yml, "--device", "cpu"])
    full = _read(os.path.join(out_dir, "truth_pred.h5"))
    inference_sr.main(["-i", batch_yml, "-bm", "-estart", "1", "-estop", "4", "--device", "cpu"])
    part = _read(os.path.join(out_dir, "truth_pred_1_4.h5"))
    assert root_io.num_entries(os.path.join(out_dir, "truth_pred_1_4.h5"), "High_Tree") == 3
    for k in ("eta_raw", "e_truth_raw", "e_proxy_raw"):
        for i in range(3):
            assert np.array_equal(part["High_Tree"][k][i], full["High_Tree"][k][i + 1]), k
    assert all(np.isfinite(part["High_Tree"]["e_pred_raw"].flat))
    with pytest.raises(ValueError):
        inference_sr.main(["-i", batch_yml, "--device", "cpu"])  # a batch config without -bm


def test_cuda_refused_without_a_card(setup):
    """``run_pred``'s driver and the CLI default to the card and raise where
    there is none, rather than running on the CPU."""
    d, truth, model, tree = setup
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be shown here")
    with pytest.raises(RuntimeError, match="cuda"):
        SRInference({"model": model}, params=params_from_jax(tree, small_flow_config("DiT")))
    items_yml, _ = _write_cli_configs(d, truth, model, tree)
    with pytest.raises(RuntimeError, match="cuda"):
        inference_sr.main(["-i", items_yml])
