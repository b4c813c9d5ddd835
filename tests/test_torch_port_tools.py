"""PyTorch port, the small tools against the JAX package (CPU): the jet
substructure observables (``analysis/substructure.py``, a numpy copy: equal
bit for bit), the Lightning checkpoint reader and writer
(``tools/lightning.py``) both ways, and the tensor-parallel roles of the
stage-2 model's parameters (``parallel/tp.py::tp_role``) against the JAX
package's ``_tp_role``, leaf for leaf.  Model outputs on the same weights
are held to the JAX package's SP/TP tolerances (logits rtol 2e-5 / atol
2e-6, kinematics 2e-4 / 2e-5, incidence 2e-5 / 2e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolutionhep_tpu.analysis import substructure as jsub
from superresolutionhep_tpu.models.pf.model_pf import SAPF as JSAPF
from superresolutionhep_tpu.parallel.tp import _tp_role
from superresolutionhep_tpu.tools.torch_convert import convert_pf_state_dict
from superresolutionhep_tpu.tools.torch_convert import load_lightning_checkpoint as jload_lightning_checkpoint
from superresolutionhep_tpu.tools.torch_export import export_pf_params
from superresolutionhep_tpu.tools.torch_export import save_lightning_checkpoint as jsave_lightning_checkpoint
from superresolutionhep_tpu.transforms import build_var_transforms as jbuild_var_transforms
from superresolutionhep_tpu_torch.analysis import substructure
from superresolutionhep_tpu_torch.models.pf import SAPF
from superresolutionhep_tpu_torch.parallel.tp import tp_role
from superresolutionhep_tpu_torch.tools.convert import pf_key_pairs
from superresolutionhep_tpu_torch.tools.lightning import load_lightning_checkpoint, save_lightning_checkpoint
from superresolutionhep_tpu_torch.transforms import build_var_transforms

from test_pf_pipeline import pf_config_mv
from test_torch_port_parallel_pf import pf_sp_batch

torch.set_num_threads(1)

JAX_ROLE = {"col_kernel": "col_weight", "col_bias": "col_bias", "row_kernel": "row_weight", "row_bias": "row_bias",
            None: None}
HPARAMS = {"config_mv": {"pf_model": {"h_dim": 32}}, "lr": 1e-3}


@pytest.fixture(scope="module")
def jax_pf():
    """The JAX SAPF on ``pf_config_mv`` (seeded init), its outputs on a batch."""
    cfg = pf_config_mv()
    batch = pf_sp_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JSAPF(config_pf=cfg["pf_model"], transforms=jbuild_var_transforms(cfg["var_transform"]), attn_impl="xla")
    variables = jax.jit(model.init)(jax.random.PRNGKey(1), jb)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    apply = jax.jit(model.apply)
    return dict(cfg=cfg, batch=batch, params=params, apply=lambda p: [np.asarray(x) for x in apply({"params": p}, jb)])


def port_outputs(cfg, batch, state_dict):
    model = SAPF(cfg["pf_model"], transforms=build_var_transforms(cfg["var_transform"]))
    model.load_reference_state_dict(state_dict, strict=True)
    with torch.no_grad():
        out = model.eval()({k: torch.from_numpy(v) for k, v in batch.items()})
    return model, [x.numpy() for x in out]


def assert_outputs(got, ref):
    for g, want, rtol, atol in zip(got, ref, (2e-5, 2e-4, 2e-5), (2e-6, 2e-5, 2e-6)):
        np.testing.assert_allclose(g, want, rtol=rtol, atol=atol)


def test_substructure_matches_jax():
    """ECFs, C2/D2/C3 and the batch function on seeded constituent sets of
    1 to 60 (one above a cap of 40, truncated to the leading pT) against the
    JAX package's module: bit for bit."""
    rng = np.random.default_rng(17)
    sets = [(rng.uniform(0.5, 80.0, n), rng.uniform(-2.5, 2.5, n), rng.uniform(-np.pi, np.pi, n))
            for n in (1, 2, 3, 4, 9, 31, 60)]
    for pt, eta, phi in sets:
        for beta, cap in ((1.0, 40), (2.0, None)):
            assert substructure.ecfs(pt, eta, phi, beta, cap) == jsub.ecfs(pt, eta, phi, beta, cap)
            assert substructure.c2_d2_c3(pt, eta, phi, beta, max_constituents=cap) == \
                jsub.c2_d2_c3(pt, eta, phi, beta, max_constituents=cap)
    e, eta, phi = ([s[i] * (np.cosh(s[1]) if i == 0 else 1) for s in sets] for i in range(3))
    for got, want in zip(substructure.calc_substructure(e, eta, phi, max_constituents=40),
                         jsub.calc_substructure(e, eta, phi, max_constituents=40)):
        np.testing.assert_array_equal(got, want)
    assert np.isfinite(substructure.calc_substructure(e, eta, phi)[0]).all()


def test_jax_written_checkpoint_loads_strict(jax_pf, tmp_path):
    """A checkpoint written by the JAX package (``export_pf_params`` ->
    ``save_lightning_checkpoint``) loads into the port's SAPF with
    ``strict=True`` and gives the JAX model's outputs."""
    path = jsave_lightning_checkpoint(export_pf_params(jax_pf["params"], jax_pf["cfg"]["pf_model"]),
                                      str(tmp_path / "jax.ckpt"), hyper_parameters=HPARAMS, epoch=3, global_step=7)
    sd, hp = load_lightning_checkpoint(path)
    assert hp == HPARAMS and all(k.startswith("net.") for k in sd)
    _, out = port_outputs(jax_pf["cfg"], jax_pf["batch"], sd)
    assert_outputs(out, jax_pf["apply"](jax_pf["params"]))


def test_port_written_checkpoint_round_trips_through_jax(jax_pf, tmp_path):
    """The port's writer writes the JAX writer's dict (the same keys, tensors
    and fields) from a port model's own ``state_dict``, and the JAX reader
    and converter turn it into parameters whose outputs are the port's."""
    cfg, batch = jax_pf["cfg"], jax_pf["batch"]
    jpath = jsave_lightning_checkpoint(export_pf_params(jax_pf["params"], cfg["pf_model"]),
                                       str(tmp_path / "jax.ckpt"), hyper_parameters=HPARAMS, epoch=3, global_step=7)
    model, out = port_outputs(cfg, batch, load_lightning_checkpoint(jpath)[0])
    path = save_lightning_checkpoint(model.state_dict(), str(tmp_path / "port.ckpt"), hyper_parameters=HPARAMS,
                                     epoch=3, global_step=7)
    mine, theirs = (torch.load(p, weights_only=True) for p in (path, jpath))
    assert {k: v for k, v in mine.items() if k != "state_dict"} == {k: v for k, v in theirs.items()
                                                                     if k != "state_dict"}
    assert set(mine["state_dict"]) == set(theirs["state_dict"])
    for k, v in theirs["state_dict"].items():
        assert torch.equal(mine["state_dict"][k], v), k
    sd, hp = jload_lightning_checkpoint(path)
    assert hp == HPARAMS
    assert_outputs(jax_pf["apply"](convert_pf_state_dict(sd, cfg["pf_model"])), out)


def test_pf_tp_roles_match_jax(jax_pf):
    """Every SAPF leaf's role on the port's name equals the JAX package's on
    its path: both DiT stacks' Q/K/V and first MLP product column-parallel,
    attention output and second MLP product row-parallel, the kinematic
    head, cardinality MLP, embedders and adaLN rows replicated."""
    cfg, params = jax_pf["cfg"]["pf_model"], jax_pf["params"]

    def leaf_of(tree, path):
        for p in path:
            tree = tree.get(p) if isinstance(tree, dict) else None
        return tree

    pairs = [p for p in pf_key_pairs(cfg, params) if leaf_of(params, p[0]) is not None]
    assert len(pairs) == len(jax.tree_util.tree_leaves(params))
    counts = {}
    for jpath, key, _ in pairs:
        role = tp_role(key, cfg)
        assert role == JAX_ROLE[_tp_role(jpath)], key
        assert tp_role(f"net.{key}", cfg) == role
        counts[role] = counts.get(role, 0) + 1
    # (2 encoder + 2 kinematics layers) x (Q, K, V, the MLP's first) column pairs, x (out, the MLP's second) row pairs
    assert counts["col_weight"] == counts["col_bias"] == 16 and counts["row_weight"] == counts["row_bias"] == 8
