"""PyTorch port, the stage-2 particle-flow model (SAPF) against the JAX
package (fp32, CPU): the shipped trained checkpoints' goldens, the
cross-attention DiT layer, the inference-time cardinality gating (with the
fused prologue, which at this width is its unfused equivalent), the random
slots with injected noise, and the parameter converter.

Tolerances: the goldens as ``tests/test_golden_pf.py`` holds the JAX package
(logits 2e-4, kinematics and incidence 2e-3 on valid slots and cells); model
against model on the same weights 1e-5 (fp32 on both sides, another
summation order)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from superresolutionhep_tpu.models.dit import DiTLayer as JDiTLayer
from superresolutionhep_tpu.models.pf.model_pf import SAPF as JSAPF
from superresolutionhep_tpu.tools.torch_export import export_pf_params
from superresolutionhep_tpu.transforms import build_var_transforms as jbuild_var_transforms
from superresolutionhep_tpu_torch.configs import PF_CONFIG_MV, PF_CONFIG_T
from superresolutionhep_tpu_torch.models.dit import DiTLayer
from superresolutionhep_tpu_torch.models.pf import SAPF
from superresolutionhep_tpu_torch.tools import convert
from superresolutionhep_tpu_torch.transforms import build_var_transforms

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE_CFG = {"activation": "LeakyReLU", "dropout": 0.0, "final_activation": None, "hidden_layers": [32],
             "norm_final_layer": False, "norm_layer": "LayerNorm"}


def small_pf_config(slots="embedding"):
    """The published stage-2 configuration cut to h_dim 32, 2 + 2 layers."""
    import copy

    cfg = copy.deepcopy(PF_CONFIG_MV)
    pf = cfg["pf_model"]
    pf["h_dim"] = 32
    pf["cardinality_predictor"]["hidden_layers"] = [32, 16]
    for part in (pf["encoder"], pf["kinematics_predictor"]):
        part["transformer"].update(num_transformer_layers=2, context_size=32)
        part["transformer"]["dense_config"]["hidden_layers"] = [32]
    if slots == "random":
        pf["kinematics_predictor"]["init_particles"] = {"type": "random"}
    return cfg


def make_pf_batch(seed, B=3, N=40, P=4, lens=(40, 23, 9), cards=(4, 2, 1)):
    """A collate_pf-shaped numpy batch with ragged cells and particles."""
    rng = np.random.default_rng(seed)
    cell_mask = np.arange(N)[None, :] < np.asarray(lens)[:, None]
    part_mask = np.arange(P)[None, :] < np.asarray(cards)[:, None]
    e_raw = rng.uniform(1.0, 50.0, size=(B, N)).astype(np.float32) * cell_mask
    eta_raw = rng.uniform(-2.5, 2.5, size=(B, N)).astype(np.float32) * cell_mask
    phi = rng.uniform(-np.pi, np.pi, size=(B, N)).astype(np.float32) * cell_mask
    inc = rng.uniform(size=(B, N, P)).astype(np.float32) * cell_mask[..., None] * part_mask[:, None, :]
    inc = inc / np.maximum(inc.sum(-1, keepdims=True), 1e-6)
    out = {
        "cell_e": np.sqrt(e_raw) / 4 - 0.5, "cell_eta": eta_raw / 2.988, "cell_phi": phi,
        "cell_cosphi": np.cos(phi) * cell_mask, "cell_sinphi": np.sin(phi) * cell_mask,
        "cell_e_raw": e_raw, "cell_eta_raw": eta_raw, "cell_layer": rng.integers(0, 3, size=(B, N)).astype(np.int32),
        "cell_mask": cell_mask, "part_mask": part_mask, "cardinality": np.asarray(cards, np.int32),
        "incidence_matrix": inc,
    }
    for k in ("part_pt", "part_eta", "part_phi", "part_dep_e"):
        out[k] = (rng.normal(size=(B, P)) * part_mask).astype(np.float32)
    return {k: (v.astype(np.float32) if v.dtype == np.float64 else v) for k, v in out.items()}


def make_pf_trees(n, seed, max_part=4):
    """Stage-1 output trees in memory (the branches ``SRInference.predict``
    writes with ``store_energy_incidence``): ``Low_Tree``/``High_Tree`` cells
    with energies in MeV (some under the 1 MeV cut) and the per-particle
    deposits ``e_part_i``, ``Particle_Tree`` with 1-4 particles an event."""
    rng = np.random.default_rng(seed)
    low = {k: [] for k in ["eta_raw", "phi", "layer", "e_meas_raw"] + [f"e_part_{i}" for i in range(max_part)]}
    high = {k: [] for k in ["eta_raw", "phi", "layer", "e_pred_raw"] + [f"e_part_{i}" for i in range(max_part)]}
    part = {k: [] for k in ["particle_pt", "particle_eta", "particle_phi", "particle_e", "particle_pdgid",
                            "particle_dep_e"]}
    for _ in range(n):
        n_part = int(rng.integers(1, max_part + 1))
        for tree, e_key, n_cells in ((low, "e_meas_raw", int(rng.integers(20, 60))),
                                     (high, "e_pred_raw", int(rng.integers(60, 150)))):
            tree["eta_raw"].append(rng.uniform(-2.5, 2.5, n_cells).astype(np.float32))
            tree["phi"].append(rng.uniform(-np.pi, np.pi, n_cells).astype(np.float32))
            tree["layer"].append(rng.integers(0, 3, n_cells).astype(np.float32))
            deposits = rng.exponential(8.0, (n_cells, max_part)).astype(np.float32)
            deposits[:, n_part:] = 0.0
            tree[e_key].append(deposits.sum(1) * rng.uniform(0.05, 1.2, n_cells).astype(np.float32))
            for i in range(max_part):
                tree[f"e_part_{i}"].append(deposits[:, i])
        e = rng.uniform(2.0, 100.0, n_part).astype(np.float32)
        eta = rng.uniform(-2.0, 2.0, n_part).astype(np.float32)
        part["particle_pt"].append(e / np.cosh(eta))
        part["particle_eta"].append(eta)
        part["particle_phi"].append(rng.uniform(-np.pi, np.pi, n_part).astype(np.float32))
        part["particle_e"].append(e)
        part["particle_pdgid"].append(rng.choice([22.0, 11.0, -11.0], n_part).astype(np.float32))
        part["particle_dep_e"].append(e * rng.uniform(0.5, 1.0, n_part).astype(np.float32))
    return {"Low_Tree": low, "High_Tree": high, "Particle_Tree": part}


def randomize(params, seed):
    """Every leaf plus seeded noise: the zero-init adaLN would gate the
    attention off, unit LayerNorm scales would hide a swapped shift/scale."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)).astype(np.float32),
                                  params)


def jax_sapf(cfg, batch, seed=0, **kw):
    """The JAX SAPF and its randomized parameters (one jitted init)."""
    model = JSAPF(config_pf=cfg["pf_model"], transforms=jbuild_var_transforms(cfg["var_transform"]),
                  attn_impl="xla", **kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed), jb, rng=jax.random.PRNGKey(1))
    return model, randomize(variables["params"], seed + 7)


def torch_sapf(cfg, params, **kw):
    m = SAPF(cfg["pf_model"], build_var_transforms(cfg["var_transform"]), **kw)
    missing = m.load_reference_state_dict(convert.pf_params_from_jax(params, cfg["pf_model"]))
    assert not missing.missing_keys and not missing.unexpected_keys
    return m.eval()


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max err {err:.3g} > {tol}"


@pytest.mark.parametrize("tag", ["pf_lr", "pf_hr"])
def test_sapf_matches_trained_golden(tag):
    z = np.load(os.path.join(ROOT, "tests", "golden", f"{tag}_golden.npz"))
    cfg = yaml.safe_load(bytes(z["config_mv"]).decode())
    batch = {k.split("::", 1)[1]: torch.from_numpy(z[k]) for k in z.files if k.startswith("batch::")}
    params = convert.unflatten({k.split("::", 1)[1]: z[k] for k in z.files if k.startswith("param::")})
    with torch.no_grad():
        logits, kin, inc = torch_sapf(cfg, params)(batch)
    pm, cm = z["batch::part_mask"], z["batch::cell_mask"]
    np.testing.assert_allclose(logits.numpy(), z["logits"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(kin.numpy()[pm], z["kin"][pm], rtol=2e-3, atol=2e-3)
    for b in range(inc.shape[0]):
        np.testing.assert_allclose(inc.numpy()[b][pm[b]][:, cm[b]], z["inc"][b][pm[b]][:, cm[b]], rtol=2e-3,
                                   atol=2e-3)


def test_cross_attention_dit_layer_matches_jax():
    """Particle queries (B, 4, F) over cell keys (B, N, F): the modulation on
    the keys, the query and key masks."""
    rng = np.random.default_rng(3)
    B, P, N, F, Hh = 2, 4, 40, 32, 4
    q = rng.normal(size=(B, P, F)).astype(np.float32)
    k = rng.normal(size=(B, N, F)).astype(np.float32)
    ctx = rng.normal(size=(B, F)).astype(np.float32)
    q_valid = np.arange(P)[None] < np.array([[3], [1]])
    kv_valid = np.arange(N)[None] < np.array([[40], [17]])
    jm = JDiTLayer(embed_dim=F, num_heads=Hh, dense_config=DENSE_CFG, attn_impl="xla")
    args = (jnp.asarray(q),)
    kw = dict(q_valid=jnp.asarray(q_valid), k=jnp.asarray(k), kv_valid=jnp.asarray(kv_valid), context=jnp.asarray(ctx))
    params = randomize(jm.init(jax.random.PRNGKey(0), *args, **kw)["params"], 4)
    want = np.asarray(jm.apply({"params": params}, *args, **kw))
    sd = {}
    convert._fill(sd, {"layers_0": params}, convert._dit_stack_pairs((), "x", dict(DENSE_CFG), 1)[:-4])
    sd = {k[len("x.layers.0."):]: v for k, v in sd.items()}
    tm = DiTLayer(F, Hh, F, dense_config=DENSE_CFG)
    missing = tm.load_state_dict(sd, strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    with torch.no_grad():
        got = tm(torch.from_numpy(q), q_valid=torch.from_numpy(q_valid), k=torch.from_numpy(k),
                 kv_valid=torch.from_numpy(kv_valid), context=torch.from_numpy(ctx))
    _close(got.numpy(), want, 1e-5, "cross-attention DiT layer")


def test_inference_gating_and_fused_prologue_match_jax():
    """inference=True: the particle mask is arange(4) < argmax(logits), on
    both sides; the fused prologue (PFInference's default) is the same
    function at this width (h 32: fused_qkv_ok fails, the unfused equivalent
    runs)."""
    cfg = small_pf_config()
    batch = make_pf_batch(11)
    jm, params = jax_sapf(cfg, batch)
    jinf = JSAPF(config_pf=cfg["pf_model"], transforms=jbuild_var_transforms(cfg["var_transform"]), inference=True,
                 attn_impl="xla")
    want = jinf.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
    for fused in (False, True):
        with torch.no_grad():
            got = torch_sapf(cfg, params, inference=True, fused_prologue=fused)(_tb(batch))
        n_pred = np.asarray(jnp.argmax(want[0], -1))
        assert np.array_equal(torch.argmax(got[0], -1).numpy(), n_pred)
        _close(got[0], want[0], 1e-5, "logits")
        pm = np.arange(4)[None] < n_pred[:, None]
        _close(got[1].numpy()[pm], np.asarray(want[1])[pm], 1e-5, "kinematics")
        _close(got[2].numpy(), np.asarray(want[2]), 1e-5, "incidence")
        assert np.array_equal(got[2].numpy().sum(1) > 0, pm.any(1)[:, None] & batch["cell_mask"])


def test_random_slots_with_injected_noise_match_jax():
    """init_particles.type: random: mu + exp(logsigma) * noise, the noise
    drawn by jax.random from the model's rng and handed to the port."""
    cfg = small_pf_config("random")
    batch = make_pf_batch(12)
    jm, params = jax_sapf(cfg, batch)
    key = jax.random.PRNGKey(5)
    want = jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()}, rng=key)
    noise = np.array(jax.random.normal(key, (3, 4, 32), jnp.float32))
    with torch.no_grad():
        got = torch_sapf(cfg, params)(_tb(batch), noise=torch.from_numpy(noise))
    _close(got[0], want[0], 1e-5, "logits")
    _close(got[1], want[1], 1e-5, "kinematics")


def test_pf_converter_equals_export_pf_params():
    """pf_params_from_jax = export_pf_params key for key and value for value
    (the reference checkpoint layout, strict); pf_params_to_jax inverts it;
    init_pf_params_jax_layout has the JAX model's tree; the config literals
    are the shipped YAML files."""
    assert PF_CONFIG_MV == yaml.safe_load(open(os.path.join(ROOT, "configs", "pflow", "model_and_var.yml")))
    assert PF_CONFIG_T == yaml.safe_load(open(os.path.join(ROOT, "configs", "pflow", "train.yml")))
    for slots in ("embedding", "random"):
        cfg = small_pf_config(slots)
        _, params = jax_sapf(cfg, make_pf_batch(13))
        ours = convert.pf_params_from_jax(params, cfg["pf_model"])
        ref = export_pf_params(params, cfg["pf_model"])
        assert sorted(ours) == sorted(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(ours[k].numpy(), v)
        back = convert.pf_params_to_jax(ours, cfg["pf_model"])
        jax.tree_util.tree_map(np.testing.assert_array_equal, back, jax.tree_util.tree_map(np.asarray, params))
        mine = convert.init_pf_params_jax_layout(cfg["pf_model"], seed=0)
        assert (jax.tree_util.tree_map(np.shape, mine) == jax.tree_util.tree_map(np.shape, params))
