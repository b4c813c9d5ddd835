"""PyTorch port, tensor parallelism against the JAX package (CPU).

Ranks over gloo, two spawns for the whole file, three meshes
(``_torch_parallel_ranks.TP_MESHES``): (data 2, model 2) and (data 1, seq 2,
model 2) on four ranks, (data 1, model 2) on two.  The port's parameter
roles and sharded view on the converted names against the JAX package's
``_tp_role`` and ``tp_param_view``, leaf for leaf; Megatron's f and g by
their gradients at two ranks; the TP forward and the TP train step's loss
and gradients against single-device JAX (``FlowModel.apply``,
``value_and_grad`` on the JAX TP step's own draws, injected), on the three
meshes.  Tolerances are the JAX package's own
(tests/test_tensor_parallel.py): forward rtol 2e-5 and atol 2e-6, loss rtol
1e-5, gradients rtol 2e-4 (absolute floor: ``assert_grads_close``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolutionhep_tpu.parallel.tp import _tp_role, tp_param_view as jtp_param_view
from superresolutionhep_tpu_torch.parallel.launch import run_ranks
from superresolutionhep_tpu_torch.parallel.tp import tp_param_view, tp_role
from superresolutionhep_tpu_torch.tools.convert import flow_key_pairs

from _torch_parallel_ranks import TP_MESHES, tp_rank
from test_flow_model import small_flow_config
from test_torch_port_parallel_sp import (
    RANK_TIMEOUT_S,
    assemble,
    assert_grads_close,
    flow_inputs,
    jax_init,
    jax_loss_and_grads,
    jax_streams,
    one_layer,
    port_params,
)

torch.set_num_threads(1)

JAX_ROLE = {"col_kernel": "col_weight", "col_bias": "col_bias", "row_kernel": "row_weight", "row_bias": "row_bias",
            None: None}


@pytest.fixture(scope="module")
def setup():
    cfg = small_flow_config("DiT")
    cfg1 = one_layer(cfg)
    batch, noisy, t = flow_inputs()
    model, params, model1, params1 = jax_init(cfg, batch, noisy, t)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = np.asarray(jax.jit(model.apply)({"params": params}, jb, jnp.asarray(noisy), jnp.asarray(t)))
    grads_fn = jax_loss_and_grads(model1, cfg1)
    # the JAX TP step's draws: t and x0 per data shard, no fold over model;
    # with a seq axis (no JAX step has both) the SP step's, x0 per cell shard
    steps = {}
    for name, n_data, n_seq in (("dp2_tp2", 2, None), ("dp1_tp2", 1, None), ("dp1_sp2_tp2", 1, 2)):
        t_step, x0 = jax_streams(batch["target"], jax.random.PRNGKey(3), n_data, n_seq)
        steps[name] = (t_step, x0, *grads_fn(params1, batch, t_step, x0))
    return dict(cfg=cfg, cfg1=cfg1, batch=batch, noisy=noisy, t=t, ref=ref, jparams=params,
                params=port_params(params, cfg), params1=port_params(params1, cfg1), steps=steps)


@pytest.fixture(scope="module")
def ranks(setup):
    """One run of four ranks (dp2_tp2, dp1_sp2_tp2) and one of two (dp1_tp2)."""
    s = setup
    inputs = dict(s["batch"], noisy=s["noisy"], t=s["t"])
    for name, (t_step, x0, _, _) in s["steps"].items():
        inputs[f"t_step_{name}"], inputs[f"x0_{name}"] = t_step, x0
    out = {}
    for world_size in (4, 2):
        results = run_ranks(tp_rank, world_size, (s["cfg"], s["params"], s["cfg1"], s["params1"], inputs),
                            device="cpu", timeout_s=RANK_TIMEOUT_S)
        for name, (_, n) in TP_MESHES.items():
            if n == world_size:
                out[name] = [r[name] for r in results]
    return out


def test_tp_roles_and_view_match_jax(setup):
    """Every leaf's role on the port's name equals the JAX package's on its
    path, and the port's view of each rank equals the JAX view's block of
    that rank (a Flax kernel is the transpose of a torch weight)."""
    cfg, jparams = setup["cfg"], setup["jparams"]
    n = 2
    jview = jtp_param_view(jparams, n)
    def leaf_of(tree, path):
        for p in path:
            tree = tree.get(p) if isinstance(tree, dict) else None
        return tree

    pairs = [p for p in flow_key_pairs(cfg) if leaf_of(jparams, p[0]) is not None]  # leaves the model has
    counts = {}
    for jpath, key, _ in pairs:
        role = tp_role(key, cfg)
        assert role == JAX_ROLE[_tp_role(jpath)], key
        counts[role] = counts.get(role, 0) + 1
    # 2 DiT layers x (linear_q/k/v + the MLP's first) column pairs, x (linear_out + the MLP's second) row pairs
    assert counts["col_weight"] == counts["col_bias"] == 8 and counts["row_weight"] == counts["row_bias"] == 4
    full = setup["params"]
    for i in range(n):
        view = tp_param_view({k: torch.from_numpy(v) for k, v in full.items()}, cfg, n, i)
        for jpath, key, transposed in pairs:
            leaf = np.asarray(leaf_of(jview, jpath))
            role = tp_role(key, cfg)
            if role == "col_weight":
                leaf = np.split(leaf, n, axis=1)[i]
            elif role == "col_bias":
                leaf = np.split(leaf, n, axis=0)[i]
            elif role == "row_weight":
                leaf = np.split(leaf, n, axis=0)[i]
            np.testing.assert_array_equal(view[key].numpy(), leaf.T if transposed else leaf, err_msg=key)


def test_f_and_g_gradients(ranks):
    """f: identity forward, the cotangents of the two ranks summed backward
    (a = 2 and 3: 5 on every element); g: the two ranks' products summed
    forward (5 x), the cotangent passed through (a_rank x (1, 2, 3))."""
    for r in ranks["dp1_tp2"]:
        fg = r["f_g"]
        a = 2.0 + r["coords"]["model"]
        np.testing.assert_array_equal(fg["f_grad"], np.full(3, 5.0, np.float32))
        np.testing.assert_array_equal(fg["g_value"], 5.0 * np.arange(1.0, 4.0, dtype=np.float32))
        np.testing.assert_array_equal(fg["g_grad"], a * np.arange(1.0, 4.0, dtype=np.float32))


@pytest.mark.parametrize("name", ["dp2_tp2", "dp1_tp2", "dp1_sp2_tp2"])
def test_tp_forward_and_train_step_match_jax(setup, ranks, name):
    """dp x tp, and dp x seq x tp (the sequence gather over head-local K/V
    under the tensor sums; gradients summed over data and seq)."""
    shape = TP_MESHES[name][0]
    out = assemble(ranks[name], "fwd", shape, setup["ref"])
    np.testing.assert_allclose(out, setup["ref"], rtol=2e-5, atol=2e-6)
    _, _, ref_loss, ref_grads = setup["steps"][name]
    for r in ranks[name]:
        np.testing.assert_allclose(float(r["loss"]), ref_loss, rtol=1e-5)
        assert_grads_close(r["grads"], ref_grads)
