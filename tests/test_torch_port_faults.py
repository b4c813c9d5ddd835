"""PyTorch port, repaired faults against the JAX package (fp32, CPU):

  * dopri5 over a folded ensemble: each member keeps its own step-size
    control, as the JAX package's vmap gives (within 1e-6: the members'
    solver arithmetic is the same, only the model evaluations are batched);
  * the kernels' capacity gates: every shape that the model's combined gate
    (the JAX package's rule and the kernel's capacity) admits passes its
    wrapper's argument checks, and a DiT layer whose shapes fail a capacity
    gate (head dim 8; fp32 at F = 640) takes the unfused formulation and
    matches the JAX layer (5e-5, the DiT-layer bound of
    ``test_torch_port_modules.py``);
  * the training CLIs take the reference's ``-d`` and ``-ekey`` flags.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolutionhep_tpu.flow import sampling as jsamp
from superresolutionhep_tpu.models.dit import DiTLayer as JDiTLayer
from superresolutionhep_tpu_torch.cli.common import add_train_args
from superresolutionhep_tpu_torch.flow import sampling as tsamp
from superresolutionhep_tpu_torch.models.dit import DiTLayer
from superresolutionhep_tpu_torch.ops import flash_attention as tfa
from superresolutionhep_tpu_torch.ops import fused_mlp as tfm
from superresolutionhep_tpu_torch.ops import fused_qkv as tfq
from superresolutionhep_tpu_torch.ops import kernels
from superresolutionhep_tpu_torch.tools import convert

torch.set_num_threads(1)
LAYER_TOL = 5e-5


def test_dopri5_ensemble_matches_jax():
    """E = 4 members, B = 2, N = 16, n_steps 10, x0 from jax.random.normal:
    a field whose stiffness depends on the state, so that the members need
    different steps.  Folded with one error norm (the fault) the ensemble
    missed JAX by 4e-4."""
    E, B, N, n_steps = 4, 2, 16, 10
    rng = np.random.default_rng(10)
    w = rng.normal(size=(B, N, 1)).astype(np.float32)
    e_proxy = np.zeros((B, N, 1), np.float32)

    def fj(variables, batch, x, t):
        return jnp.tanh(4.0 * x) * w - 2.0 * t[:, None, None] * x + jnp.sin(6.0 * t)[:, None, None]

    def ft(batch, x, t):
        wt = torch.from_numpy(np.tile(w, (x.shape[0] // B, 1, 1)))
        return torch.tanh(4.0 * x) * wt - 2.0 * t[:, None, None] * x + torch.sin(6.0 * t)[:, None, None]

    key = jax.random.PRNGKey(3)
    want = jsamp.generate_ensemble(fj, None, {"e_proxy": jnp.asarray(e_proxy)}, key, E, n_steps, method="dopri5",
                                   ret_seq=True)
    x0 = np.stack([np.asarray(jax.random.normal(k, (B, N, 1), jnp.float32)) for k in jax.random.split(key, E)])
    got = tsamp.generate_ensemble(ft, {"e_proxy": torch.from_numpy(e_proxy)}, E, n_steps, method="dopri5",
                                  ret_seq=True, x0=torch.from_numpy(x0))
    assert got.shape == (E, n_steps, B, N, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


class _Launched(Exception):
    """Raised in place of loading the kernel library: the wrapper's checks passed."""


def test_combined_gates_admit_only_what_the_wrappers_take(monkeypatch):
    """Pure Python: for every shape the model's combined gate admits, the
    wrapper's own argument checks pass (the launch is replaced by a sentinel),
    and the shapes the kernels are not built for are refused by the gate."""

    def no_library():
        raise _Launched

    monkeypatch.setattr(kernels, "library", no_library)
    B, L = 1, 128
    for d in range(8, 136, 8):
        admitted = tfa.flash_shapes_ok(L, L, d) and tfa.flash_kernel_ok(d)
        assert admitted == (d in (16, 32, 64))
        if admitted:
            for dt in (torch.bfloat16, torch.float32):
                q = torch.zeros(B, L, 2, d, dtype=dt)
                m = torch.ones(B, L)
                tfa._cuda_operands(q, q, q, m, m)
    for dt in (torch.bfloat16, torch.float32):
        for F in range(128, 1152, 128):
            if tfq.fused_qkv_ok(L, F) and tfq.fused_qkv_capacity_ok(F, dt):
                x = torch.zeros(B, L, F, dtype=dt)
                w = torch.zeros(F, 3 * F, dtype=dt)
                a = torch.ones(B, F)
                with pytest.raises(_Launched):
                    tfq._cuda_ln_mod_proj(x, a, a, w, torch.zeros(3 * F))
            for Fh in range(128, 1152, 128):
                if tfm.fused_mlp_ok(L, F, Fh) and tfm.fused_mlp_capacity_ok(F, Fh, dt):
                    q = torch.zeros(B, L, F, dtype=dt)
                    r = torch.ones(B, F)
                    with pytest.raises(_Launched):
                        tfm._cuda_dit_mlp(q, q, r, r, r, r, torch.zeros(F, Fh, dtype=dt), torch.zeros(Fh),
                                          torch.zeros(Fh, F, dtype=dt), torch.zeros(F))
    # what the kernels are not built for (the JAX gate alone admits these)
    assert tfq.fused_qkv_ok(L, 640) and not tfq.fused_qkv_capacity_ok(640, torch.float32)
    assert tfm.fused_mlp_ok(L, 512, 256) and not tfm.fused_mlp_capacity_ok(512, 256, torch.float32)
    assert tfq.fused_qkv_capacity_ok(256, torch.bfloat16) and not tfq.fused_qkv_capacity_ok(384, torch.bfloat16)
    assert tfm.fused_mlp_capacity_ok(256, 256, torch.bfloat16) and not tfm.fused_mlp_capacity_ok(256, 512, torch.bfloat16)
    # a shape the kernel does not take raises in the wrapper, before any launch
    with pytest.raises(ValueError, match="capacity"):
        tfq._cuda_ln_mod_proj(torch.zeros(B, L, 640), torch.ones(B, 640), torch.ones(B, 640),
                              torch.zeros(640, 1920), torch.zeros(1920))


def _dit_layer_sd(p, dense_cfg):
    out = {}
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        convert._linear(out, p["mha"][name], f"mha.{name}")
    convert._dense(out, p["dense"], "dense", dense_cfg)
    convert._layernorm(out, p["norm1"], "norm1")
    convert._layernorm(out, p["norm2"], "norm2")
    convert._linear(out, p["adaLN_modulation"], "adaLN_modulation.1")
    return out


@pytest.mark.parametrize("F,H,Fh", [(128, 16, 128), (640, 10, 640)], ids=["head_dim_8", "fp32_F640"])
def test_dit_layer_past_capacity_takes_the_unfused_path(F, H, Fh):
    """Fused prologue and flash attention asked for, at shapes the JAX gates
    admit but the kernels do not take: the port computes the unfused
    formulation (on the card it would otherwise raise) and matches the JAX
    layer, which runs its fused Pallas kernels in interpret mode."""
    dense_cfg = {"activation": "LeakyReLU", "dropout": 0.0, "final_activation": "LeakyReLU", "hidden_layers": [Fh],
                 "norm_final_layer": False, "norm_layer": "LayerNorm"}
    rng = np.random.default_rng(F)
    B, L, C = 2, 128, 16
    x = (0.5 * rng.normal(size=(B, L, F))).astype(np.float32)
    ctx = rng.normal(size=(B, C)).astype(np.float32)
    valid = np.arange(L)[None, :] < np.array([L, 77])[:, None]
    jm = JDiTLayer(embed_dim=F, num_heads=H, dense_config=dense_cfg, attn_impl="flash", fused_prologue=True)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), q_valid=jnp.asarray(valid), context=jnp.asarray(ctx))
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params["params"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), q_valid=jnp.asarray(valid),
                               context=jnp.asarray(ctx)))
    tm = DiTLayer(F, H, C, dense_cfg, attn_impl="flash", fused_prologue=True)
    tm.load_state_dict(_dit_layer_sd(params, dense_cfg), strict=True)
    HD = F // H
    assert not (tfa.flash_kernel_ok(HD) and tfq.fused_qkv_capacity_ok(F, torch.float32)
                and tfm.fused_mlp_capacity_ok(F, Fh, torch.float32))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), q_valid=torch.from_numpy(valid), context=torch.from_numpy(ctx)).numpy()
    np.testing.assert_allclose(got[valid], want[valid], atol=LAYER_TOL, rtol=0)


def test_train_cli_accepts_reference_flags():
    """``-d/--debug_mode`` and ``-ekey/--exp_key`` (JAX cli/common.py:13-14)."""
    args = add_train_args(argparse.ArgumentParser()).parse_args(["-cmv", "a", "-ct", "b", "-d", "-ekey", "x"])
    assert (args.config_mv, args.config_t, args.debug_mode, args.exp_key) == ("a", "b", True, "x")
    args = add_train_args(argparse.ArgumentParser()).parse_args(["--config_mv", "a", "--config_t", "b"])
    assert (args.debug_mode, args.exp_key) == (False, None)
