"""PyTorch port, samplers and transforms against the JAX package: the AB2
multistep solver with both bootstraps and selective storage, the fixed-step
solvers, the ensemble sampler with injected noise (x0 drawn by
``jax.random.normal`` exactly as the JAX sampler draws it), and the variable
and target transforms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolutionhep_tpu.flow import ode as jode
from superresolutionhep_tpu.flow.sampling import generate_ensemble as jgenerate_ensemble
from superresolutionhep_tpu.models.flow_model import FlowModel as JFlowModel
from superresolutionhep_tpu.transforms import TargetTransform as JTargetTransform
from superresolutionhep_tpu.transforms import build_var_transforms as jbuild_var_transforms
from superresolutionhep_tpu_torch.configs import MULTIPART_CONFIG_MV
from superresolutionhep_tpu_torch.flow import ode as tode
from superresolutionhep_tpu_torch.flow.sampling import generate_ensemble, generate_samples
from superresolutionhep_tpu_torch.models.flow_model import FlowModel
from superresolutionhep_tpu_torch.tools import convert
from superresolutionhep_tpu_torch.transforms import TargetTransform, build_var_transforms

torch.set_num_threads(1)


def _field_np(t, y):
    # nonlinear in y and explicit in t: an order or time-index slip shows
    return np.sin(3.0 * t) - 0.7 * y + 0.1 * y * y


def _jfield(t, y):
    return jnp.sin(3.0 * t) - 0.7 * y + 0.1 * y * y


def _tfield(t, y):
    return torch.sin(3.0 * t) - 0.7 * y + 0.1 * y * y


Y0 = np.random.default_rng(0).normal(size=(2, 5, 1)).astype(np.float32)


@pytest.mark.parametrize("bootstrap", ["heun", "euler"])
@pytest.mark.parametrize("store", [None, (0, 1, 6, 24), (24,), (0, 12), (1,)])
def test_odeint_ab2_matches_jax(bootstrap, store):
    ts = np.linspace(0.0, 1.0, 25).astype(np.float32)
    want = jode.odeint_ab2(_jfield, jnp.asarray(Y0), jnp.asarray(ts), store_idx=store, bootstrap=bootstrap)
    got = tode.odeint_ab2(_tfield, torch.from_numpy(Y0), torch.from_numpy(ts), store_idx=store, bootstrap=bootstrap)
    assert got.shape == (25 if store is None else len(store), *Y0.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_odeint_ab2_counts_evaluations():
    """ab2e spends n_steps - 1 model evaluations, ab2 one more."""
    ts = torch.linspace(0.0, 1.0, 25)
    for bootstrap, n in (("euler", 24), ("heun", 25)):
        calls = []
        tode.odeint_ab2(lambda t, y: calls.append(float(t)) or -y, torch.ones(1), ts, store_idx=(24,), bootstrap=bootstrap)
        assert len(calls) == n


@pytest.mark.parametrize("method", ["euler", "midpoint"])
def test_fixed_step_solvers_match_jax(method):
    ts = np.linspace(0.0, 1.0, 7).astype(np.float32)
    want = jode.odeint_fixed(_jfield, jnp.asarray(Y0), jnp.asarray(ts), method)
    got = tode.odeint(_tfield, torch.from_numpy(Y0), torch.from_numpy(ts), method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    want_s = jode.odeint_fixed_store(_jfield, jnp.asarray(Y0), jnp.asarray(ts), (0, 3, 6), method)
    got_s = tode.odeint_fixed_store(_tfield, torch.from_numpy(Y0), torch.from_numpy(ts), (0, 3, 6), method)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_s.numpy(), got.numpy()[[0, 3, 6]], atol=1e-6, rtol=0)


@pytest.mark.parametrize("method", ["heun", "rk4", "ab3", "dopri5"])
def test_unported_solvers_raise(method):
    """The solvers that once raised here are ported: each integrates as the
    JAX package does (the whole trajectory, and for the fixed-step and
    multistep ones also the stored grid states)."""
    ts = np.linspace(0, 1, 6).astype(np.float32)
    got = tode.odeint(_tfield, torch.from_numpy(Y0), torch.from_numpy(ts), method=method)
    want = jode.odeint(_jfield, jnp.asarray(Y0), jnp.asarray(ts), method=method)
    assert got.shape == (6, *Y0.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    if method == "ab3":
        store = (0, 2, 5)
        got_s = tode.odeint_ab3(_tfield, torch.from_numpy(Y0), torch.from_numpy(ts), store_idx=store)
        want_s = jode.odeint_ab3(_jfield, jnp.asarray(Y0), jnp.asarray(ts), store_idx=store)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5, rtol=0)
        short = np.linspace(0, 1, 2).astype(np.float32)  # fewer than 3 points: the AB2 path
        np.testing.assert_allclose(
            tode.odeint_ab3(_tfield, torch.from_numpy(Y0), torch.from_numpy(short)).numpy(),
            np.asarray(jode.odeint_ab3(_jfield, jnp.asarray(Y0), jnp.asarray(short))), atol=1e-5, rtol=0)
    elif method != "dopri5":
        got_s = tode.odeint_fixed_store(_tfield, torch.from_numpy(Y0), torch.from_numpy(ts), (1, 5), method)
        want_s = jode.odeint_fixed_store(_jfield, jnp.asarray(Y0), jnp.asarray(ts), (1, 5), method)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5, rtol=0)


def _small_flow_config():
    cfg = dict(MULTIPART_CONFIG_MV["flow_model"])
    cfg["h_dim"] = 128
    cfg["feat_0_mlp"] = dict(cfg["feat_0_mlp"], output_size=128)
    cfg["transformer"] = dict(cfg["transformer"], num_transformer_layers=1,
                              dense_config=dict(cfg["transformer"]["dense_config"], hidden_layers=[128]))
    return cfg


def _small_batch(rng, B, N):
    lens = [N, N - 37][:B]
    valid = np.arange(N)[None, :] < np.asarray(lens)[:, None]
    phi = rng.uniform(-3, 3, size=(B, N, 1)).astype(np.float32)
    return {
        "eta": rng.uniform(-1, 1, size=(B, N, 1)).astype(np.float32),
        "cosphi": np.cos(phi), "sinphi": np.sin(phi),
        "layer": rng.integers(0, 3, size=(B, N, 1)).astype(np.int32),
        "e_proxy": rng.normal(size=(B, N, 1)).astype(np.float32),
        "q_mask": valid,
    }


@pytest.mark.parametrize("method,store", [("ab2e", (0, 3)), ("midpoint", (3,))])
def test_generate_ensemble_matches_jax_with_injected_noise(method, store):
    """One DiT layer at h=128, L=128: the JAX side runs flash_nomax + fused
    prologue through the Pallas kernels (interpret mode), the port runs the
    plain versions; x0 is what the JAX sampler draws from its keys."""
    rng = np.random.default_rng(1)
    cfg = _small_flow_config()
    B, N, E, n_steps = 2, 128, 2, 4
    batch = _small_batch(rng, B, N)
    tree = convert.init_params_jax_layout(cfg, seed=5)
    jmodel = JFlowModel(config=cfg, attn_impl="flash_nomax", fused_prologue=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(11)
    want = jgenerate_ensemble(
        lambda v, b, x, t: jmodel.apply(v, b, x, t), {"params": tree}, jb, key,
        n_ensemble=E, n_steps=n_steps, method=method, ret_seq=True, store_indices=store)
    x0 = np.stack([np.asarray(jax.random.normal(k, (B, N, 1), jnp.float32)) for k in jax.random.split(key, E)])

    model = FlowModel(cfg, attn_impl="flash_nomax", fused_prologue=True).eval()
    model.load_reference_state_dict(convert.params_from_jax(tree, cfg))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = generate_ensemble(model, tb, n_ensemble=E, n_steps=n_steps, method=method, ret_seq=True,
                            store_indices=store, x0=torch.from_numpy(x0))
    assert got.shape == (E, len(store), B, N, 1) == want.shape
    valid = np.broadcast_to(batch["q_mask"][None, None, :, :, None], got.shape)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=2e-4, rtol=0)
    # the ensemble is folded into the batch axis member-major: member e alone gives row e
    one = generate_samples(model, tb, n_steps=n_steps, method=method, store_indices=store, x0=torch.from_numpy(x0[1]))
    np.testing.assert_allclose(one.numpy(), got.numpy()[1], atol=1e-5, rtol=0)


def test_sampler_draws_from_generator_and_requires_one():
    tb = {"e_proxy": torch.zeros(2, 4, 1)}
    f = lambda b, x, t: -x  # noqa: E731
    a = generate_ensemble(f, tb, 3, 4, method="ab2e", ret_seq=False, generator=torch.Generator().manual_seed(3))
    b = generate_ensemble(f, tb, 3, 4, method="ab2e", ret_seq=False, generator=torch.Generator().manual_seed(3))
    c = generate_ensemble(f, tb, 3, 4, method="ab2e", ret_seq=False, generator=torch.Generator().manual_seed(4))
    assert a.shape == (3, 2, 4, 1) and torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError):
        generate_samples(f, tb, 4)
    with pytest.raises(ValueError):
        generate_ensemble(f, tb, 3, 4, x0=torch.zeros(2, 2, 4, 1))


def test_target_transform_round_trip_and_matches_jax():
    cfg = MULTIPART_CONFIG_MV["target_transform"]
    tt, jtt = TargetTransform.from_config(cfg), JTargetTransform.from_config(cfg)
    rng = np.random.default_rng(2)
    proxy = rng.uniform(0.01, 50.0, size=200).astype(np.float32)
    truth = (proxy * 1.2 * rng.uniform(0.001, 0.999, size=200)).astype(np.float32)
    fwd = tt.forward(truth, proxy)
    assert np.array_equal(fwd, jtt.forward(truth, proxy))  # numpy in, numpy out: bit for bit
    np.testing.assert_allclose(tt.inverse(fwd, proxy), truth, rtol=2e-4, atol=1e-5)  # exact inverse up to fp32
    assert np.array_equal(tt.inverse(fwd, proxy), jtt.inverse(fwd, proxy))
    # torch tensors take the same math
    np.testing.assert_allclose(tt.inverse(torch.from_numpy(fwd), torch.from_numpy(proxy)).numpy(),
                               tt.inverse(fwd, proxy), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tt.forward(torch.from_numpy(truth), torch.from_numpy(proxy)).numpy(), fwd,
                               rtol=1e-5, atol=1e-5)
    # saturated ratios clip
    assert np.isfinite(tt.forward(np.array([0.0, 100.0], np.float32), np.array([1.0, 1.0], np.float32))).all()


def test_var_transforms_match_jax():
    cfgs = MULTIPART_CONFIG_MV["var_transform"]
    ours, theirs = build_var_transforms(cfgs), jbuild_var_transforms(cfgs)
    assert set(ours) == set(theirs)
    rng = np.random.default_rng(3)
    x = rng.uniform(0.01, 30.0, size=64).astype(np.float32)
    for name in ours:
        a, b = ours[name], theirs[name]
        if name == "e":  # per-event statistics, fitted on the data (ddof=1)
            a, b = a.fit(x), b.fit(x)
            assert float(a.mean) == float(b.mean) and float(a.std) == float(b.std)
        assert np.array_equal(a.forward(x), b.forward(x)), name
        np.testing.assert_allclose(a.inverse(a.forward(x)), x, rtol=1e-4, atol=1e-4)
