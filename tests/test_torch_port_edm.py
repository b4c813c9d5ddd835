"""PyTorch port, the EDM / Karras sampler family against the JAX package
(``flow/edm.py``), on the cases of ``tests/test_edm_samplers.py``: the sigma
schedule, each sampler against the JAX one with a perfect denoiser and with a
nonlinear one, and the churn path with the JAX sampler's noise passed in
(the JAX sampler splits its key once a step and draws from the second half).
fp32 on both sides: within 1e-5 of the output's scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolutionhep_tpu.flow import edm as jedm
from superresolutionhep_tpu_torch.flow import edm

torch.set_num_threads(1)
TARGET = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)


def _jdenoise(x, sigma):  # nonlinear in x and in sigma: a slip in either shows
    return jnp.tanh(0.3 * x) * (1.0 / (1.0 + sigma)) + jnp.asarray(TARGET)


def _tdenoise(x, sigma):
    return torch.tanh(0.3 * x) * (1.0 / (1.0 + sigma)) + torch.from_numpy(TARGET)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= tol * max(1.0, np.abs(want).max())


def test_karras_schedule_matches_jax():
    for args in ((18, 0.002, 80.0, 7.0), (1, 0.01, 10.0, 3.0), (24, 0.002, 80.0, 7.0)):
        s = edm.karras_sigmas(*args)
        np.testing.assert_array_equal(s, jedm.karras_sigmas(*args))
    s = edm.karras_sigmas(18, 0.002, 80.0, 7.0)
    assert s[0] == pytest.approx(80.0) and s[-1] == 0.0 and np.all(np.diff(s) < 0)
    np.testing.assert_allclose(edm.lms_coefficients(s, 4), jedm._lms_coefficients(s, 4), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["edm_sampler", "dpm2_sampler", "lms_sampler"])
def test_samplers_match_jax(name):
    """With a perfect denoiser every sampler drives x to the target (the JAX
    test's case) and equals the JAX sampler; with the nonlinear denoiser, the
    whole sequence equals the JAX one."""
    jfn, tfn = getattr(jedm, name), getattr(edm, name)
    x0 = np.ones_like(TARGET)
    got = tfn(lambda x, s: torch.from_numpy(TARGET), torch.from_numpy(x0), num_steps=24)
    want = jfn(lambda x, s: jnp.asarray(TARGET), jnp.asarray(x0), jax.random.PRNGKey(1), num_steps=24)
    np.testing.assert_allclose(got.numpy(), TARGET, atol=5e-2)
    _close(got, want)
    x0 = np.random.default_rng(1).normal(size=TARGET.shape).astype(np.float32)
    got = tfn(_tdenoise, torch.from_numpy(x0), num_steps=10, ret_seq=True)
    want = jfn(_jdenoise, jnp.asarray(x0), jax.random.PRNGKey(2), num_steps=10, ret_seq=True)
    assert got.shape == (10, *TARGET.shape)
    _close(got, want)


def test_edm_churn_with_noise_passed_in():
    """S_churn with S_min/S_max: the JAX sampler's noise draws handed to the
    port give the JAX sequence; a generator gives a finite run that still
    converges to the target."""
    key = jax.random.PRNGKey(0)
    noise = []
    for _ in range(10):
        key, k1 = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k1, TARGET.shape, jnp.float32)))
    kw = dict(num_steps=10, S_churn=10.0, S_min=0.01, S_max=50.0, ret_seq=True)
    x0 = np.ones_like(TARGET)
    want = jedm.edm_sampler(_jdenoise, jnp.asarray(x0), jax.random.PRNGKey(0), **kw)
    got = edm.edm_sampler(_tdenoise, torch.from_numpy(x0), noise=torch.from_numpy(np.stack(noise)), **kw)
    _close(got, want)
    zero = np.zeros((2, 4), np.float32)
    seq = edm.edm_sampler(lambda x, s: torch.zeros(2, 4), torch.ones(2, 4),
                          generator=torch.Generator().manual_seed(0), **kw)
    assert seq.shape == (10, 2, 4) and bool(torch.isfinite(seq).all())
    np.testing.assert_allclose(seq[-1].numpy(), zero, atol=5e-2)
