"""PyTorch port, flash attention backward (kernels K5/K6) and the dopri5
solver against the JAX package on the same numpy inputs (fp32, CPU).

  * the plain PyTorch backward (what the CUDA kernels compute, held against
    them on the card by chip_smoke.py) against the JAX ``_flash_bwd`` run in
    Pallas interpret mode, on the same forward residuals;
  * ``torch.autograd.grad`` through the port's transposed-layout entry
    against ``jax.grad`` through the JAX one (the (B, L, H, D) entry's cases
    of tests/test_flash_attention.py are in test_torch_port_flash_grads.py);
  * ``odeint_dopri5`` against the JAX ``odeint_dopri5``.

Tolerance 2e-4: fp32 on both sides, another summation order in the scores
and the three products of the backward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolutionhep_tpu.flow import ode as jode
from superresolutionhep_tpu.ops import flash_attention as jfa
from superresolutionhep_tpu_torch.flow import ode as tode
from superresolutionhep_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)
TOL = 2e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _lens_valid(lens, L):
    return np.arange(L)[None, :] < np.asarray(lens)[:, None]


@pytest.mark.parametrize("L,D", [(128, 16), (256, 64), (256, 16)])
def test_flash_bwd_matches_jax(L, D):
    """Port ``_flash_bwd`` (g masking, dl, the plain dq and dk/dv kernels,
    the ln 2 scaling) against the JAX one on the JAX forward's residuals.
    Masks: a full row, a row ending inside a tile, a row whose second half of
    keys is padded (a fully padded 64-key tile and, at L=256, a fully padded
    128-key tile), a one-cell row and an empty row."""
    rng = np.random.default_rng(L * 7 + D)
    B, H = 5, 2
    lens = [L, L - 37, L // 2, 1, 0]
    valid = _lens_valid(lens, L)
    qT, kT, vT, gT = (rng.normal(size=(B, H, D, L)).astype(np.float32) for _ in range(4))
    qT *= (1.0 / np.sqrt(D)) * jfa.LOG2E
    m = valid.astype(np.float32)[:, None, :]  # (B, 1, L)
    outT, lse = jfa._flash_fwd(jnp.asarray(qT), jnp.asarray(kT), jnp.asarray(vT), jnp.asarray(m), jnp.asarray(m))
    want = jfa._flash_bwd(jnp.asarray(qT), jnp.asarray(kT), jnp.asarray(vT), jnp.asarray(m), jnp.asarray(m),
                          outT, lse, jnp.asarray(gT))

    def bl(x):  # (B, H, D, L) -> (B, L, H, D)
        return _t(np.asarray(x)).permute(0, 3, 1, 2)

    mf = _t(valid.astype(np.float32))
    got = tfa._flash_bwd(bl(qT), bl(kT), bl(vT), mf, mf, bl(outT), _t(np.asarray(lse))[:, :, 0], bl(gT))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = bl(b).numpy()
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a.numpy(), b, atol=TOL * scale, rtol=0, err_msg=name)
    dq, dk, dv = (t.numpy() for t in got)
    assert np.all(dq[~valid] == 0.0)  # padded queries
    assert np.all(dk[~valid] == 0.0) and np.all(dv[~valid] == 0.0)  # padded keys


def test_flash_grads_transposed_entry_and_nomax():
    """The (B, H, D, L) entry differentiates through the same Function; the
    no-max kernel is inference-only and raises under grad, as in JAX."""
    rng = np.random.default_rng(11)
    B, H, D, L = 2, 2, 16, 128
    qT, kT, vT = (_t(rng.normal(size=(B, H, D, L)).astype(np.float32)).requires_grad_(True) for _ in range(3))
    valid = _t(_lens_valid([128, 70], L))
    outT = tfa.masked_flash_attention_T(qT, kT, vT, valid, valid)
    got = torch.autograd.grad((outT**2).sum(), (qT, kT, vT))
    want = jax.grad(
        lambda q, k, v: (jfa.masked_flash_attention_T(q, k, v, jnp.asarray(valid.numpy()),
                                                      jnp.asarray(valid.numpy())) ** 2).sum(),
        argnums=(0, 1, 2),
    )(*(jnp.asarray(t.detach().numpy()) for t in (qT, kT, vT)))
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=TOL * np.abs(b).max(), rtol=0)
    with pytest.raises(RuntimeError, match="inference-only"):
        tfa.masked_flash_attention_T(qT, kT, vT, valid, valid, softmax="nomax_clip")


@pytest.mark.parametrize("n_steps", [10, 25])
def test_dopri5_matches_jax(n_steps):
    """Adaptive Dormand-Prince with dense output on a stiff-ish nonlinear
    field: the same accepted steps, the same grid values within 1e-4."""
    rng = np.random.default_rng(n_steps)
    y0 = rng.normal(size=(3, 17, 1)).astype(np.float32)
    w = rng.normal(size=(3, 17, 1)).astype(np.float32)

    def fj(t, y):
        return jnp.tanh(4.0 * y) * w - 2.0 * t * y + jnp.sin(6.0 * t)

    def ft(t, y):
        return torch.tanh(4.0 * y) * _t(w) - 2.0 * t * y + torch.sin(6.0 * t)

    want = jode.odeint_dopri5(fj, jnp.asarray(y0), jnp.linspace(0.0, 1.0, n_steps))
    got = tode.odeint(ft, _t(y0), torch.linspace(0.0, 1.0, n_steps), method="dopri5")
    assert got.shape == (n_steps, *y0.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
