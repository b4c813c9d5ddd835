"""PyTorch port, gradients of flash attention: ``torch.autograd.grad``
through the port's ``masked_flash_attention`` (the ``_FlashAttention``
Function: the plain base-2 forward with LSE and the plain versions of the
K5/K6 backward kernels on the CPU) against ``jax.grad`` through the JAX one
(its custom VJP, Pallas kernels in interpret mode), on the cases of
tests/test_flash_attention.py, fp32 within 2e-4 of each gradient's max."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolutionhep_tpu.ops import flash_attention as jfa
from superresolutionhep_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)
TOL = 2e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _lens_valid(lens, L):
    return np.arange(L)[None, :] < np.asarray(lens)[:, None]


def _dense_jax(q, k, v, q_valid, kv_valid, scale):
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = kv_valid[:, None, None, :]
    p = jnp.where(mask, jax.nn.softmax(jnp.where(mask, s, -1e30), axis=-1), 0.0)
    return jnp.einsum("bhqk,bkhd->bqhd", p, v) * q_valid[:, :, None, None]


LOSSES = {
    "sq": (lambda o: (o**2).sum(), lambda o: (o**2).sum()),
    "sq_cos": (lambda o: (o**2 * jnp.cos(o)).sum(), lambda o: (o**2 * torch.cos(o)).sum()),
}


@pytest.mark.parametrize(
    "case",
    [
        # test_flash_gradients_match_dense
        dict(B=1, Lq=128, Lk=128, H=2, D=32, qlens=[100], klens=[100], mul=1.0, loss="sq", seed=1),
        # test_flash_gradients_multiblock_rectangular (lengths halved: same
        # multi-tile, two-sided padding, rectangular structure)
        dict(B=2, Lq=512, Lk=256, H=2, D=32, qlens=[350, 512], klens=[150, 256], mul=1.0, loss="sq_cos", seed=7),
        # test_flash_gradients_finite_with_saturating_scores
        dict(B=1, Lq=256, Lk=256, H=2, D=64, qlens=[200], klens=[200], mul=30.0, loss="sq", seed=3),
        # test_flash_all_padded_rows_zero: valid queries, no valid key
        dict(B=1, Lq=128, Lk=128, H=2, D=32, qlens=[128], klens=[0], mul=1.0, loss="sq", seed=4),
    ],
    ids=["match_dense", "multiblock_rect", "saturating", "all_keys_padded"],
)
def test_flash_grads_match_jax(case):
    """Autograd through the port's Function against jax.grad through the
    JAX custom VJP (interpret-mode kernels), and both against the dense
    formulation where it is defined."""
    rng = np.random.default_rng(case["seed"])
    B, Lq, Lk, H, D = (case[k] for k in ("B", "Lq", "Lk", "H", "D"))
    q = rng.normal(size=(B, Lq, H, D)).astype(np.float32) * case["mul"]
    k = rng.normal(size=(B, Lk, H, D)).astype(np.float32) * case["mul"]
    v = rng.normal(size=(B, Lk, H, D)).astype(np.float32)
    qv, kv = _lens_valid(case["qlens"], Lq), _lens_valid(case["klens"], Lk)
    scale = 1.0 / np.sqrt(D)
    jloss, tloss = LOSSES[case["loss"]]

    def f_jax(q, k, v):
        return jloss(jfa.masked_flash_attention(q, k, v, jnp.asarray(qv), jnp.asarray(kv), scale))

    want = jax.grad(f_jax, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tfa.masked_flash_attention(tq, tk, tv, _t(qv), _t(kv), scale)
    got = torch.autograd.grad(tloss(out), (tq, tk, tv))
    assert torch.isfinite(out).all()
    for name, a, b in zip("qkv", got, want):
        b = np.asarray(b)
        assert np.isfinite(a.numpy()).all(), f"non-finite d{name}"
        scale_b = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a.numpy(), b, atol=TOL * scale_b, rtol=0, err_msg=f"d{name}")
    # padded keys receive exactly zero gradient
    assert np.all(got[1].numpy()[~kv] == 0.0) and np.all(got[2].numpy()[~kv] == 0.0)
    if case["mul"] == 1.0 and kv.any():
        dense = jax.grad(lambda q, k, v: jloss(_dense_jax(q, k, v, jnp.asarray(qv), jnp.asarray(kv), scale)),
                         argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        for name, a, b in zip("qkv", got, dense):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, atol=TOL * max(np.abs(b).max(), 1e-6), rtol=0,
                                       err_msg=f"d{name} vs dense")
