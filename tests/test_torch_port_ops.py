"""PyTorch port, kernel modules: the plain PyTorch versions that stand beside
the CUDA kernels (and that the wrappers take for CPU tensors) against the JAX
package's Pallas kernels run in interpret mode, on the same numpy inputs, in
fp32.  Tolerance 2e-5 absolute: same arithmetic, another summation order.
The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolutionhep_tpu.ops import flash_attention as jfa
from superresolutionhep_tpu.ops import fused_mlp as jfm
from superresolutionhep_tpu.ops import fused_qkv as jfq
from superresolutionhep_tpu_torch.ops import flash_attention as tfa
from superresolutionhep_tpu_torch.ops import fused_mlp as tfm
from superresolutionhep_tpu_torch.ops import fused_qkv as tfq
from superresolutionhep_tpu_torch.ops import masked as tmasked
from superresolutionhep_tpu.ops import masked as jmasked

torch.set_num_threads(1)
ATOL = 2e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _valid(rng, B, L):
    lens = rng.integers(1, L + 1, size=B)
    lens[0] = L  # one full row
    if B > 2:
        lens[-1] = 0  # one empty (filler) row
    return np.arange(L)[None, :] < lens[:, None]


def _qkv(rng, B, L, H, D):
    return tuple(rng.normal(size=(B, L, H, D)).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("softmax", ["max", "nomax_clip"])
@pytest.mark.parametrize("L,D", [(128, 16), (256, 64)])
def test_flash_attention_matches_jax_kernel(softmax, L, D):
    """K1 (running max) and K2 (no max), (B, L, H, D) entry."""
    rng = np.random.default_rng(L + D)
    B, H = 3, 2
    q, k, v = _qkv(rng, B, L, H, D)
    valid = _valid(rng, B, L)
    scale = 1.0 / np.sqrt(D)
    assert jfa.flash_shapes_ok(L, L, D)
    want = jfa.masked_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid), jnp.asarray(valid), scale, softmax=softmax
    )
    got = tfa.masked_flash_attention(_t(q), _t(k), _t(v), _t(valid), _t(valid), scale, softmax=softmax)
    assert got.shape == (B, L, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert np.all(got.numpy()[~valid] == 0.0)  # padded query rows are zeroed


@pytest.mark.parametrize("softmax", ["max", "nomax_clip"])
def test_flash_attention_T_matches_jax_kernel(softmax):
    """Transposed (B, H, D, L) entry with the pre-scaled q, and K1's LSE."""
    rng = np.random.default_rng(5)
    B, L, H, D = 2, 128, 2, 16
    q, k, v = _qkv(rng, B, L, H, D)
    valid = _valid(rng, B, L)
    c = np.float32(jfa.LOG2E / np.sqrt(D))
    qT, kT, vT = (np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1))) for x in (q * c, k, v))
    want = jfa.masked_flash_attention_T(
        jnp.asarray(qT), jnp.asarray(kT), jnp.asarray(vT), jnp.asarray(valid), jnp.asarray(valid), softmax=softmax
    )
    got = tfa.masked_flash_attention_T(_t(qT), _t(kT), _t(vT), _t(valid), _t(valid), softmax=softmax)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    if softmax == "max":
        m = jnp.asarray(valid, jnp.float32)[:, None, :]
        _, want_lse = jfa._flash_fwd(jnp.asarray(qT), jnp.asarray(kT), jnp.asarray(vT), m, m, with_lse=True)
        _, got_lse = tfa.masked_flash_attention_T(
            _t(qT), _t(kT), _t(vT), _t(valid), _t(valid), softmax=softmax, with_lse=True
        )
        assert got_lse.shape == (B, H, 1, L)
        vq = np.broadcast_to(valid[:, None, None, :], got_lse.shape)
        np.testing.assert_allclose(got_lse.numpy()[vq], np.asarray(want_lse)[vq], atol=1e-4, rtol=0)


def test_ref_attention_matches_jax_ref():
    """The natural-base dense reference (any shape, no kernel gate)."""
    rng = np.random.default_rng(6)
    B, L, H, D = 2, 40, 2, 8
    q, k, v = (np.transpose(x, (0, 2, 1, 3)) for x in _qkv(rng, B, L, H, D))
    m = _valid(rng, B, L).astype(np.float32)[:, None, :]
    want, want_p = jfa._ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m), jnp.asarray(m), 0.3)
    got, got_p = tfa._ref_attention(_t(q), _t(k), _t(v), _t(m), _t(m), 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=ATOL, rtol=0)


def test_nomax_selfcheck_detects_saturation():
    rng = np.random.default_rng(7)
    B, L, H, D = 1, 128, 1, 16
    q, k, v = _qkv(rng, B, L, H, D)

    def pair(mult):
        qq = _t(q * mult)
        return (
            lambda b: tfa.masked_flash_attention(qq, _t(k), _t(v), None, None, 1.0, softmax="max"),
            lambda b: tfa.masked_flash_attention(qq, _t(k), _t(v), None, None, 1.0, softmax="nomax_clip"),
        )

    assert tfa.nomax_selfcheck(*pair(1.0), None)
    assert not tfa.nomax_selfcheck(*pair(200.0), None)  # logits far past CLIP_HI


@pytest.mark.parametrize("per_cell", [False, True])
def test_fused_ln_mod_proj_matches_jax_kernel(per_cell):
    """K3, per-batch (B, F) and per-cell (B, L, F) affine rows."""
    rng = np.random.default_rng(8)
    B, L, F, O = 2, 128, 128, 384
    x = rng.normal(size=(B, L, F)).astype(np.float32)
    w = (rng.normal(size=(F, O)) * 0.05).astype(np.float32)
    bias = rng.normal(size=(O, 1)).astype(np.float32)
    shape = (B, L, F) if per_cell else (B, F)
    a, b = rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32)
    assert jfq.fused_qkv_ok(L, F) and tfq.fused_qkv_ok(L, F)
    want = jfq.fused_ln_mod_proj(*(jnp.asarray(t) for t in (x, a, b, w, bias)))
    got = tfq.fused_ln_mod_proj(*(_t(t) for t in (x, a, b, w, bias)))
    assert got.shape == (B, O, L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("per_cell", [False, True])
def test_fused_dit_mlp_matches_jax_kernel(per_cell):
    """K4, per-batch and per-cell rows."""
    rng = np.random.default_rng(9)
    B, L, F, Fh = 2, 128, 128, 256
    r = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    shape = (B, L, F) if per_cell else (B, F)
    args = (r(B, L, F), r(B, L, F), r(*shape), r(*shape), r(*shape), r(*shape),
            r(F, Fh) * 0.05, r(Fh), r(Fh, F) * 0.05, r(F))
    assert jfm.fused_mlp_ok(L, F, Fh) and tfm.fused_mlp_ok(L, F, Fh)
    want = jfm.fused_dit_mlp(*(jnp.asarray(t) for t in args))
    got = tfm.fused_dit_mlp(*(_t(t) for t in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("L", [64, 128, 200, 256, 384, 512, 640, 4096, 5120])
def test_shape_gates_agree_with_jax(L):
    """The same shapes take the same branch in both packages."""
    for d in (8, 12, 16, 64):
        assert tfa.flash_shapes_ok(L, L, d) == jfa.flash_shapes_ok(L, L, d)
        assert tfa.flash_shapes_ok(L, 128, d) == jfa.flash_shapes_ok(L, 128, d)
    for F in (64, 128, 256, 1024, 1152):
        assert tfq.fused_qkv_ok(L, F) == jfq.fused_qkv_ok(L, F)
        for Fh in (128, 192, 256, 2048):
            assert tfm.fused_mlp_ok(L, F, Fh) == jfm.fused_mlp_ok(L, F, Fh)


def test_mlp_config_fusable_and_constants_agree_with_jax():
    base = {"activation": "LeakyReLU", "dropout": 0.0, "final_activation": "LeakyReLU",
            "hidden_layers": [256], "norm_final_layer": False, "norm_layer": "LayerNorm", "output_size": 256}
    variants = [base, dict(base, hidden_layers=[]), dict(base, hidden_layers=[64, 64]),
                dict(base, activation="ReLU"), dict(base, final_activation=None), dict(base, dropout=0.1),
                dict(base, norm_layer=None), dict(base, norm_final_layer=True), dict(base, context_size=4)]
    for cfg in variants:
        assert tfm.mlp_config_fusable(cfg) == jfm.mlp_config_fusable(cfg)
    assert tfm.mlp_config_fusable(base)
    for name in ("CLIP_LO", "CLIP_HI", "LOG2E", "NEG_INF"):
        assert getattr(tfa, name) == getattr(jfa, name)
    assert tfq.LN_EPS == jfq.LN_EPS == jfm.LN_EPS and tfm.LRELU_SLOPE == jfm.LRELU_SLOPE


def test_masked_ops_match_jax():
    rng = np.random.default_rng(10)
    B, L, C = 3, 12, 5
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    valid = _valid(rng, B, L)
    np.testing.assert_allclose(
        tmasked.masked_mean(_t(x), _t(valid)).numpy(), np.asarray(jmasked.masked_mean(jnp.asarray(x), jnp.asarray(valid))),
        atol=1e-6)
    s = rng.normal(size=(B, 2, L, L)).astype(np.float32)
    m = tmasked.merge_masks(_t(valid), _t(valid), None, L, L)
    jm = jmasked.merge_masks(jnp.asarray(valid), jnp.asarray(valid), None, L, L)
    assert np.array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_allclose(
        tmasked.masked_softmax(_t(s), m[:, None]).numpy(),
        np.asarray(jmasked.masked_softmax(jnp.asarray(s), jm[:, None])), atol=1e-6)
    ctx = rng.normal(size=(B, 4)).astype(np.float32)
    assert np.array_equal(
        tmasked.attach_context(_t(x), _t(ctx)).numpy(), np.asarray(jmasked.attach_context(jnp.asarray(x), jnp.asarray(ctx))))


def test_cuda_tensor_required_for_kernel_and_no_silent_fallback():
    """Without a card the kernel library cannot be built: asking for it
    raises instead of handing back a plain version."""
    from superresolutionhep_tpu_torch.ops import kernels

    if torch.cuda.is_available():  # decided inside the test, never at import
        pytest.skip("this case describes a machine without a CUDA device")
    import shutil

    if shutil.which("nvcc") is None:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kernels.build()
    assert all(v == 0 for v in kernels.LAUNCHES.values())  # CPU runs never count a launch
