"""PyTorch port, segment-packed attention (kernels K7, K8, K9) against the JAX
package on the same numpy inputs (fp32, CPU).

  * the plain versions of K7 (robust with its LSE, no-max) and of K8/K9 (what
    the CUDA kernels compute, held against them on the card by
    chip_smoke.py) against the JAX ``_packed_fwd`` / ``_packed_bwd`` run in
    Pallas interpret mode with 128-wide blocks;
  * ``band_ranges`` against the JAX one;
  * ``torch.autograd.grad`` through ``packed_flash_attention`` against
    ``jax.grad`` through the JAX one.

The rows hold: several events with alignment gaps, one event straddling a
128-block edge, an event of exactly 128 cells, a row holding one event, and
an empty row.  Tolerance 2e-5 of each output's max (fp32 on both sides,
another summation order).  LSE is compared at valid queries only: at padding
it depends on the tiling (padding cells attend each other, as in the TPU
kernels' mask)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolutionhep_tpu.ops import flash_packed as jfp
from superresolutionhep_tpu_torch.data.packing import aligned_len
from superresolutionhep_tpu_torch.ops import flash_packed as tfp

torch.set_num_threads(1)
TOL = 2e-5
S, H, D = 512, 2, 16
ROWS = ((170, 100, 160), (300, 128), (512,), ())  # events per row, in cells


def _seg(rows=ROWS, S=S):
    seg = np.full((len(rows), S), -1, np.int32)
    for b, lens in enumerate(rows):
        pos = 0
        for sid, n in enumerate(lens):
            seg[b, pos: pos + n] = sid
            pos += aligned_len(n)
    return seg


def _t(x):
    return torch.from_numpy(np.array(x))


def _bl(x):  # (B, H, D, S) -> (B, S, H, D)
    return _t(x).permute(0, 3, 1, 2)


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err:.3g} > {tol} x {scale:.3g}"


def _inputs(seed, n=4):
    rng = np.random.default_rng(seed)
    B = len(ROWS)
    ts = [rng.normal(size=(B, H, D, S)).astype(np.float32) for _ in range(n)]
    ts[0] *= (1.0 / np.sqrt(D)) * jfp.LOG2E * 2.0  # base-2 logits with a spread
    return ts


@pytest.mark.parametrize("softmax", ["max", "nomax_clip"])
def test_packed_fwd_plain_matches_jax(softmax):
    """Plain K7 against the JAX kernel body (interpret mode, 128-wide blocks,
    band capped at the longest event): output everywhere, exactly 0 at
    padding; the robust variant's base-2 LSE at valid queries."""
    qT, kT, vT = _inputs(1, 3)
    seg = _seg()
    nomax = softmax == "nomax_clip"
    want, wlse = jfp._packed_fwd(jnp.asarray(qT), jnp.asarray(kT), jnp.asarray(vT), jnp.asarray(seg), 128, 128,
                                 S // 128, nomax=nomax, with_lse=not nomax)
    got, glse = tfp._packed_fwd(_bl(qT), _bl(kT), _bl(vT), _t(seg), nomax=nomax, with_lse=not nomax)
    _close(got.numpy(), _bl(want).numpy(), f"K7 {softmax}")
    pad = seg < 0
    assert float(got.abs()[torch.from_numpy(pad)].max()) == 0.0
    if not nomax:
        valid = np.broadcast_to(~pad[:, None, :], glse.shape)
        err = np.abs(glse.numpy()[valid] - np.asarray(wlse)[:, :, 0][valid]).max()
        assert err <= 1e-4, err  # base-2 LSE of O(10): absolute


def test_band_ranges_match_jax():
    """The TPU band table, op for op, on the test rows and on the layout of
    tests/test_packing.py (an alignment gap, a partial block)."""
    gap = np.full((1, 512), -1, np.int32)
    gap[0, :128] = 0
    gap[0, 256:300] = 1
    for seg, bq, bk in ((_seg(), 128, 128), (_seg(), 128, 64), (gap, 128, 128), (_seg(), 64, 64)):
        want = jfp.band_ranges(jnp.asarray(seg), bq, bk)
        got = tfp.band_ranges(_t(seg), bq, bk)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and np.array_equal(g.numpy(), np.asarray(w))


def test_packed_bwd_plain_matches_jax():
    """Plain K8/K9 behind ``_packed_bwd`` (cotangent zeroed on padding, dl,
    the ln 2 scaling) against the JAX ``_packed_bwd`` on the JAX forward's
    residuals; dq, dk, dv exactly 0 at padding."""
    qT, kT, vT, gT = _inputs(2)
    seg = _seg()
    jq, jk, jv, js = map(jnp.asarray, (qT, kT, vT, seg))
    outT, lse = jfp._packed_fwd(jq, jk, jv, js, 128, 128, S // 128, nomax=False, with_lse=True)
    want = jfp._packed_bwd(jq, jk, jv, js, outT, lse, jnp.asarray(gT), 128, 128, S)
    got = tfp._packed_bwd(_bl(qT), _bl(kT), _bl(vT), _t(seg), _bl(outT), _t(lse)[:, :, 0].contiguous(), _bl(gT))
    pad = torch.from_numpy(seg < 0)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        _close(g.numpy(), _bl(w).numpy(), name)
        assert float(g.abs()[pad].max()) == 0.0, name


def test_packed_autograd_matches_jax_grad():
    """``torch.autograd.grad`` through ``packed_flash_attention`` (plain K7
    with LSE, K8, K9 behind ``_PackedAttention``) against ``jax.grad``
    through the JAX entry; the transposed entry gives the same forward; the
    no-max variant raises under grad."""
    rng = np.random.default_rng(3)
    B = len(ROWS)
    q, k, v, g = (rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(4))
    seg = _seg()
    js = jnp.asarray(seg)
    scale = 0.35

    def jloss(q, k, v):
        out = jfp.packed_flash_attention(q, k, v, js, scale=scale, block_q=128, block_k=128, max_segment_len=S)
        return jnp.vdot(out, jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    x = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = tfp.packed_flash_attention(*x, _t(seg), scale=scale)
    got = torch.autograd.grad((out * _t(g)).sum(), x)
    for a, b, name in zip(got, want, "qkv"):
        _close(a.numpy(), np.asarray(b), f"d{name}")
    # the pre-scaled transposed entry on the same inputs
    qT = (_t(q) * scale * tfp.LOG2E).permute(0, 2, 3, 1)
    outT = tfp.packed_flash_attention_T(qT, _t(k).permute(0, 2, 3, 1), _t(v).permute(0, 2, 3, 1), _t(seg))
    _close(outT.permute(0, 3, 1, 2).numpy(), out.detach().numpy(), "transposed entry")
    ref = tfp.ref_packed_attention(*(_t(a) for a in (q, k, v)), _t(seg), scale)
    _close(out.detach().numpy(), ref.numpy(), "natural-base reference")
    with pytest.raises(RuntimeError):
        tfp.packed_flash_attention(*x, _t(seg), scale=scale, softmax="nomax_clip")
