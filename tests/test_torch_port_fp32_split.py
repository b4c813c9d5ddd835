"""PyTorch port: the arithmetic of the fp32 attention kernels on the tensor
cores (``csrc/tf32_attention.cuh``; K1/K2/K7, K5/K8 and K6/K9 on fp32 operands),
stated in ``ops/tf32_split.py``, on the CPU.

  * ``tf32_round`` (the port's ``cvt.rna.tf32.f32``) bit for bit against a
    float64 numpy reference: ties, subnormals, overflow, +-inf, NaN;
  * the three-term split products with the kernels' summation order (head
    dim permuted in S = Q K^T, keys and queries permuted within 8-wide steps
    where an accumulator is the next A operand, 64-row tiles, the online
    softmax) against the JAX ``_flash_fwd``, ``_flash_fwd_nomax`` and
    ``_flash_bwd`` in Pallas interpret mode, within 2e-5 of each output's max;
  * single TF32 (the lo terms dropped) on the guard inputs of
    ``chip_smoke.py`` (base-2 logits of std ~8) misses the card's fp32
    bounds (2e-4 of each output's max), which the three-term split meets:
    the card's fp32 checks can see a missing term (forward, dq, dk/dv)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolutionhep_tpu.ops import flash_attention as jfa
from superresolutionhep_tpu_torch.ops import flash_attention as tfa
from superresolutionhep_tpu_torch.ops import tf32_split as ts

torch.set_num_threads(1)
EMUL_TOL = 2e-5   # the split arithmetic against JAX fp32, relative to each output's max
CARD_TOL = 2e-4   # chip_smoke.py's TOL[("flash", fp32)] and TOL[("flash_bwd", fp32)]


def _t(x):
    return torch.from_numpy(np.array(x))  # a copy: arrays from JAX are read-only


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _tf32_reference(x32):
    """Round to 10 mantissa bits, to nearest with ties away from zero, in
    float64 (exact: every fp32 value and half-ulp is a float64)."""
    with np.errstate(invalid="ignore"):  # signalling NaNs among the inputs
        x = x32.astype(np.float64)
    out = x.copy()
    fin = np.isfinite(x)
    a = np.abs(x[fin])
    _, e = np.frexp(a)
    ulp = np.where(a >= 2.0**-126, np.ldexp(1.0, e - 11), 2.0**-136)
    r = np.floor(a / ulp + 0.5) * ulp
    r = np.where(r >= 2.0**128, np.inf, r)
    out[fin] = np.copysign(r, x[fin])
    with np.errstate(invalid="ignore"):
        return out.astype(np.float32)


def test_tf32_round_matches_numpy():
    rng = np.random.default_rng(0)
    one = np.float32(1.0)
    ulp11 = np.float32(2.0**-11)
    ties = np.array([one + ulp11, one + 3 * ulp11, -(one + ulp11), np.float32(1.5) * np.float32(2.0**-130)],
                    np.float32)  # halfway cases, the last a subnormal
    subnormal = (rng.integers(1, 2**23, 64, dtype=np.int64) | (rng.integers(0, 2, 64) << 31)).astype(np.uint32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, np.float32(3.4028235e38), np.float32(-3.4028e38),
                        np.float32(2.0**-126), np.float32(2.0**-126) * np.float32(1 - 2.0**-12)], np.float32)
    nan_low_bits = np.array([0x7F800001, 0xFF801000], np.uint32).view(np.float32)  # NaNs with only low bits set
    scaled = rng.normal(size=4096) * 10.0 ** rng.integers(-30, 30, 4096)
    x = np.concatenate([ties, subnormal.view(np.float32), special, nan_low_bits, scaled.astype(np.float32)])
    got = ts.tf32_round(_t(x)).numpy()
    want = _tf32_reference(x)
    nan = np.isnan(x)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))
    assert np.all((got.view(np.uint32) & 0x1FFF)[~nan] == 0)
    # the split of a normal value keeps ~21 bits: hi + lo within 2^-21 of x
    normal = x[np.isfinite(x) & (np.abs(x) >= 2.0**-100) & (np.abs(x) < 1e38)]
    hi, lo = ts.split(_t(normal))
    assert np.all(np.abs((hi.double() + lo.double()).numpy() - normal) <= np.abs(normal) * 2.0**-21)


def _inputs(B, H, L, D, lens, logit_std, seed):
    """(B, H, L, D) fp32 q (pre-scaled: base-2 logits of std ~logit_std), k,
    v, a cotangent g, and (B, L) True==valid masks of the given lengths."""
    rng = np.random.default_rng(seed)
    sd = np.sqrt(logit_std / np.sqrt(D))
    q, k = (rng.normal(size=(B, H, L, D)).astype(np.float32) * np.float32(sd) for _ in range(2))
    v, g = (rng.normal(size=(B, H, L, D)).astype(np.float32) for _ in range(2))
    valid = np.arange(L)[None, :] < np.asarray(lens)[:, None]
    return q, k, v, g, valid


def _port_bwd_operands(q, k, v, g, valid, out, lse):
    """What the port's ``_flash_bwd`` hands the dk/dv kernel: g zeroed on
    padded queries, dl = sum_d(out * g); (B, H, L, D) layout."""
    gm = g * valid[:, None, :, None]
    dl = (out * gm).sum(-1)
    return _t(gm), _t(lse), _t(dl.astype(np.float32))


@pytest.mark.parametrize("D", [16, 64])
def test_split_arithmetic_matches_jax(D):
    """Forward (robust with LSE, no-max), dq and dk/dv at (4, 256, 4, D) with
    ragged masks (a full row, one ending inside a tile, one with two dead key
    tiles, an empty one): the split emulation against JAX within 2e-5."""
    B, H, L = 4, 4, 256
    lens = [L, L - 37, 100, 0]
    q, k, v, g, valid = _inputs(B, H, L, D, lens, logit_std=2.9, seed=D)
    m = valid.astype(np.float32)[:, None, :]  # (B, 1, L)
    tT = [jnp.asarray(np.swapaxes(x, -1, -2)) for x in (q, k, v, g)]  # (B, H, D, L)
    outT, lse = jfa._flash_fwd(*tT[:3], jnp.asarray(m), jnp.asarray(m))
    out_nomax = np.swapaxes(np.asarray(jfa._flash_fwd_nomax(*tT[:3], jnp.asarray(m), jnp.asarray(m))), -1, -2)
    dqT, dkT, dvT = jfa._flash_bwd(*tT[:3], jnp.asarray(m), jnp.asarray(m), outT, lse, tT[3])
    out, lse = np.swapaxes(np.asarray(outT), -1, -2), np.asarray(lse)[:, :, 0]

    mt = _t(m)
    got, got_lse = ts.flash_fwd_split(_t(q), _t(k), _t(v), mt, mt, "max", with_lse=True)
    assert _rel(got, out) <= EMUL_TOL
    vq = np.broadcast_to(valid[:, None, :], lse.shape)
    assert np.abs(got_lse.numpy() - lse)[vq].max() <= EMUL_TOL * np.abs(lse[vq]).max()
    assert np.all(got.numpy()[np.broadcast_to(~valid[:, None, :, None], got.shape)] == 0.0)
    assert _rel(ts.flash_fwd_split(_t(q), _t(k), _t(v), mt, mt, "nomax_clip"), out_nomax) <= EMUL_TOL

    gm, lse_t, dl = _port_bwd_operands(q, k, v, g, valid, out, lse)
    dk, dv = ts.flash_bwd_dkv_split(_t(q), _t(k), _t(v), gm, lse_t, dl, mt)
    assert _rel(dk * tfa.LN2, np.asarray(dkT).swapaxes(-1, -2)) <= EMUL_TOL
    assert _rel(dv, np.asarray(dvT).swapaxes(-1, -2)) <= EMUL_TOL
    assert np.all(dk.numpy()[np.broadcast_to(~valid[:, None, :, None], dk.shape)] == 0.0)
    dq = ts.flash_bwd_dq_split(_t(q), _t(k), _t(v), gm, lse_t, dl, mt)
    assert _rel(dq * tfa.LN2, np.asarray(dqT).swapaxes(-1, -2)) <= EMUL_TOL
    assert np.all(dq.numpy()[np.broadcast_to(~valid[:, None, :, None], dq.shape)] == 0.0)


@pytest.mark.parametrize("D", [16, 64])
def test_single_tf32_misses_the_guard(D):
    """chip_smoke.py's guard inputs (base-2 logits of std ~8, ragged keys):
    against the plain versions, the three-term split meets the card's fp32
    bound and single TF32 misses it, forward, dq and dk/dv alike."""
    B, H, L = 2, 4, 192
    q, k, v, g, valid = _inputs(B, H, L, D, [L, 150], logit_std=8.0, seed=100 + D)
    mt = _t(valid.astype(np.float32)[:, None, :])
    ref_out, ref_lse = tfa._ref_attention_base2(_t(q), _t(k), _t(v), mt, mt, "max", with_lse=True)
    gm, lse_t, dl = _port_bwd_operands(q, k, v, g, valid, ref_out.numpy(), ref_lse.numpy())
    ref_dk, ref_dv = tfa._ref_flash_bwd_dkv(_t(q), _t(k), _t(v), gm, lse_t, dl, mt)
    ref_dq = tfa._ref_flash_bwd_dq(_t(q), _t(k), _t(v), gm, lse_t, dl, mt)
    errs = {}
    for terms in (3, 1):
        out = ts.flash_fwd_split(_t(q), _t(k), _t(v), mt, mt, "max", terms=terms)
        dk, dv = ts.flash_bwd_dkv_split(_t(q), _t(k), _t(v), gm, lse_t, dl, mt, terms=terms)
        dq = ts.flash_bwd_dq_split(_t(q), _t(k), _t(v), gm, lse_t, dl, mt, terms=terms)
        errs[terms] = (_rel(out, ref_out), max(_rel(dk, ref_dk), _rel(dv, ref_dv)), _rel(dq, ref_dq))
    assert max(errs[3]) <= CARD_TOL / 10, errs
    assert min(errs[1]) > CARD_TOL, errs
