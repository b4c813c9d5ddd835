"""PyTorch port: the arithmetic of the fp32 dq kernel on the tensor cores
(``csrc/flash_attention_bwd.cu::flash_bwd_dq_f32_kernel``, K5 and K8 on fp32
operands), stated in ``ops/tf32_split.py::flash_bwd_dq_split``, against the
JAX package's backward in Pallas interpret mode, on the CPU:

  * packed rows (K8) whose segment boundaries fall inside the kernel's
    64-cell tiles, so that a tile holds two segments and the segment select,
    not only the band of key tiles, decides which pairs count; one row is all
    padding; against the JAX ``_packed_bwd`` with 128-wide blocks;
  * padding masks (K5) with Lq != Lk, query and key lengths that end inside
    tiles, fully padded key tiles (skipped by the kernel) and a batch row
    without a valid key; against the JAX ``_flash_bwd``.

dq (times ln 2, which the caller applies) within 2e-5 of its max, as the
other fp32 kernels' emulations (``tests/test_torch_port_fp32_split.py``);
padding rows exactly 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolutionhep_tpu.ops import flash_attention as jfa
from superresolutionhep_tpu.ops import flash_packed as jfp
from superresolutionhep_tpu_torch.ops import flash_attention as tfa
from superresolutionhep_tpu_torch.ops import tf32_split as ts

torch.set_num_threads(1)
EMUL_TOL = 2e-5  # the split arithmetic against JAX fp32, relative to dq's max
H = 2


def _t(x):
    return torch.from_numpy(np.array(x))  # a copy: arrays from JAX are read-only


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _operands(rng, B, Lq, Lk, D):
    """(B, H, L, D) fp32 q (pre-scaled: base-2 logits of std ~2.9), k, v and
    a cotangent g, and the same in the JAX package's (B, H, D, L) layout."""
    sd = np.float32(np.sqrt(2.9 / np.sqrt(D)))
    q = rng.normal(size=(B, H, Lq, D)).astype(np.float32) * sd
    k = rng.normal(size=(B, H, Lk, D)).astype(np.float32) * sd
    v = rng.normal(size=(B, H, Lk, D)).astype(np.float32)
    g = rng.normal(size=(B, H, Lq, D)).astype(np.float32)
    return (q, k, v, g), [jnp.asarray(np.swapaxes(x, -1, -2)) for x in (q, k, v, g)]


def _port_dq_operands(g, qvalid, outT, lse):
    """What the port's backward hands the dq kernel: g zeroed on padded
    queries, lse (B, H, Lq) and dl = sum_d(out * g), from the JAX forward."""
    out = np.swapaxes(np.asarray(outT), -1, -2)
    gm = g * qvalid[:, None, :, None]
    dl = (out * gm).sum(-1).astype(np.float32)
    return _t(gm), _t(np.asarray(lse)[:, :, 0]), _t(dl)


@pytest.mark.parametrize("D", [16, 64])
def test_packed_split_dq_matches_jax(D):
    """K8's arithmetic on three rows of S = 384: boundaries at 100, 230 and
    300 (inside tiles), padding from 330; two events meeting at 200, padding
    from 350; all padding."""
    S = 384
    seg = np.full((3, S), -1, np.int32)
    seg[0, :100], seg[0, 100:230], seg[0, 230:300], seg[0, 300:330] = 0, 1, 2, 3
    seg[1, :200], seg[1, 200:350] = 0, 1
    rng = np.random.default_rng(10 + D)
    (q, k, v, g), (jq, jk, jv, jg) = _operands(rng, 3, S, S, D)
    js = jnp.asarray(seg)
    outT, lse = jfp._packed_fwd(jq, jk, jv, js, 128, 128, S // 128, nomax=False, with_lse=True)
    dqT, _, _ = jfp._packed_bwd(jq, jk, jv, js, outT, lse, jg, 128, 128, S)
    gm, lse_t, dl = _port_dq_operands(g, seg >= 0, outT, lse)
    dq = ts.flash_bwd_dq_split(_t(q), _t(k), _t(v), gm, lse_t, dl, None, seg=_t(seg))
    assert _rel(dq * tfa.LN2, np.asarray(dqT).swapaxes(-1, -2)) <= EMUL_TOL
    pad = np.broadcast_to((seg < 0)[:, None, :, None], dq.shape)
    assert np.all(dq.numpy()[pad] == 0.0)


def test_masked_split_dq_matches_jax():
    """K5's arithmetic at D = 32, Lq = 256, Lk = 384: query lengths 256, 200,
    77, 256 and key lengths 384, 250 (tiles 4 and 5 padding), 100 (tiles 2-5
    padding), 0."""
    B, Lq, Lk, D = 4, 256, 384, 32
    qvalid = np.arange(Lq)[None, :] < np.array([256, 200, 77, 256])[:, None]
    kvalid = np.arange(Lk)[None, :] < np.array([384, 250, 100, 0])[:, None]
    rng = np.random.default_rng(7)
    (q, k, v, g), (jq, jk, jv, jg) = _operands(rng, B, Lq, Lk, D)
    qm, km = (x.astype(np.float32)[:, None, :] for x in (qvalid, kvalid))
    outT, lse = jfa._flash_fwd(jq, jk, jv, jnp.asarray(qm), jnp.asarray(km))
    dqT, _, _ = jfa._flash_bwd(jq, jk, jv, jnp.asarray(qm), jnp.asarray(km), outT, lse, jg)
    gm, lse_t, dl = _port_dq_operands(g, qvalid, outT, lse)
    dq = ts.flash_bwd_dq_split(_t(q), _t(k), _t(v), gm, lse_t, dl, _t(km))
    assert _rel(dq * tfa.LN2, np.asarray(dqT).swapaxes(-1, -2)) <= EMUL_TOL
    dead = ~qvalid | ~kvalid.any(-1, keepdims=True)  # padded queries, and a row without a valid key
    assert np.all(dq.numpy()[np.broadcast_to(dead[:, None, :, None], dq.shape)] == 0.0)
