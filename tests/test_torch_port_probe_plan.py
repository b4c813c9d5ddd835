"""PyTorch port, the host side of the attention probes K10/K11 on the shipped
bf16 forward body (``csrc/attention_probes.cu`` on ``csrc/flash_fwd.cuh``),
which the CPU reaches without the card:

  * the launch plan for each tile shape of ``TILES`` at the scripts' shape
    (8, 8, 2048, 64): the TMA tensor maps of the (B, H, L, D) operands read
    through their (B, L, H, D) views ``t.transpose(1, 2)``, the grid (a ragged
    last query tile at 192 rows: 2048 is no multiple of 192), the consumer
    warpgroups NC, the dynamic shared memory within the H100's opt-in limit
    (and two blocks an SM at NC = 1), and the default tile (the shipped
    forward's pick for the shape);
  * the checks the wrappers apply before a launch: what the kernels do not
    take is refused, a query tile that does not divide L is taken;
  * the plain versions at 64-key blocks against the scripts' Pallas kernels
    in interpret mode at BK = 64 (``test_torch_port_probes.py`` covers 128),
    with a key mask whose first two 64-key tiles are dead for one row and a
    row with no valid key at all.  Tolerances as there: 1e-2 of each output's
    max, 3e-2 in mode no_max (XLA's bf16 exp2 on the CPU).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from superresolutionhep_tpu_torch.ops import attention_probes as ap
from superresolutionhep_tpu_torch.ops import flash_attention as fa
from superresolutionhep_tpu_torch.ops.fused_qkv import SMEM_LIMIT

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100_SMS = 132
SMEM_PER_SM = 233472  # the SM's 228 KB; each resident block reserves 1 KB of it


def _empty(B, H, L, D=64, dtype=torch.bfloat16):
    return torch.empty((B, H, L, D), dtype=dtype)


@pytest.mark.parametrize("tile", ap.TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_probe_plan(tile):
    bq, bk = tile
    B, H, L, D = 8, 8, 2048, 64
    q, k, v = _empty(B, H, L), _empty(B, H, L), _empty(B, H, L)
    plan = ap.probe_plan(q, k, v, bq, bk)
    nc = bq // 64
    assert (plan["block_q"], plan["block_k"], plan["nc"]) == (bq, bk, nc)
    assert plan["threads"] == 128 * (nc + 1)
    assert plan["grid"] == (-(-L // bq), H, B)
    assert L % bq == 0 or bq == 192  # 2048 = 10 * 192 + 128: the last query tile is ragged
    for name in ("q", "k", "v"):
        m = plan["maps"][name]
        assert m["dims"] == (D, L, H, B)
        assert m["strides_bytes"] == (D * 2, L * D * 2, H * L * D * 2)  # L, H, B of the (B, H, L, D) layout
        assert m["box"] == (D, 64, 1, 1) and m["swizzle_bytes"] == 128
    stages = 3 if nc == 1 else 5
    ring = stages * 2 * (bk // 64) * 64 * D * 2  # K and V tiles of bk keys, two TMA boxes each at 128
    assert plan["stages"] == stages
    assert plan["smem_bytes"] == 1024 + nc * 64 * D * 2 + ring + stages * bk * 4 + 32 + (2 * stages + 1) * 8
    assert plan["smem_bytes"] <= SMEM_LIMIT
    if nc == 1:  # the launch bound's two blocks an SM
        assert 2 * (plan["smem_bytes"] + 1024) <= SMEM_PER_SM
    # the default tile is the shipped forward's pick: 192 rows here, 64 on a
    # small grid, where 64 rows are built for the key width (else 192)
    assert ap.probe_plan(q, k, v, None, bk, H100_SMS)["block_q"] == fa.fwd_tile_rows(B, H, L, H100_SMS) == 192
    small = _empty(1, 2, 256)
    assert ap.probe_plan(small, small, small, None, bk, H100_SMS)["block_q"] == (64 if (64, bk) in ap.TILES else 192)


def test_probe_checks_refuse_what_the_kernels_do_not_take():
    q = _empty(1, 2, 320)  # a multiple of 64, not of 128 or 192
    assert ap.probe_plan(q, q, q, 192, 64)["grid"] == (2, 2, 1)  # block_q need not divide L
    assert ap.probe_plan(q, q, q, 64, 64)["grid"] == (5, 2, 1)
    bad = [
        ((q, q, q), dict(block_q=128, block_k=64)),  # not a built tile
        ((q, q, q), dict(block_q=64, block_k=128)),  # not built: it spilled
        ((q, q, q), dict(block_q=64, block_k=256)),
        ((q, q, q), dict(block_q=192, block_k=128)),  # 128 keys do not divide 320
        ((_empty(1, 2, 320, 32),) * 3, dict(block_q=64, block_k=64)),  # D = 32
        ((_empty(1, 2, 320, dtype=torch.float32),) * 3, dict(block_q=64, block_k=64)),
        ((q, _empty(1, 2, 384), q), dict(block_q=64, block_k=64)),  # shapes differ
        ((q, q.transpose(1, 2).contiguous().transpose(1, 2), q), dict(block_q=64, block_k=64)),  # not contiguous
    ]
    for args, kw in bad:
        with pytest.raises(ValueError):
            ap.probe_plan(*args, **kw)


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas(kernel, args, bq, bk, extra_specs=()):
    """The scripts' pallas_call with their BlockSpecs at (bq, bk), in interpret mode."""
    q = args[0]
    B, H, L, D = q.shape
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(q.shape, q.dtype),
        grid=(B, H, L // bq, L // bk),
        in_specs=[pl.BlockSpec((1, 1, bq, D), lambda b, h, i, j: (b, h, i, 0)),
                  pl.BlockSpec((1, 1, bk, D), lambda b, h, i, j: (b, h, j, 0)),
                  pl.BlockSpec((1, 1, bk, D), lambda b, h, i, j: (b, h, j, 0)), *extra_specs],
        out_specs=pl.BlockSpec((1, 1, bq, D), lambda b, h, i, j: (b, h, i, 0)),
        scratch_shapes=[pltpu.VMEM((bq, 1), jnp.float32), pltpu.VMEM((bq, 1), jnp.float32),
                        pltpu.VMEM((bq, D), jnp.float32)],
        interpret=True,
    )(*args)


def _close(got, want, what, tol):
    want = np.asarray(want, np.float32)
    assert np.isfinite(want).all(), f"{what}: the Pallas result is not finite"
    err = float(np.abs(got.float().numpy() - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * scale, f"{what}: max err {err:.3g} > {tol} x {scale:.3g}"


def test_plain_at_64_key_blocks_matches_script_kernels():
    """K11 (both exp dtypes) and K10 (every mode) at BK = 64 against the
    scripts' kernels: row 1's first two 64-key tiles hold no valid key (their
    p = 1, seen while m = -1e30, is wiped by alpha = 0), row 2 has none at all
    (its output is the mean of v on both sides)."""
    B, H, L, D, BQ, BK = 3, 2, 256, 64, 64, 64
    rng = np.random.default_rng(1)
    js = [jnp.asarray(rng.normal(size=(B, H, L, D)) * sc, jnp.bfloat16) for sc in (0.5, 0.5, 1.0)]
    ts = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16) for a in js]
    km = np.ones((B, 1, L), np.float32)
    km[1, 0, :2 * BK] = 0.0
    km[1, 0, 230:] = 0.0
    km[2, 0, :] = 0.0
    pe = _script("probe_exp_dtype")
    for exp_bf16 in (True, False):
        want = _pallas(functools.partial(pe.kernel, exp_bf16=exp_bf16), (*js, jnp.asarray(km)), BQ, BK,
                       [pl.BlockSpec((1, 1, BK), lambda b, h, i, j: (b, 0, j))]).astype(jnp.float32)
        got = ap.attention_exp_probe(*ts, torch.from_numpy(km[:, 0]), exp_bf16, block_k=BK)
        _close(got, want, f"exp_bf16={exp_bf16}", 1e-2)
        mean_v = ts[2][2].float().mean(dim=1, keepdim=True).expand(H, L, D)
        np.testing.assert_allclose(got[2].float().numpy(), mean_v.numpy(), atol=2e-2)
    ke = _script("kernel_experiments")
    for mode in ap.MODES:
        want = _pallas(functools.partial(ke.variant_kernel, mode=mode), js[:3], BQ, BK).astype(jnp.float32)
        got = ap.attention_variant(*ts, mode, block_k=BK)
        _close(got, want, mode, 3e-2 if mode == "no_max" else 1e-2)
