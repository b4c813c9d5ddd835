"""PyTorch port, the attention-probe kernels of the two measuring scripts
(K10: ``scripts/kernel_experiments.py::variant_kernel`` in its four modes;
K11: ``scripts/probe_exp_dtype.py::kernel`` with bf16 and fp32 exp): the plain
versions beside the Hopper kernels (ops/attention_probes.py) against the
scripts' own Pallas kernels, run in interpret mode on the CPU with the
scripts' BlockSpecs at (B, H, L, D) = (1, 2, 256, 64) and 128-wide blocks.

The scripts are not a package: they are loaded from their paths.  The
scripts feed q as q, k and v, which makes attention nearly the identity (the
diagonal logit |q|^2 ~ 64 dominates); here q, k, v are independent,
q and k ~ N(0, 0.25) and v ~ N(0, 1) in bf16, raw logits of std ~2.
Tolerance: 1e-2 of each output's max (p rounded to bf16 by exp2 on both
sides, possibly one bf16 ulp apart; another summation order), 3e-2 in mode
no_max, whose exp2 takes the raw logit: XLA on the CPU computes a bf16 exp2
as exp(x * bf16(ln 2)), 0.25% off in the exponent, up to 2.3% in p at
|x| = 10, where the plain version (and the hardware) take exp2 itself.  K11 runs a
ragged key mask that leaves the first key block fully masked for one row
(the p = 1 trap wiped by alpha = 0) and a row with no valid key at all (the
mean of v)."""

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

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, L, D, BQ, BK = 1, 2, 256, 64, 128, 128
TOL = 1e-2


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas(kernel, args, extra_specs=()):
    """The scripts' pallas_call with their BlockSpecs, in interpret mode."""
    q = args[0]
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(q.shape, q.dtype),
        grid=(q.shape[0], H, L // BQ, L // BK),
        in_specs=[pl.BlockSpec((1, 1, BQ, D), lambda b, h, i, j: (b, h, i, 0)),
                  pl.BlockSpec((1, 1, BK, D), lambda b, h, i, j: (b, h, j, 0)),
                  pl.BlockSpec((1, 1, BK, D), lambda b, h, i, j: (b, h, j, 0)), *extra_specs],
        out_specs=pl.BlockSpec((1, 1, BQ, D), lambda b, h, i, j: (b, h, i, 0)),
        scratch_shapes=[pltpu.VMEM((BQ, 1), jnp.float32), pltpu.VMEM((BQ, 1), jnp.float32),
                        pltpu.VMEM((BQ, D), jnp.float32)],
        interpret=True,
    )(*args)


def _inputs(batch):
    """(q, k, v) as bf16 JAX arrays and the same values as torch tensors."""
    rng = np.random.default_rng(0)
    js = [jnp.asarray(rng.normal(size=(batch, H, L, D)) * sc, jnp.bfloat16) for sc in (0.5, 0.5, 1.0)]
    return js, [torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16) for a in js]


def _close(got, want, what, tol=TOL):
    want = np.asarray(want, np.float32)
    assert np.isfinite(want).all(), f"{what}: the Pallas result is not finite"
    err = float(np.abs(got.float().numpy() - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * scale, f"{what}: max err {err:.3g} > {tol} x {scale:.3g}"


@pytest.mark.parametrize("mode", ap.MODES)
def test_variant_plain_matches_script_kernel(mode):
    """K10; matmuls_only divides by max(l, 1e-30) with l = 0, so its output
    is ~1e33 and is compared relative to its max like the others."""
    ke = _script("kernel_experiments")
    js, ts = _inputs(B)
    want = _pallas(functools.partial(ke.variant_kernel, mode=mode), js).astype(jnp.float32)
    got = ap.attention_variant(*ts, mode, block_q=BQ, block_k=BK)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, L, D)
    _close(got, want, mode, tol=3e-2 if mode == "no_max" else TOL)


@pytest.mark.parametrize("exp_bf16", [True, False], ids=["exp_bf16", "exp_fp32"])
def test_exp_probe_plain_matches_script_kernel(exp_bf16):
    """K11 with an all-ones mask (the script's) and a ragged one: row 1 has
    its valid keys only in the second block (the first block's p = 1 is wiped
    by alpha = 0), row 2 has none (its output is the mean of v)."""
    pe = _script("probe_exp_dtype")
    js, ts = _inputs(3)
    km = np.ones((3, 1, L), np.float32)
    km[1, 0, :] = 0.0
    km[1, 0, 150:230] = 1.0
    km[2, 0, :] = 0.0
    want = _pallas(functools.partial(pe.kernel, exp_bf16=exp_bf16), (*js, jnp.asarray(km)),
                   [pl.BlockSpec((1, 1, BK), lambda b, h, i, j: (b, 0, j))]).astype(jnp.float32)
    got = ap.attention_exp_probe(*ts, torch.from_numpy(km[:, 0]), exp_bf16, block_q=BQ, block_k=BK)
    _close(got, want, f"exp_bf16={exp_bf16}")
    # the trap, on both sides: no valid key -> the mean of v
    mean_v = ts[2][2].float().mean(dim=1, keepdim=True).expand(H, L, D)
    np.testing.assert_allclose(got[2].float().numpy(), mean_v.numpy(), atol=2e-2)
