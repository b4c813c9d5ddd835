"""Alternative diffusion samplers (EDM / Karras family).

Counterpart of the JAX package's ``flow/edm.py``: the Karras EDM sampler with
its rho-schedule, 2nd-order Heun correction and S_churn noise injection; a
DPM-Solver-2 variant; and a linear-multistep (LMS) sampler whose quadrature
coefficients are computed on the host (scipy) once per call.  A Python loop
over the static sigma schedule takes the place of ``lax.scan``.

All samplers share the signature ``sampler(denoise_fn, x_init, num_steps,
...)`` where ``denoise_fn(x, sigma) -> D(x; sigma)`` is the denoiser
(x0-prediction) and sigma a 0-dim fp32 tensor on x's device.  The churn noise
of ``edm_sampler`` comes from an explicit ``torch.Generator`` or is passed in
as ``noise`` (num_steps, *x.shape): the JAX sampler splits its key once a
step and draws ``normal(k1, x.shape)`` from the second half.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch


def karras_sigmas(num_steps: int, sigma_min: float = 0.002, sigma_max: float = 80.0, rho: float = 7.0):
    """Karras et al. rho-schedule, descending, with terminal 0 (fp32 numpy)."""
    i = np.arange(num_steps)
    s = (sigma_max ** (1 / rho) + i / max(num_steps - 1, 1) * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
    return np.concatenate([s, [0.0]]).astype(np.float32)


def _sigmas(num_steps, sigma_min, sigma_max, rho, device):
    return torch.from_numpy(karras_sigmas(num_steps, sigma_min, sigma_max, rho)).to(device)


def edm_sampler(
    denoise_fn: Callable,
    x_init,
    num_steps: int = 18,
    sigma_min: float = 0.002,
    sigma_max: float = 80.0,
    rho: float = 7.0,
    S_churn: float = 0.0,
    S_min: float = 0.0,
    S_max: float = float("inf"),
    S_noise: float = 1.0,
    ret_seq: bool = False,
    generator: Optional[torch.Generator] = None,
    noise=None,
):
    """Karras EDM sampler: optional churn, Euler step + Heun correction.
    ``noise`` (num_steps, *x.shape), else drawn from ``generator`` each step
    (standard normal, times ``S_noise``)."""
    sigmas = _sigmas(num_steps, sigma_min, sigma_max, rho, x_init.device)
    x = x_init * sigmas[0]
    gamma_base = min(S_churn / num_steps, math.sqrt(2.0) - 1.0)
    seq = []
    for i in range(num_steps):
        t_cur, t_next = sigmas[i], sigmas[i + 1]
        in_range = bool((t_cur >= S_min) & (t_cur <= S_max))
        gamma = torch.tensor(gamma_base if in_range else 0.0, dtype=torch.float32, device=x.device)
        t_hat = t_cur * (1 + gamma)
        eps = noise[i] if noise is not None else torch.randn(x.shape, generator=generator, device=x.device,
                                                              dtype=torch.float32).to(x.dtype)
        x_hat = x + torch.sqrt(torch.clamp_min(t_hat**2 - t_cur**2, 0.0)) * (S_noise * eps)

        d_cur = (x_hat - denoise_fn(x_hat, t_hat)) / torch.clamp_min(t_hat, 1e-12)
        x_euler = x_hat + (t_next - t_hat) * d_cur
        if bool(t_next > 0):  # Heun's 2nd-order correction on all but the last step
            t_den = torch.clamp_min(t_next, 1e-12)
            d_prime = (x_euler - denoise_fn(x_euler, t_den)) / t_den
            x = x_hat + (t_next - t_hat) * 0.5 * (d_cur + d_prime)
        else:
            x = x_euler
        seq.append(x)
    return torch.stack(seq) if ret_seq else x


def dpm2_sampler(
    denoise_fn: Callable,
    x_init,
    num_steps: int = 18,
    sigma_min: float = 0.002,
    sigma_max: float = 80.0,
    rho: float = 7.0,
    ret_seq: bool = False,
):
    """DPM-Solver-2 on the Karras schedule: the midpoint evaluation at the
    log-space geometric mean sigma; Euler on the terminal step."""
    sigmas = _sigmas(num_steps, sigma_min, sigma_max, rho, x_init.device)
    x = x_init * sigmas[0]
    seq = []
    for i in range(num_steps):
        t_cur, t_next = sigmas[i], sigmas[i + 1]
        d = (x - denoise_fn(x, t_cur)) / torch.clamp_min(t_cur, 1e-12)
        if bool(t_next > 0):
            sigma_mid = torch.exp(0.5 * (torch.log(torch.clamp_min(t_cur, 1e-12))
                                         + torch.log(torch.clamp_min(t_next, 1e-12))))
            x_mid = x + (sigma_mid - t_cur) * d
            d_mid = (x_mid - denoise_fn(x_mid, sigma_mid)) / torch.clamp_min(sigma_mid, 1e-12)
            x = x + (t_next - t_cur) * d_mid
        else:
            x = x + (t_next - t_cur) * d
        seq.append(x)
    return torch.stack(seq) if ret_seq else x


def lms_coefficients(sigmas: np.ndarray, order: int) -> np.ndarray:
    """Adams-Bashforth-style coefficients over the sigma grid by quadrature
    of the Lagrange basis (scipy ``quad``), (n, order) fp32."""
    from scipy.integrate import quad

    n = len(sigmas) - 1
    coeffs = np.zeros((n, order), np.float32)
    for i in range(n):
        cur_order = min(i + 1, order)
        for j in range(cur_order):
            def lms_fn(tau, i=i, j=j, cur_order=cur_order):
                prod = 1.0
                for k in range(cur_order):
                    if j == k:
                        continue
                    prod *= (tau - sigmas[i - k]) / (sigmas[i - j] - sigmas[i - k])
                return prod

            coeffs[i, j] = quad(lms_fn, sigmas[i], sigmas[i + 1])[0]
    return coeffs


def lms_sampler(
    denoise_fn: Callable,
    x_init,
    num_steps: int = 18,
    order: int = 4,
    sigma_min: float = 0.002,
    sigma_max: float = 80.0,
    rho: float = 7.0,
    ret_seq: bool = False,
):
    """Linear multistep sampler: the history of derivatives (newest first,
    zeros before the first steps) combined with the quadrature
    coefficients."""
    sig_np = karras_sigmas(num_steps, sigma_min, sigma_max, rho)
    coeffs = torch.from_numpy(lms_coefficients(sig_np, order)).to(x_init.device)
    sigmas = torch.from_numpy(sig_np).to(x_init.device)
    x = x_init * sigmas[0]
    d_hist = torch.zeros((order,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    seq = []
    for i in range(num_steps):
        t_cur = sigmas[i]
        d = (x - denoise_fn(x, t_cur)) / torch.clamp_min(t_cur, 1e-12)
        d_hist = torch.cat([d[None], d_hist[:-1]], dim=0)
        x = x + torch.tensordot(coeffs[i], d_hist, dims=1)
        seq.append(x)
    return torch.stack(seq) if ret_seq else x
