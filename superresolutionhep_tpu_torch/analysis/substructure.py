"""Jet substructure observables C2 / C3 / D2 (energy correlation functions).

The port's own copy of the JAX package's ``analysis/substructure.py`` (numpy
only; held equal to it by tests/test_torch_port_tools.py).  The reference's
performance/substructure/compute_substructures.py:10-24 delegates to the
``energyflow`` package, which is not a dependency here, so the observables
are implemented natively:

with z_i = pT_i / sum(pT), theta_ij = (dy^2 + dphi^2)^(beta/2):

  e2 = sum_{i<j}     z_i z_j theta_ij
  e3 = sum_{i<j<k}   z_i z_j z_k theta_ij theta_ik theta_jk
  e4 = sum_{i<j<k<l} z... (product over all 6 pairs)

  C2 = e3 / e2^2,  D2 = e3 / e2^3,  C3 = e4 * e2 / e3^2
(hadronic measure, beta=1, ptyphim coordinates, reg added to denominators —
the exact energyflow configuration used by the reference.)

Sums over coincident indices vanish because theta_ii = 0 appears in every
product, so the ECFs are computed as full einsums divided by N!.

``e4`` is O(n^4); events above ``max_constituents`` are truncated to the
leading-pT constituents (the observables are pT-weighted, so the tail's
contribution is negligible); the cap is the explicit ``max_constituents``
argument.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

REG = 1e-31
DEFAULT_MAX_CONSTITUENTS = 128


def _theta(eta, phi, beta: float):
    dphi = np.abs(phi[:, None] - phi[None, :])
    dphi = np.minimum(dphi, 2 * np.pi - dphi)
    deta = eta[:, None] - eta[None, :]
    theta2 = deta**2 + dphi**2
    th = theta2 ** (beta / 2.0)
    np.fill_diagonal(th, 0.0)
    return th


def ecfs(pt, eta, phi, beta: float = 1.0, max_constituents: Optional[int] = DEFAULT_MAX_CONSTITUENTS):
    """Returns (e2, e3, e4) normalized ECFs for one constituent set."""
    pt = np.asarray(pt, np.float64)
    eta = np.asarray(eta, np.float64)
    phi = np.asarray(phi, np.float64)
    if max_constituents is not None and len(pt) > max_constituents:
        order = np.argsort(pt)[::-1][:max_constituents]
        pt, eta, phi = pt[order], eta[order], phi[order]
    tot = pt.sum()
    if tot <= 0 or len(pt) < 2:
        return 0.0, 0.0, 0.0
    z = pt / tot
    th = _theta(eta, phi, beta)

    e2 = 0.5 * float(z @ th @ z)

    # e3 over the triangle i-j-k: M[i,j] = sum_k theta_ik z_k theta_kj
    M = (th * z[None, :]) @ th
    e3 = float(np.einsum("i,j,ij,ij->", z, z, th, M)) / 6.0

    # e4 by variable elimination on the K4 graph: for fixed i,
    #   U[j,k] = theta_ik theta_jk z_k,  inner[j] = sum_kl U[j,k] theta_kl U[j,l]
    #           = rowsum(U * (U @ theta)),
    #   e4 = (1/24) sum_i z_i sum_j z_j theta_ij inner[j].
    # O(n^4) flops but expressed as n batched n^2-matmuls (BLAS friendly),
    # instead of the reference's energyflow call (11h-walltime chunks of 10
    # events, submit_job_substructures.py:9-11).
    n = len(z)
    if n >= 4:
        acc = 0.0
        zth = th * z[None, :]  # zth[j,k] = theta_jk z_k
        for i in range(n):
            U = th[i][None, :] * zth  # (n, n)
            inner = np.einsum("jk,jk->j", U, U @ th)
            acc += z[i] * float((z * th[i]) @ inner)
        e4 = acc / 24.0
    else:
        e4 = 0.0
    return e2, e3, e4


def c2_d2_c3(pt, eta, phi, beta: float = 1.0, reg: float = REG, max_constituents=DEFAULT_MAX_CONSTITUENTS):
    e2, e3, e4 = ecfs(pt, eta, phi, beta, max_constituents)
    c2 = e3 / (e2**2 + reg)
    d2 = e3 / (e2**3 + reg)
    c3 = e4 * e2 / (e3**2 + reg)
    return c2, d2, c3


def calc_substructure(
    e_list, eta_list, phi_list, beta: float = 1.0, max_constituents=DEFAULT_MAX_CONSTITUENTS
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batch D2/C2/C3 from cell (E, eta, phi) with pt = E/cosh(eta)
    (compute_substructures.py:10-24). Returns (d2, c2, c3) arrays."""
    d2s, c2s, c3s = [], [], []
    for e, eta, phi in zip(e_list, eta_list, phi_list):
        pt = np.asarray(e) / np.cosh(np.asarray(eta))
        c2, d2, c3 = c2_d2_c3(pt, eta, phi, beta, max_constituents=max_constituents)
        d2s.append(d2)
        c2s.append(c2)
        c3s.append(c3)
    return np.asarray(d2s), np.asarray(c2s), np.asarray(c3s)
