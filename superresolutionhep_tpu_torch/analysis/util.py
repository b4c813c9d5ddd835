"""Small analysis helpers: the port's own copy of the JAX package's
``analysis/util.py`` (numpy only)."""

from __future__ import annotations

import numpy as np


def mean_std_iqr(array):
    mean = float(np.mean(array))
    std = float(np.std(array))
    iqr = float(np.subtract(*np.percentile(array, [75, 25])))
    return mean, std, iqr


def mean_std_iqr_label(array, precision: int = 2):
    mean, std, iqr = mean_std_iqr(array)
    p = precision
    label = rf"$\mu$: {mean:.{p}f} $\sigma$: {std:.{p}f} IQR: {iqr:.{p}f}"
    return label, (mean, std, iqr)


def robust_bins(*arrays, n_bins: int = 30, lo: float = 1.0, hi: float = 99.0):
    comb = np.hstack([np.asarray(a).ravel() for a in arrays])
    comb = comb[np.isfinite(comb)]
    if comb.size == 0:
        return np.linspace(-1, 1, n_bins)
    a, b = np.percentile(comb, [lo, hi])
    if a == b:
        a, b = a - 1, b + 1
    return np.linspace(a, b, n_bins)
