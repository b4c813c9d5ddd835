"""ODE integrators for flow-matching sample generation.

Counterpart of the JAX package's ``flow/ode.py``: the fixed-step solvers
``euler``, ``midpoint``, ``heun`` and ``rk4``, the Adams-Bashforth multistep
solvers (``ab2`` with a Heun bootstrap, ``ab2e`` with an Euler one, ``ab3``
on a uniform grid) and the adaptive Dormand-Prince 5(4) solver with dense
output (``dopri5``, the trainer's validation sampler).  A Python loop over the
time grid takes the place of ``lax.scan`` / ``lax.while_loop``: PyTorch runs
eagerly and each step is a handful of kernel launches.

All integrators share the signature ``odeint(f, y0, ts)`` with
``f(t, y) -> dy/dt`` (t a 0-dim tensor; for dopri5 a (groups,) tensor, one
time per group of rows) and return the trajectory at the
requested grid points, shape (T, *y0.shape), with ``y[0] == y0``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..parallel.comm import all_reduce_sum


def _euler_step(f, t0, t1, y):
    return y + (t1 - t0) * f(t0, y)


def _midpoint_step(f, t0, t1, y):
    h = t1 - t0
    return y + h * f(t0 + h / 2, y + (h / 2) * f(t0, y))


def _heun_step(f, t0, t1, y):
    h = t1 - t0
    k1 = f(t0, y)
    k2 = f(t1, y + h * k1)
    return y + (h / 2) * (k1 + k2)


def _rk4_step(f, t0, t1, y):
    h = t1 - t0
    k1 = f(t0, y)
    k2 = f(t0 + h / 2, y + (h / 2) * k1)
    k3 = f(t0 + h / 2, y + (h / 2) * k2)
    k4 = f(t1, y + h * k3)
    return y + (h / 6) * (k1 + 2 * k2 + 2 * k3 + k4)


FIXED_STEP_METHODS = {
    "euler": _euler_step,
    "midpoint": _midpoint_step,
    "heun": _heun_step,
    "rk4": _rk4_step,
}

# multistep methods reuse previous evaluations (1 f-eval per step at 2nd/3rd
# order).  "ab2e" is ab2 with an Euler bootstrap (one fewer eval in all).
MULTISTEP_METHODS = ("ab2", "ab2e", "ab3")


def _store_list(store_idx):
    return sorted(set(int(i) for i in store_idx)) if store_idx is not None else None


def odeint_ab2(f: Callable, y0, ts, store_idx=None, bootstrap: str = "heun"):
    """Adams-Bashforth-2 over the grid: Heun (or Euler) bootstrap on the first
    interval, then x_{n+1} = x_n + h[(1 + r) f_n - r f_{n-1}], r = h / (2 h_prev)
    — one vector-field evaluation per step with 2nd-order accuracy.

    ``bootstrap="euler"`` reuses the already-computed f0: one fewer evaluation
    on the whole trajectory (25 -> 24 at n_steps=25).

    Returns the full trajectory (T, *y) when store_idx is None, else the
    states at the sorted ``store_idx`` grid positions only.
    """
    T = ts.shape[0]
    store = _store_list(store_idx)

    t0, t1 = ts[0], ts[1]
    h0 = t1 - t0
    f0 = f(t0, y0)
    if bootstrap == "euler":
        y1 = y0 + h0 * f0  # no extra f-eval
    elif bootstrap == "heun":
        y1 = y0 + (h0 / 2) * (f0 + f(t1, y0 + h0 * f0))
    else:
        raise ValueError(f"unknown ab2 bootstrap {bootstrap!r}")

    states = [y0, y1]
    kept = {0: y0, 1: y1}
    y, f_prev, h_prev = y1, f0, h0
    for n in range(2, T):
        t_n, t_np1 = ts[n - 1], ts[n]
        f_n = f(t_n, y)
        h = t_np1 - t_n
        r = h / (2 * h_prev)
        y = y + h * ((1 + r) * f_n - r * f_prev)
        f_prev, h_prev = f_n, h
        if store is None:
            states.append(y)
        elif n in store:
            kept[n] = y
    if store is None:
        return torch.stack(states[:T], dim=0)
    return torch.stack([kept[pos] for pos in store], dim=0)


def odeint_ab3(f: Callable, y0, ts, store_idx=None):
    """Adams-Bashforth-3 on a UNIFORM grid: Heun bootstrap for y1, AB2 for
    y2, then x_{n+1} = x_n + h(23 f_n - 16 f_{n-1} + 5 f_{n-2}) / 12 — one
    vector-field evaluation per step at 3rd order.  The step is the first
    interval's.  A grid of fewer than 3 points goes to ``odeint_ab2``.  Same
    ``store_idx`` contract as ``odeint_ab2``."""
    T = ts.shape[0]
    if T < 3:
        return odeint_ab2(f, y0, ts, store_idx=store_idx)
    store = _store_list(store_idx)

    h = ts[1] - ts[0]
    f0 = f(ts[0], y0)
    y1 = y0 + (h / 2) * (f0 + f(ts[1], y0 + h * f0))  # Heun bootstrap
    f1 = f(ts[1], y1)
    y2 = y1 + h * (1.5 * f1 - 0.5 * f0)  # uniform-step AB2

    states = [y0, y1, y2]
    kept = {0: y0, 1: y1, 2: y2}
    y, f_nm1, f_nm2 = y2, f1, f0
    for n in range(3, T):
        f_n = f(ts[n - 1], y)
        y = y + (h / 12.0) * (23.0 * f_n - 16.0 * f_nm1 + 5.0 * f_nm2)
        f_nm1, f_nm2 = f_n, f_nm1
        if store is None:
            states.append(y)
        elif n in store:
            kept[n] = y
    if store is None:
        return torch.stack(states, dim=0)
    return torch.stack([kept[pos] for pos in store], dim=0)


def odeint_fixed(f: Callable, y0, ts, method: str = "midpoint"):
    """Integrate with one fixed step per grid interval."""
    step = FIXED_STEP_METHODS[method]
    ys = [y0]
    y = y0
    for i in range(ts.shape[0] - 1):
        y = step(f, ts[i], ts[i + 1], y)
        ys.append(y)
    return torch.stack(ys, dim=0)


def odeint_fixed_store(f: Callable, y0, ts, store_idx, method: str = "midpoint"):
    """Fixed-step integration storing ONLY the grid states in ``store_idx``.
    Returns (len(store_idx), *y0.shape) stacked in sorted store_idx order."""
    step = FIXED_STEP_METHODS[method]
    store = _store_list(store_idx)
    out = []
    y = y0
    pos = 0
    for target in store:
        for i in range(pos, target):
            y = step(f, ts[i], ts[i + 1], y)
        pos = max(pos, target)
        out.append(y)
    return torch.stack(out, dim=0)


# ----------------------------------------------------------------------------
# Dormand-Prince 5(4) adaptive solver with dense output
# ----------------------------------------------------------------------------

_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0)
_A = (
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
)
_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84)
# b - b* (5th-order minus embedded 4th-order weights), incl. the FSAL stage
_E = (
    35 / 384 - 5179 / 57600, 0.0, 500 / 1113 - 7571 / 16695, 125 / 192 - 393 / 640,
    -2187 / 6784 + 92097 / 339200, 11 / 84 - 187 / 2100, -1 / 40,
)
# scipy RK45 dense-output interpolation matrix (7 stages x 4 powers of theta)
_P = (
    (1.0, -8048581381 / 2820520608, 8663915743 / 2820520608, -12715105075 / 11282082432),
    (0.0, 0.0, 0.0, 0.0),
    (0.0, 131558114200 / 32700410799, -68118460800 / 10900136933, 87487479700 / 32700410799),
    (0.0, -1754552775 / 470086768, 14199869525 / 1410260304, -10690763975 / 1880347072),
    (0.0, 127303824393 / 49829197408, -318862633887 / 49829197408, 701980252875 / 199316789632),
    (0.0, -282668133 / 205662961, 2019193451 / 616988883, -1453857185 / 822651844),
    (0.0, 40617522 / 29380423, -110615467 / 29380423, 69997945 / 29380423),
)
_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0
_ORDER_EXP = -1.0 / 5.0


def _rms_norm(x):
    return torch.sqrt(torch.mean(x * x))


def _group_rms_norm(x, groups: int, pg=None):
    """(groups,) root mean squares, each over one group's rows of x (the
    groups are consecutive blocks of rows: an ensemble folded member-major
    into the batch axis).  One group: the plain ``_rms_norm``.  ``pg``: a
    data-parallel process group whose ranks hold the other rows of one
    problem: the root mean square over all of them (one group only)."""
    if pg is not None:
        if groups != 1:
            raise ValueError("dopri5 over a process group takes one group of rows")
        tot = all_reduce_sum(torch.stack([(x * x).sum(),
                                          torch.tensor(float(x.numel()), device=x.device)]), pg)
        return torch.sqrt(tot[0] / tot[1]).reshape(1)
    if groups == 1:
        return _rms_norm(x).reshape(1)
    return torch.stack([_rms_norm(xg) for xg in x.reshape(groups, -1)])


def _tensordot0(w, K):
    """sum_j w[..., j] * K[j] with w (..., S) and K (S, *y): the stage
    combination, in fp32 (the JAX package asks for HIGHEST precision)."""
    return torch.tensordot(w, K, dims=1)


def _initial_step(f, t0, y0, f0, t1, atol, rtol, rows, pg=None):
    """scipy ``_select_initial_step`` heuristic, as the JAX package, for each
    group of rows (``rows(v)`` spreads a (groups,) value over its rows)."""
    G = t0.shape[0]
    scale = atol + torch.abs(y0) * rtol
    d0 = _group_rms_norm(y0 / scale, G, pg)
    d1 = _group_rms_norm(f0 / scale, G, pg)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), torch.full_like(d0, 1e-6), 0.01 * d0 / d1)
    y1 = y0 + rows(h0) * f0
    f1 = f(t0 + h0, y1)
    d2 = _group_rms_norm((f1 - f0) / scale, G, pg) / h0
    h1 = torch.where(
        (d1 <= 1e-15) & (d2 <= 1e-15),
        torch.clamp_min(h0 * 1e-3, 1e-6),
        (0.01 / torch.maximum(d1, d2)) ** (1.0 / 5.0),
    )
    return torch.minimum(torch.minimum(100 * h0, h1), t1 - t0)


def odeint_dopri5(f: Callable, y0, ts, rtol: float = 1e-4, atol: float = 1e-4, max_steps: int = 10_000,
                  groups: int = 1, pg=None):
    """Adaptive DOPRI5 with dense output at the grid points ``ts``: the JAX
    package's step-size control and quartic interpolation, step for step.
    The solver's own arithmetic (times, step sizes, error norms, stage
    combinations) runs in fp32 whatever the state's dtype; whether any group
    is still integrating is read on the host each step.

    ``groups``: y0's rows are that many independent problems in consecutive
    blocks (an ensemble folded member-major into the batch axis).  Each group
    keeps its own t, h, accept and error norm over its own rows, as the JAX
    package's vmap over the members gives; ``f`` is then called with a
    (groups,) tensor of times.  A group that has reached the end keeps its
    state while the others go on.

    ``pg``: a data-parallel process group whose ranks hold the other rows of
    the one problem (a validation batch split over the ranks, one group):
    the error norms are taken over every rank's rows, so each step's size
    and acceptance are the single-process solver's on the whole batch, the
    same on every rank."""
    dev = y0.device
    G = int(groups)
    if G < 1 or y0.shape[0] % G:
        raise ValueError(f"dopri5: {y0.shape[0]} rows do not split into {G} groups")
    n_rows = y0.shape[0] // G
    ts = torch.as_tensor(ts, dtype=torch.float32, device=dev)
    C = torch.tensor(_C, dtype=torch.float32, device=dev)
    Bw = torch.tensor(_B, dtype=torch.float32, device=dev)
    Ew = torch.tensor(_E, dtype=torch.float32, device=dev)
    Pm = torch.tensor(_P, dtype=torch.float32, device=dev)
    A = [torch.tensor(a, dtype=torch.float32, device=dev) for a in _A]

    def rows(v):  # (G,) -> broadcastable onto y's rows
        return v.repeat_interleave(n_rows).reshape((-1,) + (1,) * (y0.ndim - 1))

    t0, t1 = ts[0].expand(G).clone(), ts[-1]
    f0 = f(t0, y0)
    h = _initial_step(f, t0, y0, f0, t1, atol, rtol, rows, pg)

    n_out = ts.shape[0]
    ys = torch.zeros((n_out, *y0.shape), dtype=y0.dtype, device=dev)
    ys[0] = y0
    t, y, k1 = t0, y0, f0
    for _ in range(max_steps):
        active = t < t1
        if not bool(active.any()):
            break
        h = torch.minimum(h, t1 - t)
        hr = rows(h)
        ks = [k1]
        for i in range(5):
            yi = y + hr * _tensordot0(A[i], torch.stack(ks))
            ks.append(f(t + C[i + 1] * h, yi))
        y_new = y + hr * _tensordot0(Bw, torch.stack(ks))
        ks.append(f(t + h, y_new))
        K = torch.stack(ks)  # (7, *y.shape)
        err = hr * _tensordot0(Ew, K)
        scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y_new))
        err_norm = _group_rms_norm(err / scale, G, pg)
        accept = err_norm <= 1.0
        factor = torch.where(err_norm == 0.0, torch.full_like(err_norm, _MAX_FACTOR),
                             torch.clamp(_SAFETY * err_norm**_ORDER_EXP, _MIN_FACTOR, _MAX_FACTOR))
        factor = torch.where(accept, factor, torch.clamp_max(factor, 1.0))
        h_next = h * factor
        accept = accept & active

        # dense output at every grid point inside (t, t + h] of each accepting group
        t_new = t + h
        for g in range(G):
            sl = slice(g * n_rows, (g + 1) * n_rows)
            theta = torch.clamp((ts - t[g]) / torch.clamp_min(h[g], 1e-30), 0.0, 1.0)  # (T,)
            powers = torch.stack([theta, theta**2, theta**3, theta**4], dim=-1)  # (T, 4)
            w = powers @ Pm.T  # (T, 7)
            dense = y[sl][None] + h[g] * _tensordot0(w, K[:, sl])
            in_window = (ts > t[g]) & (ts <= t_new[g] + 1e-12) & accept[g]
            mask = in_window.reshape((n_out,) + (1,) * y.ndim)
            ys[:, sl] = torch.where(mask, dense.to(ys.dtype), ys[:, sl])
        acc_rows = rows(accept)
        t = torch.where(accept, t_new, t)
        y = torch.where(acc_rows, y_new, y)
        k1 = torch.where(acc_rows, K[6], k1)  # FSAL
        h = torch.where(active, h_next, h)
    return ys


def odeint(f, y0, ts, method: str = "ab2e", rtol: float = 1e-4, atol: float = 1e-4, groups: int = 1, pg=None):
    """``groups``: independent problems in consecutive blocks of y0's rows;
    ``pg``: a process group over which one problem's rows are split.  Only
    the adaptive dopri5 reads them (fixed-step solvers treat every row
    alike)."""
    if method == "dopri5":
        return odeint_dopri5(f, y0, ts, rtol=rtol, atol=atol, groups=groups, pg=pg)
    if method in FIXED_STEP_METHODS:
        return odeint_fixed(f, y0, ts, method)
    if method == "ab2":
        return odeint_ab2(f, y0, ts)
    if method == "ab2e":
        return odeint_ab2(f, y0, ts, bootstrap="euler")
    if method == "ab3":
        return odeint_ab3(f, y0, ts)
    raise ValueError(f"unknown ODE method {method!r}")
