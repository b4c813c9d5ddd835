"""Sample generation for the SR flow model.

Integrate the learned vector field from x0 ~ N(0, I) over t in
linspace(0, 1, n_steps).  Where the JAX package vmaps the sampler over
ensemble noise keys, the ensemble is folded into the batch axis here: the
batch rows are repeated E times (member-major), one sampler call runs all
E*B rows, and the result is reshaped to (E, S, B, N, 1).  The adaptive
dopri5 keeps each member's own step-size control over its own rows
(``groups``), as the vmap does.

Noise: drawn on the batch's device from an explicit ``torch.Generator``, or
passed in as ``x0`` (tests fill it from numpy so that both packages
integrate from the same start).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .ode import FIXED_STEP_METHODS, odeint, odeint_ab2, odeint_ab3, odeint_fixed_store


def _draw_x0(shape, dtype, device, generator):
    if generator is None:
        raise ValueError("generate_samples needs a torch.Generator or an explicit x0")
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32).to(dtype)


def generate_samples(
    apply_fn: Callable,
    batch: dict,
    n_steps: int,
    method: str = "ab2e",
    ret_seq: bool = False,
    store_indices=None,
    generator: Optional[torch.Generator] = None,
    x0: Optional[torch.Tensor] = None,
    groups: int = 1,
    pg=None,
):
    """apply_fn(batch, noisy, t) -> v_t.  ``groups``: independent problems in
    consecutive blocks of the batch rows (a folded ensemble), for dopri5.
    ``pg``: a data-parallel process group over which the batch's rows are
    split (this rank's rows are ``batch``; dopri5's error norms then span
    every rank's rows).

    Returns the final sample (B,N,1); with ``ret_seq`` the full trajectory
    (n_steps,B,N,1); with ``store_indices`` only the selected grid states
    (S,B,N,1).
    """
    e_proxy = batch["e_proxy"]
    if x0 is None:
        x0 = _draw_x0(e_proxy.shape, e_proxy.dtype, e_proxy.device, generator)
    ts = torch.linspace(0.0, 1.0, n_steps, device=e_proxy.device)

    def vector_field(t, x):
        # the state stays in x0's dtype (fp32): a bf16 velocity is promoted
        # before it meets the fp32 step sizes, as in the JAX package; t is one
        # time, or one per group of rows (dopri5 over a folded ensemble)
        t_rows = t.to(x.dtype).reshape(-1)
        t_rows = t_rows.repeat_interleave(x.shape[0] // t_rows.shape[0])
        return apply_fn(batch, x, t_rows).to(x.dtype)

    with torch.no_grad():
        if store_indices is not None and method in ("ab2", "ab2e"):
            boot = "euler" if method == "ab2e" else "heun"
            return odeint_ab2(vector_field, x0, ts, store_idx=store_indices, bootstrap=boot)
        if store_indices is not None and method == "ab3":
            return odeint_ab3(vector_field, x0, ts, store_idx=store_indices)
        if store_indices is not None and method in FIXED_STEP_METHODS:
            return odeint_fixed_store(vector_field, x0, ts, store_indices, method)
        traj = odeint(vector_field, x0, ts, method=method, groups=groups, pg=pg)
    if store_indices is not None:
        return traj[sorted(set(int(i) for i in store_indices))]
    return traj if ret_seq else traj[-1]


def generate_ensemble(
    apply_fn: Callable,
    batch: dict,
    n_ensemble: int,
    n_steps: int,
    method: str = "midpoint",
    ret_seq: bool = True,
    store_indices=None,
    generator: Optional[torch.Generator] = None,
    x0: Optional[torch.Tensor] = None,
):
    """Ensemble of generate_samples over independent noise draws, folded into
    the batch axis.  ``x0``, when given, is (n_ensemble, B, N, 1).

    Returns (n_ensemble, n_steps, B, N, 1) when ret_seq, (n_ensemble, S, B,
    N, 1) with store_indices, else (n_ensemble, B, N, 1).
    """
    e_proxy = batch["e_proxy"]
    B = e_proxy.shape[0]
    E = int(n_ensemble)
    if x0 is None:
        x0 = _draw_x0((E, *e_proxy.shape), e_proxy.dtype, e_proxy.device, generator)
    elif tuple(x0.shape) != (E, *e_proxy.shape):
        raise ValueError(f"x0 must be {(E, *e_proxy.shape)}, got {tuple(x0.shape)}")
    folded = {k: v.repeat(E, *([1] * (v.ndim - 1))) for k, v in batch.items()}
    out = generate_samples(
        apply_fn, folded, n_steps=n_steps, method=method, ret_seq=ret_seq,
        store_indices=store_indices, x0=x0.reshape(E * B, *e_proxy.shape[1:]), groups=E,
    )
    if out.ndim == e_proxy.ndim:  # final state only: (E*B, N, 1)
        return out.reshape(E, B, *out.shape[1:])
    S = out.shape[0]  # (S, E*B, N, 1) -> (E, S, B, N, 1)
    return out.reshape(S, E, B, *out.shape[2:]).transpose(0, 1)
