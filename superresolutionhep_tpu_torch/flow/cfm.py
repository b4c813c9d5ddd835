"""Target-OT conditional flow matching.

Counterpart of the JAX package's ``flow/cfm.py``:

  x_t = (1 - (1 - sigma) t) * x0 + t * x1
  u_t = x1 - (1 - sigma) * x0

with x0 ~ N(0, I) the noise, x1 the data, t ~ U(0,1) per event; t=0 is
noise, t=1 is data.  The noise and the times are drawn from an explicit
``torch.Generator``, or passed in (the tests draw them with ``jax.random``
exactly as the JAX package does, so that both packages see the same ones).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.comm import all_reduce_sum


def sample_location_and_conditional_flow(
    x1,
    sigma_min: float,
    t: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Returns (t, x_t, u_t).  x1: (B, ...) data; t: (B,) or None to draw;
    x0: noise of x1's shape or None to draw."""
    if (t is None or x0 is None) and generator is None:
        raise ValueError("sample_location_and_conditional_flow needs a torch.Generator or explicit t and x0")
    if x0 is None:
        x0 = torch.randn(x1.shape, generator=generator, device=x1.device, dtype=torch.float32).to(x1.dtype)
    if t is None:
        t = torch.rand((x1.shape[0],), generator=generator, device=x1.device, dtype=torch.float32).to(x1.dtype)
    x0 = x0.to(device=x1.device, dtype=x1.dtype)
    t = t.to(device=x1.device, dtype=x1.dtype)
    t_b = t.reshape((-1,) + (1,) * (x1.ndim - 1))
    xt = (1.0 - (1.0 - sigma_min) * t_b) * x0 + t_b * x1
    ut = x1 - (1.0 - sigma_min) * x0
    return t, xt, ut


def _stats(x, prefix):
    return {
        f"{prefix}_max": x.max(),
        f"{prefix}_min": x.min(),
        f"{prefix}_mean": x.mean(),
        f"{prefix}_std": x.std(correction=0),
    }


def flow_matching_loss(v_pred, u_target, valid_mask, group=None):
    """Masked MSE over valid cells, and the per-step statistics the JAX
    package logs (ut/vt/loss min/max/mean/std; the loss statistics over valid
    entries only).  Returns (loss, stats) as 0-dim tensors: nothing is read
    back to the host here.

    ``group``: the data-parallel process group, the batch's rows sharded
    over it.  ``loss`` is then this rank's squared error over the GLOBAL
    valid count (the count summed with no gradient path), whose gradients
    SUM over the ranks to the global loss's; the statistics are the global
    batch's (``stats["loss_mean"]`` the global loss)."""
    se = (v_pred - u_target) ** 2
    m = valid_mask
    while m.ndim < se.ndim:
        m = m[..., None]
    m = m.to(se.dtype)
    n_valid = m.sum() if group is None else all_reduce_sum(m.sum(), group)
    n_valid = n_valid.clamp_min(1.0)
    loss = (se * m).sum() / n_valid
    if group is not None:
        return loss, _global_stats(u_target, v_pred, se, m, loss, n_valid, group)

    valid = m > 0
    nan = torch.full((), float("nan"), dtype=se.dtype, device=se.device)
    any_valid = valid.any()
    stats = {}
    stats.update(_stats(u_target, "ut"))
    stats.update(_stats(v_pred, "vt"))
    stats.update(
        {
            "loss_max": torch.where(any_valid, torch.where(valid, se, -torch.inf).amax(), nan),
            "loss_min": torch.where(any_valid, torch.where(valid, se, torch.inf).amin(), nan),
            "loss_mean": loss,
            "loss_std": torch.sqrt(
                (((se - loss) ** 2 * m).sum() / (n_valid - 1.0).clamp_min(1.0)).clamp_min(0.0)
            ),
        }
    )
    return loss, stats


@torch.no_grad()
def _global_stats(u, v, se, m, loss_share, n_valid, group):
    """``flow_matching_loss``'s statistics over the rows of every rank of
    ``group``: one sum, one max and one more sum over the group."""
    valid = m > 0
    sums = all_reduce_sum(torch.stack([u.sum(), v.sum(), loss_share, m.sum(), u.new_tensor(float(u.numel()))]), group)
    ext = torch.stack([u.max(), v.max(), -u.min(), -v.min(), torch.where(valid, se, -torch.inf).amax(),
                       -torch.where(valid, se, torch.inf).amin()])
    dist.all_reduce(ext, op=dist.ReduceOp.MAX, group=group)
    n = sums[4]
    mu_u, mu_v, loss = sums[0] / n, sums[1] / n, sums[2]
    sq = all_reduce_sum(torch.stack([((u - mu_u) ** 2).sum(), ((v - mu_v) ** 2).sum(), ((se - loss) ** 2 * m).sum()]),
                        group)
    nan = torch.full((), float("nan"), dtype=se.dtype, device=se.device)
    any_valid = sums[3] > 0
    return {
        "ut_max": ext[0], "ut_min": -ext[2], "ut_mean": mu_u, "ut_std": torch.sqrt(sq[0] / n),
        "vt_max": ext[1], "vt_min": -ext[3], "vt_mean": mu_v, "vt_std": torch.sqrt(sq[1] / n),
        "loss_max": torch.where(any_valid, ext[4], nan), "loss_min": torch.where(any_valid, -ext[5], nan),
        "loss_mean": loss,
        "loss_std": torch.sqrt((sq[2] / (n_valid - 1.0).clamp_min(1.0)).clamp_min(0.0)),
    }
