"""Hungarian-matched set-to-set losses for particle-flow training.

Counterpart of the JAX package's ``losses/set2set.py``.  For up to
``MAX_EXHAUSTIVE_P`` particles (4 in every shipped configuration) the optimal
assignment is an exhaustive argmin over all P! permutations on the device:
exact, batched, no host round trip; ``torch.argmin`` takes the first minimum,
as ``jnp.argmin`` does.  Beyond that scipy's ``linear_sum_assignment`` runs on
the host, event by event.

Cost-mask convention: real x real keeps the cost, real x pad gets +1e6 (real
particles are matched to real predictions first), pad x pad gets 0.  Batch
means are taken over real events only where an ``event_mask`` is given
(bucketed batches carry filler slots).
"""

from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np
import torch

from ..parallel.comm import all_reduce_sum, psum

BIG = 1.0e6
EPS = 1e-8
MAX_EXHAUSTIVE_P = 8  # 8! = 40320 permutations


@lru_cache(maxsize=None)
def _permutations(p: int) -> np.ndarray:
    return np.array(list(itertools.permutations(range(p))), dtype=np.int64)


def pad_cost_masks(part_valid):
    """(not_q4, q2_q3_inf) from the particle validity mask (B, P)."""
    pv = part_valid.float()
    sum_mask = pv[:, None, :] + pv[:, :, None]  # (B, P, P): 2 = real x real, 1 = real x pad, 0 = pad x pad
    q2_q3_inf = (sum_mask == 1.0).float() * BIG
    not_q4 = (sum_mask != 0.0).float()
    return not_q4, q2_q3_inf


def hungarian(cost):
    """Optimal assignment of a (B, P, P) cost batch: ``col_of_row`` (B, P),
    for truth row i the matched prediction column.  Exhaustive on the
    cost's device for P <= MAX_EXHAUSTIVE_P, scipy on the host beyond."""
    B, P = cost.shape[0], cost.shape[-1]
    if P <= MAX_EXHAUSTIVE_P:
        perms = torch.from_numpy(_permutations(P)).to(cost.device)  # (P!, P)
        rows = torch.arange(P, device=cost.device)
        perm_costs = cost[:, rows, perms].sum(-1)  # (B, P!): sum_i cost[b, i, perm[i]]
        return perms[torch.argmin(perm_costs, dim=-1)]
    from scipy.optimize import linear_sum_assignment

    host = cost.detach().float().cpu().numpy()
    out = np.zeros((B, P), np.int64)
    for b in range(B):
        out[b] = linear_sum_assignment(host[b])[1]
    return torch.from_numpy(out).to(cost.device)


def _gather_matched(cost_terms, assign):
    """cost_terms (B, P, P) keyed [truth_i, pred_j]; assign (B, P) -> (B, P)."""
    B, P = assign.shape
    return cost_terms[torch.arange(B, device=assign.device)[:, None], torch.arange(P, device=assign.device)[None, :],
                      assign]


def _event_weighted_mean(per_event, event_mask, n_events=None):
    """Mean of a (B,) per-event vector over real events (plain mean without a
    mask).  ``n_events``: the count of real events to divide by in place of
    this batch's (a data-parallel rank's share of the global mean)."""
    if event_mask is None:
        return per_event.mean()
    w = event_mask.to(per_event.dtype)
    return (per_event * w).sum() / (w.sum() if n_events is None else n_events).clamp_min(1.0)


def _event_weighted_mean2(per_slot, event_mask, n_events=None):
    """Mean of a (B, P) per-slot tensor over the real events' slots."""
    if event_mask is None:
        return per_slot.mean()
    w = event_mask.to(per_slot.dtype)[:, None]
    n = w.sum() if n_events is None else n_events
    return (per_slot * w).sum() / (n * per_slot.shape[1]).clamp_min(1.0)


# ---------------------------------------------------------------------------
# kinematics variant
# ---------------------------------------------------------------------------


def kinematics_pairwise_cost(kin_pred, batch, weights):
    """Pairwise weighted cost (B, P, P), [truth_i, pred_j]; kin_pred (B, P, 4)
    = (pt, eta, phi, e) in target space, truth from part_pt / part_eta /
    part_phi / part_dep_e (the deposited energy is the energy target)."""
    pred = [kin_pred[:, None, :, i] for i in range(4)]
    tr = [batch[k][:, :, None] for k in ("part_pt", "part_eta", "part_phi", "part_dep_e")]
    not_q4, q2_q3_inf = pad_cost_masks(batch["part_mask"])
    raw = {
        "pt_loss": weights["pt_loss_wt"] * (pred[0] - tr[0]) ** 2,
        "eta_loss": weights["eta_loss_wt"] * (pred[1] - tr[1]) ** 2,
        "phi_loss": weights["phi_loss_wt"] * (1.0 - torch.cos(pred[2] - tr[2])),
        "e_loss": weights["e_loss_wt"] * (pred[3] - tr[3]) ** 2,
    }
    terms = {k: v * not_q4 + q2_q3_inf for k, v in raw.items()}
    return sum(terms.values()), terms


def set_to_set_kinematics_loss(kin_pred, batch, config, event_mask=None, n_events=None):
    """Returns (loss, components, assign (B, P): truth row -> matched
    prediction); ``n_events`` as for ``_event_weighted_mean``."""
    weights = {k: float(config.get(k, 1.0)) for k in ("pt_loss_wt", "eta_loss_wt", "phi_loss_wt", "e_loss_wt")}
    total, terms = kinematics_pairwise_cost(kin_pred, batch, weights)
    assign = hungarian(total.detach())
    loss = _event_weighted_mean(_gather_matched(total, assign).mean(dim=1), event_mask, n_events)
    components = {k: _event_weighted_mean2(_gather_matched(v, assign), event_mask, n_events)
                  for k, v in terms.items()}
    return loss, components, assign


# ---------------------------------------------------------------------------
# incidence variant
# ---------------------------------------------------------------------------


def incidence_pairwise_cost(inc_weights, batch, group=None):
    """Masked-KL pairwise cost (B, P, P): truth incidence row i against
    predicted incidence row j, over the valid cells.

    ``group``: the sequence-parallel group when the cell axis is sharded over
    it: each shard's partial KL sums (with the all-reduce backward) and its
    cell counts are summed over the group into the exact global cost, the
    same on every shard (the KL is a plain sum over cells)."""
    cell_mask = batch["cell_mask"].float()  # (B, N)
    target = batch["incidence_matrix"].transpose(1, 2) * cell_mask[:, None, :]  # (B, P, N)
    inp = inc_weights * cell_mask[:, None, :]
    kld = -torch.einsum("bin,bjn->bij", target, torch.log(inp + EPS))
    n_cells = cell_mask.sum(-1)
    if group is not None:
        kld, n_cells = psum(kld, group), all_reduce_sum(n_cells, group)
    kld = kld / n_cells.clamp_min(1.0)[:, None, None]
    not_q4, q2_q3_inf = pad_cost_masks(batch["part_mask"])
    return kld * not_q4 + q2_q3_inf


def set_to_set_incidence_loss(inc_weights, batch, kin_pred, event_mask=None, n_events=None):
    """Returns (loss, components, assign).  The kinematics components are
    computed after the assignment, for logging only; ``n_events`` as for
    ``_event_weighted_mean``."""
    pdist = incidence_pairwise_cost(inc_weights, batch)
    assign = hungarian(pdist.detach())
    loss = _event_weighted_mean(_gather_matched(pdist, assign).mean(dim=1), event_mask, n_events)
    B = assign.shape[0]
    kin = kin_pred[torch.arange(B, device=assign.device)[:, None], assign, :]  # (B, P, 4)

    def wm(x):
        return _event_weighted_mean2(x, event_mask, n_events)

    comps = {
        "pt_loss": wm((kin[:, :, 0] - batch["part_pt"]) ** 2),
        "eta_loss": wm((kin[:, :, 1] - batch["part_eta"]) ** 2),
        "phi_loss": wm(1.0 - torch.cos(kin[:, :, 2] - batch["part_phi"])),
        "e_loss": wm((kin[:, :, 3] - batch["part_dep_e"]) ** 2),
    }
    comps["kin_loss"] = comps["pt_loss"] + comps["eta_loss"] + comps["phi_loss"] + comps["e_loss"]
    return loss, comps, assign
