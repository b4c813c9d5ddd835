"""Tensor parallelism (Megatron head/MLP sharding) for the SR flow model and
the stage-2 SAPF.

Counterpart of the JAX package's ``parallel/tp.py``: attention heads and the
DiT MLP's hidden width shard over the ``model`` group, with two reduce points
per DiT layer (attention output projection, MLP second product) summing
partial products, and everything else — embedders, LayerNorms, adaLN
modulation, the v_t head — replicated.

Parameter roles, on the port's own ``state_dict`` names:

  transformer.layers.{i}.mha.linear_{q,k,v}       column-parallel
  transformer.layers.{i}.mha.linear_out           row-parallel
  transformer.layers.{i}.dense.net.{j0}           column-parallel
  transformer.layers.{i}.dense.net.{j1}           row-parallel
  everything else (v_t_pred_net included)         replicated

with j0, j1 the DiT MLP's two Linear slots (``tools/convert.py::
dense_linear_indices``).  The SAPF's two DiT stacks take the same roles under
``encoder.transformer.layers.{i}`` and ``kinematics_predictor.transformer.
layers.{i}``, each with its own ``dense_config``; its kinematic head
(``kin_net.linear_{q,k}``), cardinality MLP, embedders and adaLN rows stay
replicated.  A ``Linear.weight`` is (out, in), the transpose of
a Flax kernel: a column shard takes ROWS of the weight (and of the bias), a
row shard takes COLUMNS of the weight.  A row-parallel bias is DIVIDED by the
group size in the sharded view (``tp_param_view``), so the forward sum adds
it once; the gradient of the divided leaf equals the full bias's, so it needs
no correction.

Every rank keeps the full (replicated) parameters; a forward or train step
loads this rank's view into a model built with LOCAL widths, and the train
step returns gradients in the full layout: sharded leaves gathered over
``model``, every leaf summed over ``data`` (and ``seq``).  The loss is this
rank's squared error over the GLOBAL masked cell count, the count summed with
no gradient path; gradients sum (not average) over the ranks, so the step
computes what the single-device step computes (``DistributedDataParallel``'s
mean of per-rank means would not wherever shards hold different cell counts).
Composes with sequence parallelism on a (``data``, ``seq``, ``model``) mesh.

The SAPF's steps (``make_pf_train_step``, shared with parallel/sp.py) follow
the JAX package's ``make_pf_{sp,tp}_train_step``: the loss is
``card_loss_weight`` x the cardinality cross-entropy plus the Hungarian-matched
set cost (incidence KL with ``loss_on_inc_wts``, the default, else the
kinematics cost), summed over the rank's real events — an event is real
where any shard of the sequence group holds a valid cell — and divided by
the GLOBAL real-event count times the ``seq`` size: every quantity entering
the loss is replicated over ``seq`` (the incidence cost is summed over it,
models/pf/*.py sum their pools), so the ``seq`` ranks' shares add up to the
loss once.  Under ``model`` the loss needs no collective at all.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch

from ..flow.cfm import sample_location_and_conditional_flow
from ..inference.sr import resolve_device
from ..losses.set2set import _gather_matched, hungarian, incidence_pairwise_cost, kinematics_pairwise_cost
from ..models.flow_model import FlowModel
from ..models.pf.model_pf import SAPF
from ..tools.convert import dense_linear_indices
from .comm import all_gather, all_reduce_grads, all_reduce_sum
from .mesh import DATA, MODEL, SEQ, Mesh, shard_rows

# a DiT stack's sharded leaves: the SR model's ``transformer``, the SAPF's
# ``encoder.transformer`` and ``kinematics_predictor.transformer``
_DIT_LEAF = re.compile(
    r"^((?:encoder\.|kinematics_predictor\.)?)transformer\.layers\.\d+\."
    r"(mha\.(linear_q|linear_k|linear_v|linear_out)|dense\.net\.(\d+))\.(weight|bias)$")


def tp_role(key: str, config: dict) -> Optional[str]:
    """'col_weight' | 'col_bias' | 'row_weight' | 'row_bias' | None
    (replicated) for a FlowModel ``state_dict`` key (``config``: its
    ``flow_model`` config) or a SAPF one (``config``: its ``pf_model``
    config); ``net.`` prefix allowed."""
    key = key[4:] if key.startswith("net.") else key
    m = _DIT_LEAF.match(key)
    if m is None:
        return None
    stack, _, mha_name, slot, leaf = m.groups()
    kind = None
    if mha_name in ("linear_q", "linear_k", "linear_v"):
        kind = "col"
    elif mha_name == "linear_out":
        kind = "row"
    elif slot is not None:
        part = config[stack[:-1]] if stack else config
        j0, j1 = dense_linear_indices(part["transformer"]["dense_config"])[:2]
        kind = {j0: "col", j1: "row"}.get(int(slot))
    return None if kind is None else f"{kind}_{leaf}"


def tp_param_view(params: Dict[str, torch.Tensor], flow_config: dict, n_tp: int, index: int) -> dict:
    """Rank ``index`` of ``n_tp``'s shard of full FlowModel (or SAPF)
    parameters:
    column leaves' rows, row weights' columns, row biases divided by n_tp,
    replicated leaves as they are."""
    out = {}
    for k, x in params.items():
        role = tp_role(k, flow_config)
        if role in ("col_weight", "col_bias"):
            x = shard_rows(x, n_tp, index, 0)
        elif role == "row_weight":
            x = shard_rows(x, n_tp, index, 1)
        elif role == "row_bias":
            x = x / n_tp
        out[k] = x
    return out


def tp_full_grads(grads: Dict[str, torch.Tensor], flow_config: dict, group) -> dict:
    """Gradients of a rank's view -> the full layout: column shards gathered
    along the weight's rows, row-weight shards along its columns (in rank
    order over ``group``); the row bias's and the replicated leaves' as they
    are."""
    out = {}
    for k, g in grads.items():
        role = tp_role(k, flow_config)
        if group is not None and role in ("col_weight", "col_bias", "row_weight"):
            g = all_gather(g, group, dim=1 if role == "row_weight" else 0)
        out[k] = g
    return out


def parallel_model(flow_config: dict, mesh: Mesh, dtype=None, attn_impl: str = "auto", sp_mode: str = "gather",
                   device="cuda") -> FlowModel:
    """A FlowModel bound to the mesh's ``seq`` and ``model`` groups (where
    the mesh has those axes), on ``device``, in fp32 parameters."""
    model = FlowModel(
        flow_config, attn_impl=attn_impl, dtype=dtype,
        sp_group=mesh.group(SEQ) if mesh.has(SEQ) else None, sp_mode=sp_mode,
        tp_group=mesh.group(MODEL) if mesh.has(MODEL) else None,
    )
    return model.to(resolve_device(device)).float().eval()


def load_view(model, params: Dict[str, torch.Tensor], flow_config: dict, mesh: Optional[Mesh]):
    """Load this rank's view of full parameters (``state_dict`` names, with
    or without ``net.``) into a model from ``parallel_model`` (or
    ``parallel_pf_model``)."""
    params = {(k[4:] if k.startswith("net.") else k): v for k, v in params.items()}
    if mesh is not None and mesh.has(MODEL):
        params = tp_param_view(params, flow_config, mesh.size(MODEL), mesh.index(MODEL))
    with torch.no_grad():
        model.load_state_dict(params)


def make_forward(flow_config: dict, mesh: Mesh, dtype=None, attn_impl: str = "auto", sp_mode: str = "gather",
                 device="cuda"):
    """Returns (model, forward): ``forward(params, batch, noisy, t)`` runs the
    FlowModel on this rank's shard (its rows over ``data``, its cells over
    ``seq`` where the mesh has it) with heads/MLP sharded over ``model``
    where it has that; ``params`` are the full replicated parameters."""
    model = parallel_model(flow_config, mesh, dtype, attn_impl, sp_mode, device)

    def forward(params, batch, noisy, t):
        load_view(model, params, flow_config, mesh)
        return model(batch, noisy, t)

    return model, forward


def make_train_step(flow_config: dict, mesh: Mesh, sigma_min: float, dtype=None, attn_impl: str = "auto",
                    sp_mode: str = "gather", device="cuda"):
    """Returns (model, step): ``step(params, batch, t, x0)`` -> (loss, grads)
    of the flow-matching loss on this rank's shard, with ``t`` (this rank's
    rows) and ``x0`` (this rank's shard of the noise) given.  ``loss`` is the
    global masked MSE (for logging), ``grads`` the full-layout gradients of
    it, the same on every rank: apply them with the caller's optimizer
    (``train/sr_trainer.py::AdamW``)."""
    model = parallel_model(flow_config, mesh, dtype, attn_impl, sp_mode, device)
    red = tuple(a for a in (DATA, SEQ) if mesh.has(a))
    group = mesh.group(*red) if red else None
    tp_group = mesh.group(MODEL) if mesh.has(MODEL) and mesh.size(MODEL) > 1 else None
    names = [n for n, _ in model.named_parameters()]

    def step(params, batch, t, x0):
        load_view(model, params, flow_config, mesh)
        _, xt, ut = sample_location_and_conditional_flow(batch["target"], sigma_min, t=t, x0=x0)
        vt = model(batch, xt, t)
        m = batch["q_mask"][..., None].to(vt.dtype)
        # this rank's squared-error share over the GLOBAL cell count: a sum
        # over ranks inside the differentiated function would multiply every
        # gradient by the rank count; the gradient sum below is the one
        # cross-rank accumulation
        n = m.sum() if group is None else all_reduce_sum(m.sum(), group)
        loss = ((vt - ut) ** 2 * m).sum() / n.clamp_min(1.0)
        grads = list(torch.autograd.grad(loss, list(model.parameters())))
        if group is not None:
            grads = all_reduce_grads(grads, group)
            loss = all_reduce_sum(loss, group)
        return loss.detach(), tp_full_grads(dict(zip(names, grads)), flow_config, tp_group)

    return model, step


def make_tp_forward(flow_config: dict, mesh: Mesh, dtype=None, attn_impl: str = "auto", device="cuda"):
    """dp x tp forward on a (``data``, ``model``) mesh."""
    if mesh.has(SEQ):
        raise ValueError("make_tp_forward takes a (data, model) mesh; use make_sp_tp_forward with seq")
    return make_forward(flow_config, mesh, dtype, attn_impl, device=device)


def make_sp_tp_forward(flow_config: dict, mesh: Mesh, dtype=None, sp_mode: str = "gather", attn_impl: str = "auto",
                       device="cuda"):
    """dp x sp x tp forward on a (``data``, ``seq``, ``model``) mesh: the
    sequence gather moves the token axis of head-local projections, the
    tensor sums reduce the feature axis of cell-local activations."""
    if not (mesh.has(SEQ) and mesh.has(MODEL)):
        raise ValueError("make_sp_tp_forward takes a (data, seq, model) mesh")
    return make_forward(flow_config, mesh, dtype, attn_impl, sp_mode, device)


def make_tp_train_step(flow_config: dict, mesh: Mesh, sigma_min: float, dtype=None, attn_impl: str = "auto",
                       device="cuda"):
    """dp x tp (or dp x sp x tp) flow-matching train step; see
    ``make_train_step``."""
    if not mesh.has(MODEL):
        raise ValueError("make_tp_train_step takes a mesh with a model axis")
    return make_train_step(flow_config, mesh, sigma_min, dtype, attn_impl, device=device)


# ---------------------------------------------------------------------------
# stage 2 (SAPF): shared by parallel/sp.py and the TP entry points below
# ---------------------------------------------------------------------------


def _axis_group(mesh: Optional[Mesh], axis: str):
    return mesh.group(axis) if mesh is not None and mesh.has(axis) else None


def parallel_pf_model(config_pf: dict, transforms, mesh: Optional[Mesh], dtype=None, attn_impl: str = "auto",
                      sp_mode: str = "gather", device="cuda") -> SAPF:
    """A SAPF bound to the mesh's ``seq`` and ``model`` groups (where the mesh
    has those axes; ``mesh=None``: one process, no group), on ``device``, in
    fp32 parameters."""
    model = SAPF(config_pf, transforms=transforms, attn_impl=attn_impl, dtype=dtype,
                 sp_group=_axis_group(mesh, SEQ), sp_mode=sp_mode, tp_group=_axis_group(mesh, MODEL))
    return model.to(resolve_device(device)).float().eval()


def make_pf_forward(config_pf: dict, transforms, mesh: Optional[Mesh], dtype=None, attn_impl: str = "auto",
                    sp_mode: str = "gather", device="cuda"):
    """Returns (model, forward): ``forward(params, batch, noise=None)`` runs the
    SAPF on this rank's shard (rows over ``data``; with ``seq``, the cell
    entries' block, ``mesh.py::shard_batch(..., pf=True)``) and returns
    (logits, kinematics, incidence weights): the first two whole over
    ``seq`` and ``model``, the incidence weights over this rank's cells.
    ``params`` are the full replicated parameters; ``noise`` the random
    slots' draws for this rank's rows.  ``mesh=None``: one process, the
    reference the sharded runs are held against."""
    model = parallel_pf_model(config_pf, transforms, mesh, dtype, attn_impl, sp_mode, device)

    def forward(params, batch, noise=None):
        load_view(model, params, config_pf, mesh)
        return model(batch, noise=noise)

    return model, forward


def make_pf_train_step(config_pf: dict, transforms, mesh: Optional[Mesh], config_t: Optional[dict] = None,
                       dtype=None, attn_impl: str = "auto", sp_mode: str = "gather", device="cuda"):
    """Returns (model, step): ``step(params, batch, noise=None)`` -> (loss,
    grads) of the stage-2 loss (module docstring) on this rank's shard:
    ``loss`` the global batch's (for logging), ``grads`` its full-layout
    gradients, the same on every rank; apply them with the caller's
    optimizer (``train/sr_trainer.py::AdamW``).  ``config_t``: the training
    config's ``loss_on_inc_wts`` (default True), ``card_loss_weight`` and
    kinematics weights.  ``mesh=None``: one process, no collective."""
    config_t = config_t or {}
    loss_on_inc = bool(config_t.get("loss_on_inc_wts", True))
    card_weight = float(config_t.get("card_loss_weight", 1.0))
    kin_weights = {k: float(config_t.get(k, 1.0)) for k in ("pt_loss_wt", "eta_loss_wt", "phi_loss_wt", "e_loss_wt")}
    model = parallel_pf_model(config_pf, transforms, mesh, dtype, attn_impl, sp_mode, device)
    seq_group, data_group = _axis_group(mesh, SEQ), _axis_group(mesh, DATA)
    n_seq = mesh.size(SEQ) if seq_group is not None else 1
    red = tuple(a for a in (DATA, SEQ) if mesh is not None and mesh.has(a))
    group = mesh.group(*red) if red else None
    tp_group = _axis_group(mesh, MODEL)
    tp_group = tp_group if tp_group is not None and mesh.size(MODEL) > 1 else None
    names = [n for n, _ in model.named_parameters()]

    def step(params, batch, noise=None):
        load_view(model, params, config_pf, mesh)
        # real (non-filler) events: a valid cell on any shard of the event
        has_cells = batch["cell_mask"].any(dim=-1).float()
        w = ((has_cells if seq_group is None else all_reduce_sum(has_cells, seq_group)) > 0).float()
        n_real = w.sum() if data_group is None else all_reduce_sum(w.sum(), data_group)
        card_logits, kin_pred, inc_weights = model(batch, noise=noise)
        loss_sum = 0.0
        if card_logits is not None:
            logp = torch.log_softmax(card_logits, dim=-1)
            ce = -torch.gather(logp, -1, batch["cardinality"][:, None].long())[:, 0]
            loss_sum = loss_sum + card_weight * (ce * w).sum()
        if kin_pred is not None:
            if loss_on_inc:
                pdist = incidence_pairwise_cost(inc_weights, batch, group=seq_group)
            else:
                pdist, _ = kinematics_pairwise_cost(kin_pred, batch, kin_weights)
            # the cost is the same on every seq shard, so every shard picks
            # the same assignment
            assign = hungarian(pdist.detach())
            loss_sum = loss_sum + (_gather_matched(pdist, assign).mean(dim=1) * w).sum()
        # loss_sum is whole on every seq shard: each takes 1/n_seq of it.  A
        # sum over ranks inside the differentiated function would multiply
        # every gradient by the rank count; the gradient sum below is the one
        # cross-rank accumulation
        loss = loss_sum / (n_real.clamp_min(1.0) * n_seq)
        grads = list(torch.autograd.grad(loss, list(model.parameters())))
        if group is not None:
            grads = all_reduce_grads(grads, group)
            loss = all_reduce_sum(loss, group)
        return loss.detach(), tp_full_grads(dict(zip(names, grads)), config_pf, tp_group)

    return model, step


def make_pf_tp_forward(config_pf: dict, transforms, mesh: Mesh, dtype=None, attn_impl: str = "auto", device="cuda"):
    """Stage-2 dp x tp forward on a (``data``, ``model``) mesh: both DiT
    stacks' heads and MLPs sharded over ``model``; outputs whole over it."""
    if not mesh.has(MODEL) or mesh.has(SEQ):
        raise ValueError("make_pf_tp_forward takes a (data, model) mesh; with seq use parallel/sp.py")
    return make_pf_forward(config_pf, transforms, mesh, dtype, attn_impl, device=device)


def make_pf_tp_train_step(config_pf: dict, transforms, mesh: Mesh, config_t: Optional[dict] = None, dtype=None,
                          attn_impl: str = "auto", device="cuda"):
    """Stage-2 dp x tp train step: gradients summed over ``data`` alone
    (Megatron's f makes the replicated leaves' whole on every model rank);
    see ``make_pf_train_step``."""
    if not mesh.has(MODEL) or mesh.has(SEQ):
        raise ValueError("make_pf_tp_train_step takes a (data, model) mesh; with seq use parallel/sp.py")
    return make_pf_train_step(config_pf, transforms, mesh, config_t, dtype, attn_impl, device=device)
