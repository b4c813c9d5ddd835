"""Tensor parallelism (Megatron head/MLP sharding) for the SR flow model.

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
dense_linear_indices``).  A ``Linear.weight`` is (out, in), the transpose of
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
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch

from ..flow.cfm import sample_location_and_conditional_flow
from ..inference.sr import resolve_device
from ..models.flow_model import FlowModel
from ..tools.convert import dense_linear_indices
from .comm import all_gather, all_reduce_grads, all_reduce_sum
from .mesh import DATA, MODEL, SEQ, Mesh, shard_rows

_DIT_LEAF = re.compile(
    r"^transformer\.layers\.\d+\.(mha\.(linear_q|linear_k|linear_v|linear_out)|dense\.net\.(\d+))\.(weight|bias)$")


def tp_role(key: str, flow_config: dict) -> Optional[str]:
    """'col_weight' | 'col_bias' | 'row_weight' | 'row_bias' | None
    (replicated) for a FlowModel ``state_dict`` key (``net.`` prefix
    allowed)."""
    key = key[4:] if key.startswith("net.") else key
    m = _DIT_LEAF.match(key)
    if m is None:
        return None
    _, mha_name, slot, leaf = m.groups()
    kind = None
    if mha_name in ("linear_q", "linear_k", "linear_v"):
        kind = "col"
    elif mha_name == "linear_out":
        kind = "row"
    elif slot is not None:
        j0, j1 = dense_linear_indices(flow_config["transformer"]["dense_config"])[:2]
        kind = {j0: "col", j1: "row"}.get(int(slot))
    return None if kind is None else f"{kind}_{leaf}"


def tp_param_view(params: Dict[str, torch.Tensor], flow_config: dict, n_tp: int, index: int) -> dict:
    """Rank ``index`` of ``n_tp``'s shard of full FlowModel parameters:
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


def load_view(model: FlowModel, params: Dict[str, torch.Tensor], flow_config: dict, mesh: Mesh):
    """Load this rank's view of full parameters (``state_dict`` names, with
    or without ``net.``) into a model from ``parallel_model``."""
    params = {(k[4:] if k.startswith("net.") else k): v for k, v in params.items()}
    if mesh.has(MODEL):
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
