"""Sequence (context) parallelism for the SR flow model and the stage-2 SAPF.

Counterpart of the JAX package's ``parallel/sp.py``: cells are sharded over
the ``seq`` group; per-cell modules run locally, the pooled conditioning
vector sums over ``seq`` (``ops/masked.py::masked_mean``), and attention
gathers the keys and values (``sp_mode='gather'``: the flash kernel with
local queries against all keys) or rotates them round the group (``'ring'``,
ops/ring_attention.py) while the queries stay local.  Composes with data
parallelism on a (``data``, ``seq``) mesh: rows over ``data``, cells over
``seq``, parameters replicated, gradients summed over both.

The train step takes ``t`` and each shard's ``x0`` as inputs (the port's rule
that parity takes the noise as an input): the JAX step's split-then-fold
streams are reproduced by the tests, which inject them.  The shared
machinery (model build, parameter views, the step) is in parallel/tp.py.

The SAPF (``make_pf_sp_forward``, ``make_pf_sp_train_step``; the JAX
package's namesakes): the cell entries and the incidence matrix are sharded
over ``seq`` (``mesh.py::shard_batch(..., cells=True, pf=True)``), the
particle entries stay whole on every shard; the pools, the kinematic head's
cell sums and the incidence cost are summed over ``seq``, the kinematics
cross-attention gathers (or rotates) the cell keys and values under the
whole particle queries, and the Hungarian assignment runs on the summed cost,
the same on every shard.
"""

from __future__ import annotations

from .mesh import MODEL, SEQ, Mesh
from .tp import make_forward, make_pf_forward, make_pf_train_step, make_train_step


def _check(mesh: Mesh, what: str):
    """A (data, seq) mesh, without a model axis."""
    if not mesh.has(SEQ) or mesh.has(MODEL):
        raise ValueError(f"{what} takes a (data, seq) mesh; with a model axis use parallel/tp.py")


def make_sp_forward(flow_config: dict, mesh: Mesh, dtype=None, sp_mode: str = "gather", attn_impl: str = "auto",
                    device="cuda"):
    """Returns (model, forward): ``forward(params, batch, noisy, t)`` runs the
    FlowModel on this rank's rows and cells; ``sp_mode`` picks gather or
    ring K/V movement."""
    _check(mesh, "make_sp_forward")
    return make_forward(flow_config, mesh, dtype, attn_impl, sp_mode, device)


def make_sp_train_step(flow_config: dict, mesh: Mesh, sigma_min: float, dtype=None, sp_mode: str = "gather",
                       attn_impl: str = "auto", device="cuda"):
    """dp x sp flow-matching train step: each shard's loss share over the
    GLOBAL cell count, gradients summed over (``data``, ``seq``); see
    ``parallel/tp.py::make_train_step``."""
    _check(mesh, "make_sp_train_step")
    return make_train_step(flow_config, mesh, sigma_min, dtype, attn_impl, sp_mode, device)


def make_pf_sp_forward(config_pf: dict, transforms, mesh: Mesh, dtype=None, sp_mode: str = "gather",
                       attn_impl: str = "auto", device="cuda"):
    """Returns (model, forward): ``forward(params, batch, noise=None)`` runs the
    SAPF on this rank's rows and cells -> (logits, kinematics) whole over
    ``seq``, incidence weights over this rank's cells; ``sp_mode`` picks
    gather or ring K/V movement (``parallel/tp.py::make_pf_forward``)."""
    _check(mesh, "make_pf_sp_forward")
    return make_pf_forward(config_pf, transforms, mesh, dtype, attn_impl, sp_mode, device)


def make_pf_sp_train_step(config_pf: dict, transforms, mesh: Mesh, config_t=None, dtype=None,
                          sp_mode: str = "gather", attn_impl: str = "auto", device="cuda"):
    """Stage-2 dp x sp train step: each shard's share of the loss over the
    global real-event count times the ``seq`` size, gradients summed over
    (``data``, ``seq``); see ``parallel/tp.py::make_pf_train_step``."""
    _check(mesh, "make_pf_sp_train_step")
    return make_pf_train_step(config_pf, transforms, mesh, config_t, dtype, attn_impl, sp_mode, device)
