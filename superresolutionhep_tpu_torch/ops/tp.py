"""Tensor-parallel collective operators (Megatron's ``f``/``g`` pair).

Counterpart of the JAX package's ``ops/tp.py``.  Megatron tensor parallelism
splits each transformer block into a column-parallel projection (Q/K/V, MLP
fc1: output features sharded) followed by a row-parallel one (attention out,
MLP fc2: input features sharded) whose partial products all-reduce over the
``model`` group.  Correct gradients need both conjugate operators:

  g = ``tp_allreduce``: all-reduce forward, identity backward.  Everything
      after it is replicated over the group and every rank computes the same
      loss, so the cotangent arriving at g is already the whole one; an
      all-reduce there would multiply it by the group size at every crossing.

  f = ``tp_block_input``: identity forward, all-reduce backward, at the
      entry of each sharded block.  Without it the cotangent leaving a
      rank's Q/K/V (or fc1) slice is only that shard's part, and every
      replicated module upstream would accumulate partial, rank-varying
      gradients.

With both, every cotangent upstream of the sharded blocks is complete and the
same on every model rank, so a replicated parameter's gradient needs no
model-group reduction, and the gradient of the row-parallel bias's divided
view equals the full bias's (``parallel/tp.py``).
"""

from __future__ import annotations

import torch

from ..parallel.comm import all_reduce_sum


class _F(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _G(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_block_input(x, group):
    """Megatron ``f``: identity forward, all-reduce backward over ``group``
    (None: the identity both ways).  Apply to every replicated activation
    entering a column-parallel projection."""
    return x if group is None else _F.apply(x, group)


def tp_allreduce(x, group):
    """Megatron ``g``: all-reduce forward over ``group``, identity backward
    (None: the identity).  Apply to every row-parallel partial product."""
    return x if group is None else _G.apply(x, group)
