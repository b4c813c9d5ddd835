"""Differentiable collectives over a process group, written out by hand.

The counterparts of the JAX package's ``shard_map`` collectives, each with the
transpose JAX gives it:

  * ``psum``: all-reduce (sum) forward and backward — the adjoint of a sum
    over ranks whose result feeds each rank's OWN share of the loss (the
    pooled context of a sequence shard, ``ops/masked.py::masked_mean``);
  * ``all_gather``: shards concatenated along an axis; the backward
    all-reduces the cotangent and takes this rank's slice (JAX's
    psum-scatter, written with all-reduce because gloo may lack
    reduce-scatter);
  * ``ppermute``: each rank's tensor to the rank ``shift`` places further
    round the group (``batch_isend_irecv``); the backward sends the
    cotangent the other way.  At group size 1 it is the identity: no send
    to self is posted.

With ``group=None`` each is the identity.  Boolean masks are carried as
uint8 and come back boolean.  Megatron's ``f``/``g`` pair is in
``ops/tp.py``.  Host objects (metrics, lists of numpy arrays) go through
``gather_object`` and ``broadcast_object``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce_sum(x, group):
    """Sum of ``x`` over the group, outside autograd (a new tensor)."""
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def _gather(x, group, dim):
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _shift(x, group, shift):
    n = dist.get_world_size(group)
    if n == 1:
        return x
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    ops = [dist.P2POp(dist.isend, x.contiguous(), dst, group), dist.P2POp(dist.irecv, out, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.width = group, dim, x.shape[dim]
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_sum(g, ctx.group)
        start = dist.get_rank(ctx.group) * ctx.width
        return g.narrow(ctx.dim, start, ctx.width), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.shift), None, None


def psum(x, group):
    """All-reduce (sum) with the all-reduce backward."""
    return x if group is None else _PSum.apply(x, group)


def all_gather(x, group, dim: int = 1):
    """This group's shards of ``x`` concatenated along ``dim`` in rank order
    (JAX ``all_gather(..., tiled=True)``); equal shard widths."""
    if group is None:
        return x
    if x.dtype == torch.bool:
        return _gather(x.to(torch.uint8), group, dim).bool()
    return _AllGather.apply(x, group, dim)


def ppermute(x, group, shift: int = 1):
    """``x`` of the rank ``shift`` places back round the group (each rank
    sends its own ``shift`` places on); the ring's rotation."""
    if group is None:
        return x
    if x.dtype == torch.bool:
        return _shift(x.to(torch.uint8), group, shift).bool()
    return _PPermute.apply(x, group, shift)


def all_reduce_grads(grads, group):
    """Sum a list of gradients over the group in one all-reduce of their
    concatenation; returns new tensors in the same shapes."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return [t.view_as(g) for t, g in zip(flat.split([g.numel() for g in grads]), grads)]


def gather_object(obj, group) -> list:
    """Every rank's picklable ``obj`` of the group, in rank order."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj, group):
    """The group's first rank's picklable ``obj``, on every rank of the group."""
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
    return box[0]
