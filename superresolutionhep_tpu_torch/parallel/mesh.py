"""A named mesh of ranks and the sharding of host batches over it.

Counterpart of the JAX package's ``parallel/mesh.py`` (and of the meshes
``parallel/sp.py`` / ``parallel/tp.py`` build there): the world's ranks laid
out row-major on named axes — ``data`` (batch rows), ``seq`` (the cell axis)
and ``model`` (attention heads and the DiT MLP's hidden width) — with the
process groups the entry points reduce over: each axis alone, and
(``data``, ``seq``) where the mesh has both (the gradient sum of the SP train
step), each among the ranks that share the coordinates of the other axes.

Every group is made with ``torch.distributed.new_group`` on every rank in one
order (its creation is collective), with the default group's backend.  A group
of one rank is made too: the collectives run through it unchanged at size 1.
"""

from __future__ import annotations

import itertools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA, SEQ, MODEL = "data", "seq", "model"


class Mesh:
    """``Mesh({"data": 2, "seq": 2})``: the axes in order and their sizes;
    their product must be the world size.  ``group(*axes)`` is this rank's
    process group over one axis or over (``data``, ``seq``), ``size(*axes)``
    the size of any subset of the axes and ``index(axis)`` this rank's
    coordinate on an axis."""

    def __init__(self, shape: Dict[str, int]):
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs a process group: call parallel.distributed.initialize() first")
        self.names: Tuple[str, ...] = tuple(shape)
        self.sizes: Tuple[int, ...] = tuple(int(shape[n]) for n in self.names)
        world = dist.get_world_size()
        if int(np.prod(self.sizes)) != world:
            raise ValueError(f"mesh {dict(shape)} has {int(np.prod(self.sizes))} ranks; the world has {world}")
        self.rank = dist.get_rank()
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank, self.sizes))
        grid = np.arange(world).reshape(self.sizes)
        families = [(a,) for a in range(len(self.names))]
        if DATA in self.names and SEQ in self.names:
            families.append(tuple(sorted((self.names.index(DATA), self.names.index(SEQ)))))
        self._groups = {}
        for axes in families:
            rest = [a for a in range(len(self.names)) if a not in axes]
            # one group per coordinate of the other axes, made by every rank
            for fixed in itertools.product(*(range(self.sizes[a]) for a in rest)):
                index = [slice(None)] * len(self.names)
                for a, c in zip(rest, fixed):
                    index[a] = c
                ranks = sorted(int(r) for r in grid[tuple(index)].ravel())
                group = dist.new_group(ranks=ranks)
                if self.rank in ranks:
                    self._groups[tuple(self.names[a] for a in axes)] = group

    def _key(self, axes: Sequence[str]) -> Tuple[str, ...]:
        unknown = [a for a in axes if a not in self.names]
        if unknown or not axes:
            raise KeyError(f"axes {tuple(axes)} are not a subset of the mesh's {self.names}")
        return tuple(n for n in self.names if n in axes)

    def group(self, *axes: str):
        key = self._key(axes)
        if key not in self._groups:
            raise KeyError(f"the mesh makes groups over each axis and (data, seq), not over {key}")
        return self._groups[key]

    def size(self, *axes: str) -> int:
        key = self._key(axes)
        return int(np.prod([self.sizes[self.names.index(a)] for a in key]))

    def index(self, axis: str) -> int:
        return self.coords[self.names.index(self._key((axis,))[0])]

    def has(self, axis: str) -> bool:
        return axis in self.names


def make_mesh(**shape: int) -> Mesh:
    """``make_mesh(data=2, seq=2)``; with no axes, ``data`` over the world."""
    return Mesh(shape or {DATA: dist.get_world_size()})


def shard_rows(x, n: int, i: int, dim: int = 0):
    """Block ``i`` of ``n`` equal blocks of ``x`` along ``dim`` (numpy or
    torch); the length must divide evenly."""
    L = x.shape[dim]
    if L % n:
        raise ValueError(f"axis {dim} of length {L} does not split into {n} equal shards")
    w = L // n
    index = [slice(None)] * x.ndim
    index[dim] = slice(i * w, (i + 1) * w)
    return x[tuple(index)]


def shard_batch(batch: dict, mesh: Mesh, cells: bool = False, pf: bool = False) -> dict:
    """This rank's part of a global host batch: its block of rows over
    ``data`` (the JAX package's ``P('data')``), and with ``cells`` its block
    of the cell axis (axis 1) over ``seq`` (``P('data', 'seq')``): of every
    entry with two or more axes, or with ``pf`` (a stage-2 batch) of the
    ``cell_*`` entries and the incidence matrix alone, the particle entries
    keeping their whole axis 1 (the JAX package's ``_pf_batch_specs``).  Entries that are not arrays (jagged lists)
    are left whole."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, (np.ndarray, torch.Tensor)) or v.ndim == 0:
            out[k] = v
            continue
        if mesh.has(DATA):
            v = shard_rows(v, mesh.size(DATA), mesh.index(DATA), 0)
        if cells and mesh.has(SEQ) and v.ndim >= 2 and (not pf or k.startswith("cell_") or k == "incidence_matrix"):
            v = shard_rows(v, mesh.size(SEQ), mesh.index(SEQ), 1)
        out[k] = v
    return out
