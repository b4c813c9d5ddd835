"""Process-group start and host-sharded event ranges.

Counterpart of the JAX package's ``parallel/distributed.py``:

  * :func:`initialize` starts ``torch.distributed`` from the torchrun
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``)
    or from an explicit store, rank and world size.  Unlike the JAX version
    it swallows nothing: a group that fails to come up raises, it never
    quietly becomes a single process;
  * :func:`host_entry_range` — the [start, stop) event range of one process,
    the balanced split of the JAX version.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from ..inference.sr import resolve_device

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device="cuda") -> torch.device:
    """This rank's device: a bare ``cuda`` takes the index ``LOCAL_RANK``
    (torchrun's) where it is set, else the current device; an explicit index
    is kept (several ranks on one card name it alike)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return resolve_device(device)


def initialize(backend: Optional[str] = None, device="cuda", store=None, rank: Optional[int] = None,
               world_size: Optional[int] = None, timeout_s: float = 600.0) -> bool:
    """Start the default process group; returns True when one is up.

    With ``store`` (a ``torch.distributed.Store``), ``rank`` and
    ``world_size`` are required; otherwise the torchrun environment is read,
    and without it nothing is started and False is returned.  ``backend``
    defaults to NCCL for a CUDA ``device`` and gloo for the CPU; it is never
    swapped for another after a failure.  A CUDA rank's device becomes the
    current one (``rank_device``) before the group starts."""
    if dist.is_initialized():
        return True
    if store is None and not all(k in os.environ for k in TORCHRUN_ENV):
        return False
    device = rank_device(device)
    backend = backend or default_backend(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = dict(backend=backend, timeout=timedelta(seconds=timeout_s))
    if store is not None:
        if rank is None or world_size is None:
            raise ValueError("initialize(store=...) needs rank and world_size")
        dist.init_process_group(store=store, rank=rank, world_size=world_size, **kw)
    else:
        dist.init_process_group(init_method="env://", **kw)
    return True


def host_entry_range(n_events: int, process_id: Optional[int] = None, process_count: Optional[int] = None) -> tuple:
    """[start, stop) event range owned by one process (balanced split); the
    process index and count default to this rank and the world size (0 and 1
    without a process group)."""
    up = dist.is_initialized()
    pid = (dist.get_rank() if up else 0) if process_id is None else process_id
    n_proc = (dist.get_world_size() if up else 1) if process_count is None else process_count
    base, rem = divmod(n_events, n_proc)
    start = pid * base + min(pid, rem)
    stop = start + base + (1 if pid < rem else 0)
    return start, stop
