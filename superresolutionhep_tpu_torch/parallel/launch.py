"""Start ranks on one host: spawned processes joined over a ``FileStore``.

``run_ranks(fn, world_size, args)`` runs ``fn(rank, world_size, *args)`` in
``world_size`` processes started with the ``spawn`` method (CUDA does not
survive ``fork``), each with a default process group from
``parallel/distributed.py::initialize`` over a ``FileStore`` in a fresh
temporary directory, and returns their results in rank order.  ``fn`` must be
importable by name (a module-level function).  The arguments go to the ranks
through a file in that directory, not through the process start: a rank that
dies while starting then cannot block its parent on a full pipe.  Tensors in
a result come back as numpy arrays.

The CUDA kernels are built by the caller's process before any rank starts
(``ops/kernels.py`` builds at first use into one directory, and two ranks
building at once would race); the ranks then load the built library.

A rank that raises fails the call with its traceback; at ``timeout_s`` the
call raises ``TimeoutError``.  Either way every rank still alive is killed, so
a hung rendezvous or collective costs one call, not the caller.  For several
hosts, start one process per rank with ``torchrun`` and call ``initialize()``.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from ..inference.sr import resolve_device
from .distributed import default_backend, initialize

KILL_GRACE_S = 5.0


def _to_host(obj):
    """Tensors -> numpy arrays, through dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(fn, rank, world_size, store_path, backend, device, args_path, results):
    try:
        if str(device) == "cuda":  # a bare cuda: one card per rank, as torchrun's LOCAL_RANK gives
            os.environ["LOCAL_RANK"] = str(rank)
        with open(args_path, "rb") as fp:  # written by run_ranks
            args = pickle.load(fp)
        store = dist.FileStore(store_path, world_size)
        initialize(backend=backend, device=device, store=store, rank=rank, world_size=world_size)
        results.put((rank, True, _to_host(fn(rank, world_size, *args))))
    except Exception:  # the rank's boundary: report the traceback to the caller
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size: int, args=(), backend: Optional[str] = None, device="cuda",
              timeout_s: float = 120.0) -> list:
    """Results of ``fn(rank, world_size, *args)`` on ``world_size`` spawned
    ranks, in rank order.  ``device`` (default ``cuda``; raises without a
    card) and ``backend`` (default NCCL for CUDA, gloo for the CPU) go to
    ``initialize``.  A bare ``cuda`` puts rank r on card r (NCCL needs one
    card per rank); ``cuda:0`` puts every rank on card 0 (gloo only)."""
    resolve_device(device)  # no card -> raise here, before any rank starts
    backend = backend or default_backend(device)
    if torch.device(device).type == "cuda":
        from ..ops import kernels

        kernels.build()
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="srhep_ranks_")
    results = ctx.Queue()
    args_path = os.path.join(tmp, "args.pkl")
    with open(args_path, "wb") as fp:
        pickle.dump(tuple(args), fp)
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, rank, world_size, os.path.join(tmp, "store"), backend, device, args_path, results))
        for rank in range(world_size)]
    deadline = time.monotonic() + timeout_s
    got, ok = {}, False
    try:
        for p in procs:
            p.start()
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(got))} did not finish in "
                                   f"{timeout_s} s")
            try:
                rank, rank_ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited without a result "
                                       f"(exit codes {[procs[r].exitcode for r in dead]})")
                continue
            if not rank_ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            got[rank] = payload
        ok = True
    finally:
        for p in procs:
            if p.pid is None:  # never started
                continue
            p.join(max(deadline - time.monotonic(), 0.0) if ok else KILL_GRACE_S)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(world_size)]
