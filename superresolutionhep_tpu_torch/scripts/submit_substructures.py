"""Substructure fan-out submitter with per-job status tracking.

The port's copy of the JAX package's ``scripts/submit_substructures.py``:
chunk the event range, create one status file per job (removed on success),
and run the chunks through a backend:

  * ``local``: a pool of processes on this host, one
    ``python -m superresolutionhep_tpu_torch.scripts.compute_substructures``
    per chunk;
  * ``print``: dry run, print those commands.

(Submission to a PBS cluster stays with the JAX package's script and its
node wrapper.)  ``merge_substructures`` refuses to merge while any status
file remains or any error log is non-empty.

    python -m superresolutionhep_tpu_torch.scripts.submit_substructures -fp pred.h5 -cs 10 --workers 4
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..data import root_io
from . import REPO_ROOT


def chunk_command(file_path, start, stop, save_dir, res_factor):
    return [sys.executable, "-m", "superresolutionhep_tpu_torch.scripts.compute_substructures",
            "-fp", file_path, "-estart", str(start), "-estop", str(stop), "-sd", save_dir,
            "--res_factor", str(res_factor)]


def run_local_job(job):
    file_path, start, stop, save_dir, res_factor = job
    status = os.path.join(save_dir, "status", f"job_{start}_{stop}.status")
    err_log = os.path.join(save_dir, f"error_{start}_{stop}.log")
    # the worker imports this package from the checkout it runs from
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (REPO_ROOT, os.environ.get("PYTHONPATH")) if p))
    with open(err_log, "w") as ef:
        rc = subprocess.call(chunk_command(file_path, start, stop, save_dir, res_factor), stderr=ef, env=env)
    if rc == 0:
        if os.path.getsize(err_log) == 0:
            os.remove(err_log)
        os.remove(status)
    return rc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--file_path", "-fp", type=str, required=True)
    ap.add_argument("--chunk_size", "-cs", type=int, default=10)
    ap.add_argument("--backend", choices=["local", "print"], default="local")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--res_factor", type=int, default=2)
    args = ap.parse_args(argv)

    n_events = root_io.num_entries(args.file_path, "Low_Tree")
    splits = np.array_split(np.arange(n_events), int(np.ceil(n_events / args.chunk_size)))

    dst_dir = os.path.join(Path(args.file_path).parent, "substructures")
    status_dir = os.path.join(dst_dir, "status")
    os.makedirs(status_dir, exist_ok=True)

    jobs = []
    for sp in splits:
        start, stop = int(sp[0]), int(sp[-1]) + 1
        Path(os.path.join(status_dir, f"job_{start}_{stop}.status")).touch()
        jobs.append((args.file_path, start, stop, dst_dir, args.res_factor))

    print(f"total job count: {len(jobs)}")

    if args.backend == "local":
        # each job is a process of its own: threads only wait on them
        with ThreadPoolExecutor(max_workers=args.workers) as ex:
            rcs = list(ex.map(run_local_job, jobs))
        bad = [j for j, rc in zip(jobs, rcs) if rc != 0]
        if bad:
            print(f"{len(bad)} job(s) FAILED; status files remain for: {[(j[1], j[2]) for j in bad]}")
            sys.exit(1)
        print("all jobs finished")
    else:
        for job in jobs:
            print(" ".join(chunk_command(*job)))
    return dst_dir


if __name__ == "__main__":
    main()
