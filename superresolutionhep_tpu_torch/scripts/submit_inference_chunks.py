"""SR inference fan-out: chunk the event range and run the port's inference
CLI in batch mode (``-bm``) per chunk.

The port's copy of the JAX package's ``scripts/submit_inference_chunks.py``,
after the reference's fan-out over entry ranges (100-event chunks, one job
each).  Backends:

  * ``local``: subprocesses on this host, ``--workers`` at a time (each
    chunk is an independent process, restartable by rerunning its range);
  * ``pbs``: submit one qsub command per chunk;
  * ``print``: dry run, print them.

Chunk outputs are ``*_pred_{start}_{stop}.*`` files, what the PF stage
globs (data/pf_dataset.py::sorted_chunk_files).

    python -m superresolutionhep_tpu_torch.scripts.submit_inference_chunks -i inference_batch.yml -n 1000
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import REPO_ROOT


def chunk_command(inference_yaml, start, stop, device):
    return [sys.executable, "-m", "superresolutionhep_tpu_torch.cli.inference_sr", "-i", inference_yaml, "-bm",
            "-estart", str(start), "-estop", str(stop), "--device", device]


def run_chunk(job):
    # the chunk's process imports this package from the checkout it runs from
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (REPO_ROOT, os.environ.get("PYTHONPATH")) if p))
    return subprocess.call(chunk_command(*job), env=env)


def chunk_jobs(inference_yaml, n_events, entry_start, chunk_size, device):
    edges = np.arange(entry_start, entry_start + n_events + chunk_size, chunk_size)
    edges[-1] = min(edges[-1], entry_start + n_events)
    return [(inference_yaml, int(a), int(b), device) for a, b in zip(edges[:-1], edges[1:]) if b > a]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--inference_path", "-i", required=True, help="batch-mode inference YAML")
    ap.add_argument("--n_events", "-n", type=int, required=True)
    ap.add_argument("--entry_start", type=int, default=0)
    ap.add_argument("--chunk_size", "-cs", type=int, default=100)
    ap.add_argument("--backend", choices=["local", "pbs", "print"], default="local")
    ap.add_argument("--workers", type=int, default=1, help="local parallel chunks (one card: 1)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help="each chunk's torch device")
    ap.add_argument("--walltime", default="11:00:00")
    ap.add_argument("--mem", default="8gb")
    args = ap.parse_args(argv)

    jobs = chunk_jobs(args.inference_path, args.n_events, args.entry_start, args.chunk_size, args.device)
    print(f"total chunk jobs: {len(jobs)}")

    if args.backend == "local":
        # each chunk is a process of its own: threads only wait on them
        with ThreadPoolExecutor(max_workers=args.workers) as ex:
            rcs = list(ex.map(run_chunk, jobs))
        bad = [(j[1], j[2]) for j, rc in zip(jobs, rcs) if rc != 0]
        if bad:
            print(f"{len(bad)} chunk(s) FAILED: {bad} - rerun those ranges")
            sys.exit(1)
        print("all chunks finished")
    else:
        for job in jobs:
            cmd = (f"qsub -q N -N sr_inf -l walltime={args.walltime},mem={args.mem} -- "
                   + " ".join(chunk_command(*job)))
            print(cmd)
            if args.backend == "pbs":
                subprocess.call(cmd, shell=True)  # noqa: S602 - the user's own queue command
    return jobs


if __name__ == "__main__":
    main()
