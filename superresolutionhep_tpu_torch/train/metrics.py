"""Metrics sink of the trainers.

Counterpart of the JAX package's ``train/metrics.py``: a local JSONL stream
of scalars (``metrics.jsonl``), a provenance record
(``run_metadata.json``) and a source snapshot (the package's sources plus
the resolved configs as JSON), and a profiled window (``tools/trace_summary.py::
ProfiledWindow``) over one epoch.
No external logger.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import zipfile
from typing import Optional

import torch


class MetricsLogger:
    def __init__(self, run_dir: str):
        self.run_dir = os.path.abspath(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self._fp = open(os.path.join(self.run_dir, "metrics.jsonl"), "a", buffering=1)
        self._t0 = time.time()
        self._profiler = None
        self._write_run_metadata()

    def _write_run_metadata(self):
        """Provenance: command line, git revision where the source tree is a
        checkout, devices."""
        meta = {"argv": sys.argv, "t": time.time(), "torch": torch.__version__}
        try:
            meta["git_rev"] = subprocess.check_output(
                ["git", "rev-parse", "HEAD"], cwd=os.path.dirname(os.path.abspath(__file__)),
                stderr=subprocess.DEVNULL,
            ).decode().strip()
        except (OSError, subprocess.CalledProcessError):
            pass  # not a git checkout: the source snapshot carries the code
        if torch.cuda.is_available():
            meta["devices"] = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        with open(os.path.join(self.run_dir, "run_metadata.json"), "w") as fp:
            json.dump(meta, fp, indent=2)

    def snapshot_source(self, configs: Optional[dict] = None) -> str:
        """Zip the package's sources (Python and CUDA) and the resolved
        configs (as JSON) into the run dir: a run's exact code is then
        recoverable from the run dir alone."""
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        repo_root = os.path.dirname(pkg_root)
        zip_path = os.path.join(self.run_dir, "source_snapshot.zip")
        with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
            for base, _, files in os.walk(pkg_root):
                for f in sorted(files):
                    if f.endswith((".py", ".cu", ".cuh")):
                        p = os.path.join(base, f)
                        zf.write(p, os.path.relpath(p, repo_root))
            for name, cfg in (configs or {}).items():
                zf.writestr(f"configs_resolved/{name}.json", json.dumps(cfg, indent=2, default=str))
        return zip_path

    def log_scalars(self, scalars: dict, step: int):
        rec = {"step": step, "t": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._fp.write(json.dumps(rec) + "\n")

    def log_figure(self, fig, name: str):
        """Save a matplotlib figure as ``<run_dir>/figures/<name>_<n>.png``."""
        out = os.path.join(self.run_dir, "figures")
        os.makedirs(out, exist_ok=True)
        n = sum(f.startswith(f"{name}_") for f in os.listdir(out))
        path = os.path.join(out, f"{name}_{n}.png")
        fig.savefig(path)
        return path

    def start_profile(self, device=None):
        """Profile the device's activity and the host's operators until
        ``stop_profile``, in a ``tools/trace_summary.py::ProfiledWindow``: on
        the card its pad kernels around the block, so that ``complete`` says
        whether the profiler lost any of the block's first records.  The
        Chrome trace is written to ``<run_dir>/profile/trace.json`` at the
        window's end.  ``device``: the trainer's (default the card where
        there is one)."""
        from ..tools.trace_summary import ProfiledWindow

        dev = torch.device(device if device is not None else ("cuda" if torch.cuda.is_available() else "cpu"))
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._profiler = ProfiledWindow(dev, "train profile epoch",
                                        trace_path=os.path.join(self.run_dir, "profile", "trace.json"), host_ops=True)
        self._profiler.__enter__()

    def stop_profile(self) -> Optional[dict]:
        """Close the window; its record (wall and device time by class, busy
        share, ``complete``, the hand kernels' launches) goes to
        ``<run_dir>/profile/summary.json`` and is returned."""
        if self._profiler is None:
            return None
        window, self._profiler = self._profiler, None
        window.__exit__(None, None, None)
        record = window.record()
        with open(os.path.join(self.run_dir, "profile", "summary.json"), "w") as fp:
            json.dump(record, fp, indent=1)
        return record


class NullMetrics:
    """``MetricsLogger``'s interface writing nothing: the sink of a
    data-parallel rank other than 0 (rank 0 writes the run's metrics)."""

    def snapshot_source(self, configs: Optional[dict] = None):
        return None

    def log_scalars(self, scalars: dict, step: int):
        pass

    def log_figure(self, fig, name: str):
        return None

    def start_profile(self, device=None):
        pass

    def stop_profile(self):
        return None
