"""Substructure merger: check that the fan-out finished cleanly, then
concatenate the npz chunks into one ``substructures`` tree.

The port's copy of the JAX package's ``scripts/merge_substructures.py``:
refuses to merge while any job status file remains or any error log is
non-empty; optionally removes the chunk files after a successful merge.

    python -m superresolutionhep_tpu_torch.scripts.merge_substructures -sd substructures/
"""

from __future__ import annotations

import argparse
import os
import sys
from glob import glob

import numpy as np

from ..data import root_io


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--substructure_dir", "-sd", type=str, required=True)
    ap.add_argument("--output", "-o", type=str, default=None)
    ap.add_argument("--cleanup", action="store_true", help="remove chunk npz files after merging")
    ap.add_argument("--force", action="store_true", help="merge even with pending/error jobs")
    args = ap.parse_args(argv)

    sd = args.substructure_dir

    pending = glob(os.path.join(sd, "status", "*.status"))
    if pending and not args.force:
        print(f"REFUSING to merge: {len(pending)} job status file(s) remain (jobs unfinished/failed)")
        for p in pending[:10]:
            print("  ", p)
        sys.exit(1)

    bad_logs = [p for p in glob(os.path.join(sd, "error_*.log")) if os.path.getsize(p) > 0]
    if bad_logs and not args.force:
        print(f"REFUSING to merge: {len(bad_logs)} non-empty error log(s)")
        for p in bad_logs[:10]:
            print("  ", p)
        sys.exit(1)

    chunks = glob(os.path.join(sd, "substructures_*_*.npz"))
    chunks.sort(key=lambda x: int(os.path.basename(x).split("_")[1]))
    if not chunks:
        print("no chunk files found")
        sys.exit(1)

    merged = {}
    for path in chunks:
        with np.load(path) as z:
            for k in z.files:
                merged.setdefault(k, []).append(z[k])
    merged = {k: np.concatenate(v) for k, v in merged.items()}

    out = args.output or os.path.join(sd, "substructures.h5")
    root_io.write_trees(out, {"substructures": merged})
    print(f"merged {len(chunks)} chunks -> {out} ({len(next(iter(merged.values())))} events)")

    if args.cleanup:
        for path in chunks:
            os.remove(path)
        print("chunk files removed")
    return out


if __name__ == "__main__":
    main()
