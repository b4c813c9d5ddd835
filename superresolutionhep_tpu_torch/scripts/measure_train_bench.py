"""Measure SR and PF training-step throughput and MFU on the card.

Counterpart of the JAX package's ``scripts/measure_train_bench.py``: the SR
train step at both production shapes with the fused-prologue and remat
levers toggled (six legs), then the PF train step (forward, backward, the
on-device matching, the clip and AdamW) at the reference packer scale.  It
reuses the port's bench (``scripts/bench.py::train_bench`` and
``::pf_train_bench``), so the numbers are the bench's ``sr_train`` and
``pf_train`` entries by definition.  The MFU fields divide by this card's
bf16 matmul rate, measured once here as the bench measures it
(``bench.chip_tfs``), and by the published 989 TFLOP/s.  A leg that fails
(an out-of-memory no-remat leg, say) records its error and the run goes on.

    python -m superresolutionhep_tpu_torch.scripts.measure_train_bench [--device cuda] [--out PATH]

Prints the card's name and power limit, a JSON line per leg and one for the
PF step; writes everything to ``--out`` (default
``runs/measure/train_bench.json``; nothing is written under ``docs/``).
``--device cpu`` runs ``TINY``: the tools' CPU model at (2, 128) and
(2, 256), the PF step at (2, 128), one step a block; no device figure.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

from ..configs import MULTIPART_CONFIG_MV
from . import bench
from .common import RUNS_DIR, device_line, measure_device, tiny_config_mv, write_json

LEGS = [
    dict(B=8, N=2048, fused=False, remat=True),
    dict(B=8, N=2048, fused=True, remat=True),
    dict(B=8, N=2048, fused=False, remat=False),
    dict(B=8, N=2048, fused=True, remat=False),
    dict(B=6, N=3584, fused=False, remat=True),
    dict(B=6, N=3584, fused=True, remat=True),
]
PF = dict(B=25, N=2048)
N_REP = 8
# --device cpu: the same six toggles and the PF step at the tests' sizes
TINY = {"legs": [dict(leg, B=2, N=128 if leg["N"] == 2048 else 256) for leg in LEGS], "pf": dict(B=2, N=128),
        "n_rep": 1}


def measure(dev, legs=LEGS, pf=PF, n_rep=N_REP, config_mv=MULTIPART_CONFIG_MV, checked=contextlib.nullcontext):
    """Every leg of ``legs`` (``bench.train_bench``), then the PF step
    (``bench.pf_train_bench`` at ``pf``); ``checked()`` wraps one
    ``loss_and_grads`` of each."""
    peak = bench.chip_tfs(dev) if dev.type == "cuda" else None
    out = {"device": str(dev), "card": device_line(dev), "measured_chip_tfs": peak,
           "published_peak_tfs": bench.PUBLISHED_PEAK_TFS, "sr_train": [], "pf_train": None}
    for leg in legs:
        r = bench._recorded(lambda: bench.train_bench(dev, config_mv, n_rep=n_rep, peak_tfs=peak, checked=checked,
                                                      **leg), **leg)
        out["sr_train"].append(r)
        print(json.dumps(r), flush=True)
    out["pf_train"] = bench._recorded(lambda: bench.pf_train_bench(dev, n_rep=n_rep, checked=checked, **pf))
    print(json.dumps({"pf_train": out["pf_train"]}), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(RUNS_DIR, "train_bench.json"))
    args = ap.parse_args(argv)
    from ..utils.hostmem import ensure_tuned

    ensure_tuned()  # glibc malloc tunables, by one re-exec of this command
    dev = measure_device(args.device)
    print(device_line(dev), flush=True)
    kw = {} if dev.type == "cuda" else dict(TINY, config_mv=tiny_config_mv())
    out = measure(dev, **kw)
    print(f"wrote {write_json(args.out, out)}", flush=True)
    return out


if __name__ == "__main__":
    main()
