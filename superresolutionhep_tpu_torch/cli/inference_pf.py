"""Stage-2 (particle-flow) inference CLI:

    python -m superresolutionhep_tpu_torch.cli.inference_pf -i inference_pf.yml [--device cuda]

Runs every item of the config's ``items`` with ``run_pred: true``; an item
without ``pred_path`` writes ``inference/<pred_file_name>`` beside the
model's config.  ``model.checkpoint_path`` names a checkpoint of the port's
PF trainer or a Flax ``.msgpack`` blob such as the shipped
``saved_checkpoints/closure_pf/params.msgpack`` (train/checkpoint.py).
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

from ..config import load_yaml


def main(argv=None):
    parser = argparse.ArgumentParser(description="Stage-2 particle-flow inference (PyTorch)")
    parser.add_argument("--inference_path", "-i", type=str, required=True)
    parser.add_argument("--device", "-g", type=str, default="cuda",
                        help="torch device; 'cuda' (default) raises where there is no GPU, 'cpu' runs on the CPU")
    args = parser.parse_args(argv)

    inf_cfg = load_yaml(args.inference_path)

    from ..inference.pf import PFInference

    inf = PFInference(inf_cfg, device=args.device)
    for inf_dict in inf_cfg["items"]:
        if not inf_dict.get("run_pred", False):
            continue
        inf_dict = dict(inf_dict)
        if not inf_dict.get("pred_path"):
            outputdir = os.path.join(os.path.dirname(inf_cfg["model"].get("config_path_mv") or ""), "inference")
            Path(outputdir).mkdir(parents=True, exist_ok=True)
            inf_dict["pred_path"] = os.path.join(outputdir, inf_dict["pred_file_name"])
        print(f"Running PF predictions -> {inf_dict['pred_path']}")
        inf.run_pred(inf_dict)
    return inf


if __name__ == "__main__":
    from ..utils.hostmem import ensure_tuned

    ensure_tuned()  # glibc malloc tunables, by one re-exec of this command
    main()
