"""Stage-1 (super-resolution) inference CLI:

    python -m superresolutionhep_tpu_torch.cli.inference_sr -i inference.yml \
        [-bm -estart 0 -estop 100] [--precision bfloat16] [--device cuda]

Two modes, as the JAX package's:
  * batch mode (``-bm``): one entry range, the output suffixed
    ``_{start}_{stop}`` (the unit of a fan-out over hosts);
  * the config's ``items`` loop: every item with ``run_pred: true``.

``model.checkpoint_path`` in the YAML names a checkpoint of the port's
trainer or a Flax ``.msgpack`` blob such as the shipped
``saved_checkpoints/closure_sr/params.msgpack`` (train/checkpoint.py).  ``--precision bfloat16`` runs the dense stack
in bf16 (the YAML's ``model.dtype: bfloat16``).
"""

from __future__ import annotations

import argparse
import time

from ..config import load_yaml
from .common import add_inference_args


def main(argv=None):
    parser = argparse.ArgumentParser(description="Stage-1 super-resolution inference (PyTorch)")
    add_inference_args(parser)
    args = parser.parse_args(argv)

    inf_cfg = load_yaml(args.inference_path)
    if args.precision == "bfloat16":
        inf_cfg["model"] = dict(inf_cfg["model"], dtype="bfloat16")

    from ..inference.sr import SRInference

    inf = SRInference(inf_cfg, device=args.device)

    if args.batch_mode:
        if "items" in inf_cfg:
            raise ValueError("batch mode takes an `inf_dict` config, not an `items` list")
        if args.entry_stop is None:
            raise ValueError("batch mode needs --entry_stop")
        inf_dict = dict(inf_cfg["inf_dict"])
        inf_dict["entry_start"] = args.entry_start
        inf_dict["n_events"] = args.entry_stop - args.entry_start
        inf_dict["batch_size"] = inf_cfg.get("batch_size", 32)
        inf_dict["max_particles"] = inf_cfg.get("max_particles", 0)
        stem, ext = inf.get_output_path(inf_dict).rsplit(".", 1)
        inf_dict["pred_path"] = f"{stem}_{args.entry_start}_{args.entry_stop}.{ext}"
        t0 = time.time()
        inf.run_pred(inf_dict)
        print(f"Prediction time: {time.time() - t0:.2f} s")
    else:
        if "items" not in inf_cfg:
            raise ValueError("without -bm the config needs an `items` list")
        for inf_dict in inf_cfg["items"]:
            if not inf_dict.get("run_pred", False):
                continue
            inf_dict = dict(inf_dict)
            inf_dict["batch_size"] = inf_cfg.get("batch_size", 32)
            inf_dict["max_particles"] = inf_cfg.get("max_particles", 0)
            if not inf_dict.get("pred_path"):
                inf_dict["pred_path"] = inf.get_output_path(inf_dict)
            print(f"Running predictions on {inf_dict['truth_path']}")
            inf.run_pred(inf_dict)
    return inf


if __name__ == "__main__":
    main()
