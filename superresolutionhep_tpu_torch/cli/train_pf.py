"""Stage-2 (particle-flow) training CLI:

    python -m superresolutionhep_tpu_torch.cli.train_pf -cmv model_and_var.yml -ct train.yml [--device cuda]

The YAML files are read here; the trainer takes mappings.  Under
``torchrun --nproc_per_node N -m superresolutionhep_tpu_torch.cli.train_pf ...``
each rank joins the process group (NCCL on ``cuda:LOCAL_RANK``) and the
trainer runs data parallel over the world.  The train YAML's
``train_glob_arg`` / ``val_glob_arg`` name the stage-1 inference outputs.
"""

from __future__ import annotations

import argparse

from ..config import load_config_pair
from .common import add_train_args, compute_dtype, default_run_dir


def main(argv=None):
    parser = argparse.ArgumentParser(description="Stage-2 particle-flow training (PyTorch)")
    add_train_args(parser)
    args = parser.parse_args(argv)

    config_mv, config_t = load_config_pair(args.config_mv, args.config_t)
    if args.profile:
        config_t = dict(config_t, profile=True)
    run_dir = args.run_dir or default_run_dir(config_t, "pf")

    from ..parallel.distributed import initialize
    from ..train.pf_trainer import PFTrainer

    # under torchrun (one process per rank) the trainer runs data parallel
    # over the world; without its environment this starts nothing
    initialize(device=args.device)

    trainer = PFTrainer(config_mv, config_t, run_dir=run_dir, seed=args.seed, dtype=compute_dtype(args.precision),
                        device=args.device)
    trainer.fit(resume=args.resume or bool(config_t.get("resume_from_checkpoint")))
    return trainer


if __name__ == "__main__":
    from ..utils.hostmem import ensure_tuned

    ensure_tuned()  # glibc malloc tunables, by one re-exec of this command
    main()
