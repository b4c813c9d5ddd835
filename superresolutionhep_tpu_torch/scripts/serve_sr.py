"""Online SR serving entry point (inference/server.py::SRServer).

The port's counterpart of the JAX package's ``scripts/serve_sr.py``:

    python -m superresolutionhep_tpu_torch.scripts.serve_sr --config-mv <mv.yml> --config-t <t.yml> \
        --checkpoint saved_checkpoints/closure_sr/params.msgpack \
        --port 8310 --buckets 256 512 1024 --n-ensemble 10 --n-steps 25

``--checkpoint`` is a Flax msgpack blob (the shipped-checkpoint format) or a
checkpoint of the port's trainer (a ``checkpoints/`` directory, one of its
``.pt`` files or a saved state dict), read by ``train/checkpoint.py::
load_params`` (``SRInference`` maps a msgpack tree to the port's layout).  POST /predict one event: {"low": {cell_* arrays,
high_cell_to_low_cell_edge}, "high": {cell geometry arrays}}.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config-mv", required=True)
    ap.add_argument("--config-t", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8310)
    ap.add_argument("--buckets", type=int, nargs="+", default=[256, 512, 1024, 2048, 3072, 4096, 5120])
    ap.add_argument("--n-ensemble", type=int, default=10)
    ap.add_argument("--n-steps", type=int, default=25)
    ap.add_argument("--ode-method", default="ab2e")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="torch device ('cuda' raises where there is no GPU)")
    args = ap.parse_args(argv)

    from ..inference.server import SRServer

    inf_cfg = {
        "model": {
            "config_path_mv": args.config_mv,
            "config_path_t": args.config_t,
            "checkpoint_path": args.checkpoint,
            "n_steps": args.n_steps,
            "n_steps_to_store": 1,
        },
        "n_ensemble": args.n_ensemble,
        "ode_method": args.ode_method,
    }
    server = SRServer(inf_cfg, buckets=tuple(args.buckets), device=args.device)
    server.warmup()
    server.serve(args.host, args.port)


if __name__ == "__main__":
    main()
