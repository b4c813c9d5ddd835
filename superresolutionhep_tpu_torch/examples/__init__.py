"""Examples on the port's modules, run as ``python -m
superresolutionhep_tpu_torch.examples.<name>`` from the repository root."""
