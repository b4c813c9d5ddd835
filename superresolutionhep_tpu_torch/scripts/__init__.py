"""Measuring scripts of the port, run as ``python -m
superresolutionhep_tpu_torch.scripts.<name>`` on a machine with the card."""
