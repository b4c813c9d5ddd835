"""The port's scripts, run as ``python -m superresolutionhep_tpu_torch.scripts.<name>``
from the repository root: the measuring scripts (on a machine with the card)
and the pipelines users run on the system's outputs (closure suites,
substructure and inference fan-outs, serving, checkpoint conversion)."""

import os

# the checkout the scripts read their base configs from and start workers in
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
