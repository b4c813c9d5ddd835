"""Stage 2: the set-attention particle-flow model (SAPF)."""
from .cardinality import CardinalityPredictor  # noqa: F401
from .encoder import PFEncoder  # noqa: F401
from .kinematics import AttnKinematicNet, KinematicsPredictor  # noqa: F401
from .model_pf import SAPF  # noqa: F401
