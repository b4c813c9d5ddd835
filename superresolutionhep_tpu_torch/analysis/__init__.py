"""Analysis: the live validation plots, the offline SR and PF plotters (numpy,
matplotlib) and the jet substructure observables (numpy)."""

from .performance import PerformanceCOCOA, PFPerformanceCOCOA  # noqa: F401
