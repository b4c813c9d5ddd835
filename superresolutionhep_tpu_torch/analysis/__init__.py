"""Analysis: the live validation plots and the offline SR plotters (numpy, matplotlib)."""
