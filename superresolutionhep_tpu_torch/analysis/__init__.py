"""Analysis: the live validation plots, the offline SR plotters (numpy, matplotlib) and the
jet substructure observables (numpy)."""
