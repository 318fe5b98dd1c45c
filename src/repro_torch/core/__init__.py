"""Core of the PyTorch port: the DOSC power model as a design-space
engine (tables, Eq. 1-11, dense grid, chunk contract, streaming sweep,
Pareto analysis)."""
