"""Core of the PyTorch port: the DOSC power model as a design-space
engine (tables, Eq. 1-11, dense grid, chunk contract, streaming sweep,
Pareto analysis, the knob optimizer) and the sweep service over it
(``core.service``, ``core.client``)."""

from . import (arrays, constants, energy, handtracking,  # noqa: F401
               latency, optimize, pareto, partition, rbe, sweep, system,
               workloads)
