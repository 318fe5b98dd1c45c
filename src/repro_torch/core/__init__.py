"""Core of the PyTorch port: the DOSC power model as a design-space
engine (tables, Eq. 1-11, dense grid, chunk contract, streaming sweep,
Pareto analysis, the knob optimizer), the sweep service over it
(``core.service``, ``core.client``), and the analysis of a program's
counts (``hlo_analysis``, ``hlo_cost``: HLO text or a torch program;
``roofline``, ``tpu_energy``, ``dosc``: roofline terms, energy and the
partition advisor, for a TPU or the H100)."""

from . import (arrays, constants, dosc, energy, handtracking,  # noqa: F401
               hlo_analysis, hlo_cost, latency, optimize, pareto, partition,
               rbe, roofline, sweep, system, tpu_energy, workloads)
