"""Marks on the model loops whose bodies the reference compiles into a
``while`` at depth >= 2 (inside the layer stack's scan): the bodies its
``hlo_cost.analyze(..., vmem_credit_depth=2)`` prices as a VMEM-fused
Pallas kernel.  The models mark their loops with :func:`fused_loop`;
``core.hlo_cost.analyze_program(..., vmem_credit=True)`` reads the marks.
This module imports nothing of either, so the models do not depend on
the cost counter.

The port's marks: the blockwise attention's pairs
(``models/flash.py::_fwd_pass`` and ``_bwd_pass``, so also the twin a
count credits to kernel E), the Mamba scan
(``models/ssm.py::_mamba_scan``), the mLSTM block pairs
(``mlstm_parallel``, without its normalisation, which the reference
runs after its scan) and the sLSTM recurrence (``_slstm_scan``).
"""

from __future__ import annotations

import contextlib

#: Counts with the VMEM credit on that are running (``hlo_cost`` raises
#: and lowers it), the marks entered while one is, and the outermost
#: marks entered so far (which marked loop is running).
credit_counts = 0
depth = 0
loops = 0
_NO_MARK = contextlib.nullcontext()


class _Mark:
    def __enter__(self):
        global depth, loops
        loops += depth == 0
        depth += 1

    def __exit__(self, *exc):
        global depth
        depth -= 1


def fused_loop(trips: int):
    """``with fused_loop(trips):`` around a whole loop of ``trips`` trips
    (not around each step) marks it.  A loop of one trip is no mark: XLA
    inlines a ``while`` of one trip into its caller, so the reference's
    credit does not reach that body.  Unless a count with the credit is
    running, it is the one shared no-op context (one flag test), so the
    marked loops cost nothing outside such a count."""
    return _Mark() if credit_counts and trips > 1 else _NO_MARK
