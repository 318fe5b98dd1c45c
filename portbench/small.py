"""Cells of the benchmark cut to a size that the CPU tests run in a
second: the same configuration and traffic files, fewer rate values and
smaller chunks.  Only the tests use these."""

from __future__ import annotations

import copy

from . import cells

#: Rate values a sweep draws, a cell's configuration kind.
SMALL_DRAWS = {"grid": {"detnet_fps": 5, "keynet_fps": 2, "camera_fps": 2},
               "sessions": {"detnet_fps": 3, "camera_fps": 2}}


def small_cell(name, root=cells.ROOT) -> cells.Cell:
    """Cell ``name`` (or a ``(configuration, traffic)`` pair that is no
    cell) with :data:`SMALL_DRAWS` values on its rate axes and
    4,096-configuration chunks."""
    cell = copy.deepcopy(cells.assemble(*name, root) if isinstance(
        name, tuple) else cells.resolve(name, root))
    for axis, n in SMALL_DRAWS[cell.config["kind"]].items():
        cell.config["axes"][axis]["draw"] = n
    cell.traffic["chunk"] = 4096
    return cell
