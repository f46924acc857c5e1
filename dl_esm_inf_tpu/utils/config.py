"""Environment-variable configuration registry.

The reference's entire config system is environment variables
(SURVEY §5): ``DL_ESM_ALIGNMENT`` (grid_mod.f90:349-363),
``GOCEAN_OMP_GRID`` (field_mod.f90:1473-1503), test-domain sizes
``JPIGLO``/``JPJGLO`` (tests/dist_mem/test_halos.f90:56-62).  This module
reads them all in one place, with this framework's additions
``DL_ESM_DTYPE``
(see core/kinds.py) documented alongside.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

from ..core.decomposition import alignment_from_env


@dataclass(frozen=True)
class EnvConfig:
    #: contiguous-dimension padding multiple (DL_ESM_ALIGNMENT)
    alignment: int
    #: explicit thread/tile grid "NxM" (GOCEAN_OMP_GRID) or None.
    #: The reference used it for OpenMP sub-tiling; here
    #: :meth:`~...core.grid.Grid.decompose` consults it when no explicit
    #: sizing is given and uses it as the (ndomainx, ndomainy) request.
    tile_grid: tuple[int, int] | None
    #: test global domain size (JPIGLO/JPJGLO) or None
    jpiglo: int | None
    jpjglo: int | None
    #: working precision name (DL_ESM_DTYPE) or None
    dtype: str | None


def parse_grid_dims(value: str) -> tuple[int, int] | None:
    """Parse an 'NxM' grid string (reference get_grid_dims,

    field_mod.f90:1473-1503): returns None on malformed input, like the
    reference's success=.FALSE. path."""
    if "x" not in value:
        return None
    left, _, right = value.partition("x")
    try:
        nx, ny = int(left), int(right)
    except ValueError:
        return None
    if nx < 1 or ny < 1:
        return None      # malformed, like non-numeric input
    return nx, ny


def _int_env(name: str) -> int | None:
    val = os.environ.get(name, "").strip()
    if not val:
        return None
    try:
        return int(val)
    except ValueError:
        return None


def read_env() -> EnvConfig:
    grid = None
    raw = os.environ.get("GOCEAN_OMP_GRID", "").strip()
    if raw:
        grid = parse_grid_dims(raw)
    return EnvConfig(
        alignment=alignment_from_env(),
        tile_grid=grid,
        jpiglo=_int_env("JPIGLO"),
        jpjglo=_int_env("JPJGLO"),
        dtype=os.environ.get("DL_ESM_DTYPE") or None,
    )
