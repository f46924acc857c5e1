"""Rectangular index regions — the universal currency for bounds.

JAX analogue of the reference's ``region_type``
(finite_difference/src/region_mod.f90:7-12) and ``subdomain_type``
(finite_difference/src/decomposition_mod.f90:44-50).

Conventions (deliberately different from the Fortran reference):

* **0-based, half-open** intervals ``[start, stop)`` — Python/JAX idiom.
  The reference uses 1-based inclusive bounds; the mapping is
  ``py_start = f_start - 1``, ``py_stop = f_stop``.
* Arrays are indexed ``data[y, x]`` (x is the contiguous
  dimension), whereas the Fortran reference uses column-major
  ``data(ji, jj)`` with ji contiguous.  Both put the x sweep on the
  fast axis of the hardware.

Regions are frozen dataclasses: hashable, usable as static jit arguments.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class Region:
    """A rectangular region of index space, ``[xstart, xstop) x [ystart, ystop)``."""

    xstart: int
    xstop: int
    ystart: int
    ystop: int

    @property
    def nx(self) -> int:
        return self.xstop - self.xstart

    @property
    def ny(self) -> int:
        return self.ystop - self.ystart

    @property
    def npts(self) -> int:
        return max(self.nx, 0) * max(self.ny, 0)

    def is_empty(self) -> bool:
        return self.nx <= 0 or self.ny <= 0

    def slices(self) -> tuple[slice, slice]:
        """(y_slice, x_slice) for indexing a ``data[y, x]`` array."""
        return (slice(self.ystart, self.ystop), slice(self.xstart, self.xstop))

    def shift(self, dx: int = 0, dy: int = 0) -> "Region":
        return Region(self.xstart + dx, self.xstop + dx,
                      self.ystart + dy, self.ystop + dy)

    def grow(self, d: int) -> "Region":
        """Grow (or shrink, for negative d) by ``d`` on every side.

        ``internal.grow(1)`` gives the reference's ``whole`` region
        (internal +/- NBOUNDARY, field_mod.f90:604-622).
        """
        return Region(self.xstart - d, self.xstop + d,
                      self.ystart - d, self.ystop + d)

    def intersect(self, other: "Region") -> "Region":
        return Region(max(self.xstart, other.xstart),
                      min(self.xstop, other.xstop),
                      max(self.ystart, other.ystart),
                      min(self.ystop, other.ystop))

    def contains(self, x: int, y: int) -> bool:
        return (self.xstart <= x < self.xstop) and (self.ystart <= y < self.ystop)

    def replace(self, **kw) -> "Region":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class Halo:
    """A (source -> dest) intra-field copy descriptor.

    Analogue of the reference ``halo_type`` (halo_mod.f90:9-25), used for
    periodic-BC wrap copies on a single shard.  Distributed halo exchange
    does not use these — it is expressed directly as mesh collectives
    (see parallel/halo.py).
    """

    source: Region
    dest: Region


@dataclass(frozen=True)
class Subdomain:
    """One shard's place in the global domain.

    Analogue of ``subdomain_type`` (decomposition_mod.f90:44-50):

    * ``internal`` — local (shard) coordinates of the in-domain points this
      shard owns, excluding halos.  With halo width ``h`` and an in-domain
      tile of ``wi x hi`` points this is ``[h, h+wi) x [h, h+hi)``.
    * ``global_`` — where that internal part sits in *global domain*
      coordinates (no halos).

    Unlike the reference, shards are shape-uniform (XLA requires identical
    shard shapes): ``internal`` may be smaller than the allocated tile for
    shards at the global east/north edge; the remainder is padding that is
    masked out of checksums and stencil results.
    """

    internal: Region
    global_: Region

    @property
    def nx(self) -> int:
        return self.internal.nx

    @property
    def ny(self) -> int:
        return self.internal.ny
