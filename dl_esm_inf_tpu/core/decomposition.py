"""2D domain decomposition.

JAX analogue of the reference's ``go_decompose``
(finite_difference/src/parallel_mod.f90:70-332) and
``decomposition_type`` (decomposition_mod.f90:54-68).

Two layouts are provided:

* :func:`decompose` — the layout actually used on device.  Shards are
  **shape-uniform** (XLA requires every shard of a sharded array to have
  the same shape): the tile size is ``ceil(global/nprocs)`` per axis and
  the remainder becomes masked padding on the last shard of each axis.
  Each shard's array additionally carries a halo ring of width ``h`` on
  all four sides plus optional alignment padding of the contiguous (x)
  dimension, mirroring ``DL_ESM_ALIGNMENT`` (grid_mod.f90:347-381).

* :func:`reference_subdomains` — the reference's exact uneven splitting
  (integer remainder spread one extra row/col at a time,
  parallel_mod.f90:204-317).  Kept for parity analysis and as a test
  oracle for the process-grid factorisation; not used for device layout.

The process-grid *choice* (near-square factorisation oriented so the
longer process-grid axis matches the longer domain axis,
parallel_mod.f90:167-194) is shared by both and reproduced exactly in
:func:`choose_process_grid`.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass

from .region import Region, Subdomain


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def alignment_from_env(default: int = 1) -> int:
    """Read ``DL_ESM_ALIGNMENT`` (reference grid_mod.f90:349-363).

    The reference limits the value to 3 digits; we just require a positive
    integer.
    """
    val = os.environ.get("DL_ESM_ALIGNMENT", "").strip()
    if not val:
        return default
    try:
        align = int(val)
    except ValueError as exc:
        raise ValueError(
            f"Cannot convert DL_ESM_ALIGNMENT value ({val!r}) into a "
            "positive integer.") from exc
    if align < 1:
        raise ValueError(
            f"DL_ESM_ALIGNMENT must be a positive integer, got {align}.")
    return align


def choose_process_grid(ndomains: int, xlen: int, ylen: int) -> tuple[int, int]:
    """Choose an (nprocx, nprocy) grid for ``ndomains`` domains.

    Exact reproduction of the reference algorithm
    (parallel_mod.f90:167-194): nprocx = floor(sqrt(n)) decremented until
    it divides n, then oriented so the longer process-grid axis matches
    the longer domain axis.
    """
    if ndomains < 1:
        raise ValueError("ndomains must be >= 1")
    ntilex = int(math.isqrt(ndomains))
    while ndomains % ntilex != 0:
        ntilex -= 1
    ntiley = ndomains // ntilex
    if xlen > ylen:
        if ntilex < ntiley:
            ntilex, ntiley = ntiley, ntilex
    else:
        # ylen >= xlen so want nprocy >= nprocx
        if ntiley < ntilex:
            ntilex, ntiley = ntiley, ntilex
    return ntilex, ntiley


@dataclass(frozen=True)
class Decomposition:
    """Static description of the uniform device decomposition.

    Analogue of ``decomposition_type`` (decomposition_mod.f90:54-68),
    extended with the uniform-shard layout facts every kernel and
    collective needs:

    * ``global_nx/global_ny`` — extent of the simulated T-point domain.
    * ``nprocx/nprocy`` — process (device) grid.
    * ``halo`` — halo-ring width (reference hardwires 1,
      parallel_comms_mod.f90:48; here it is a first-class parameter).
    * ``tile_nx/tile_ny`` — uniform in-domain tile size
      (= ceil(global/nproc)); the last shard of an axis may own fewer
      in-domain points (the rest is masked padding).
    * ``local_nx/local_ny`` — allocated shard extent including the halo
      ring and x alignment padding: ``local_nx = align_up(tile_nx + 2h)``,
      ``local_ny = tile_ny + 2h``.
    """

    global_nx: int
    global_ny: int
    nprocx: int
    nprocy: int
    halo: int
    tile_nx: int
    tile_ny: int
    local_nx: int
    local_ny: int
    align: int
    subdomains: tuple[Subdomain, ...]

    # --- basic facts -----------------------------------------------------
    @property
    def ndomains(self) -> int:
        return self.nprocx * self.nprocy

    @property
    def padded_nx(self) -> int:
        """Global x extent after padding to uniform tiles."""
        return self.nprocx * self.tile_nx

    @property
    def padded_ny(self) -> int:
        return self.nprocy * self.tile_ny

    @property
    def array_nx(self) -> int:
        """x extent of the stacked global array (all shards side by side)."""
        return self.nprocx * self.local_nx

    @property
    def array_ny(self) -> int:
        return self.nprocy * self.local_ny

    @property
    def max_width(self) -> int:
        """Reference decomp%max_width: widest subdomain incl. halos."""
        return self.tile_nx + 2 * self.halo

    @property
    def max_height(self) -> int:
        return self.tile_ny + 2 * self.halo

    # --- rank mapping ----------------------------------------------------
    def rank_coords(self, rank: int) -> tuple[int, int]:
        """rank -> (ix, iy); ranks are x-fastest like the reference."""
        return rank % self.nprocx, rank // self.nprocx

    def coords_rank(self, ix: int, iy: int) -> int:
        return iy * self.nprocx + ix

    def subdomain(self, rank: int) -> Subdomain:
        return self.subdomains[rank]

    def shard_slices(self, rank: int) -> tuple[slice, slice]:
        """(y, x) slices of this rank's shard in the stacked global array."""
        ix, iy = self.rank_coords(rank)
        return (slice(iy * self.local_ny, (iy + 1) * self.local_ny),
                slice(ix * self.local_nx, (ix + 1) * self.local_nx))

    # --- stats (reference parallel_mod.f90:319-330) -----------------------
    def imbalance_stats(self) -> dict:
        sizes = [s.internal.npts for s in self.subdomains]
        nmin, nmax = min(sizes), max(sizes)
        return {
            "mean_pts": sum(sizes) / len(sizes),
            "min_pts": nmin,
            "max_pts": nmax,
            "imbalance_pct": 100.0 * (nmax - nmin) / nmin if nmin else math.inf,
            "max_width": self.max_width,
            "max_height": self.max_height,
        }


def decompose(global_nx: int,
              global_ny: int,
              ndomains: int | None = None,
              ndomainx: int | None = None,
              ndomainy: int | None = None,
              halo_width: int = 1,
              align: int | None = None,
              align_y: int = 1) -> Decomposition:
    """Decompose a ``global_nx x global_ny`` domain into uniform shards.

    Mirrors the argument contract of ``go_decompose``
    (parallel_mod.f90:70-139): give either ``ndomains`` (auto process
    grid) or both ``ndomainx`` and ``ndomainy``.
    """
    if global_nx < 1 or global_ny < 1:
        raise ValueError("domain extents must be positive")
    if halo_width < 0:
        raise ValueError("halo width must be >= 0")
    if align is None:
        align = alignment_from_env()

    if ndomainx is not None or ndomainy is not None:
        if ndomainx is None or ndomainy is None or ndomains is not None:
            raise ValueError(
                "supply either ndomains or both ndomainx and ndomainy")
        px, py = ndomainx, ndomainy
    else:
        ndom = 1 if ndomains is None else ndomains
        px, py = choose_process_grid(ndom, global_nx, global_ny)

    if (px > 1 or py > 1) and halo_width < 1:
        raise ValueError(
            "halo width must be > 0 when decomposing over more than one "
            "domain (reference parallel_mod.f90:134-137)")

    h = halo_width
    tile_nx = _cdiv(global_nx, px)
    tile_ny = _cdiv(global_ny, py)
    # Every shard must own at least one row and column (the reference
    # guarantees this, parallel_mod.f90:244-317): with ceil tiling the
    # LAST shard owns global - (n-1)*tile, which can hit zero.
    if (px - 1) * tile_nx >= global_nx or (py - 1) * tile_ny >= global_ny:
        raise ValueError(
            f"process grid {px}x{py} leaves at least one shard empty for "
            f"domain {global_nx}x{global_ny} under uniform {tile_nx}x"
            f"{tile_ny} tiles; use fewer domains or a different grid")
    local_nx = _cdiv(tile_nx + 2 * h, align) * align
    # align_y pads the row count (a caller's layout choice; 1 = none)
    local_ny = _cdiv(tile_ny + 2 * h, align_y) * align_y

    subs = []
    for iy in range(py):
        gy0 = iy * tile_ny
        gy1 = min(gy0 + tile_ny, global_ny)
        for ix in range(px):
            gx0 = ix * tile_nx
            gx1 = min(gx0 + tile_nx, global_nx)
            wi = max(gx1 - gx0, 0)
            hi = max(gy1 - gy0, 0)
            subs.append(Subdomain(
                internal=Region(h, h + wi, h, h + hi),
                global_=Region(gx0, gx0 + wi, gy0, gy0 + hi),
            ))
    return Decomposition(
        global_nx=global_nx, global_ny=global_ny,
        nprocx=px, nprocy=py, halo=h,
        tile_nx=tile_nx, tile_ny=tile_ny,
        local_nx=local_nx, local_ny=local_ny,
        align=align, subdomains=tuple(subs))


def reference_subdomains(global_nx: int,
                         global_ny: int,
                         nprocx: int,
                         nprocy: int,
                         halo_width: int = 1) -> list[Subdomain]:
    """The reference's exact uneven splitting (parallel_mod.f90:204-317).

    Rows/cols are split evenly with the integer remainder distributed one
    extra row/col at a time starting from the first tile.  Returned in the
    reference's rank order (x-fastest).  Used as a parity oracle and for
    host-side analysis only — the device layout is uniform
    (:func:`decompose`).
    """
    h = halo_width
    internal_width = global_nx // nprocx
    internal_height = global_ny // nprocy
    junder = global_ny - nprocy * internal_height
    iunder = global_nx - nprocx * internal_width

    subs = []
    jval = 0  # 0-based global y start of current row of tiles
    jrem = junder
    for _jj in range(nprocy):
        if jrem > 0:
            height = internal_height + 1
            jrem -= 1
        else:
            height = internal_height
        ival = 0
        irem = iunder
        for _ji in range(nprocx):
            if irem > 0:
                width = internal_width + 1
                irem -= 1
            else:
                width = internal_width
            subs.append(Subdomain(
                internal=Region(h, h + width, h, h + height),
                global_=Region(ival, ival + width, jval, jval + height),
            ))
            ival += width
        jval += height
    return subs
