"""Fields on the staggered grid.

JAX analogue of the reference ``r2d_field``
(finite_difference/src/field_mod.f90:110-390 and methods through :1464).

A field's storage is one ``jax.Array`` in stacked local-shard layout
(see parallel/halo.py): each device holds its local subdomain including
its halo ring, all fields allocated at the full (uniform, padded) shard
extent — the analogue of the reference allocating every field at the full
padded grid extent (field_mod.f90:326-351) — and zero-filled on creation
(field_mod.f90:357-376).

The staggering truth table (which points of the allocated array are the
field's *internal* region) reproduces the reference's
``{cu,cv,ct,cf}_{sw,ne}_init`` routines (field_mod.f90:652-1122):

=========  =======  ==============================  =====================
offset     point    x internal start offset         y internal start offset
=========  =======  ==============================  =====================
NE         U,V,T,F  0 (same region as T points,     0
                    field_mod.f90:769-772 etc.)
SW         T        0                               0
SW         U        +1 unless periodic x            0
                    (field_mod.f90:710-726)
SW         V        0                               +1 unless periodic y
                                                    (field_mod.f90:822-845)
SW         F        +1 unless periodic x            +1 unless periodic y
                    (field_mod.f90:1040-1060)
=========  =======  ==============================  =====================

Documented deviation: the reference applies the SW ``+1`` to *every
rank's* subdomain start, which punches holes at shard seams in a
multi-rank SW run (a path the reference itself aborts on, field_mod.f90:
844/1048/1059).  Here the offset is applied to the *global* region, so
single-shard behaviour is identical and multi-shard SW runs are seamless.

There is no device-pointer machinery (field_mod.f90:65-105, :407-525):
data is born in HBM.  ``get_data``/``set_data`` map to host<->device
transfers of the stacked array, and sub-region read/write helpers cover
the reference's partial-sync protocol (exercised by
tests/device_computation/test_device_io.f90).
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from . import kinds, layout
from .constants import (ALL_POINTS, BC_PERIODIC, GridPoints, NBOUNDARY,
                        Offset)
from .grid import Grid
from .region import Halo, Region
from ..parallel import halo as halo_mod


def _sharding_nd(grid: Grid, lead: int):
    """The canonical sharding with ``lead`` unsharded leading dims."""
    if lead == 0:
        return grid.sharding
    from jax.sharding import NamedSharding, PartitionSpec as P
    return NamedSharding(grid.mesh, P(*((None,) * lead), "y", "x"))


def staggering_offsets(grid: Grid, point) -> tuple[int, int]:
    """(off_x, off_y) of the field's global internal region start."""
    point = GridPoints(point)
    off_x = off_y = 0
    if grid.offset == Offset.SW:
        if point in (GridPoints.U, GridPoints.F) and not grid.wrap_x:
            off_x = 1
        if point in (GridPoints.V, GridPoints.F) and not grid.wrap_y:
            off_y = 1
    return off_x, off_y


@functools.lru_cache(maxsize=8)
def _checksum_fn(acc_dtype_str: str):
    acc = jnp.dtype(acc_dtype_str)

    @jax.jit
    def f(data, mask):
        return jnp.sum(jnp.abs(data.astype(acc)) * mask.astype(acc))
    return f


class Field:
    """A real field bound to a grid-point type (reference r2d_field).

    ``levels=None`` gives the reference's 2D field; ``levels=N`` a
    MULTI-LEVEL (3D) field of shape ``(N, ny, nx)`` sharing one halo
    exchange, checksum and gather — the 3D-real case the reference
    aborts on (parallel_comms_mod.f90:1738-1742) falls out of the
    stacked-array design (the level axis is just a leading dim of the
    same sharded array; every level's strips ride the same messages).
    """

    def __init__(self, grid: Grid, grid_points, init_global_data=None,
                 dtype=None, levels: int | None = None):
        if grid.decomp is None or not grid._initialised:
            raise RuntimeError(
                "grid must be decomposed and initialised before creating "
                "fields (reference requires grid_init first)")
        self.grid = grid
        self.defined_on = GridPoints(grid_points)
        self.dtype = jnp.dtype(dtype) if dtype is not None else grid.dtype
        self._off = staggering_offsets(grid, self.defined_on)
        if levels is not None and levels < 1:
            raise ValueError(f"levels must be >= 1, got {levels}")
        self.levels = levels
        lead = () if levels is None else (int(levels),)

        d = grid.decomp
        sharding = _sharding_nd(grid, len(lead))
        if init_global_data is not None:
            g = np.asarray(init_global_data)
            want = lead + (d.global_ny, d.global_nx)
            if g.shape != want:
                raise ValueError(
                    f"init_global_data shape {g.shape} != {want}")
            if lead:
                stacked = np.stack([
                    layout.stack_global(d, g[k], mode="zeros",
                                        dtype=np.dtype(self.dtype))
                    for k in range(lead[0])])
            else:
                stacked = layout.stack_global(d, g, mode="zeros",
                                              dtype=np.dtype(self.dtype))
            self.data = jax.device_put(stacked, sharding)
        else:
            self.data = jax.device_put(
                np.zeros(lead + (d.array_ny, d.array_nx),
                         dtype=self.dtype), sharding)

        self.halos = _periodic_bc_halos(self)

    # --- regions ----------------------------------------------------------
    @property
    def num_halos(self) -> int:
        return len(self.halos)

    def internal_region(self, rank: int = 0) -> Region:
        """Internal region of one rank's shard, in local coordinates.

        The analogue of the reference's per-rank ``field%internal``
        (field_mod.f90:596-598)."""
        d = self.grid.decomp
        if self.defined_on == ALL_POINTS:
            return Region(0, d.local_nx, 0, d.local_ny)
        sub = d.subdomains[rank]
        gx0, gy0 = sub.global_.xstart, sub.global_.ystart
        h = d.halo
        xs = h + max(self._off[0] - gx0, 0)
        ys = h + max(self._off[1] - gy0, 0)
        return Region(xs, h + sub.global_.nx, ys, h + sub.global_.ny)

    @property
    def internal(self) -> Region:
        """Rank-0's internal region (single-shard runs: THE internal region)."""
        return self.internal_region(0)

    def whole_region(self, rank: int = 0) -> Region:
        """internal +/- NBOUNDARY (reference field_mod.f90:604-622)."""
        if self.defined_on == ALL_POINTS:
            return self.internal_region(rank)
        return self.internal_region(rank).grow(NBOUNDARY)

    @property
    def whole(self) -> Region:
        return self.whole_region(0)

    @property
    def internal_mask(self) -> jax.Array:
        """Device mask selecting in-domain internal points of every shard."""
        if self.defined_on == ALL_POINTS:
            return jnp.ones(self.grid.array_shape, dtype=self.dtype)
        return self.grid.region_mask(*self._off, dtype=self.dtype)

    def internal_mask_np(self) -> np.ndarray:
        if self.defined_on == ALL_POINTS:
            return np.ones(self.grid.array_shape, dtype=bool)
        return self.grid.region_mask_np(*self._off)

    @property
    def external_mask(self) -> jax.Array:
        """Device mask of this field's GLOBAL boundary ring — whole
        minus internal in global coordinates (field_mod.f90:604-622),
        decomposition-invariant by construction.  ALL_POINTS fields have
        whole == internal (field_mod.f90:624-650): the ring is empty."""
        if self.defined_on == ALL_POINTS:
            return jnp.zeros(self.grid.array_shape, dtype=self.dtype)
        return self.grid.external_mask(*self._off, dtype=self.dtype)

    def external_mask_np(self) -> np.ndarray:
        if self.defined_on == ALL_POINTS:
            return np.zeros(self.grid.array_shape, dtype=bool)
        return self.grid.external_mask_np(*self._off)

    # --- communication ------------------------------------------------------
    def halo_exchange(self, depth: int = 1) -> None:
        """Refresh this field's halo ring (field_mod.f90:1231-1256).

        ``depth`` is honoured up to the decomposition's halo width —
        unlike the reference, which ignores it (field_mod.f90:1226-1229).
        Across devices the exchange is ``ppermute`` (parallel/halo.py)."""
        self.data = halo_mod.exchange(self.data, self.grid.mesh,
                                      self.grid.halo_spec, depth)

    def apply_periodic_bcs(self) -> None:
        """Apply single-shard periodic wrap copies from the halo

        descriptors (reference init_periodic_bc_halos targets,
        field_mod.f90:1394-1464).  On a multi-shard mesh the wrap is part
        of halo_exchange(); this mirrors the serial reference workflow
        where clients apply ``copy_field`` over ``fld%halo(i)``."""
        for hd in self.halos:
            copy_field_patch(self, hd.source, hd.dest)

    # --- reductions / gather -------------------------------------------------
    def checksum(self) -> float:
        """Sum of |internal points| over all shards (field_mod.f90:1289-1307).

        The reduction is a single fused masked-sum; XLA inserts the
        cross-device psum (the reference's MPI_allreduce,
        parallel_utils_mod.f90:230-238)."""
        f = _checksum_fn(str(kinds.sum_dtype()))
        return float(f(self.data, self.internal_mask))

    def integral(self) -> float:
        """SIGNED sum of internal points over all shards (the building
        block of volume/mass diagnostics; checksum() is the |.| form)."""
        from ..parallel.collectives import masked_sum
        return masked_sum(self.data, self.internal_mask)

    def max_abs(self) -> float:
        """max |internal points| over all shards (CFL monitoring)."""
        import jax.numpy as _jnp
        return float(_jnp.max(_jnp.abs(self.data) * self.internal_mask))

    def gather_inner_data(self) -> np.ndarray:
        """Assemble the global (global_ny, global_nx) array of internal

        points (reference gather_inner_data, field_mod.f90:1313-1390).
        Returns a host NumPy array on every process (multi-process runs
        gather across hosts via process_allgather)."""
        from ..parallel.collectives import gather_to_host
        return gather_to_host(layout.unstack_internal(self.grid.decomp,
                                                      self.data))

    # --- host <-> device ------------------------------------------------------
    def get_data(self) -> np.ndarray:
        """Host copy of the stacked array (reference get_data,

        field_mod.f90:530-542 — the device->host sync collapses to one
        device_get; across processes, to one process_allgather)."""
        from ..parallel.collectives import gather_to_host
        return gather_to_host(self.data)

    def set_data(self, array) -> None:
        """Replace the stacked array from host data (field_mod.f90:546-559)."""
        arr = np.asarray(array, dtype=self.dtype)
        lead = () if self.levels is None else (self.levels,)
        want = lead + self.grid.array_shape
        if arr.shape != want:
            raise ValueError(
                f"set_data expects stacked shape {want}, got {arr.shape}")
        self.data = jax.device_put(arr, _sharding_nd(self.grid, len(lead)))

    def read_from_device(self, region: Region) -> np.ndarray:
        """Host copy of a sub-region of the stacked array — the analogue

        of the reference's partial device->host sync
        (field_mod.f90:407-465)."""
        from ..parallel.collectives import gather_to_host
        sy, sx = region.slices()
        return gather_to_host(self.data[..., sy, sx])

    def write_to_device(self, region: Region, values) -> None:
        """Update a sub-region (reference write_to_device,

        field_mod.f90:467-525)."""
        sy, sx = region.slices()
        vals = jnp.asarray(np.asarray(values, dtype=self.dtype))
        self.data = self.data.at[..., sy, sx].set(vals)

    def local_view(self, rank: int = 0) -> np.ndarray:
        """One rank's local array incl. halo ring — the per-rank

        ``field%data`` of the reference.  Host copy."""
        return layout.shard_view(self.grid.decomp, self.get_data(), rank)


# ---------------------------------------------------------------------------
# Module-level operations, matching the reference's public interface
# (field_mod.f90:191-194).
# ---------------------------------------------------------------------------

def copy_field(field_in: Field, field_out: Field) -> None:
    """copy_2dfield (field_mod.f90:1152-1174)."""
    field_out.data = field_in.data.astype(field_out.dtype)


def copy_field_patch(field: Field, src: Region, dest: Region) -> None:
    """copy_2dfield_patch (field_mod.f90:1179-1187)."""
    ssy, ssx = src.slices()
    dsy, dsx = dest.slices()
    field.data = field.data.at[..., dsy, dsx].set(field.data[..., ssy, ssx])


def set_field(fld: Field, val) -> None:
    """set_field (field_mod.f90:1191-1202)."""
    lead = () if fld.levels is None else (fld.levels,)
    fld.data = jnp.full(lead + fld.grid.array_shape, val, dtype=fld.dtype)
    fld.data = jax.device_put(fld.data, _sharding_nd(fld.grid, len(lead)))


def field_checksum(field: Field) -> float:
    """fld_checksum (field_mod.f90:1209-1219)."""
    return field.checksum()


def free_field(fld: Field) -> None:
    """r2d_free_field (field_mod.f90:395-403)."""
    fld.data = None


def _periodic_bc_halos(fld: Field) -> tuple[Halo, ...]:
    """Wrap-copy descriptors for periodic BCs on a single shard

    (reference init_periodic_bc_halos, field_mod.f90:1394-1464).  Pure
    metadata; descriptors exist ONLY along wrapped axes that are
    unsplit — when an axis is decomposed, its wrap rides the halo
    exchange permutation, and a local rank-0 copy would overwrite seam
    halos with the wrong shard's data."""
    halos: list[Halo] = []
    r = fld.internal_region(0)
    if fld.defined_on == ALL_POINTS:
        return tuple(halos)
    d = fld.grid.decomp
    if (fld.grid.boundary_conditions[0] == BC_PERIODIC
            and d.nprocx == 1):
        # E-most column <- W-most internal column, W-most <- E-most
        halos.append(Halo(
            source=Region(r.xstart, r.xstart + 1, r.ystart, r.ystop),
            dest=Region(r.xstop, r.xstop + 1, r.ystart, r.ystop)))
        halos.append(Halo(
            source=Region(r.xstop - 1, r.xstop, r.ystart, r.ystop),
            dest=Region(r.xstart - 1, r.xstart, r.ystart, r.ystop)))
    if (fld.grid.boundary_conditions[1] == BC_PERIODIC
            and d.nprocy == 1):
        halos.append(Halo(
            source=Region(r.xstart - 1, r.xstop + 1, r.ystart, r.ystart + 1),
            dest=Region(r.xstart - 1, r.xstop + 1, r.ystop, r.ystop + 1)))
        halos.append(Halo(
            source=Region(r.xstart - 1, r.xstop + 1, r.ystop - 1, r.ystop),
            dest=Region(r.xstart - 1, r.xstop + 1, r.ystart - 1, r.ystart)))
    return tuple(halos)
