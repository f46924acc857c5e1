"""The finite-difference grid.

JAX analogue of the reference ``grid_type`` + ``grid_init``
(finite_difference/src/grid_mod.f90:75-570).  Same responsibilities:

* validate grid kind / offset convention / boundary conditions
  (grid_constructor, grid_mod.f90:217-304);
* own the domain decomposition (``decompose`` -> go_decompose,
  grid_mod.f90:183-211);
* hold the T-point mask with its boundary replication
  (grid_mod.f90:395-455), the constant scale factors / cell areas /
  f-plane latitudes (grid_mod.f90:461-523) and T-point coordinates
  (grid_mod.f90:525-556);
* set up communications (grid_mod.f90:558-569) — here that means
  building the static :class:`~..parallel.halo.HaloSpec` and the device
  mesh instead of MPI send/recv lists.

Deviations (all documented):

* Shards are shape-uniform; the remainder is masked padding on the last
  shard of each axis (see core/decomposition.py).
* Scale-factor / area / latitude / coordinate arrays are materialised
  lazily (the mesh is orthogonal-regular, so they are constant or affine;
  kernels on the fast path take scalars instead).
* Periodic BCs are supported with any number of shards (the reference
  aborts, grid_mod.f90:437-442) provided the periodic axis divides
  evenly into tiles.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import kinds, layout
from .constants import (ARAKAWA_B, ARAKAWA_C, BC, BC_PERIODIC, GridKind,
                        Offset)
from .decomposition import Decomposition, decompose as _decompose
from .region import Subdomain
from ..parallel import environment as env
from ..parallel.halo import HaloSpec


def _make_mesh(px: int, py: int, devices=None) -> Mesh:
    """Device mesh for a logical (px, py) process grid.

    With enough devices each subdomain gets its own device (mesh shape
    (py, px)).  OVER-DECOMPOSITION: with fewer devices, the largest
    device grid (my, mx) with my | py and mx | px is chosen and each
    device carries a (py/my, px/mx) block of logical tiles — exceeding
    the reference, whose mapping table allows several subdomains per
    rank but whose comms never support it (parallel_mod.f90:141-152,
    parallel_comms_mod.f90:295)."""
    devs = list(devices) if devices is not None else env.devices()
    best = None
    for my in range(1, py + 1):
        if py % my:
            continue
        for mx in range(1, px + 1):
            if px % mx or my * mx > len(devs):
                continue
            key = (my * mx, min(my, mx))   # max devices, then balanced
            if best is None or key > best[0]:
                best = (key, (my, mx))
    if best is None:
        raise ValueError(
            f"decomposition {px}x{py} cannot be mapped onto "
            f"{len(devs)} device(s)")
    my, mx = best[1]
    arr = np.array(devs[: my * mx]).reshape(my, mx)
    return Mesh(arr, ("y", "x"))


class Grid:
    """An Arakawa-C staggered grid over a device mesh."""

    def __init__(self, grid_name=ARAKAWA_C,
                 boundary_conditions=(BC.EXTERNAL, BC.EXTERNAL, BC.NONE),
                 grid_offsets=Offset.NE,
                 dtype=None):
        # Validation mirrors grid_constructor (grid_mod.f90:250-278);
        # ARAKAWA_B is declared-but-rejected exactly like the reference.
        kind = GridKind(grid_name)
        if kind == ARAKAWA_B:
            raise NotImplementedError(
                "ARAKAWA_B grids are declared but not supported "
                "(reference parity: grid_mod.f90:46 is never usable)")
        self.name = kind
        offset = Offset(grid_offsets)
        if offset not in (Offset.SW, Offset.NE):
            # The reference's field-bounds code only implements SW and NE
            # (field_mod.f90:658-669 et al.)
            raise NotImplementedError(
                f"offset convention {offset!r} not supported (only SW/NE, "
                "matching the reference's implemented paths)")
        self.offset = offset
        bcs = tuple(BC(b) for b in boundary_conditions)
        if len(bcs) != 3:
            raise ValueError("boundary_conditions must have 3 entries (x,y,z)")
        self.boundary_conditions = bcs

        self.dtype = jnp.dtype(dtype) if dtype is not None else kinds.wp()

        # Filled in by decompose()/grid_init():
        self.decomp: Decomposition | None = None
        self.mesh: Mesh | None = None
        self.halo_spec: HaloSpec | None = None
        self.global_nx = 0
        self.global_ny = 0
        self.dx = None
        self.dy = None
        # Model time step; the reference declares the GO_TIME_STEP grid
        # property (argument_mod.f90:75) for kernels to request.  Set it
        # via init(time_step=...) or assign directly.
        self.time_step = None
        self.tmask = None          # stacked int32 device array
        self._tmask_np = None      # host copy for mask derivation
        self._initialised = False
        self._lazy = {}
        self._curvi = {}           # per-point scale factors (curvilinear)
        self._curvi_derived: set = set()   # area_* entries derived here
        self._region_masks = {}

    # ------------------------------------------------------------------
    @property
    def wrap_x(self) -> bool:
        return self.boundary_conditions[0] == BC_PERIODIC

    @property
    def wrap_y(self) -> bool:
        return self.boundary_conditions[1] == BC_PERIODIC

    @property
    def nx(self) -> int:
        """Local shard x extent incl. halos+padding (reference grid%nx)."""
        return self.decomp.local_nx

    @property
    def ny(self) -> int:
        return self.decomp.local_ny

    @property
    def array_shape(self) -> tuple[int, int]:
        """Shape of the stacked global array: (nprocy*ny, nprocx*nx)."""
        return (self.decomp.array_ny, self.decomp.array_nx)

    @property
    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, P("y", "x"))

    def subdomain(self, rank: int = 0) -> Subdomain:
        """This rank's subdomain (reference grid%subdomain, per-rank)."""
        return self.decomp.subdomains[rank]

    # ------------------------------------------------------------------
    def decompose(self, domainx: int, domainy: int, ndomains=None,
                  ndomainx=None, ndomainy=None, halo_width: int = 1,
                  mesh: Mesh | None = None, devices=None,
                  align: int | None = None,
                  align_y: int = 1) -> Decomposition:
        """Decompose the global domain over the device mesh.

        Analogue of grid%decompose -> go_decompose (grid_mod.f90:183-211).
        With no explicit sizing, the ``GOCEAN_OMP_GRID`` environment
        variable ("NxM") seeds an explicit (ndomainx, ndomainy) request
        — the moral port of the reference's tiling-grid override
        (field_mod.f90:1473-1503; malformed values are ignored exactly
        like its success=.FALSE. path) — and otherwise every available
        device is used (the reference uses every MPI rank).
        """
        if mesh is not None:
            if set(mesh.axis_names) != {"y", "x"}:
                raise ValueError("mesh must have axes ('y', 'x')")
            ndomainx = mesh.shape["x"]
            ndomainy = mesh.shape["y"]
            ndomains = None
        elif ndomains is None and ndomainx is None and ndomainy is None:
            from ..utils.config import read_env
            tile_grid = read_env().tile_grid
            if tile_grid is not None:
                ndomainx, ndomainy = tile_grid
            else:
                ndomains = (len(devices) if devices is not None
                            else env.num_devices())

        # Build and VALIDATE everything locally before mutating self:
        # a failed decompose must not leave the grid torn between the
        # new decomposition and a stale (or absent) mesh/halo_spec.
        decomp = _decompose(domainx, domainy, ndomains=ndomains,
                            ndomainx=ndomainx, ndomainy=ndomainy,
                            halo_width=halo_width, align=align,
                            align_y=align_y)
        # Validate the domain decomposition itself before requiring devices,
        # so configuration errors surface with the most specific message.
        for axis, wrap, nproc, tile, glob in (
                ("x", self.wrap_x, decomp.nprocx, decomp.tile_nx,
                 domainx),
                ("y", self.wrap_y, decomp.nprocy, decomp.tile_ny,
                 domainy)):
            if wrap and nproc * tile != glob:
                raise ValueError(
                    f"periodic {axis} axis requires the global extent "
                    f"({glob}) to divide evenly into {nproc} tiles "
                    f"(got tile={tile}); choose a divisible size or a "
                    "different process grid")

        if mesh is None:
            mesh = _make_mesh(decomp.nprocx, decomp.nprocy, devices)
        mx, my = mesh.shape["x"], mesh.shape["y"]
        if decomp.nprocx % mx or decomp.nprocy % my:
            raise ValueError(
                f"process grid {decomp.nprocx}x{decomp.nprocy} "
                f"does not divide over the {mx}x{my} device mesh")

        # commit (nothing below can fail)
        self.decomp = decomp
        self.mesh = mesh
        self.global_nx = domainx
        self.global_ny = domainy
        # a re-decomposition invalidates everything built on the old one
        self._initialised = False
        self.tmask = None
        self._tmask_np = None
        self._lazy.clear()
        self._curvi.clear()
        self._curvi_derived.clear()
        self._region_masks.clear()
        self.halo_spec = HaloSpec(
            nprocx=decomp.nprocx, nprocy=decomp.nprocy,
            halo=decomp.halo,
            tile_nx=decomp.tile_nx, tile_ny=decomp.tile_ny,
            local_nx=decomp.local_nx, local_ny=decomp.local_ny,
            wrap_x=self.wrap_x, wrap_y=self.wrap_y,
            repx=decomp.nprocx // mx, repy=decomp.nprocy // my)
        return self.decomp

    # ------------------------------------------------------------------
    def init(self, dx: float, dy: float, tmask=None,
             time_step: float | None = None) -> None:
        """Flesh out the grid (reference grid_init, grid_mod.f90:330-570).

        ``tmask`` is the GLOBAL T-point mask, shape (global_ny, global_nx),
        with 1=wet, 0=dry, -1=wet-outside-domain.  (The reference takes a
        per-rank local mask; taking the global one and scattering is the
        mesh-native equivalent and removes per-rank bookkeeping from
        clients.)  If omitted, an all-wet mask is fabricated
        (grid_mod.f90:444-453).
        """
        if self.decomp is None:
            raise RuntimeError("call decompose() before init()")
        self.dx = float(dx)
        self.dy = float(dy)
        if time_step is not None:
            self.time_step = float(time_step)

        if tmask is None:
            tmask = np.ones((self.global_ny, self.global_nx), dtype=np.int32)
        tmask = np.asarray(tmask, dtype=np.int32)
        # Boundary strips / halos replicate the nearest edge value
        # (grid_mod.f90:415-431); padding cells likewise.
        stacked = layout.stack_global(self.decomp, tmask, mode="edge")
        if (self.wrap_x or self.wrap_y) and self.decomp.halo > 0:
            # Periodic axes: seam/wrap halo cells must hold the WRAP
            # partner's values, not edge replication — stencil masks
            # (derived face wetness) read neighbour tmask across the seam.  One
            # halo exchange on the device fills them (int path).
            from ..parallel import halo as halo_mod
            from ..parallel.collectives import gather_to_host
            self.tmask = halo_mod.exchange(
                jax.device_put(stacked, self.sharding), self.mesh,
                self.halo_spec, depth=self.decomp.halo)
            self._tmask_np = gather_to_host(self.tmask)
        else:
            self._tmask_np = stacked
            self.tmask = jax.device_put(stacked, self.sharding)
        self._initialised = True
        self._lazy.clear()
        self._curvi.clear()
        self._curvi_derived.clear()
        self._region_masks.clear()

    def scatter_exchanged(self, global_arr, mode: str = "edge",
                          dtype=None):
        """Scatter a global ``(gny, gnx)`` array to the stacked sharded
        layout and halo-exchange it to full depth, so every halo cell
        carries its source cell's value (seam- and wrap-correct).  The
        one way coefficient-like operands enter device programs
        (solver couplings, face depths, boundary masks)."""
        from ..parallel import halo as halo_mod
        dt = np.dtype(self.dtype if dtype is None else dtype)
        stacked = jnp.asarray(layout.stack_global(
            self.decomp, np.asarray(global_arr), mode=mode, dtype=dt))
        return halo_mod.exchange(
            jax.device_put(stacked, self.sharding), self.mesh,
            self.halo_spec, depth=self.decomp.halo)

    def get_tmask(self):
        """Reference grid%get_tmask (grid_mod.f90:169-177)."""
        return self.tmask

    # ------------------------------------------------------------------
    # Scale-factor / area / latitude arrays.  The reference allocates
    # all of these eagerly per rank (grid_mod.f90:461-523, 121-134); on
    # a device the orthogonal-regular case would spend memory on values
    # kernels
    # can derive from scalars, so constant arrays materialise lazily on
    # first use — and :meth:`set_scale_factors` replaces any of them
    # with real per-point arrays (GO_ORTHOGONAL_CURVILINEAR support,
    # kernel_mod.f90:43-44).
    def _const_array(self, key: str, value: float):
        if key not in self._lazy:
            self._lazy[key] = jax.device_put(
                np.full(self.array_shape, value, dtype=self.dtype),
                self.sharding)
        return self._lazy[key]

    def _scale_array(self, name: str, const_key: str, value: float):
        if name in self._curvi:
            return self._curvi[name]
        return self._const_array(const_key, value)

    #: per-point array names set_scale_factors accepts (the reference's
    #: e1/e2/area/gphi families, grid_mod.f90:121-134)
    SCALE_FACTOR_NAMES = ("dx_t", "dx_u", "dx_v", "dx_f",
                          "dy_t", "dy_u", "dy_v", "dy_f",
                          "area_t", "area_u", "area_v",
                          "gphiu", "gphiv", "gphif")

    @property
    def is_curvilinear(self) -> bool:
        """True once per-point scale factors are installed — the grid
        then honours kernels declaring GO_ORTHOGONAL_CURVILINEAR."""
        return bool(self._curvi)

    def set_scale_factors(self, **arrays) -> None:
        """Install per-point scale factors / areas / latitudes.

        The reference allocates per-point ``e1u/e2v/...`` arrays a
        client could populate (grid_mod.f90:121-134, 461-523) and
        declares ``GO_ORTHOGONAL_CURVILINEAR`` (kernel_mod.f90:43-44)
        without ever filling them with anything non-constant; here the
        surface is live: pass GLOBAL ``(global_ny, global_nx)`` arrays
        for any of :data:`SCALE_FACTOR_NAMES` and they are scattered
        over the mesh (edge-replicated into halos/padding like the
        tmask) and served by the grid-property getters — flowing into
        :func:`~..api.kernel_meta.invoke` kernels that request them.
        Missing ``area_*`` entries are derived as ``dx_* * dy_*`` when
        both are present (grid_mod.f90:505-510).

        The flagship's fused GPU kernel takes scalar spacings and does
        not serve such grids; curvilinear physics runs on the
        jnp/invoke path.
        """
        if not self._initialised:
            raise RuntimeError("call init() before set_scale_factors()")
        unknown = sorted(set(arrays) - set(self.SCALE_FACTOR_NAMES))
        if unknown:
            raise ValueError(
                f"unknown scale-factor name(s) {unknown}; valid names: "
                f"{self.SCALE_FACTOR_NAMES}")
        for name, arr in arrays.items():
            # cast straight to the GRID's dtype (a Grid(dtype=float64)
            # must not round-trip through a narrower working precision)
            arr = np.asarray(arr, dtype=np.dtype(self.dtype))
            if arr.shape != (self.global_ny, self.global_nx):
                raise ValueError(
                    f"{name} must be the GLOBAL array "
                    f"({self.global_ny}, {self.global_nx}), got "
                    f"{arr.shape}")
            stacked = layout.stack_global(self.decomp, arr, mode="edge")
            dev = jax.device_put(stacked.astype(self.dtype),
                                 self.sharding)
            if self.wrap_x or self.wrap_y:
                # Periodic seams: halo cells must hold the WRAP
                # partner's metric values, not edge replication —
                # stencil reads of grid-property arrays cross the seam
                # (same treatment as the tmask in init()).
                from ..parallel import halo as halo_mod
                dev = halo_mod.exchange(dev, self.mesh, self.halo_spec,
                                        depth=self.decomp.halo)
            self._curvi[name] = dev
            # an explicitly-supplied array is authoritative; a derived
            # one must be re-derived below if its inputs changed
            self._curvi_derived.discard(name)
        for pt in ("t", "u", "v"):
            area = f"area_{pt}"
            inputs_changed = (f"dx_{pt}" in arrays or f"dy_{pt}" in arrays)
            if (area in self._curvi_derived and inputs_changed):
                del self._curvi[area]          # stale derivation
                self._curvi_derived.discard(area)
            if (area not in self._curvi
                    and f"dx_{pt}" in self._curvi
                    and f"dy_{pt}" in self._curvi):
                self._curvi[area] = (self._curvi[f"dx_{pt}"]
                                     * self._curvi[f"dy_{pt}"])
                self._curvi_derived.add(area)

    @property
    def dx_t(self): return self._scale_array("dx_t", "dx_c", self.dx)
    @property
    def dy_t(self): return self._scale_array("dy_t", "dy_c", self.dy)
    @property
    def dx_u(self): return self._scale_array("dx_u", "dx_c", self.dx)
    @property
    def dy_u(self): return self._scale_array("dy_u", "dy_c", self.dy)
    @property
    def dx_v(self): return self._scale_array("dx_v", "dx_c", self.dx)
    @property
    def dy_v(self): return self._scale_array("dy_v", "dy_c", self.dy)
    @property
    def dx_f(self): return self._scale_array("dx_f", "dx_c", self.dx)
    @property
    def dy_f(self): return self._scale_array("dy_f", "dy_c", self.dy)
    @property
    def area_t(self):
        return self._scale_array("area_t", "area", self.dx * self.dy)
    @property
    def area_u(self):
        return self._scale_array("area_u", "area", self.dx * self.dy)
    @property
    def area_v(self):
        return self._scale_array("area_v", "area", self.dx * self.dy)
    #: f-plane latitude, constant 50 degrees (grid_mod.f90:512-523)
    @property
    def gphiu(self): return self._scale_array("gphiu", "gphi", 50.0)
    @property
    def gphiv(self): return self._scale_array("gphiv", "gphi", 50.0)
    @property
    def gphif(self): return self._scale_array("gphif", "gphi", 50.0)

    def xt_1d(self) -> np.ndarray:
        """x coordinate of T points per stacked column (host array).

        Matches the reference exactly: global 1-based index * dx, extended
        into halo/padding columns (grid_mod.f90:536-556).
        """
        gx = layout.global_x_index(self.decomp)
        return ((gx + 1) * self.dx).astype(kinds.np_wp())

    def yt_1d(self) -> np.ndarray:
        gy = layout.global_y_index(self.decomp)
        return ((gy + 1) * self.dy).astype(kinds.np_wp())

    @property
    def xt(self):
        if "xt" not in self._lazy:
            arr = np.broadcast_to(self.xt_1d()[None, :], self.array_shape)
            self._lazy["xt"] = jax.device_put(
                np.ascontiguousarray(arr, dtype=self.dtype), self.sharding)
        return self._lazy["xt"]

    @property
    def yt(self):
        if "yt" not in self._lazy:
            arr = np.broadcast_to(self.yt_1d()[:, None], self.array_shape)
            self._lazy["yt"] = jax.device_put(
                np.ascontiguousarray(arr, dtype=self.dtype), self.sharding)
        return self._lazy["yt"]

    # ------------------------------------------------------------------
    def region_mask(self, off_x: int = 0, off_y: int = 0,
                    dtype=None) -> jax.Array:
        """Device mask (1 inside / 0 outside) of a global internal region

        shifted by the staggering offsets — the masking vocabulary that
        replaces per-rank loop bounds (SURVEY §7 'pad-and-mask').
        Cached per (off_x, off_y, dtype)."""
        dtype = jnp.dtype(dtype) if dtype is not None else self.dtype
        key = (off_x, off_y, str(dtype))
        if key not in self._region_masks:
            m = layout.region_mask(self.decomp, off_x, off_y)
            self._region_masks[key] = jax.device_put(
                m.astype(dtype), self.sharding)
        return self._region_masks[key]

    def region_mask_np(self, off_x: int = 0, off_y: int = 0) -> np.ndarray:
        return layout.region_mask(self.decomp, off_x, off_y)

    def external_mask(self, off_x: int = 0, off_y: int = 0,
                      dtype=None) -> jax.Array:
        """Device mask of the GLOBAL boundary ring (whole minus internal
        in global coordinates — layout.external_mask): the write mask of
        ``GO_EXTERNAL_PTS`` kernels.  Cached per (off_x, off_y, dtype)."""
        dtype = jnp.dtype(dtype) if dtype is not None else self.dtype
        key = ("ext", off_x, off_y, str(dtype))
        if key not in self._region_masks:
            m = layout.external_mask(self.decomp, off_x, off_y)
            self._region_masks[key] = jax.device_put(
                m.astype(dtype), self.sharding)
        return self._region_masks[key]

    def external_mask_np(self, off_x: int = 0, off_y: int = 0) -> np.ndarray:
        return layout.external_mask(self.decomp, off_x, off_y)


def grid_init(grid: Grid, dx: float, dy: float, tmask=None,
              time_step: float | None = None) -> None:
    """Module-level spelling matching the reference API (grid_mod.f90:330)."""
    grid.init(dx, dy, tmask, time_step=time_step)
