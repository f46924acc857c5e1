"""dl_esm_inf_tpu — a 2D finite-difference earth-system modelling
infrastructure for GPUs.

A from-scratch JAX/XLA framework with the capabilities of
STFC's dl_esm_inf (the GOcean / PSyclone runtime library): Arakawa-C
staggered grids, grid-point-typed fields with internal/whole regions,
T-point masking, 2D domain decomposition with halo exchange, global
reductions and gathers, and kernel metadata — redesigned for SPMD
execution over a ``jax.sharding.Mesh`` instead of MPI ranks.

Quick start (the reference example, example/model.f90:54-109)::

    import dl_esm_inf_tpu as dl

    dl.initialise()
    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                   dl.OFFSET_NE)
    grid.decompose(jpiglo, jpjglo)
    dl.grid_init(grid, dx, dy, tmask)          # tmask: global (ny, nx)
    u = dl.Field(grid, dl.U_POINTS)
    u.halo_exchange(1)
    print(dl.field_checksum(u))
    dl.finalise()
"""
from .core.constants import (  # noqa: F401
    ARAKAWA_B, ARAKAWA_C, BC, BC_EXTERNAL, BC_NONE, BC_PERIODIC, GridKind,
    GridPoints, NBOUNDARY, Offset, OFFSET_ANY, OFFSET_NE, OFFSET_NW,
    OFFSET_SE, OFFSET_SW, ALL_POINTS, F_POINTS, T_POINTS, U_POINTS, V_POINTS,
    TMASK_DRY, TMASK_OUTSIDE, TMASK_WET)
from .core.decomposition import (  # noqa: F401
    Decomposition, choose_process_grid, decompose, reference_subdomains)
from .core.field import (  # noqa: F401
    Field, copy_field, copy_field_patch, field_checksum, free_field,
    set_field)
from .core.grid import Grid, grid_init  # noqa: F401
from .core.kinds import set_working_precision, wp  # noqa: F401
from .core.region import Halo, Region, Subdomain  # noqa: F401
from .parallel import collectives, halo  # noqa: F401
from .parallel.environment import (  # noqa: F401
    GOceanStop, finalise, get_num_ranks, get_rank, initialise,
    num_devices, on_master, stop)
from .utils.logging import model_write_log  # noqa: F401

__version__ = "0.1.0"
