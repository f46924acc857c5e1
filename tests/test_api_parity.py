"""Executable parity checklist: the reference's public API surface.

One test file the reviewer can read top-to-bottom against SURVEY.md §2:
every user-facing symbol of the reference maps to an importable,
callable thing here, and the enum VALUES the PSyclone layer depends on
match argument_mod.f90 / kernel_mod.f90 / global_parameters_mod.f90
exactly.
"""
import dl_esm_inf_tpu as dl


def test_grid_field_surface():
    # grid_mod.f90 / field_mod.f90
    for name in ("Grid", "grid_init", "Field", "field_checksum",
                 "copy_field", "set_field", "free_field", "Region",
                 "decompose", "initialise", "finalise", "stop",
                 "model_write_log"):
        assert hasattr(dl, name), name
    for name in ("ARAKAWA_C", "ARAKAWA_B", "OFFSET_NE", "OFFSET_SW",
                 "BC_PERIODIC", "BC_EXTERNAL", "BC_NONE",
                 "U_POINTS", "V_POINTS", "T_POINTS", "F_POINTS",
                 "ALL_POINTS"):
        assert hasattr(dl, name), name


def test_kernel_metadata_enum_values():
    """The PSyclone-facing enums carry the REFERENCE's numeric values
    (argument_mod.f90:39-117, kernel_mod.f90:21-56,
    global_parameters_mod.f90:13-17)."""
    from dl_esm_inf_tpu.api import kernel_meta as km
    from dl_esm_inf_tpu.core import constants as c

    # access enums (argument_mod.f90:39-46)
    assert [int(a) for a in (km.GO_READ, km.GO_WRITE, km.GO_READWRITE,
                             km.GO_INC)] == [0, 1, 2, 3]
    assert [int(a) for a in (km.GO_MIN, km.GO_MAX, km.GO_SUM)] == [4, 5, 6]
    # iteration spaces (kernel_mod.f90:35-37)
    assert (km.GO_INTERNAL_PTS, km.GO_EXTERNAL_PTS,
            km.GO_ALL_PTS) == (0, 1, 2)
    # grid kinds (kernel_mod.f90:43-44)
    assert km.GO_ORTHOGONAL_REGULAR == 7
    assert km.GO_ORTHOGONAL_CURVILINEAR == 8
    # iteration-space enums (global_parameters_mod.f90:13-17)
    assert (int(c.GO_VERTICES), int(c.GO_EDGES), int(c.GO_CELLS)) \
        == (0, 1, 2)
    # the full grid-property menu exists (argument_mod.f90:75-112)
    for name in ("TIME_STEP", "GRID_AREA_T", "GRID_AREA_U", "GRID_AREA_V",
                 "GRID_MASK_T", "GRID_DX_T", "GRID_DX_U", "GRID_DX_V",
                 "GRID_DY_T", "GRID_DY_U", "GRID_DY_V", "GRID_LAT_U",
                 "GRID_LAT_V", "GRID_DX_CONST", "GRID_DY_CONST",
                 "GRID_X_MIN_INDEX", "GRID_X_MAX_INDEX",
                 "GRID_Y_MIN_INDEX", "GRID_Y_MAX_INDEX"):
        assert hasattr(km.GridProp, name), name
    # stencil/arg constructors (argument_mod.f90:48-61)
    assert km.go_stencil(0, 11, 0).reaches_off_point()
    assert km.go_arg(km.GO_READ, km.GO_CT).access == km.GO_READ
    assert km.GO_POINTWISE == km.go_stencil(0, 10, 0)


def test_field_method_surface():
    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                   dl.OFFSET_NE)
    grid.decompose(8, 8, ndomains=1)
    dl.grid_init(grid, 1.0, 1.0)
    f = dl.Field(grid, dl.U_POINTS)
    # reference r2d_field methods (field_mod.f90:110-194)
    for name in ("halo_exchange", "get_data", "set_data",
                 "read_from_device", "write_to_device",
                 "gather_inner_data", "checksum", "internal_region",
                 "whole_region", "apply_periodic_bcs", "local_view"):
        assert callable(getattr(f, name)), name
    assert f.internal is not None and f.whole is not None
    assert f.defined_on == dl.U_POINTS
    # grid surface (grid_mod.f90:75-177)
    for name in ("get_tmask", "decompose", "init", "subdomain",
                 "region_mask"):
        assert callable(getattr(grid, name)), name
    for name in ("dx_t", "dy_u", "area_v", "gphiu", "xt", "yt", "nx",
                 "ny", "tmask"):
        assert getattr(grid, name) is not None, name


def test_beyond_reference_surface():
    """Documented extensions a reference user gains when switching."""
    from dl_esm_inf_tpu.api.kernel_meta import Schedule, invoke
    from dl_esm_inf_tpu.launch import launch
    from dl_esm_inf_tpu.ops.sweep import make_stencil_sweep
    from dl_esm_inf_tpu.utils import checkpoint, diagnostics, profiling
    assert all(callable(x) for x in (
        Schedule, invoke, launch, make_stencil_sweep,
        checkpoint.save_fields_orbax, diagnostics.kinetic_energy,
        profiling.comms_schedule))
