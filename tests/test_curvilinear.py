"""Curvilinear scale factors: the GO_ORTHOGONAL_CURVILINEAR surface.

The reference allocates per-point dx/dy/area/gphi arrays a client could
populate (grid_mod.f90:121-134, 461-523) and declares the curvilinear
grid type (kernel_mod.f90:43-44) without ever making the surface
reachable; here it is live — Grid.set_scale_factors installs global
per-point arrays that flow through the grid-property getters and
invoke kernels — and dishonest combinations are rejected.
"""
import numpy as np
import pytest

import dl_esm_inf_tpu as dl
from dl_esm_inf_tpu.api.kernel_meta import (
    GO_ORTHOGONAL_CURVILINEAR, GO_READ, GO_WRITE, GO_CT, GridProp,
    go_arg, invoke, kernel)


def make_grid(gnx=12, gny=8, ndom=4):
    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                   dl.OFFSET_NE)
    grid.decompose(gnx, gny, ndomains=ndom)
    dl.grid_init(grid, 2.0, 3.0)
    return grid


def varying(gny, gnx, base):
    return base + np.arange(gny * gnx, dtype=float).reshape(gny, gnx)


def test_set_scale_factors_flow_through_getters():
    gnx, gny = 12, 8
    grid = make_grid(gnx, gny)
    assert not grid.is_curvilinear
    dxu = varying(gny, gnx, 100.0)
    dyu = varying(gny, gnx, 500.0)
    grid.set_scale_factors(dx_u=dxu, dy_u=dyu)
    assert grid.is_curvilinear
    # internal points of the scattered arrays equal the global input
    f = dl.Field(grid, dl.T_POINTS)
    f.data = grid.dx_u
    np.testing.assert_allclose(f.gather_inner_data(), dxu)
    # area_u derived as dx_u * dy_u (grid_mod.f90:505-510)
    f.data = grid.area_u
    np.testing.assert_allclose(f.gather_inner_data(), dxu * dyu)
    # untouched families still serve the regular-grid constants
    f.data = grid.dx_t
    np.testing.assert_allclose(f.gather_inner_data(),
                               np.full((gny, gnx), 2.0))


def test_curvilinear_kernel_uses_per_point_arrays():
    gnx, gny = 12, 8
    grid = make_grid(gnx, gny)
    dxt = varying(gny, gnx, 10.0)
    grid.set_scale_factors(dx_t=dxt)

    @kernel(args=[go_arg(GO_WRITE, GO_CT),
                  go_arg(GO_READ, GO_CT),
                  go_arg(GO_READ, GridProp.GRID_DX_T)],
            grid_type=GO_ORTHOGONAL_CURVILINEAR)
    def scale_by_dx(out, x, dx_arr):
        return x * dx_arr

    vals = varying(gny, gnx, 1.0)
    a = dl.Field(grid, dl.T_POINTS, init_global_data=vals)
    out = dl.Field(grid, dl.T_POINTS)
    invoke(scale_by_dx, out, a)
    np.testing.assert_allclose(out.gather_inner_data(), vals * dxt)


def test_curvilinear_kernel_rejected_on_regular_grid():
    grid = make_grid()

    @kernel(args=[go_arg(GO_WRITE, GO_CT), go_arg(GO_READ, GO_CT)],
            grid_type=GO_ORTHOGONAL_CURVILINEAR)
    def curv(out, x):
        return x

    a = dl.Field(grid, dl.T_POINTS)
    with pytest.raises(ValueError, match="CURVILINEAR.*scale factors"):
        invoke(curv, a, a)


def test_const_spacing_rejected_on_curvilinear_grid():
    gnx, gny = 12, 8
    grid = make_grid(gnx, gny)
    grid.set_scale_factors(dx_t=varying(gny, gnx, 1.0))

    @kernel(args=[go_arg(GO_WRITE, GO_CT), go_arg(GO_READ, GO_CT),
                  go_arg(GO_READ, GridProp.GRID_DX_CONST)])
    def uses_const(out, x, dx):
        return x * dx

    a = dl.Field(grid, dl.T_POINTS)
    with pytest.raises(ValueError, match="DX_CONST.*per-point"):
        invoke(uses_const, a, a)


def test_set_scale_factors_validation():
    grid = make_grid()
    with pytest.raises(ValueError, match="unknown scale-factor"):
        grid.set_scale_factors(dx_q=np.ones((8, 12)))
    with pytest.raises(ValueError, match="GLOBAL array"):
        grid.set_scale_factors(dx_t=np.ones((4, 4)))
    g2 = dl.Grid(dl.ARAKAWA_C,
                 (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                 dl.OFFSET_NE)
    g2.decompose(12, 8, ndomains=4)
    with pytest.raises(RuntimeError, match="init"):
        g2.set_scale_factors(dx_t=np.ones((8, 12)))


def test_latitude_only_grid_keeps_constant_spacing():
    """Installing only per-point latitudes must not break kernels that
    request the (still genuinely constant) GRID_DX/DY_CONST."""
    gnx, gny = 12, 8
    grid = make_grid(gnx, gny)
    grid.set_scale_factors(gphiu=varying(gny, gnx, 10.0))
    assert grid.is_curvilinear

    @kernel(args=[go_arg(GO_WRITE, GO_CT), go_arg(GO_READ, GO_CT),
                  go_arg(GO_READ, GridProp.GRID_DX_CONST)])
    def uses_const(out, x, dx):
        return x * dx

    vals = varying(gny, gnx, 1.0)
    a = dl.Field(grid, dl.T_POINTS, init_global_data=vals)
    out = dl.Field(grid, dl.T_POINTS)
    invoke(uses_const, out, a)
    np.testing.assert_allclose(out.gather_inner_data(), vals * 2.0)


def test_rederived_area_tracks_dx_update():
    """A derived area_* must be re-derived when its dx/dy inputs are
    replaced in a later call (no silently stale products)."""
    gnx, gny = 12, 8
    grid = make_grid(gnx, gny)
    A = varying(gny, gnx, 100.0)
    B = varying(gny, gnx, 500.0)
    grid.set_scale_factors(dx_t=A, dy_t=B)
    C = varying(gny, gnx, 900.0)
    grid.set_scale_factors(dx_t=C)
    f = dl.Field(grid, dl.T_POINTS)
    f.data = grid.area_t
    np.testing.assert_allclose(f.gather_inner_data(), C * B)
    # an explicitly supplied area is authoritative and never re-derived
    E = varying(gny, gnx, 7.0)
    grid.set_scale_factors(area_t=E)
    grid.set_scale_factors(dx_t=A)
    f.data = grid.area_t
    np.testing.assert_allclose(f.gather_inner_data(), E)


def test_periodic_seam_scale_factors():
    """On a periodic grid the halo cells of a per-point scale-factor
    array must hold the WRAP partner's values (stencil reads cross the
    seam), not edge replication."""
    gnx, gny = 16, 8
    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_PERIODIC, dl.BC_EXTERNAL, dl.BC_NONE),
                   dl.OFFSET_NE)
    grid.decompose(gnx, gny, ndomains=1, halo_width=1)
    dl.grid_init(grid, 2.0, 3.0)
    dxu = varying(gny, gnx, 100.0)
    grid.set_scale_factors(dx_u=dxu)
    arr = np.asarray(grid.dx_u)
    h = grid.decomp.halo
    # west halo column mirrors the global EAST column, row-aligned
    np.testing.assert_allclose(arr[h:h + gny, h - 1], dxu[:, -1])
    np.testing.assert_allclose(arr[h:h + gny, h + gnx], dxu[:, 0])


def test_curvilinear_kernel_in_fused_schedule():
    """Per-point scale-factor arrays stream as aux planes through the
    FUSED schedule tier too."""
    from dl_esm_inf_tpu.api.kernel_meta import Schedule

    gnx, gny = 32, 32
    def build():
        g = dl.Grid(dl.ARAKAWA_C,
                    (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                    dl.OFFSET_NE)
        g.decompose(gnx, gny, ndomains=4, halo_width=2, align_y=8)
        dl.grid_init(g, 2.0, 3.0)
        g.set_scale_factors(dx_t=varying(gny, gnx, 10.0))
        a = dl.Field(g, dl.T_POINTS,
                     init_global_data=varying(gny, gnx, 1.0))
        return g, a, dl.Field(g, dl.T_POINTS)

    @kernel(args=[go_arg(GO_WRITE, GO_CT), go_arg(GO_READ, GO_CT),
                  go_arg(GO_READ, GridProp.GRID_DX_T)],
            grid_type=GO_ORTHOGONAL_CURVILINEAR)
    def scale_dx(out, x, dxa):
        return x * dxa

    g1, a1, b1 = build()
    g2, a2, b2 = build()
    Schedule((scale_dx, b1, a1))()
    Schedule((scale_dx, b2, a2)).fused()
    np.testing.assert_allclose(b2.gather_inner_data(),
                               b1.gather_inner_data(), rtol=1e-12)
