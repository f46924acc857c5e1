"""NEMOLite2D expressed PURELY through the PSyclone metadata API.

The reference library exists to serve PSyclone-generated GOcean
layers: clients write metadata-carrying kernels (``*_code`` routines
with ``go_arg`` declarations) and PSyclone generates the loops and
halo exchanges.  This module is that client, written against this
framework's LIVE metadata runtime: every kernel of the NEMOLite2D
workflow — next_sshu/v, continuity, bc_ssh, momentum u/v, bc_solid,
bc_flather, the time-update copies — is declared with metadata and
bound into ONE :class:`~..api.kernel_meta.Schedule` per time step,
runnable three ways:

* eagerly, one ``invoke`` per kernel (the PSyclone-compatibility tier);
* as one jnp program with statically planned exchanges (``Schedule()``);
* as ONE fused sweep with a single up-front exchange
  (``Schedule.fused()`` — the tier PSyclone cannot generate).

The physics formulas are SHARED with :mod:`.nemolite2d` (the same
``momentum_u``/``momentum_v``/``continuity``/``next_sshu``/BC
functions), so the production model pins this layer's numerics; the
kernel set and naming mirror the GOcean NEMOLite2D PSyclone
application built on the reference (continuity/momentum/
boundary_conditions/time_update kernel modules).

Wet/dry classification is derived inside each kernel from the
``GO_GRID_MASK_T`` grid property (argument_mod.f90:85), exactly like
the reference's kernels test ``tmask`` point classes.
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from .. import Field, Grid, grid_init
from ..api.kernel_meta import (Arg, GO_ALL_PTS, GO_CT, GO_CU, GO_CV,
                               GO_EVERY, GO_R_SCALAR, GO_READ,
                               GO_READWRITE, GO_WRITE, GridProp,
                               Schedule, Stencil, kernel)
from ..core.constants import (ARAKAWA_C, BC_EXTERNAL, BC_NONE, OFFSET_NE,
                              T_POINTS, U_POINTS, V_POINTS)
from . import nemolite2d as nl

_E = Stencil(0, 11, 0)      # reads centre + East
_W = Stencil(0, 110, 0)     # reads centre + West
_N = Stencil(10, 10, 0)     # reads centre + North
_S = Stencil(0, 10, 10)     # reads centre + South
_FULL = Stencil(111, 111, 111)


def _wet_out(tm, dtype):
    return (tm == 1).astype(dtype), (tm == -1).astype(dtype)


@kernel(args=[Arg(GO_WRITE, GO_CU),
              Arg(GO_READ, GO_CT, _E),
              Arg(GO_READ, GridProp.GRID_MASK_T, _E)],
        name="next_sshu_code")
def next_sshu_code(sshn_u, sshn_t, tmask):
    t_wet, _ = _wet_out(tmask, sshn_t.dtype)
    return nl.next_sshu(sshn_t, t_wet)


@kernel(args=[Arg(GO_WRITE, GO_CV),
              Arg(GO_READ, GO_CT, _N),
              Arg(GO_READ, GridProp.GRID_MASK_T, _N)],
        name="next_sshv_code")
def next_sshv_code(sshn_v, sshn_t, tmask):
    t_wet, _ = _wet_out(tmask, sshn_t.dtype)
    return nl.next_sshv(sshn_t, t_wet)


@kernel(args=[Arg(GO_WRITE, GO_CT),
              Arg(GO_READ, GO_CT),
              Arg(GO_READ, GO_CU, _W), Arg(GO_READ, GO_CV, _S),
              Arg(GO_READ, GO_CU, _W), Arg(GO_READ, GO_CV, _S),
              Arg(GO_READ, GO_CU, _W), Arg(GO_READ, GO_CV, _S),
              Arg(GO_READ, GO_R_SCALAR),
              Arg(GO_READ, GridProp.GRID_DX_CONST),
              Arg(GO_READ, GridProp.GRID_DY_CONST),
              Arg(GO_READ, GridProp.GRID_MASK_T)],
        name="continuity_code")
def continuity_code(ssha_t, sshn_t, un, vn, sshn_u, sshn_v, hu, hv,
                    rdt, dx, dy, tmask):
    t_wet, _ = _wet_out(tmask, sshn_t.dtype)
    depu = hu + sshn_u
    depv = hv + sshn_v
    ssha = nl.continuity(sshn_t, un, vn, depu, depv, rdt=rdt,
                         dx=dx, dy=dy)
    return jnp.where(t_wet > 0, ssha, sshn_t)


@kernel(args=[Arg(GO_READWRITE, GO_CT),
              Arg(GO_READ, GO_R_SCALAR),
              Arg(GO_READ, GridProp.GRID_MASK_T, _FULL)],
        name="bc_ssh_code")
def bc_ssh_code(ssha_t, forcing, tmask):
    t_wet, out_f = _wet_out(tmask, ssha_t.dtype)
    from ..ops import stencils as st
    near_out = jnp.minimum(st.xp(out_f) + st.xm(out_f)
                           + st.yp(out_f) + st.ym(out_f), 1.0)
    return nl.bc_ssh(ssha_t, t_wet * near_out,
                     jnp.asarray(forcing, ssha_t.dtype))


@kernel(args=[Arg(GO_WRITE, GO_CU),
              Arg(GO_READ, GO_CU, _FULL), Arg(GO_READ, GO_CV, _FULL),
              Arg(GO_READ, GO_CT, _E), Arg(GO_READ, GO_CT, _E),
              Arg(GO_READ, GO_CU), Arg(GO_READ, GO_CV, _FULL),
              Arg(GO_READ, GO_CU), Arg(GO_READ, GO_CV, _FULL),
              Arg(GO_READ, GO_CT, _E),
              Arg(GO_READ, GO_R_SCALAR), Arg(GO_READ, GO_R_SCALAR),
              Arg(GO_READ, GO_R_SCALAR), Arg(GO_READ, GO_R_SCALAR),
              Arg(GO_READ, GO_R_SCALAR),
              Arg(GO_READ, GridProp.GRID_DX_CONST),
              Arg(GO_READ, GridProp.GRID_DY_CONST)],
        name="momentum_u_code")
def momentum_u_code(ua, un, vn, sshn_t, ssha_t, sshn_u, sshn_v,
                    hu, hv, ht, rdt, visc, cbfr, fcor, g, dx, dy):
    # every Params field the momentum maths reads must come from the
    # caller (a partial Params would silently mix default g into the
    # pressure gradient while the Flather BCs use the user's)
    p = nl.Params(rdt=rdt, cbfr=cbfr, visc=visc, g=g)
    return nl.momentum_u(un, vn, sshn_t, ssha_t, sshn_u, ht, hu,
                         hv + sshn_v, p=p, dx=dx, dy=dy, fcor=fcor)


@kernel(args=[Arg(GO_WRITE, GO_CV),
              Arg(GO_READ, GO_CU, _FULL), Arg(GO_READ, GO_CV, _FULL),
              Arg(GO_READ, GO_CT, _N), Arg(GO_READ, GO_CT, _N),
              Arg(GO_READ, GO_CV), Arg(GO_READ, GO_CU, _FULL),
              Arg(GO_READ, GO_CV), Arg(GO_READ, GO_CU, _FULL),
              Arg(GO_READ, GO_CT, _N),
              Arg(GO_READ, GO_R_SCALAR), Arg(GO_READ, GO_R_SCALAR),
              Arg(GO_READ, GO_R_SCALAR), Arg(GO_READ, GO_R_SCALAR),
              Arg(GO_READ, GO_R_SCALAR),
              Arg(GO_READ, GridProp.GRID_DX_CONST),
              Arg(GO_READ, GridProp.GRID_DY_CONST)],
        name="momentum_v_code")
def momentum_v_code(va, un, vn, sshn_t, ssha_t, sshn_v, sshn_u,
                    hv, hu, ht, rdt, visc, cbfr, fcor, g, dx, dy):
    p = nl.Params(rdt=rdt, cbfr=cbfr, visc=visc, g=g)
    return nl.momentum_v(un, vn, sshn_t, ssha_t, sshn_v, ht, hv,
                         hu + sshn_u, p=p, dx=dx, dy=dy, fcor=fcor)


@kernel(args=[Arg(GO_READWRITE, GO_CU),
              Arg(GO_READ, GridProp.GRID_MASK_T, _E)],
        name="bc_solid_u_code")
def bc_solid_u_code(ua, tmask):
    from ..ops import stencils as st
    t_wet, _ = _wet_out(tmask, ua.dtype)
    return jnp.where(t_wet * st.xp(t_wet) > 0, ua,
                     jnp.zeros((), ua.dtype))


@kernel(args=[Arg(GO_READWRITE, GO_CV),
              Arg(GO_READ, GridProp.GRID_MASK_T, _N)],
        name="bc_solid_v_code")
def bc_solid_v_code(va, tmask):
    from ..ops import stencils as st
    t_wet, _ = _wet_out(tmask, va.dtype)
    return jnp.where(t_wet * st.yp(t_wet) > 0, va,
                     jnp.zeros((), va.dtype))


@kernel(args=[Arg(GO_READWRITE, GO_CU),
              Arg(GO_READ, GO_CU), Arg(GO_READ, GO_CU),
              Arg(GO_READ, GO_R_SCALAR),
              Arg(GO_READ, GridProp.GRID_MASK_T, _E)],
        name="bc_flather_u_code")
def bc_flather_u_code(ua, sshn_u, hu, g, tmask):
    from ..ops import stencils as st
    t_wet, out_f = _wet_out(tmask, ua.dtype)
    flather_u = t_wet * st.xp(out_f) + out_f * st.xp(t_wet)
    return nl.bc_flather_u(ua, sshn_u, hu, flather_u,
                           nl.Params(g=g))


@kernel(args=[Arg(GO_READWRITE, GO_CV),
              Arg(GO_READ, GO_CV), Arg(GO_READ, GO_CV),
              Arg(GO_READ, GO_R_SCALAR),
              Arg(GO_READ, GridProp.GRID_MASK_T, _N)],
        name="bc_flather_v_code")
def bc_flather_v_code(va, sshn_v, hv, g, tmask):
    from ..ops import stencils as st
    t_wet, out_f = _wet_out(tmask, va.dtype)
    flather_v = t_wet * st.yp(out_f) + out_f * st.yp(t_wet)
    return nl.bc_flather_v(va, sshn_v, hv, flather_v,
                           nl.Params(g=g))


@kernel(args=[Arg(GO_WRITE, GO_EVERY), Arg(GO_READ, GO_EVERY)],
        iterates_over=GO_ALL_PTS, name="copy_code")
def copy_code(dst, src):
    """The time-update field copy (the reference app's copy kernel,
    infrastructure_mod.f90:13-41 — there dead code, here live)."""
    return src


class NemoLite2DPsy:
    """The flagship assembled from metadata kernels + one Schedule.

    ``halo_width`` must cover the schedule's dataflow erosion for the
    fused tier (``Schedule.fused_erosion``: 3 for one sequence, +2 per
    further in-kernel repeat — build with ``halo_width=8`` to enable
    ``repeats=3`` temporal blocking); the jnp tier needs only 1.
    """

    def __init__(self, gnx: int, gny: int, params: nl.Params = nl.Params(),
                 depth: float = 100.0, halo_width: int = 5,
                 ndomains=None, align: int | None = None,
                 align_y: int = 1):
        grid = Grid(ARAKAWA_C, (BC_EXTERNAL, BC_EXTERNAL, BC_NONE),
                    OFFSET_NE)
        grid.decompose(gnx, gny, ndomains=ndomains,
                       halo_width=halo_width, align=align,
                       align_y=align_y)
        grid_init(grid, 1000.0, 1000.0, nl.default_tmask(gnx, gny, True))
        self.grid = grid
        self.p = params
        self.fcor = float(2.0 * params.omega * np.sin(50.0 * params.d2r))
        F = lambda pts: Field(grid, pts)
        self.sshn_t, self.ssha_t = F(T_POINTS), F(T_POINTS)
        self.sshn_u, self.sshn_v = F(U_POINTS), F(V_POINTS)
        self.un, self.vn = F(U_POINTS), F(V_POINTS)
        self.ua, self.va = F(U_POINTS), F(V_POINTS)
        wp = grid.dtype
        dep = np.full(grid.array_shape, depth)
        self.ht = Field(grid, T_POINTS)
        self.hu, self.hv = F(U_POINTS), F(V_POINTS)
        for f in (self.ht, self.hu, self.hv):
            f.data = jnp.asarray(dep, wp)
        self._sched = self._build_schedule()
        self._step = 0

    def _build_schedule(self) -> Schedule:
        p, fc = self.p, self.fcor
        mom_sc = (p.rdt, p.visc, p.cbfr, fc, p.g)
        return Schedule(
            (next_sshu_code, self.sshn_u, self.sshn_t),
            (next_sshv_code, self.sshn_v, self.sshn_t),
            (continuity_code, self.ssha_t, self.sshn_t, self.un,
             self.vn, self.sshn_u, self.sshn_v, self.hu, self.hv,
             p.rdt),
            (bc_ssh_code, self.ssha_t, 0.0),
            (momentum_u_code, self.ua, self.un, self.vn, self.sshn_t,
             self.ssha_t, self.sshn_u, self.sshn_v, self.hu, self.hv,
             self.ht, *mom_sc),
            (momentum_v_code, self.va, self.un, self.vn, self.sshn_t,
             self.ssha_t, self.sshn_v, self.sshn_u, self.hv, self.hu,
             self.ht, *mom_sc),
            (bc_solid_u_code, self.ua),
            (bc_solid_v_code, self.va),
            (bc_flather_u_code, self.ua, self.sshn_u, self.hu, p.g),
            (bc_flather_v_code, self.va, self.sshn_v, self.hv, p.g),
            (copy_code, self.sshn_t, self.ssha_t),
            (copy_code, self.un, self.ua),
            (copy_code, self.vn, self.va),
        )

    def _scalars_at(self, step: int):
        """User-scalar vector for one step (forcing varies with time)."""
        p, fc = self.p, self.fcor
        forcing = nl.tidal_forcing_host((step + 1) * p.rdt, p)
        mom = [p.rdt, p.visc, p.cbfr, fc, p.g]
        return [p.rdt, forcing, *mom, *mom, p.g, p.g]

    def set_initial_ssh(self, eta0) -> None:
        f = Field(self.grid, T_POINTS, init_global_data=eta0)
        self.sshn_t.data = f.data

    def run(self, nsteps: int, *, fused: bool = False) -> None:
        if fused:
            # whole-run driver: nsteps fused steps in ONE dispatch, with
            # the per-step forcing series bound up front
            runp = self._sched.fused_program(nsteps)
            runp(scalars=[self._scalars_at(self._step + k)
                          for k in range(nsteps)])
            self._step += nsteps
            return
        for _ in range(nsteps):
            self._sched(self._scalars_at(self._step))
            self._step += 1

    def gather(self) -> dict:
        return {"sshn": self.sshn_t.gather_inner_data(),
                "un": self.un.gather_inner_data(),
                "vn": self.vn.gather_inner_data()}
