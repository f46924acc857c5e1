"""Two-layer linear shallow-water model (baroclinic demonstrator).

A fourth client family, beyond anything the reference ecosystem ships:
two stacked fluid layers on the Arakawa-C grid (NE offset) carrying a
fast barotropic (surface) mode and a slow baroclinic (internal) mode.
Its purpose in the framework is structural: the state is SIX fields
(eta1, eta2, u1, v1, u2, v2), which exercises the n-field path of the
K-step sweep (ops/sweep.py) — the sweep and halo machinery must be
field-count-agnostic, like the reference's per-field exchange
machinery.

Linearised layered equations (flat bottom, f=0, forward-backward):

    P1 = g*eta1                      (upper-layer pressure / rho)
    P2 = g*eta1 + gp*eta2            (gp = reduced gravity)
    du_i/dt = -dP_i/dx,   dv_i/dt = -dP_i/dy       on U/V faces
    deta1/dt = -[H1 div(u1) + H2 div(u2)]          (surface)
    deta2/dt = -H2 div(u2)                         (interface)

Solid walls come from the T mask exactly as in gravity_wave (both
layers share the coastline).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import dl_esm_inf_tpu as dl
from ..core import layout
from ..ops import stencils as st
from ..parallel.halo import exchange_multi_fn
from .gravity_wave import default_tmask, gaussian_eta  # noqa: F401


class TwoLayerModel:
    """eta1/eta2 + per-layer velocities; fused multi-step programs."""

    def __init__(self, grid: dl.Grid, dt: float, g: float = 9.81,
                 gp: float = 0.02, h1: float = 20.0, h2: float = 80.0):
        self.grid = grid
        self.dt, self.g, self.gp = float(dt), float(g), float(gp)
        self.h1, self.h2 = float(h1), float(h2)

        self.eta1 = dl.Field(grid, dl.T_POINTS)
        self.eta2 = dl.Field(grid, dl.T_POINTS)
        self.u1 = dl.Field(grid, dl.U_POINTS)
        self.v1 = dl.Field(grid, dl.V_POINTS)
        self.u2 = dl.Field(grid, dl.U_POINTS)
        self.v2 = dl.Field(grid, dl.V_POINTS)

        dtype = self.eta1.dtype
        tm = grid.tmask
        wet_t = (tm == 1)
        d = grid.decomp
        gx = layout.global_x_index(d)
        gy = layout.global_y_index(d)
        geo = jnp.asarray(((gy >= 0) & (gy < d.global_ny))[:, None]
                          & ((gx >= 0) & (gx < d.global_nx))[None, :])
        self._t_upd = (wet_t & geo).astype(dtype)
        self._u_wet = (wet_t & (st.xp(tm) == 1)).astype(dtype)
        self._v_wet = (wet_t & (st.yp(tm) == 1)).astype(dtype)
        self._step_cache = {}
        self._sweep_K = 1

    # ------------------------------------------------------------------
    def set_initial(self, eta1_global=None, eta2_global=None) -> None:
        for fld, arr in ((self.eta1, eta1_global), (self.eta2, eta2_global)):
            if arr is None:
                continue
            fld.set_data(layout.stack_global(
                self.grid.decomp, np.asarray(arr), mode="zeros",
                dtype=np.dtype(fld.dtype)))
            fld.halo_exchange(1)

    # ------------------------------------------------------------------
    def _step_math(self, eta1, eta2, u1, v1, u2, v2, t_upd, u_wet, v_wet):
        """One forward-backward step on a block/window (total reach 1)."""
        g, gp, H1, H2, dt = self.g, self.gp, self.h1, self.h2, self.dt
        dx, dy = self.grid.dx, self.grid.dy
        p1 = g * eta1
        p2 = g * eta1 + gp * eta2
        u1n = (u1 - dt * st.ddx(p1, dx)) * u_wet
        v1n = (v1 - dt * st.ddy(p1, dy)) * v_wet
        u2n = (u2 - dt * st.ddx(p2, dx)) * u_wet
        v2n = (v2 - dt * st.ddy(p2, dy)) * v_wet
        div1 = st.ddx_back(u1n, dx) + st.ddy_back(v1n, dy)
        div2 = st.ddx_back(u2n, dx) + st.ddy_back(v2n, dy)
        eta1n = jnp.where(t_upd > 0,
                          eta1 - dt * (H1 * div1 + H2 * div2), eta1)
        eta2n = jnp.where(t_upd > 0, eta2 - dt * H2 * div2, eta2)
        return eta1n, eta2n, u1n, v1n, u2n, v2n

    def _block_step(self, exch, *state_and_masks):
        state, masks = state_and_masks[:6], state_and_masks[6:]
        state = exch(state)
        return self._step_math(*state, *masks)

    # ------------------------------------------------------------------
    def set_steps_per_exchange(self, steps_per_sweep: int) -> None:
        """Comm avoidance: K chained steps per depth-K exchange
        (ops/sweep.py)."""
        from ..ops.sweep import set_steps_per_exchange
        set_steps_per_exchange(self, reach=1,
                               steps_per_sweep=steps_per_sweep)

    def step_program(self, nsteps: int,
                     remat_chunk: int | None = None):
        if remat_chunk is not None and self._sweep_K > 1:
            raise ValueError(
                "remat_chunk needs the one-step differentiable path: "
                "build the model without steps_per_sweep")
        key = (nsteps, remat_chunk)
        if key not in self._step_cache:
            from ..ops.sweep import make_stencil_sweep, run_steps
            grid = self.grid
            exch = exchange_multi_fn(grid.halo_spec, depth=1)
            K = self._sweep_K
            sweepK = make_stencil_sweep(
                lambda s, masks, _: self._step_math(*s, *masks),
                spec=grid.halo_spec, steps_per_sweep=K, reach=1)

            def body(e1, e2, u1, v1, u2, v2, t_upd, u_wet, v_wet):
                state = (e1, e2, u1, v1, u2, v2)
                masks = (t_upd, u_wet, v_wet)

                def one(_, s):
                    return self._block_step(exch, *s, *masks)

                if remat_chunk is not None:
                    from ..ops.adjoint import checkpointed_fori
                    return checkpointed_fori(nsteps, one, state,
                                             remat_chunk)
                return run_steps(nsteps, K, state,
                                 lambda _, s: sweepK(s, masks), one)

            smapped = jax.shard_map(
                body, mesh=grid.mesh,
                in_specs=(P("y", "x"),) * 9,
                out_specs=(P("y", "x"),) * 6, check_vma=False)
            self._step_cache[key] = jax.jit(smapped)
        return self._step_cache[key]

    def run(self, nsteps: int) -> None:
        prog = self.step_program(nsteps)
        out = prog(self.eta1.data, self.eta2.data, self.u1.data,
                   self.v1.data, self.u2.data, self.v2.data,
                   self._t_upd, self._u_wet, self._v_wet)
        (self.eta1.data, self.eta2.data, self.u1.data, self.v1.data,
         self.u2.data, self.v2.data) = out

    # ------------------------------------------------------------------
    def gather(self) -> dict:
        return {"eta1": self.eta1.gather_inner_data(),
                "eta2": self.eta2.gather_inner_data(),
                "u1": self.u1.gather_inner_data(),
                "v1": self.v1.gather_inner_data(),
                "u2": self.u2.gather_inner_data(),
                "v2": self.v2.gather_inner_data()}

    def checksums(self) -> dict:
        return {"eta1": self.eta1.checksum(), "eta2": self.eta2.checksum()}


def build(gnx: int = 128, gny: int = 128, ndomains=None, dt: float = 0.02,
          tmask=None, halo_width: int = 1,
          steps_per_sweep: int = 1, **kw) -> TwoLayerModel:
    from ..ops.sweep import sweep_halo
    halo_width = sweep_halo(steps_per_sweep, 1, halo_width)
    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                   dl.OFFSET_NE)
    grid.decompose(gnx, gny, ndomains=ndomains, halo_width=halo_width)
    dl.grid_init(grid, 1.0, 1.0, default_tmask(gnx, gny)
                 if tmask is None else tmask)
    model = TwoLayerModel(grid, dt=dt, **kw)
    if steps_per_sweep > 1:
        model.set_steps_per_exchange(steps_per_sweep)
    return model


def golden_reference(eta1_0, eta2_0, tmask, dx, dy, dt, nsteps,
                     g: float = 9.81, gp: float = 0.02,
                     h1: float = 20.0, h2: float = 80.0) -> dict:
    """Independent NumPy transcription (explicit slicing, no rolls at
    the boundary because the land ring keeps faces dry there)."""
    wet_t = (tmask == 1).astype(np.float64)
    u_wet = wet_t * np.roll(wet_t, -1, axis=1)
    v_wet = wet_t * np.roll(wet_t, -1, axis=0)
    e1 = eta1_0.astype(np.float64).copy()
    e2 = eta2_0.astype(np.float64).copy()
    u1 = np.zeros_like(e1); v1 = np.zeros_like(e1)
    u2 = np.zeros_like(e1); v2 = np.zeros_like(e1)
    xp = lambda a: np.roll(a, -1, axis=1)
    xm = lambda a: np.roll(a, 1, axis=1)
    ym = lambda a: np.roll(a, 1, axis=0)
    yp = lambda a: np.roll(a, -1, axis=0)
    for _ in range(nsteps):
        p1 = g * e1
        p2 = g * e1 + gp * e2
        u1 = (u1 - dt * (xp(p1) - p1) / dx) * u_wet
        v1 = (v1 - dt * (yp(p1) - p1) / dy) * v_wet
        u2 = (u2 - dt * (xp(p2) - p2) / dx) * u_wet
        v2 = (v2 - dt * (yp(p2) - p2) / dy) * v_wet
        div1 = (u1 - xm(u1)) / dx + (v1 - ym(v1)) / dy
        div2 = (u2 - xm(u2)) / dx + (v2 - ym(v2)) / dy
        e1 = np.where(wet_t > 0, e1 - dt * (h1 * div1 + h2 * div2), e1)
        e2 = np.where(wet_t > 0, e2 - dt * h2 * div2, e2)
    return {"eta1": e1, "eta2": e2, "u1": u1, "v1": v1,
            "u2": u2, "v2": v2}
