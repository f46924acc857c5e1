"""Linear gravity-wave shallow-water model (BASELINE.json config #2).

The smallest end-to-end client of the framework: grid + staggered fields
+ stencil step + BC masks + time loop (SURVEY §7 M2).  Forward-backward
time stepping on the Arakawa-C grid with NE offset:

    u^{n+1}   = u^n - g dt (eta^n_{i+1} - eta^n_i)/dx          on U faces
    v^{n+1}   = v^n - g dt (eta^n_{j+1} - eta^n_j)/dy          on V faces
    eta^{n+1} = eta^n - H dt [ (u^{n+1}_i - u^{n+1}_{i-1})/dx
                             + (v^{n+1}_j - v^{n+1}_{j-1})/dy ] on T points

Solid walls are expressed purely through the T mask: a face is wet only
if both adjacent T points are wet, so a land ring is a no-slip wall with
no special-case edge code (the reference's tmask philosophy,
grid_mod.f90:94-102).

The whole time step — halo exchange + three stencil updates — is ONE
``shard_map`` program; multiple steps run under ``lax.fori_loop`` inside
a single jit, so XLA fuses each step into a minimal number of HBM passes
and schedules the ppermutes.
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


def default_tmask(gnx: int, gny: int) -> np.ndarray:
    """All-wet domain with a one-cell land ring (solid walls)."""
    t = np.ones((gny, gnx), dtype=np.int32)
    t[0, :] = t[-1, :] = 0
    t[:, 0] = t[:, -1] = 0
    return t


def gaussian_eta(gnx: int, gny: int, amp: float = 1.0,
                 width: float = 0.1) -> np.ndarray:
    """Initial sea-surface bump in the domain centre."""
    x = (np.arange(gnx) - gnx / 2) / gnx
    y = (np.arange(gny) - gny / 2) / gny
    r2 = x[None, :] ** 2 + y[:, None] ** 2
    return amp * np.exp(-r2 / (2 * width ** 2))


def wet_update_masks(grid, dtype):
    """``(t_upd, u_wet, v_wet)`` update masks shared by the explicit
    and semi-implicit models.

    ``t_upd`` is the geometric update mask: wet T cells representing a
    real global cell, INCLUDING in-domain shard-halo cells (not just
    the internal region) — the deep-halo sweep path recomputes halo
    cells locally each sub-step, which requires them to evolve exactly
    like their interior twins on the neighbouring shard.  Face masks:
    a U/V face is wet only if both adjacent T points are
    (grid_mod.f90:94-102's tmask philosophy)."""
    tm = grid.tmask
    wet_t = (tm == 1)
    d = grid.decomp
    gx = layout.global_x_index(d)
    gy = layout.global_y_index(d)
    geo = jnp.asarray(((gy >= 0) & (gy < d.global_ny))[:, None]
                      & ((gx >= 0) & (gx < d.global_nx))[None, :])
    return ((wet_t & geo).astype(dtype),
            (wet_t & (st.xp(tm) == 1)).astype(dtype),
            (wet_t & (st.yp(tm) == 1)).astype(dtype))


class GravityWaveModel:
    """eta/u/v fields on a grid + a fused, jitted multi-step program."""

    def __init__(self, grid: dl.Grid, dt: float, g: float = 9.81,
                 depth: float = 100.0):
        self.grid = grid
        self.dt = float(dt)
        self.g = float(g)
        self.depth = float(depth)

        self.eta = dl.Field(grid, dl.T_POINTS)
        self.u = dl.Field(grid, dl.U_POINTS)
        self.v = dl.Field(grid, dl.V_POINTS)

        dtype = self.eta.dtype
        self._t_upd, self._u_wet, self._v_wet = wet_update_masks(
            grid, dtype)
        self._step_cache = {}
        self._sweep_K = 1

    # ------------------------------------------------------------------
    def set_initial_eta(self, eta_global: np.ndarray) -> None:
        stacked = layout.stack_global(self.grid.decomp,
                                      np.asarray(eta_global),
                                      mode="zeros",
                                      dtype=np.dtype(self.eta.dtype))
        self.eta.set_data(stacked)
        self.eta.halo_exchange(1)

    # ------------------------------------------------------------------
    def _step_math(self, eta, u, v, t_upd, u_wet, v_wet):
        """One forward-backward step on a block/window (total reach 1)."""
        g, H, dt = self.g, self.depth, self.dt
        dx, dy = self.grid.dx, self.grid.dy
        u_new = (u - g * dt * st.ddx(eta, dx)) * u_wet
        v_new = (v - g * dt * st.ddy(eta, dy)) * v_wet
        div = st.ddx_back(u_new, dx) + st.ddy_back(v_new, dy)
        eta_new = jnp.where(t_upd > 0, eta - H * dt * div, eta)
        return eta_new, u_new, v_new

    def _block_step(self, exch, eta, u, v, t_upd, u_wet, v_wet):
        """One step on a local block (inside shard_map)."""
        eta, u, v = exch((eta, u, v))
        return self._step_math(eta, u, v, t_upd, u_wet, v_wet)

    # ------------------------------------------------------------------
    def set_steps_per_exchange(self, steps_per_sweep: int) -> None:
        """Comm avoidance: K chained steps per depth-K exchange
        (ops/sweep.py)."""
        from ..ops.sweep import set_steps_per_exchange
        set_steps_per_exchange(self, reach=1,
                               steps_per_sweep=steps_per_sweep)

    def step_program(self, nsteps: int = 1,
                     remat_chunk: int | None = None):
        """Compiled program advancing (eta, u, v) by ``nsteps``.

        ``remat_chunk`` bounds the memory of reverse-mode AD through
        the loop (``ops/adjoint.py``): per-step checkpointing, plus a
        two-level scheme when ``remat_chunk > 1``.  Forward results
        are bitwise unchanged."""
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

            def body(eta, u, v, t_upd, u_wet, v_wet):
                masks = (t_upd, u_wet, v_wet)

                def one(_, s):
                    return self._block_step(exch, *s, *masks)

                if remat_chunk is not None:
                    from ..ops.adjoint import checkpointed_fori
                    return checkpointed_fori(nsteps, one, (eta, u, v),
                                             remat_chunk)
                return run_steps(nsteps, K, (eta, u, v),
                                 lambda _, s: sweepK(s, masks), one)

            smapped = jax.shard_map(
                body, mesh=grid.mesh,
                in_specs=(P("y", "x"),) * 6,
                out_specs=(P("y", "x"),) * 3, check_vma=False)
            self._step_cache[key] = jax.jit(smapped)
        return self._step_cache[key]

    def run(self, nsteps: int) -> None:
        prog = self.step_program(nsteps)
        eta, u, v = prog(self.eta.data, self.u.data, self.v.data,
                         self._t_upd, self._u_wet, self._v_wet)
        self.eta.data, self.u.data, self.v.data = eta, u, v

    # ------------------------------------------------------------------
    def checksums(self) -> dict:
        return {"eta": self.eta.checksum(), "u": self.u.checksum(),
                "v": self.v.checksum()}

    def gather(self) -> dict:
        return {"eta": self.eta.gather_inner_data(),
                "u": self.u.gather_inner_data(),
                "v": self.v.gather_inner_data()}


def build(gnx: int = 256, gny: int = 256, ndomains=None, dt: float = 0.05,
          g: float = 9.81, depth: float = 10.0, dx: float = 1.0,
          dy: float = 1.0, tmask=None, dtype=None, halo_width: int = 1,
          steps_per_sweep: int = 1) -> GravityWaveModel:
    """Convenience constructor: grid + land-ring tmask + model.

    ``steps_per_sweep=K`` runs K steps per depth-K halo exchange
    (``halo_width`` is deepened to K)."""
    from ..ops.sweep import sweep_halo
    halo_width = sweep_halo(steps_per_sweep, 1, halo_width)
    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                   dl.OFFSET_NE, dtype=dtype)
    grid.decompose(gnx, gny, ndomains=ndomains, halo_width=halo_width)
    dl.grid_init(grid, dx, dy, default_tmask(gnx, gny)
                 if tmask is None else tmask)
    model = GravityWaveModel(grid, dt=dt, g=g, depth=depth)
    if steps_per_sweep > 1:
        model.set_steps_per_exchange(steps_per_sweep)
    return model


def golden_reference(eta0: np.ndarray, tmask: np.ndarray, dx: float,
                     dy: float, dt: float, nsteps: int, g: float = 9.81,
                     depth: float = 100.0) -> dict:
    """Independent NumPy transcription (explicit slicing, fp64) — the

    'NumPy golden reference of the Fortran semantics' of SURVEY §4/§7.
    Operates on plain global arrays with no halos."""
    gny, gnx = eta0.shape
    eta = eta0.astype(np.float64).copy()
    u = np.zeros_like(eta)
    v = np.zeros_like(eta)
    wet = tmask == 1
    u_wet = np.zeros_like(eta)
    u_wet[:, :-1] = (wet[:, :-1] & wet[:, 1:]).astype(np.float64)
    v_wet = np.zeros_like(eta)
    v_wet[:-1, :] = (wet[:-1, :] & wet[1:, :]).astype(np.float64)

    for _ in range(nsteps):
        un = u.copy()
        vn = v.copy()
        un[:, :-1] = u[:, :-1] - g * dt * (eta[:, 1:] - eta[:, :-1]) / dx
        un *= u_wet
        vn[:-1, :] = v[:-1, :] - g * dt * (eta[1:, :] - eta[:-1, :]) / dy
        vn *= v_wet
        div = np.zeros_like(eta)
        div[:, 0] += un[:, 0] / dx
        div[:, 1:] += (un[:, 1:] - un[:, :-1]) / dx
        div[0, :] += vn[0, :] / dy
        div[1:, :] += (vn[1:, :] - vn[:-1, :]) / dy
        eta = np.where(wet, eta - depth * dt * div, eta)
        u, v = un, vn
    return {"eta": eta, "u": u, "v": v}
