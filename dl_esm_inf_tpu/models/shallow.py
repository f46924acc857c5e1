"""'Shallow'-style rotating shallow-water model: SW offset + periodic BCs.

The reference's second client family is the 'shallow' benchmark code —
SW staggering convention (U west of T, V south of T; grid_mod.f90:52)
with doubly-periodic boundaries.  The reference only half-supports this
regime (PBC + multi-rank aborts, grid_mod.f90:437-442; several SW-offset
paths stop, field_mod.f90:844/1048/1059); here it runs distributed.

Physics: linear rotating shallow water (f-plane) on the C grid,
forward-backward in the gravity terms, explicit in Coriolis:

    u^{n+1}   = u^n + f v̄ dt - g dt (eta_i - eta_{i-1})/dx     (SW: U_i
                                                               west of T_i)
    v^{n+1}   = v^n - f ū dt - g dt (eta_j - eta_{j-1})/dy
    eta^{n+1} = eta - H dt [(u_{i+1}-u_i)/dx + (v_{j+1}-v_j)/dy]

Periodic wrap rides the halo exchange (wrap pairs in the permutation);
no special-case boundary code exists anywhere in the model.
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import PartitionSpec as P

import dl_esm_inf_tpu as dl
from ..core import layout
from ..ops import stencils as st
from ..parallel.halo import exchange_multi_fn


class ShallowModel:
    """Doubly-periodic rotating SW on the SW-offset C grid."""

    def __init__(self, grid: dl.Grid, dt: float, g: float = 9.81,
                 depth: float = 100.0, f0: float = 1.0e-4):
        if grid.offset != dl.OFFSET_SW:
            raise ValueError("ShallowModel expects the SW offset convention")
        if not (grid.wrap_x and grid.wrap_y):
            raise ValueError("ShallowModel expects doubly-periodic BCs")
        self.grid = grid
        self.dt, self.g, self.depth, self.f0 = (float(dt), float(g),
                                                float(depth), float(f0))
        self.eta = dl.Field(grid, dl.T_POINTS)
        self.u = dl.Field(grid, dl.U_POINTS)
        self.v = dl.Field(grid, dl.V_POINTS)
        self._step_cache = {}
        self._sweep_K = 1

    def set_initial_eta(self, eta_global: np.ndarray) -> None:
        stacked = layout.stack_global(self.grid.decomp,
                                      np.asarray(eta_global), mode="zeros",
                                      dtype=np.dtype(self.eta.dtype))
        self.eta.set_data(stacked)
        self.eta.halo_exchange(1)

    def _step_math(self, eta, u, v):
        """One step on a block (total reach 1; no masks — the
        domain is all-wet periodic, so even halo cells evolve exactly
        like their interior twins: the deep-halo sweep needs no mask)."""
        g, H, dt, f = self.g, self.depth, self.dt, self.f0
        dx, dy = self.grid.dx, self.grid.dy
        # SW offset: U_i sits between T_{i-1} and T_i; V_j between
        # T_{j-1} and T_j.
        # Coriolis velocities interpolated to the opposite points:
        # v at U point averages v at (i-1,j),(i,j),(i-1,j+1),(i,j+1)
        v_at_u = 0.25 * (v + st.xm(v) + st.yp(v) + st.yp(st.xm(v)))
        u_at_v = 0.25 * (u + st.ym(u) + st.xp(u) + st.xp(st.ym(u)))
        u_new = u + f * dt * v_at_u - g * dt * st.ddx_back(eta, dx)
        v_new = v - f * dt * u_at_v - g * dt * st.ddy_back(eta, dy)
        eta_new = eta - H * dt * (st.ddx(u_new, dx) + st.ddy(v_new, dy))
        return eta_new, u_new, v_new

    def _block_step(self, exch, eta, u, v):
        eta, u, v = exch((eta, u, v))
        return self._step_math(eta, u, v)

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
                lambda s, _p, _s: self._step_math(*s),
                spec=grid.halo_spec, steps_per_sweep=K, reach=1)

            def body(eta, u, v):
                def one(_, s):
                    return self._block_step(exch, *s)

                if remat_chunk is not None:
                    from ..ops.adjoint import checkpointed_fori
                    return checkpointed_fori(nsteps, one, (eta, u, v),
                                             remat_chunk)
                return run_steps(nsteps, K, (eta, u, v),
                                 lambda _, s: sweepK(s), one)

            self._step_cache[key] = jax.jit(jax.shard_map(
                body, mesh=grid.mesh, in_specs=(P("y", "x"),) * 3,
                out_specs=(P("y", "x"),) * 3, check_vma=False))
        return self._step_cache[key]

    def run(self, nsteps: int) -> None:
        prog = self.step_program(nsteps)
        self.eta.data, self.u.data, self.v.data = prog(
            self.eta.data, self.u.data, self.v.data)

    def gather(self) -> dict:
        return {"eta": self.eta.gather_inner_data(),
                "u": self.u.gather_inner_data(),
                "v": self.v.gather_inner_data()}

    def checksums(self) -> dict:
        return {k: f.checksum() for k, f in
                (("eta", self.eta), ("u", self.u), ("v", self.v))}


def build(gnx: int = 64, gny: int = 64, ndomains=None, dt: float = 0.01,
          halo_width: int = 1,
          steps_per_sweep: int = 1, **kw) -> ShallowModel:
    from ..ops.sweep import sweep_halo
    halo_width = sweep_halo(steps_per_sweep, 1, halo_width)
    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_PERIODIC, dl.BC_PERIODIC, dl.BC_NONE),
                   dl.OFFSET_SW)
    grid.decompose(gnx, gny, ndomains=ndomains, halo_width=halo_width)
    dl.grid_init(grid, 1.0, 1.0)          # all-wet periodic domain
    model = ShallowModel(grid, dt=dt, **kw)
    if steps_per_sweep > 1:
        model.set_steps_per_exchange(steps_per_sweep)
    return model


def golden_reference(eta0: np.ndarray, dt: float, nsteps: int,
                     dx: float = 1.0, dy: float = 1.0, g: float = 9.81,
                     depth: float = 100.0, f0: float = 1.0e-4) -> dict:
    """Independent NumPy transcription using np.roll periodic wrap."""
    eta = eta0.astype(np.float64).copy()
    u = np.zeros_like(eta)
    v = np.zeros_like(eta)
    xm = lambda a: np.roll(a, 1, axis=1)
    xp = lambda a: np.roll(a, -1, axis=1)
    ym = lambda a: np.roll(a, 1, axis=0)
    yp = lambda a: np.roll(a, -1, axis=0)
    for _ in range(nsteps):
        v_at_u = 0.25 * (v + xm(v) + yp(v) + yp(xm(v)))
        u_at_v = 0.25 * (u + ym(u) + xp(u) + xp(ym(u)))
        un = u + f0 * dt * v_at_u - g * dt * (eta - xm(eta)) / dx
        vn = v - f0 * dt * u_at_v - g * dt * (eta - ym(eta)) / dy
        eta = eta - depth * dt * ((xp(un) - un) / dx + (yp(vn) - vn) / dy)
        u, v = un, vn
    return {"eta": eta, "u": u, "v": v}
