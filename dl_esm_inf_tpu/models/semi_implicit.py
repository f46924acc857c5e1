"""Semi-implicit (theta-method) free-surface gravity-wave model.

The capability class the explicit clients cannot demonstrate: an
ELLIPTIC SOLVE inside the time step.  Real semi-implicit ocean codes
(the lineage the reference serves — NEMO's free-surface ancestors)
treat the fast gravity-wave terms implicitly so the time step is not
CFL-limited by sqrt(g*H); each step then requires solving a Helmholtz
problem for the new surface elevation.  On MPI that is a hand-written
CG with halo exchanges in the matvec and ``global_sum`` dot products
(parallel_utils_mod.f90:230-238); here the WHOLE step — exchange, rhs,
CG (``ops/solvers.pcg_block``: psum dots + ``lax.while_loop``),
velocity update — is ONE jitted shard_map program.

Discretisation (theta in (0.5, 1]; 0.5 = Crank-Nicolson, second order
and energy-conserving; 1.0 = backward Euler, dissipative)::

    u' = u - g dt d/dx(theta eta' + (1-theta) eta)        on U faces
    v' = v - g dt d/dy(theta eta' + (1-theta) eta)        on V faces
    eta' = eta - H dt div(theta (u',v') + (1-theta) (u,v)) on T points

Eliminating (u', v') gives the Helmholtz problem::

    (I + lam*L) eta' = eta - H dt div(u,v)
                       + g H theta (1-theta) dt^2 Lm eta

with ``lam_x = g H (theta dt)^2 / dx^2`` and ``L = -Lm`` the masked
5-point Laplacian whose faces conduct only between wet in-domain cells
(no-flux walls via the tmask, grid_mod.f90:94-102).  Unconditional
stability lets dt exceed the explicit limit by orders of magnitude;
``tests/test_solvers.py`` runs wave CFL ~ 8 stably and pins mass
conservation and the small-dt agreement with the explicit model.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

import dl_esm_inf_tpu as dl
from ..core import layout
from ..ops import stencils as st
from ..ops.solvers import (chebyshev_block, chebyshev_iterations,
                           helmholtz_coefficients, make_helmholtz_matvec,
                           pcg_block, pcg_solve)
from ..parallel.halo import exchange_fn, exchange_multi_fn
from .gravity_wave import default_tmask, gaussian_eta  # noqa: F401 (re-export)


class SemiImplicitModel:
    """eta/u/v fields + a fused, jitted multi-step implicit program."""

    def __init__(self, grid: dl.Grid, dt: float, theta: float = 0.5,
                 g: float = 9.81, depth: float = 100.0,
                 tol: float | None = None, maxiter: int | None = None,
                 differentiable: bool = False, solver: str = "cg",
                 open_north: bool = False, bc_amp: float = 0.0,
                 bc_omega: float = 0.0):
        """``differentiable=True`` swaps the in-step CG for the
        ``lax.custom_linear_solve``-wrapped variant: `jax.grad` flows
        through the implicit step via the adjoint (same symmetric)
        solve instead of unrolling iterations.  The iteration counter
        is unavailable in that mode (``run`` reports 0).

        ``solver="chebyshev"`` uses the dot-free iteration
        (`ops/solvers.chebyshev_block`) — zero scalar collectives per
        step and a STATIC iteration count, at the price of iterating
        to the eigenvalue-bound worst case instead of stopping at the
        measured residual.

        ``open_north=True`` makes the northmost wet row a RADIATIVE
        (Flather) open boundary with external elevation
        ``bc_amp * cos(bc_omega * t)`` (constant ``bc_amp`` at
        ``bc_omega=0``) — solved IMPLICITLY: the
        theta-implicit part of the boundary flux
        ``sqrt(g*H)*(eta_theta - eta_ext)`` couples a boundary cell
        only to itself, so it lands on the operator DIAGONAL (SPD
        preserved) while the explicit part and the external elevation
        ride the rhs (the flagship's Flather bc, nemolite2d.py, made
        implicit)."""
        if not 0.5 <= theta <= 1.0:
            raise ValueError(f"theta must be in [0.5, 1], got {theta}"
                             " (below 0.5 the scheme is unstable)")
        if solver not in ("cg", "chebyshev"):
            raise ValueError(f"solver must be 'cg' or 'chebyshev', "
                             f"got {solver!r}")
        if differentiable and solver != "cg":
            raise ValueError("differentiable=True requires solver='cg' "
                             "(the custom_linear_solve wrapper)")
        self.solver = solver
        self.differentiable = bool(differentiable)
        self.grid = grid
        self.dt = float(dt)
        self.theta = float(theta)
        self.g = float(g)
        from ..ops.solvers import default_tol
        self.tol = float(tol if tol is not None
                         else default_tol(grid.dtype))
        d = grid.decomp
        self._user_maxiter = maxiter is not None
        self.maxiter = int(maxiter if maxiter is not None
                           else 4 * (d.global_nx + d.global_ny))

        self.eta = dl.Field(grid, dl.T_POINTS)
        self.u = dl.Field(grid, dl.U_POINTS)
        self.v = dl.Field(grid, dl.V_POINTS)

        dtype = self.eta.dtype
        from .gravity_wave import wet_update_masks
        self._t_upd, self._u_wet, self._v_wet = wet_update_masks(
            grid, dtype)
        self.open_north = bool(open_north)
        self.bc_amp = float(bc_amp)
        self.bc_omega = float(bc_omega)
        self._istep0 = 0
        if self.open_north:
            if grid.halo_spec.wrap_y:
                raise ValueError("open_north is incompatible with a "
                                 "periodic y boundary")
            # host-side construction (the sharded t_upd cannot be
            # materialised under a multi-controller run): wet & strict
            # in-domain & north row, from the grid's host tmask copy
            gy = layout.global_y_index(d)
            gx = layout.global_x_index(d)
            geo_np = (((gy >= 0) & (gy < d.global_ny))[:, None]
                      & ((gx >= 0) & (gx < d.global_nx))[None, :])
            obc_np = ((grid._tmask_np == 1) & geo_np
                      & (gy == d.global_ny - 1)[:, None])
            self._obc = jax.device_put(
                jnp.asarray(obc_np.astype(np.dtype(dtype))),
                grid.sharding)
            # the boundary FACE (NE offset: v_j sits above T_j) must
            # not be driven by the interior momentum update — its
            # value is the Flather velocity, set after each solve
            self._v_wet = self._v_wet * (1.0 - self._obc)
        else:
            self._obc = jax.device_put(
                jnp.zeros_like(self._t_upd), grid.sharding)

        # depth: scalar (flat) or global (gny, gnx) T-point bathymetry.
        # Face depths use the NE-offset mean of adjacent T depths; the
        # Helmholtz face couplings are BUILT FROM the same face depths
        # the continuity flux uses, so the eliminated system is exactly
        # the theta-method discretisation (operator/rhs consistency).
        scale = g * (self.theta * dt) ** 2
        if np.isscalar(depth) or getattr(depth, "ndim", 0) == 0:
            self.depth = float(depth)
            hu_g = hv_g = None
            lam_x = scale * self.depth / grid.dx ** 2
            lam_y = scale * self.depth / grid.dy ** 2
            hmax = self.depth
        else:
            ht = np.asarray(depth, dtype=np.dtype(dtype))
            if ht.shape != (d.global_ny, d.global_nx):
                raise ValueError(
                    f"depth array must be (gny, gnx) = "
                    f"({d.global_ny}, {d.global_nx}), got {ht.shape}")
            if (ht <= 0).any():
                raise ValueError("depth must be positive everywhere "
                                 "(mask land with the tmask, not H<=0)")
            self.depth = ht
            hu_g = ht.copy()
            hu_g[:, :-1] = 0.5 * (ht[:, :-1] + ht[:, 1:])
            hv_g = ht.copy()
            hv_g[:-1, :] = 0.5 * (ht[:-1, :] + ht[1:, :])
            lam_x = scale * hu_g / grid.dx ** 2
            lam_y = scale * hv_g / grid.dy ** 2
            hmax = float(ht.max())
        self._lam_bounds = (1.0, 1.0 + 4.0 * scale * hmax
                            * (1.0 / grid.dx ** 2 + 1.0 / grid.dy ** 2))
        diag_extra = None
        if self.open_north:
            # theta-implicit Flather: rc = theta*dt*sqrt(g*H_b)/dy on
            # the open row (H_b = the boundary v-face depth, which is
            # the edge-replicated T depth there); same value recomputed
            # in-step from the hv operand for the rhs terms
            hb_row = (np.full(d.global_nx, self.depth)
                      if hu_g is None else hv_g[-1, :])
            rc_g = np.zeros((d.global_ny, d.global_nx))
            rc_g[-1, :] = (self.theta * dt
                           * np.sqrt(g * hb_row) / grid.dy)
            diag_extra = rc_g
            # Chebyshev's upper eigenvalue bound gains the largest
            # radiation diagonal (Gershgorin)
            self._lam_bounds = (self._lam_bounds[0],
                                self._lam_bounds[1]
                                + float(rc_g.max()))
        coeffs = helmholtz_coefficients(grid, lam_x, lam_y,
                                        diag_extra=diag_extra)
        self._coeffs = tuple(
            jax.device_put(jnp.asarray(c), grid.sharding) for c in coeffs)
        self._inv_diag = jax.device_put(
            jnp.asarray(1.0 / coeffs[4]), grid.sharding)
        self._weight = jax.device_put(
            jnp.asarray(layout.internal_mask(d).astype(np.dtype(dtype))),
            grid.sharding)

        if hu_g is None:
            full = np.full((d.global_ny, d.global_nx), self.depth,
                           dtype=np.dtype(dtype))
            self._hu = self._hv = grid.scatter_exchanged(full)
        else:
            self._hu = grid.scatter_exchanged(hu_g)
            self._hv = grid.scatter_exchanged(hv_g)
        self._step_cache = {}

    # ------------------------------------------------------------------
    def set_initial_eta(self, eta_global: np.ndarray) -> None:
        stacked = layout.stack_global(self.grid.decomp,
                                      np.asarray(eta_global), mode="zeros",
                                      dtype=np.dtype(self.eta.dtype))
        self.eta.set_data(stacked)
        self.eta.halo_exchange(1)

    # ------------------------------------------------------------------
    def _block_step(self, exch, istep, eta, u, v, t_upd, u_wet, v_wet,
                    wgt, e, w, n, s, diag, hu, hv, obc, invd=None):
        """One implicit step on a local block (inside shard_map):
        exchange, rhs, Helmholtz solve, velocity update.  Returns
        ``(eta, u, v, solver_iterations)``.  Works with a leading
        (ensemble) axis when ``solver="chebyshev"`` — the dot-free
        iteration is member-independent, where CG's psum dots would
        couple ensemble members into one misshapen scalar."""
        grid = self.grid
        spec = grid.halo_spec
        g, dt, th = self.g, self.dt, self.theta
        dx, dy = grid.dx, grid.dy
        exch1 = exchange_fn(spec, depth=1)
        mv = make_helmholtz_matvec(spec, e, w, n, s, diag)

        eta, u, v = exch((eta, u, v))
        # flux-form continuity with FACE depths (hu/hv; constant for
        # flat bathymetry), and the theta cross-term expressed through
        # the operator's own face coefficients — the eliminated system
        # is exactly the theta-method discretisation, variable H or not.
        # The open-boundary face is EXCLUDED from the interior fluxes
        # (its theta-implicit Flather flux lives on the operator
        # diagonal + rhs terms below); (e+w+n+s), not (diag-1), keeps
        # the radiation diagonal out of the Laplacian cross-term.
        v_int = v * (1.0 - obc)
        div_h = st.ddx_back(hu * u, dx) + st.ddy_back(hv * v_int, dy)
        lsum = e + w + n + s
        lm = (e * st.xp(eta) + w * st.xm(eta) + n * st.yp(eta)
              + s * st.ym(eta) - lsum * eta)
        rhs = eta - dt * div_h + ((1.0 - th) / th) * lm
        if self.open_north:
            # eta_ext at t^{n+1}; rc recomputed from the hv operand ==
            # the diag_extra baked into the operator at build
            rt1 = (istep + 1).astype(eta.dtype) * dt
            # cos_wp: the working-precision cosine (ops/trig.py; the
            # flagship's tidal forcing uses the same trig)
            from ..ops.trig import cos_wp
            eta_ext1 = self.bc_amp * cos_wp(self.bc_omega * rt1)
            rc = obc * (th * dt / dy) * jnp.sqrt(g * hv)
            rhs = rhs + rc * eta_ext1 \
                - obc * (dt / dy) * hv * (1.0 - th) * v
        rhs = jnp.where(t_upd > 0, rhs, eta)
        if self.solver == "chebyshev":
            lmin, lmax = self._lam_bounds
            # run to the static error bound: the CG-sized default
            # maxiter would SILENTLY truncate a stiff (large-dt) solve
            # (only an explicit maxiter caps the fixed-count iteration)
            nit = chebyshev_iterations(lmin, lmax, self.tol)
            if self._user_maxiter:
                nit = min(nit, self.maxiter)
            sol = chebyshev_block(rhs, eta, matvec=mv, lam_min=lmin,
                                  lam_max=lmax, niters=nit)
            k = jnp.asarray(nit, jnp.int32)
        elif self.differentiable:
            sol = pcg_solve(mv, rhs, wgt, tol=self.tol,
                            maxiter=self.maxiter, inv_diag=invd,
                            x0=eta)
            k = jnp.zeros((), jnp.int32)
        else:
            sol, k, _rel = pcg_block(mv, rhs, eta, wgt, tol=self.tol,
                                     maxiter=self.maxiter,
                                     inv_diag=invd)
        eta_new = exch1(jnp.where(t_upd > 0, sol, eta))
        eta_mix = th * eta_new + (1.0 - th) * eta
        u_new = u_wet * (u - g * dt * st.ddx(eta_mix, dx))
        v_new = v_wet * (v - g * dt * st.ddy(eta_mix, dy))
        if self.open_north:
            # the stored boundary-face velocity IS the Flather value at
            # t^{n+1} (v_wet is zeroed on that face) — next step's
            # explicit flux term reads it back
            v_new = v_new + obc * jnp.sqrt(g / hv) * (eta_new - eta_ext1)
        return eta_new, u_new, v_new, k

    def step_program(self, nsteps: int = 1,
                     remat_chunk: int | None = None):
        """Compiled program advancing (eta, u, v) by ``nsteps`` implicit
        steps; also returns the total CG iteration count.

        ``remat_chunk`` bounds reverse-mode AD memory through the loop
        (``ops/adjoint.py``).  Note the remat trade is steeper here:
        the backward sweep re-runs each step's implicit SOLVE once more
        (checkpointing recomputes the forward chunk), on top of the
        adjoint solve ``custom_linear_solve`` performs anyway."""
        key = (nsteps, remat_chunk)
        if key not in self._step_cache:
            grid = self.grid
            exch3 = exchange_multi_fn(grid.halo_spec, depth=1)

            def body(istep0, eta, u, v, t_upd, u_wet, v_wet, wgt,
                     e, w, n, s, diag, hu, hv, obc, invd):
                def one(i, carry):
                    eta, u, v, its = carry
                    eta, u, v, k = self._block_step(
                        exch3, istep0 + i, eta, u, v, t_upd, u_wet,
                        v_wet, wgt, e, w, n, s, diag, hu, hv, obc,
                        invd)
                    return eta, u, v, its + k

                carry0 = (eta, u, v, jnp.zeros((), jnp.int32))
                if remat_chunk is not None:
                    from ..ops.adjoint import checkpointed_fori
                    eta, u, v, its = checkpointed_fori(
                        nsteps, one, carry0, remat_chunk)
                else:
                    eta, u, v, its = lax.fori_loop(0, nsteps, one, carry0)
                return eta, u, v, its

            smapped = jax.shard_map(
                body, mesh=grid.mesh,
                in_specs=(P(),) + (P("y", "x"),) * 16,
                out_specs=((P("y", "x"),) * 3 + (P(),)), check_vma=False)
            self._step_cache[key] = jax.jit(smapped)
        return self._step_cache[key]

    def run(self, nsteps: int) -> dict:
        prog = self.step_program(nsteps)
        eta, u, v, its = prog(jnp.int32(self._istep0),
                              self.eta.data, self.u.data, self.v.data,
                              self._t_upd, self._u_wet, self._v_wet,
                              self._weight, *self._coeffs,
                              self._hu, self._hv, self._obc,
                              self._inv_diag)
        self.eta.data, self.u.data, self.v.data = eta, u, v
        self._istep0 += nsteps
        return {"cg_iterations": int(its),
                "cg_iterations_per_step": int(its) / max(nsteps, 1)}

    # ------------------------------------------------------------------
    def checksums(self) -> dict:
        return {"eta": self.eta.checksum(), "u": self.u.checksum(),
                "v": self.v.checksum()}

    def mass(self) -> float:
        """Total surface elevation over wet cells (conserved by the
        scheme up to solver tolerance — no-flux walls telescope)."""
        from ..parallel.collectives import masked_sum
        return masked_sum(self.eta.data, self._weight * self._t_upd)

    def gather(self) -> dict:
        return {"eta": self.eta.gather_inner_data(),
                "u": self.u.gather_inner_data(),
                "v": self.v.gather_inner_data()}


def build(gnx: int = 128, gny: int = 128, ndomains=None, dt: float = 1.0,
          theta: float = 0.5, g: float = 9.81, depth: float = 10.0,
          dx: float = 1.0, dy: float = 1.0, tmask=None, dtype=None,
          tol: float | None = None, maxiter=None,
          differentiable: bool = False, solver: str = "cg",
          open_north: bool = False, bc_amp: float = 0.0,
          bc_omega: float = 0.0) -> SemiImplicitModel:
    """Convenience constructor: grid + land-ring tmask + model
    (``open_north=True`` leaves the north edge wet — a radiative
    Flather boundary)."""
    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                   dl.OFFSET_NE, dtype=dtype)
    grid.decompose(gnx, gny, ndomains=ndomains, halo_width=1)
    if tmask is None:
        tmask = default_tmask(gnx, gny)
        if open_north:
            tmask = tmask.copy()
            tmask[-1, 1:-1] = 1
    dl.grid_init(grid, dx, dy, tmask)
    return SemiImplicitModel(grid, dt=dt, theta=theta, g=g, depth=depth,
                             tol=tol, maxiter=maxiter,
                             differentiable=differentiable,
                             solver=solver, open_north=open_north,
                             bc_amp=bc_amp, bc_omega=bc_omega)


def _main(argv=None):
    """CLI demo: ``python -m dl_esm_inf_tpu.models.semi_implicit
    [N [steps [dt [solver]]]]`` — runs far beyond the explicit CFL
    limit and reports stability, mass conservation and solver cost."""
    import sys
    import time

    args = list(sys.argv[1:] if argv is None else argv)
    N = int(args[0]) if args else 128
    nsteps = int(args[1]) if len(args) > 1 else 50
    dt = float(args[2]) if len(args) > 2 else 2.0
    solver = args[3] if len(args) > 3 else "cg"
    depth = 10.0
    cfl = (9.81 * depth) ** 0.5 * dt
    print(f"semi-implicit SW: {N}x{N}, dt={dt} (wave CFL ~ {cfl:.1f}),"
          f" theta=0.5, solver={solver}")
    m = build(N, N, dt=dt, depth=depth, solver=solver)
    m.set_initial_eta(gaussian_eta(N, N, amp=0.5))
    # warm-up must run the SAME nsteps program (step_program caches
    # per nsteps; a different length would leave the timed call to
    # compile, ~20-60 s on the chip)
    m.run(nsteps)
    m0 = m.mass()
    t0 = time.perf_counter()
    info = m.run(nsteps)
    wall = time.perf_counter() - t0
    g = m.gather()
    print(f"{nsteps} steps in {wall:.2f}s "
          f"({wall / nsteps * 1e3:.1f} ms/step, "
          f"{info['cg_iterations_per_step']:.0f} solver its/step)")
    print(f"max |eta| = {float(abs(g['eta']).max()):.4f}  "
          f"mass drift = {abs(m.mass() - m0) / max(abs(m0), 1e-30):.2e}")


if __name__ == "__main__":
    _main()
