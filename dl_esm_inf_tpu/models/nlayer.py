"""N-layer linear stacked shallow-water model (multi-level client).

Fifth client family: the two-layer demonstrator generalised to an
arbitrary number of stacked fluid layers, built on MULTI-LEVEL fields
(``Field(levels=N)``) — the whole layer stack lives in three 3D arrays
whose level axis rides through one halo exchange per step, something
the reference cannot express at all (its 3D-real exchange aborts,
parallel_comms_mod.f90:1738-1742).

Linearised layered equations (flat bottom, f=0, forward-backward),
``eta[k]`` the displacement of the interface ABOVE layer k (eta[0] is
the free surface), ``H[k]`` the rest thicknesses, reduced gravities
``gp[k]`` across each interior interface:

    P[k]      = g*eta[0] + sum_{j=1..k} gp[j]*eta[j]   (cumsum over k)
    du[k]/dt  = -dP[k]/dx,   dv[k]/dt = -dP[k]/dy      (on U/V faces)
    deta[k]/dt = -sum_{j=k..N-1} H[j]*div(u[j])        (reverse cumsum)

The level couplings are cumulative sums along the (unsharded) level
axis — pure per-chip compute; the horizontal stencils are the same
reach-1 C-grid operators as every other client.  For N=2 this reduces
exactly to models/twolayer.py (pinned by test).
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


class NLayerModel:
    """eta/u/v as (layers, ny, nx) multi-level fields."""

    def __init__(self, grid: dl.Grid, dt: float, layers: int = 3,
                 g: float = 9.81, gp=0.02, thickness=None):
        if layers < 1:
            raise ValueError(f"layers must be >= 1, got {layers}")
        self.grid = grid
        self.layers = int(layers)
        self.dt, self.g = float(dt), float(g)
        gp = np.broadcast_to(np.asarray(gp, np.float64),
                             (max(layers - 1, 1),)).copy()
        #: pressure weights per interface: g above layer 0, reduced
        #: gravities across the interior interfaces
        self._pw = np.concatenate(([g], gp[: layers - 1]))
        if thickness is None:
            thickness = np.full(layers, 100.0 / layers)
        self._H = np.broadcast_to(np.asarray(thickness, np.float64),
                                  (layers,)).copy()
        if np.any(self._H <= 0):
            raise ValueError("layer thicknesses must be positive")

        self.eta = dl.Field(grid, dl.T_POINTS, levels=layers)
        self.u = dl.Field(grid, dl.U_POINTS, levels=layers)
        self.v = dl.Field(grid, dl.V_POINTS, levels=layers)

        dtype = self.eta.dtype
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
    def set_initial(self, eta_global=None) -> None:
        """``eta_global``: (layers, gny, gnx) interface displacements."""
        if eta_global is None:
            return
        g = np.asarray(eta_global)
        d = self.grid.decomp
        want = (self.layers, d.global_ny, d.global_nx)
        if g.shape != want:
            raise ValueError(
                f"set_initial expects eta of shape {want}, got {g.shape}")
        stacked = np.stack([
            layout.stack_global(self.grid.decomp, g[k], mode="zeros",
                                dtype=np.dtype(self.eta.dtype))
            for k in range(self.layers)])
        self.eta.set_data(stacked)
        self.eta.halo_exchange(1)

    # ------------------------------------------------------------------
    def _step_math(self, eta, u, v, t_upd, u_wet, v_wet):
        """One forward-backward step on (..., layers, ly, lx) blocks —
        leading-dim agnostic (the level axis is -3), so an ensemble
        member axis broadcasts through unchanged."""
        dt = self.dt
        dx, dy = self.grid.dx, self.grid.dy
        pw = jnp.asarray(self._pw, eta.dtype)[:, None, None]
        H = jnp.asarray(self._H, eta.dtype)[:, None, None]
        # layer pressures: cumulative sum down the stack
        p = jnp.cumsum(pw * eta, axis=-3)
        un = (u - dt * st.ddx(p, dx)) * u_wet
        vn = (v - dt * st.ddy(p, dy)) * v_wet
        div = st.ddx_back(un, dx) + st.ddy_back(vn, dy)
        # each interface moves with the transport of every layer BELOW
        # it: reverse cumulative sum
        flux = jnp.flip(jnp.cumsum(jnp.flip(H * div, -3), axis=-3), -3)
        etan = jnp.where(t_upd > 0, eta - dt * flux, eta)
        return etan, un, vn

    def _block_step(self, exch, eta, u, v, t_upd, u_wet, v_wet):
        """One step on local blocks (the ensemble adapter's protocol)."""
        eta, u, v = exch((eta, u, v))
        return self._step_math(eta, u, v, t_upd, u_wet, v_wet)

    # ------------------------------------------------------------------
    def set_steps_per_exchange(self, steps_per_sweep: int) -> None:
        """Comm avoidance: K chained steps per depth-K exchange
        (ops/sweep.py)."""
        from ..ops.sweep import set_steps_per_exchange
        set_steps_per_exchange(self, reach=1,
                               steps_per_sweep=steps_per_sweep)

    # ------------------------------------------------------------------
    def step_program(self, nsteps: int):
        if nsteps not in self._step_cache:
            from ..ops.sweep import make_stencil_sweep, run_steps
            grid = self.grid
            exch = exchange_multi_fn(grid.halo_spec, depth=1)
            K = self._sweep_K
            sweepK = make_stencil_sweep(
                lambda s, masks, _: self._step_math(*s, *masks),
                spec=grid.halo_spec, steps_per_sweep=K, reach=1)

            def body(eta, u, v, t_upd, u_wet, v_wet):
                masks = (t_upd, u_wet, v_wet)
                return run_steps(nsteps, K, (eta, u, v),
                                 lambda _, s: sweepK(s, masks),
                                 lambda _, s: self._block_step(exch, *s,
                                                               *masks))

            blk3 = P(None, "y", "x")
            blk2 = P("y", "x")
            smapped = jax.shard_map(
                body, mesh=grid.mesh,
                in_specs=(blk3,) * 3 + (blk2,) * 3,
                out_specs=(blk3,) * 3, check_vma=False)
            self._step_cache[nsteps] = jax.jit(smapped)
        return self._step_cache[nsteps]

    def run(self, nsteps: int) -> None:
        prog = self.step_program(nsteps)
        out = prog(self.eta.data, self.u.data, self.v.data,
                   self._t_upd, self._u_wet, self._v_wet)
        self.eta.data, self.u.data, self.v.data = out

    # ------------------------------------------------------------------
    def gather(self) -> dict:
        return {"eta": self.eta.gather_inner_data(),
                "u": self.u.gather_inner_data(),
                "v": self.v.gather_inner_data()}

    def checksums(self) -> dict:
        return {"eta": self.eta.checksum(), "u": self.u.checksum(),
                "v": self.v.checksum()}


def build(gnx: int = 64, gny: int = 64, ndomains=None, dt: float = 0.02,
          layers: int = 3, tmask=None, halo_width: int = 1,
          steps_per_sweep: int = 1, **kw) -> NLayerModel:
    from ..ops.sweep import sweep_halo
    halo_width = sweep_halo(steps_per_sweep, 1, halo_width)
    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                   dl.OFFSET_NE)
    grid.decompose(gnx, gny, ndomains=ndomains, halo_width=halo_width)
    dl.grid_init(grid, 1.0, 1.0, default_tmask(gnx, gny)
                 if tmask is None else tmask)
    model = NLayerModel(grid, dt=dt, layers=layers, **kw)
    if steps_per_sweep > 1:
        model.set_steps_per_exchange(steps_per_sweep)
    return model


def golden_reference(eta0, tmask, dx, dy, dt, nsteps, g: float = 9.81,
                     gp=0.02, thickness=None) -> dict:
    """Independent NumPy transcription: explicit per-layer Python loops
    (no cumsum, no level vectorisation) over explicit rolls — a
    different formulation from the model's level-axis cumulative sums."""
    eta0 = np.asarray(eta0, np.float64)
    layers = eta0.shape[0]
    pw = np.concatenate(([g], np.broadcast_to(
        np.asarray(gp, np.float64), (max(layers - 1, 1),))[: layers - 1]))
    H = (np.full(layers, 100.0 / layers) if thickness is None
         else np.broadcast_to(np.asarray(thickness, np.float64),
                              (layers,)))
    wet_t = (tmask == 1).astype(np.float64)
    u_wet = wet_t * np.roll(wet_t, -1, axis=1)
    v_wet = wet_t * np.roll(wet_t, -1, axis=0)
    e = eta0.copy()
    u = np.zeros_like(e)
    v = np.zeros_like(e)
    xp = lambda a: np.roll(a, -1, axis=1)
    xm = lambda a: np.roll(a, 1, axis=1)
    yp = lambda a: np.roll(a, -1, axis=0)
    ym = lambda a: np.roll(a, 1, axis=0)
    for _ in range(nsteps):
        pk = np.zeros_like(e[0])
        divs = []
        for k in range(layers):
            pk = pk + pw[k] * e[k]
            u[k] = (u[k] - dt * (xp(pk) - pk) / dx) * u_wet
            v[k] = (v[k] - dt * (yp(pk) - pk) / dy) * v_wet
            divs.append((u[k] - xm(u[k])) / dx + (v[k] - ym(v[k])) / dy)
        acc = np.zeros_like(e[0])
        for k in range(layers - 1, -1, -1):
            acc = acc + H[k] * divs[k]
            e[k] = np.where(wet_t > 0, e[k] - dt * acc, e[k])
    return {"eta": e, "u": u, "v": v}
