"""Passive tracer transport: flux-form advection-diffusion on the C grid.

The workhorse companion of every NEMO-family dynamical core the
reference serves (temperature/salinity/pollutant transport) — and the
sixth client model of this framework.  Finite-volume flux form with the
tmask philosophy throughout (a face is wet only if both adjacent T
cells are, grid_mod.f90:94-102), so land is a no-flux wall with no
special-case code and tracer mass is conserved to roundoff: every
interior face flux appears in exactly two cell updates with opposite
signs (``tests/test_tracer.py`` pins ~1e-13 relative drift).

Two advection schemes:

* ``scheme="upwind"`` — donor-cell (stencil reach 1): monotone,
  positivity-preserving at CFL <= 1, first-order.
* ``scheme="vanleer"`` — MUSCL reconstruction with the van Leer
  limiter (reach 2): second-order in smooth regions, TVD (no new
  extrema), degrades to donor-cell where the far-upwind neighbour is
  dry.  The limited correction multiplies the REAL face difference, so
  flat regions contribute exactly zero regardless of the guarded
  ratio.

Diffusion is the masked-gradient Laplacian ``div(kappa wet grad C)`` —
also flux-form, also exactly conservative.

Velocities are prescribed and steady (faces; masked at build), halo-
exchanged once to FULL halo depth so the deep-halo temporal-blocking
sweep recomputes halo cells exactly like their interior twins.
``streamfunction_velocities`` builds discretely divergence-free faces
from a streamfunction at F points (the corner convention makes the
C-grid divergence telescope to zero exactly).

The model exposes the ``_block_step`` protocol, so the ensemble runner,
ETKF/LETKF and 4D-Var compose: observing the tracer at later times and
running ``assimilate`` inverts for the initial release — the
source-identification workflow (``tests/test_tracer.py``).
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
from ..parallel.halo import exchange_multi_fn
from .gravity_wave import gaussian_eta, wet_update_masks  # noqa: F401


def _van_leer(r):
    """phi(r) = (r + |r|) / (1 + |r|) — smooth TVD limiter."""
    return (r + jnp.abs(r)) / (1.0 + jnp.abs(r))


def face_values_x(c, t_upd, u, scheme: str):
    """Tracer reconstruction at U faces (face i between T_i and
    T_{i+1}, NE offset)."""
    up = c
    dn = st.xp(c)
    if scheme == "upwind":
        return jnp.where(u > 0, up, dn)
    dc = dn - up                       # real face difference
    safe = jnp.where(dc == 0, jnp.ones_like(dc), dc)
    # u > 0: upwind cell i, far-upwind i-1;  u < 0: mirrored
    r_pos = (up - st.xm(c)) / safe
    r_neg = (st.xp(dn) - dn) / safe
    corr_pos = 0.5 * _van_leer(r_pos) * dc * st.xm(t_upd)
    corr_neg = 0.5 * _van_leer(r_neg) * dc * st.xp(st.xp(t_upd))
    return jnp.where(u > 0, up + corr_pos, dn - corr_neg)


def face_values_y(c, t_upd, v, scheme: str):
    up = c
    dn = st.yp(c)
    if scheme == "upwind":
        return jnp.where(v > 0, up, dn)
    dc = dn - up
    safe = jnp.where(dc == 0, jnp.ones_like(dc), dc)
    r_pos = (up - st.ym(c)) / safe
    r_neg = (st.yp(dn) - dn) / safe
    corr_pos = 0.5 * _van_leer(r_pos) * dc * st.ym(t_upd)
    corr_neg = 0.5 * _van_leer(r_neg) * dc * st.yp(st.yp(t_upd))
    return jnp.where(v > 0, up + corr_pos, dn - corr_neg)


def tracer_step(c, u, v, t_upd, u_wet, v_wet, *, dx, dy, dt, kappa,
                scheme):
    """One conservative flux-form step (reach 1 upwind / 2 vanleer):
    the tracer physics shared by the standalone model and the
    online-coupled step."""
    fx = u * face_values_x(c, t_upd, u, scheme)
    fy = v * face_values_y(c, t_upd, v, scheme)
    tend = -(st.ddx_back(fx, dx) + st.ddy_back(fy, dy))
    if kappa:
        gx = st.ddx(c, dx) * u_wet
        gy = st.ddy(c, dy) * v_wet
        tend = tend + kappa * (st.ddx_back(gx, dx)
                               + st.ddy_back(gy, dy))
    return jnp.where(t_upd > 0, c + dt * tend, c)


class TracerModel:
    """Tracer C on T points advected by steady face velocities."""

    def __init__(self, grid: dl.Grid, dt: float, u, v,
                 kappa: float = 0.0, scheme: str = "vanleer"):
        if scheme not in ("upwind", "vanleer"):
            raise ValueError(f"scheme must be 'upwind' or 'vanleer', "
                             f"got {scheme!r}")
        self.grid = grid
        self.dt = float(dt)
        self.kappa = float(kappa)
        self.scheme = scheme
        self.reach = 1 if scheme == "upwind" else 2
        if grid.halo_spec.halo < self.reach:
            raise ValueError(
                f"scheme={scheme!r} has stencil reach {self.reach} and "
                f"needs halo_width >= {self.reach}, got "
                f"{grid.halo_spec.halo} (build() sets this when "
                "halo_width is left None)")

        self.c = dl.Field(grid, dl.T_POINTS)
        dtype = self.c.dtype
        self._t_upd, self._u_wet, self._v_wet = wet_update_masks(
            grid, dtype)

        # steady velocities: mask at the faces, exchange to FULL halo
        # depth once (the deep-halo sweep needs them valid like masks)
        d = grid.decomp
        uf = dl.Field(grid, dl.U_POINTS,
                      init_global_data=np.broadcast_to(
                          np.asarray(u, dtype), (d.global_ny,
                                                 d.global_nx)))
        vf = dl.Field(grid, dl.V_POINTS,
                      init_global_data=np.broadcast_to(
                          np.asarray(v, dtype), (d.global_ny,
                                                 d.global_nx)))
        uf.halo_exchange(d.halo)
        vf.halo_exchange(d.halo)
        self._u = uf.data * self._u_wet
        self._v = vf.data * self._v_wet

        self._step_cache = {}
        self._sweep_K = 1

    # ------------------------------------------------------------------
    def set_initial_tracer(self, c_global: np.ndarray) -> None:
        stacked = layout.stack_global(self.grid.decomp,
                                      np.asarray(c_global), mode="zeros",
                                      dtype=np.dtype(self.c.dtype))
        self.c.set_data(stacked)
        self.c.halo_exchange(1)

    # ------------------------------------------------------------------
    def _step_math(self, c, u, v, t_upd, u_wet, v_wet):
        """One conservative step on a block (reach = 1 or 2)."""
        return (tracer_step(c, u, v, t_upd, u_wet, v_wet,
                            dx=self.grid.dx, dy=self.grid.dy,
                            dt=self.dt, kappa=self.kappa,
                            scheme=self.scheme),)

    def _block_step(self, exch, c, u, v, t_upd, u_wet, v_wet):
        (c,) = exch((c,))
        return self._step_math(c, u, v, t_upd, u_wet, v_wet)

    # ------------------------------------------------------------------
    def set_steps_per_exchange(self, steps_per_sweep: int) -> None:
        from ..ops.sweep import set_steps_per_exchange
        set_steps_per_exchange(self, reach=self.reach,
                               steps_per_sweep=steps_per_sweep)

    # ------------------------------------------------------------------
    def step_program(self, nsteps: int = 1,
                     remat_chunk: int | None = None):
        """Compiled program advancing C by ``nsteps``; ``remat_chunk``
        checkpoints the loop for bounded-memory reverse AD
        (``ops/adjoint.py`` — source-inversion 4D-Var windows)."""
        if remat_chunk is not None and self._sweep_K > 1:
            raise ValueError(
                "remat_chunk needs the one-step differentiable path: "
                "build the tracer model without steps_per_sweep")
        key = (nsteps, remat_chunk)
        if key not in self._step_cache:
            from ..ops.sweep import make_stencil_sweep, run_steps
            grid = self.grid
            exch = exchange_multi_fn(grid.halo_spec, depth=self.reach)
            K = self._sweep_K
            sweepK = make_stencil_sweep(
                lambda s, ops, _: self._step_math(*s, *ops),
                spec=grid.halo_spec, steps_per_sweep=K, reach=self.reach)

            def body(c, u, v, t_upd, u_wet, v_wet):
                ops = (u, v, t_upd, u_wet, v_wet)

                def one(_, s):
                    return self._block_step(exch, *s, *ops)

                if remat_chunk is not None:
                    from ..ops.adjoint import checkpointed_fori
                    return checkpointed_fori(nsteps, one, (c,),
                                             remat_chunk)
                return run_steps(nsteps, K, (c,),
                                 lambda _, s: sweepK(s, ops), one)

            self._step_cache[key] = jax.jit(jax.shard_map(
                body, mesh=grid.mesh, in_specs=(P("y", "x"),) * 6,
                out_specs=(P("y", "x"),), check_vma=False))
        return self._step_cache[key]

    def run(self, nsteps: int) -> None:
        prog = self.step_program(nsteps)
        (self.c.data,) = prog(self.c.data, self._u, self._v,
                              self._t_upd, self._u_wet, self._v_wet)

    # ------------------------------------------------------------------
    def mass(self) -> float:
        """Total tracer over wet internal cells (conserved exactly —
        flux form with no-flux walls telescopes)."""
        from ..parallel.collectives import masked_sum
        w = jnp.asarray(layout.internal_mask(self.grid.decomp).astype(
            np.dtype(self.c.dtype)))
        return masked_sum(self.c.data, w * self._t_upd)

    def gather(self) -> dict:
        return {"c": self.c.gather_inner_data()}

    def checksums(self) -> dict:
        return {"c": self.c.checksum()}


# ----------------------------------------------------------------------
class CoupledTracer:
    """Passive tracer advected ONLINE by the evolving flagship flow —
    the age/plume-tracer workflow: NEMOLite2D dynamics and tracer
    transport advance in ONE program, with one coalesced 4-field halo
    exchange per step (collective count independent of the tracer).

    The tracer advects with the START-of-step velocities (first-order
    operator splitting): they are freshly exchanged and therefore
    valid one ring into the halo, where the just-computed end-of-step
    velocities are not — using them would cost a second (u, v)
    exchange per step for a lag of one dt in a passive field.

    The flow is untouched: the coupled flagship trajectory equals a
    plain flagship run (``tests/test_tracer.py`` pins it), and tracer
    mass is conserved exactly as in the standalone model.
    """

    def __init__(self, flagship, kappa: float = 0.0,
                 scheme: str = "vanleer"):
        from .nemolite2d import NemoLite2D
        if not isinstance(flagship, NemoLite2D):
            raise TypeError("CoupledTracer rides a NemoLite2D model, "
                            f"got {type(flagship).__name__}")
        if flagship._sweep_K > 1:
            raise ValueError(
                "CoupledTracer wraps the one-step path: build the "
                "flagship without steps_per_sweep")
        if scheme not in ("upwind", "vanleer"):
            raise ValueError(f"scheme must be 'upwind' or 'vanleer', "
                             f"got {scheme!r}")
        reach = 1 if scheme == "upwind" else 2
        h = flagship.grid.halo_spec.halo
        if h < 2 or h < reach:
            raise ValueError(
                "CoupledTracer needs halo_width >= 2 (the flagship's "
                "communication-free reach-2 chain) and >= the tracer "
                f"scheme's reach; got {h}")
        self.flagship = flagship
        self.grid = flagship.grid
        self.kappa = float(kappa)
        self.scheme = scheme
        self.c = dl.Field(self.grid, dl.T_POINTS)
        dtype = self.c.dtype
        self._t_upd, self._u_wet, self._v_wet = wet_update_masks(
            self.grid, dtype)
        self._step_cache = {}

    set_initial_tracer = TracerModel.set_initial_tracer
    mass = TracerModel.mass

    @property
    def _istep0(self):
        """The coupled clock is the flagship's (the ensemble runner
        reads this to continue the tidal forcing)."""
        return self.flagship._istep0

    # ------------------------------------------------------------------
    def step_program(self, nsteps: int = 1,
                     remat_chunk: int | None = None):
        """``remat_chunk`` checkpoints the coupled loop for reverse AD
        (source inversion THROUGH the evolving flow)."""
        key = (nsteps, remat_chunk)
        if key not in self._step_cache:
            from . import nemolite2d as nl
            fs = self.flagship
            grid = self.grid
            p = fs.p
            dx, dy = grid.dx, grid.dy
            exch = exchange_multi_fn(grid.halo_spec, depth=2)
            have_ht = fs._ht is not None

            def body(istep0, ssh, un, vn, c, codes, t_upd, u_wet,
                     v_wet, *bathy):
                dep = bathy[0] if have_ht else fs.depth

                def one(i, s):
                    ssh, un, vn, c = exch(s)
                    rtime = (istep0 + i + 1).astype(ssh.dtype) * p.rdt
                    forcing = nl.tidal_forcing(rtime, p)
                    ssh2, un2, vn2 = nl.step_math(
                        ssh, un, vn, codes, p, dx, dy, fs._fcor, dep,
                        forcing)
                    c2 = tracer_step(
                        c, un * u_wet, vn * v_wet, t_upd, u_wet, v_wet,
                        dx=dx, dy=dy, dt=p.rdt, kappa=self.kappa,
                        scheme=self.scheme)
                    return ssh2, un2, vn2, c2

                if remat_chunk is not None:
                    from ..ops.adjoint import checkpointed_fori
                    return checkpointed_fori(nsteps, one,
                                             (ssh, un, vn, c),
                                             remat_chunk)
                return lax.fori_loop(0, nsteps, one,
                                     (ssh, un, vn, c))

            blk = P("y", "x")
            self._step_cache[key] = jax.jit(jax.shard_map(
                body, mesh=grid.mesh,
                in_specs=(P(),) + (blk,) * 8 + ((blk,) if have_ht
                                                else ()),
                out_specs=(blk,) * 4, check_vma=False))
        return self._step_cache[key]

    def run(self, nsteps: int) -> None:
        fs = self.flagship
        bathy = (fs._ht,) if fs._ht is not None else ()
        out = self.step_program(nsteps)(
            jnp.int32(fs._istep0), fs.sshn_t.data, fs.un.data,
            fs.vn.data, self.c.data, fs._mask_codes, self._t_upd,
            self._u_wet, self._v_wet, *bathy)
        fs.sshn_t.data, fs.un.data, fs.vn.data, self.c.data = out
        fs._istep0 += nsteps
        # keep the flagship's derived U/V-face ssh in sync (as nl.run)
        from .nemolite2d import next_sshu, next_sshv
        fs.sshn_t.halo_exchange(1)
        fs.sshn_u.data = next_sshu(fs.sshn_t.data, fs._t_wet)
        fs.sshn_v.data = next_sshv(fs.sshn_t.data, fs._t_wet)

    def gather(self) -> dict:
        out = self.flagship.gather()
        out["c"] = self.c.gather_inner_data()
        return out


def streamfunction_velocities(psi: np.ndarray, dx: float = 1.0,
                              dy: float = 1.0):
    """Discretely divergence-free face velocities from a streamfunction
    at F points (psi[j, i] = NE corner of T[j, i]):

        u[j, i] = -(psi[j, i] - psi[j-1, i]) / dy
        v[j, i] =  (psi[j, i] - psi[j, i-1]) / dx

    The C-grid divergence of these telescopes to zero exactly.
    """
    psi = np.asarray(psi, float)
    u = -(psi - np.roll(psi, 1, axis=0)) / dy
    v = (psi - np.roll(psi, 1, axis=1)) / dx
    return u, v


def build(gnx: int = 64, gny: int = 64, ndomains=None, dt: float = 0.1,
          u=0.2, v=0.1, kappa: float = 0.0, scheme: str = "vanleer",
          tmask: np.ndarray | None = None, halo_width: int | None = None,
          dx: float = 1.0, dy: float = 1.0, steps_per_sweep: int = 1,
          **kw) -> TracerModel:
    """Tracer model on a walled domain (one-cell land ring by default).

    ``u``/``v`` are scalars or global face arrays; ``halo_width``
    defaults to the scheme's stencil reach (2 for vanleer)."""
    from ..ops.sweep import sweep_halo
    reach = 1 if scheme == "upwind" else 2
    halo_width = sweep_halo(steps_per_sweep, reach,
                            reach if halo_width is None else halo_width)
    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                   dl.OFFSET_NE)
    grid.decompose(gnx, gny, ndomains=ndomains, halo_width=halo_width)
    if tmask is None:
        tmask = np.ones((gny, gnx), dtype=np.int32)
        tmask[0, :] = tmask[-1, :] = 0
        tmask[:, 0] = tmask[:, -1] = 0
    dl.grid_init(grid, dx, dy, tmask=tmask)
    model = TracerModel(grid, dt=dt, u=u, v=v, kappa=kappa,
                        scheme=scheme, **kw)
    if steps_per_sweep > 1:
        model.set_steps_per_exchange(steps_per_sweep)
    return model


def _main(argv=None):
    """CLI demo: ``python -m dl_esm_inf_tpu.models.tracer
    [N [steps [scheme]]]`` — a blob in a rotating gyre; reports
    throughput, exact mass conservation and the TVD range bound."""
    import sys
    import time

    args = list(sys.argv[1:] if argv is None else argv)
    N = int(args[0]) if args else 128
    nsteps = int(args[1]) if len(args) > 1 else 200
    scheme = args[2] if len(args) > 2 else "vanleer"
    x = (np.arange(N) - N / 2 + 0.5) / N
    psi = 0.4 * np.exp(-((x[None, :] ** 2 + x[:, None] ** 2) / 0.18))
    u, v = streamfunction_velocities(psi)
    print(f"tracer transport: {N}x{N}, {scheme}, rotating gyre "
          f"(max |u| = {max(abs(u).max(), abs(v).max()):.3f})")
    m = build(N, N, dt=0.5, u=u, v=v, kappa=0.02, scheme=scheme)
    c0 = gaussian_eta(N, N, amp=1.0, width=0.08)
    m.set_initial_tracer(c0)
    m.run(nsteps)        # warm-up compiles the same-nsteps program
    m.set_initial_tracer(c0)
    m0 = m.mass()
    t0 = time.perf_counter()
    m.run(nsteps)
    wall = time.perf_counter() - t0
    c = m.gather()["c"]
    print(f"{nsteps} steps in {wall:.2f}s "
          f"({N * N * nsteps / wall / 1e6:.0f} Mpt/s)")
    print(f"range [{c.min():.2e}, {c.max():.4f}]  "
          f"mass drift = {abs(m.mass() - m0) / max(abs(m0), 1e-30):.2e}")


def golden_reference(c0: np.ndarray, tmask: np.ndarray, u, v, dt: float,
                     nsteps: int, dx: float = 1.0, dy: float = 1.0,
                     kappa: float = 0.0,
                     scheme: str = "vanleer") -> np.ndarray:
    """Independent NumPy transcription (np.roll shifts, f64)."""
    c = c0.astype(np.float64).copy()
    gny, gnx = c.shape
    wet = (np.asarray(tmask) == 1)
    xp = lambda a: np.roll(a, -1, 1)
    xm = lambda a: np.roll(a, 1, 1)
    yp = lambda a: np.roll(a, -1, 0)
    ym = lambda a: np.roll(a, 1, 0)
    t_upd = wet.astype(float)
    u_wet = (wet & (xp(wet))).astype(float)
    v_wet = (wet & (yp(wet))).astype(float)
    uf = np.broadcast_to(np.asarray(u, float), c.shape) * u_wet
    vf = np.broadcast_to(np.asarray(v, float), c.shape) * v_wet

    def vl(r):
        return (r + np.abs(r)) / (1.0 + np.abs(r))

    for _ in range(nsteps):
        if scheme == "upwind":
            cfx = np.where(uf > 0, c, xp(c))
            cfy = np.where(vf > 0, c, yp(c))
        else:
            dcx = xp(c) - c
            sx = np.where(dcx == 0, 1.0, dcx)
            cfx = np.where(
                uf > 0,
                c + 0.5 * vl((c - xm(c)) / sx) * dcx * xm(t_upd),
                xp(c) - 0.5 * vl((xp(xp(c)) - xp(c)) / sx) * dcx
                * xp(xp(t_upd)))
            dcy = yp(c) - c
            sy = np.where(dcy == 0, 1.0, dcy)
            cfy = np.where(
                vf > 0,
                c + 0.5 * vl((c - ym(c)) / sy) * dcy * ym(t_upd),
                yp(c) - 0.5 * vl((yp(yp(c)) - yp(c)) / sy) * dcy
                * yp(yp(t_upd)))
        fx = uf * cfx
        fy = vf * cfy
        tend = -((fx - xm(fx)) / dx + (fy - ym(fy)) / dy)
        if kappa:
            gx = (xp(c) - c) / dx * u_wet
            gy = (yp(c) - c) / dy * v_wet
            tend = tend + kappa * ((gx - xm(gx)) / dx
                                   + (gy - ym(gy)) / dy)
        c = np.where(wet, c + dt * tend, c)
    return c


if __name__ == "__main__":
    _main()
