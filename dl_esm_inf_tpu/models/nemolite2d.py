"""NEMOLite2D-class nonlinear shallow-water solver (BASELINE config #3).

The flagship client model: free-surface + depth-integrated momentum on
the Arakawa-C grid (NE offset), with the kernel set of the NEMOLite2D
GOcean benchmark — continuity, momentum_u/v (nonlinear flux-form
advection, horizontal viscosity, f-plane Coriolis, pressure gradient,
semi-implicit bottom friction), boundary kernels (prescribed-ssh
forcing, solid walls via the T mask, Flather radiation on open
boundaries) and the field-update/next kernels.  The equations follow the
standard NEMOLite2D formulation (centred advection; per-kernel metadata
is attached for the PSyclone-style API); exact Fortran-kernel parity is
not claimed — the reference library contains no model physics
(SURVEY: 'It contains no model physics'), this is the demonstrator
client the infrastructure exists to serve.

Wetness/boundary classification comes entirely from the T mask
(1 wet, 0 dry/solid, -1 open-sea outside the modelled domain,
reference grid_mod.f90:94-102):

* solid faces  — a face between a wet and a dry (0) cell: velocity 0;
* open faces   — between wet and outside (-1): Flather radiation;
* ssh forcing  — wet cells adjacent to an outside cell.

One time step = ONE shard_map program (halo exchange + all kernels);
multi-step runs go through ``lax.fori_loop`` under a single jit.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

import dl_esm_inf_tpu as dl
from ..core import layout
from ..ops import stencils as st
from ..parallel.halo import exchange_multi_fn
from ..api.kernel_meta import (Arg, GO_CT, GO_CU, GO_CV, GO_R_SCALAR,
                               GO_READ, GO_WRITE, GridProp, Stencil,
                               kernel)

_FULL = Stencil(111, 111, 111)


@dataclass(frozen=True)
class Params:
    rdt: float = 20.0          # time step (s)
    cbfr: float = 0.00015      # bottom friction coefficient
    visc: float = 0.1          # horizontal viscosity (m^2/s)
    g: float = 9.81
    omega: float = 7.292116e-5  # Earth rotation (rad/s)
    d2r: float = np.pi / 180.0
    amp: float = 0.1           # open-boundary ssh forcing amplitude (m)
    tide_period: float = 12.42 * 3600.0


# ---------------------------------------------------------------------------
# Kernels (block-level; metadata attached for the PSyclone-facing API)
# ---------------------------------------------------------------------------

@kernel(args=[Arg(GO_WRITE, GO_CT),
              Arg(GO_READ, GO_CT),
              Arg(GO_READ, GO_CU, _FULL), Arg(GO_READ, GO_CV, _FULL),
              Arg(GO_READ, GO_CU, _FULL), Arg(GO_READ, GO_CV, _FULL)],
        name="continuity")
def continuity(sshn_t, un, vn, depu, depv, *, rdt, dx, dy):
    """ssha_t: divergence of depth-integrated fluxes onto T cells.

    Flux through the east U face of T cell (ji): dep_u*un*dy at U[ji];
    west face is U[ji-1] (NE offset).  All scalar factors are folded at
    trace time (rdt/dx, rdt/dy) — op count matters more than formula
    symmetry."""
    fx = depu * un
    fy = depv * vn
    if (isinstance(dx, (int, float)) and isinstance(dy, (int, float))
            and dx == dy):
        # Square cells with STATIC scale factors (the model
        # paths): one shared prefactor.  Traced scalars (invoke/
        # Schedule) always take the general form below, so those paths
        # may differ from this one by an ulp of rounding order —
        # deliberate; perf of the static path wins.
        return sshn_t - (rdt / dx) * ((fx - st.xm(fx))
                                      + (fy - st.ym(fy)))
    return sshn_t - ((rdt / dx) * (fx - st.xm(fx))
                     + (rdt / dy) * (fy - st.ym(fy)))


# NOTE on the metadata above (and on momentum_u/v): the Arg lists
# document the ARRAY arguments accurately (used by metadata tooling and
# parity checks), but these fast-path bodies take their scalars as
# keyword-only parameters, so they are not directly `invoke`-able.
# The PSyclone-facing entry point is the wrapper below.

@kernel(args=[Arg(GO_WRITE, GO_CT),
              Arg(GO_READ, GO_CT),
              Arg(GO_READ, GO_CU, _FULL), Arg(GO_READ, GO_CV, _FULL),
              Arg(GO_READ, GO_CU, _FULL), Arg(GO_READ, GO_CV, _FULL),
              Arg(GO_READ, GO_R_SCALAR),
              Arg(GO_READ, GridProp.GRID_DX_CONST),
              Arg(GO_READ, GridProp.GRID_DY_CONST)],
        name="continuity_psy")
def continuity_psy(ssha, sshn, un, vn, depu, depv, rdt, dx, dy):
    """`invoke`-able continuity: positional scalars, grid dx/dy fetched
    from the grid automatically (the PSyclone-generated-layer shape)."""
    return continuity(sshn, un, vn, depu, depv, rdt=rdt, dx=dx, dy=dy)


@kernel(args=[Arg(GO_WRITE, GO_CU),
              Arg(GO_READ, GO_CU, _FULL), Arg(GO_READ, GO_CV, _FULL),
              Arg(GO_READ, GO_CT, _FULL), Arg(GO_READ, GO_CT, _FULL),
              Arg(GO_READ, GO_CU),
              Arg(GO_READ, GO_CT, _FULL), Arg(GO_READ, GO_CU),
              Arg(GO_READ, GO_CV, _FULL)],
        name="momentum_u")
def momentum_u(un, vn, sshn_t, ssha_t, sshn_u, ht, hu, depv, *, p: Params,
               dx, dy, fcor, dep_u=None, z=None, fric=None):
    """ua at U faces: advection + viscosity + Coriolis + pressure
    gradient + semi-implicit bottom friction.

    Advection is flux-form donor-cell upwind (the robust variant of
    NEMOLite2D's upwind-biased scheme): mass fluxes at the T centres /
    F corners surrounding the U face carry the upstream u value.
    Every read is within +/-1 of the exchanged prognostics (halo-1).

    Roll-minimal form: each face-flux pair is computed ONCE at its donor-side
    site and the opposite face obtained by rolling the *result* —
    m_e = xp(m_w), u_de = xp(u_dw), gx_e = xp(gx_w), gy_s = ym(gy_n)
    are exact elementwise identities because roll is a permutation.
    The advection and viscosity divergences along each axis then share
    a single roll of their rdt-folded sum.  ``dep_u``/``z`` accept the
    caller's precomputed totals (step_math shares them with continuity
    and momentum_v)."""
    if dep_u is None:
        dep_u = hu + sshn_u                   # total depth at U
    if z is None:
        z = ht + sshn_t                       # total depth at (west) T

    # --- x direction: everything lives at the west T centre.  The depth
    # factor z is positive wherever results survive the masks, so it
    # factors OUT of the advection+viscosity sum (one multiply instead
    # of three) and the donor select keys on the velocity sum alone.
    umx = st.xm(un)
    su = un + umx                             # 2*m_w / z (donor sign)
    u_dw = jnp.where(su > 0, umx, un)         # donor u (z > 0 where wet)
    w_x = ((-0.5 * p.rdt / dx) * (su * u_dw)
           + (p.rdt * p.visc / (dx * dx)) * (un - umx)) * z
    term_x = st.xp(w_x) - w_x                 # rdt*(adv_x + vis_x)

    # --- y direction: everything lives at the NE F corner; the doubled
    # corner depth factors out likewise (its 0.5 folds into the scalars)
    wv = vn + st.xp(vn)                       # 2 * corner-interp v
    dep_f2 = depv + st.xp(depv)               # 2 * F-corner depth
    upy = st.yp(un)
    u_dn = jnp.where(wv > 0, un, upy)         # donor u (dep_f > 0)
    w_y = ((-0.25 * p.rdt / dy) * (wv * u_dn)
           + (0.5 * p.rdt * p.visc / (dy * dy)) * (upy - un)) * dep_f2
    term_y = w_y - st.ym(w_y)                 # rdt*(adv_y + vis_y)

    # --- Coriolis (f-plane from latitude; 0.25 of the 4-point average
    # folded into the scalar prefactor) + pressure gradient on the NEW
    # ssh (forward-backward scheme: continuity first, momentum sees the
    # updated surface — gravity-wave stable up to c*dt*sqrt(2)/dx ~ 1).
    # Both terms carry the SAME dep_u factor, so it is applied once to
    # their sum (one fewer vector multiply) -----------------------------
    corhpg = ((0.25 * p.rdt * fcor) * (wv + st.ym(wv))
              + (-p.rdt * p.g / dx) * (st.xp(ssha_t) - ssha_t)) * dep_u

    # --- time update with semi-implicit linear bottom friction.
    # (un*dep + T)/dep is applied as un + T/dep: one fewer multiply and
    # better conditioned (the dep*recip(dep) ulp never touches un).
    # ``fric`` lets the caller fold the wet-face mask into the friction
    # factor (one hoisted array multiply instead of scalar + mask) -------
    rd = 1.0 / dep_u
    if fric is None:
        fric = 1.0 / (1.0 + p.cbfr * p.rdt)
    ua = (un + (term_x + term_y + corhpg) * rd) * fric
    return ua


@kernel(args=[Arg(GO_WRITE, GO_CV),
              Arg(GO_READ, GO_CU, _FULL), Arg(GO_READ, GO_CV, _FULL),
              Arg(GO_READ, GO_CT, _FULL), Arg(GO_READ, GO_CT, _FULL),
              Arg(GO_READ, GO_CV),
              Arg(GO_READ, GO_CT, _FULL), Arg(GO_READ, GO_CV),
              Arg(GO_READ, GO_CU, _FULL)],
        name="momentum_v")
def momentum_v(un, vn, sshn_t, ssha_t, sshn_v, ht, hv, depu, *, p: Params,
               dx, dy, fcor, dep_v=None, z=None, fric=None):
    """Mirror of :func:`momentum_u` in the same roll-minimal form."""
    if dep_v is None:
        dep_v = hv + sshn_v
    if z is None:
        z = ht + sshn_t                       # total depth at (south) T

    # --- y direction: everything lives at the south T centre (z factors
    # out of the advection+viscosity sum, as in momentum_u) --------------
    vmy = st.ym(vn)
    sv = vn + vmy                             # 2*m_s / z (donor sign)
    v_ds = jnp.where(sv > 0, vmy, vn)
    w_y = ((-0.5 * p.rdt / dy) * (sv * v_ds)
           + (p.rdt * p.visc / (dy * dy)) * (vn - vmy)) * z
    term_y = st.yp(w_y) - w_y

    # --- x direction: everything lives at the NE F corner ---------------
    wu = un + st.yp(un)                       # 2 * corner-interp u
    dep_f2 = depu + st.yp(depu)               # 2 * F-corner depth
    xpv = st.xp(vn)
    v_de = jnp.where(wu > 0, vn, xpv)         # donor v (dep_f > 0)
    w_x = ((-0.25 * p.rdt / dx) * (wu * v_de)
           + (0.5 * p.rdt * p.visc / (dx * dx)) * (xpv - vn)) * dep_f2
    term_x = w_x - st.xm(w_x)

    # Coriolis + pressure gradient share the dep_v factor (see
    # momentum_u)
    corhpg = ((-0.25 * p.rdt * fcor) * (wu + st.xm(wu))
              + (-p.rdt * p.g / dy) * (st.yp(ssha_t) - ssha_t)) * dep_v

    rd = 1.0 / dep_v
    if fric is None:
        fric = 1.0 / (1.0 + p.cbfr * p.rdt)
    va = (vn + (term_y + term_x + corhpg) * rd) * fric
    return va


def tidal_forcing(rtime, p: Params):
    """The bc_ssh amplitude at model time ``rtime`` (scalar).

    Uses the working-precision sine (:mod:`..ops.trig`), faithful in
    float64 on every backend: this boundary term is injected every step,
    so an f32-accurate f64 sine would be the whole fp64 parity gap
    against the NumPy golden.
    """
    from ..ops.trig import sin_wp
    return p.amp * sin_wp(2.0 * jnp.pi * rtime / p.tide_period)


def tidal_forcing_host(rtime: float, p: Params) -> float:
    """Host-side (NumPy) twin of :func:`tidal_forcing` for callers that
    precompute per-step forcing series (e.g. the PSy flagship's scalar
    rows).  ONE formula, two evaluators: change them together."""
    return float(p.amp * np.sin(2.0 * np.pi * rtime / p.tide_period))


def bc_ssh(ssha_t, bc_cells, forcing):
    """Prescribed ssh at open-boundary wet cells (the NEMOLite2D bc_ssh
    tidal forcing); ``forcing`` is the scalar boundary value."""
    return jnp.where(bc_cells > 0, forcing, ssha_t)


def bc_flather_u(ua, sshn_u, hu, flather_u, p: Params):
    """Flather radiation: u = u_ext +/- sqrt(g/h) (ssh - ssh_ext).

    With zero external state this damps outgoing waves at open U faces."""
    flath = -jnp.sqrt(p.g / jnp.maximum(hu, 1e-3)) * sshn_u
    return jnp.where(flather_u > 0, flath, ua)


def bc_flather_v(va, sshn_v, hv, flather_v, p: Params):
    flath = -jnp.sqrt(p.g / jnp.maximum(hv, 1e-3)) * sshn_v
    return jnp.where(flather_v > 0, flath, va)


def next_sshu(sshn_t, t_wet, u_wet=None):
    """Interpolate T ssh onto U faces (area-weighted; uniform grid ->
    arithmetic mean of the wet neighbours, NEMOLite2D next_sshu).

    Division-free identity: the wet-neighbour count is 2 exactly where
    the face itself is wet (``u_wet``), else <= 1 — so the weight is
    ``1 - u_wet/2`` and the dry-face sum is already 0."""
    sw = sshn_t * t_wet
    s = sw + st.xp(sw)
    if u_wet is None:
        u_wet = t_wet * st.xp(t_wet)
    return s * (1.0 - 0.5 * u_wet)


def next_sshv(sshn_t, t_wet, v_wet=None):
    sw = sshn_t * t_wet
    s = sw + st.yp(sw)
    if v_wet is None:
        v_wet = t_wet * st.yp(t_wet)
    return s * (1.0 - 0.5 * v_wet)


def derive_masks(tmask, dtype):
    """The six 0/1 float masks of the step, from the int8/int32 tmask.

    Only pointwise compares touch bools — shifted masks roll the float
    arrays."""
    t_wet = (tmask == 1).astype(dtype)
    out_f = (tmask == -1).astype(dtype)
    u_wet = t_wet * st.xp(t_wet)
    v_wet = t_wet * st.yp(t_wet)
    near_out = jnp.minimum(
        st.xp(out_f) + st.xm(out_f) + st.yp(out_f) + st.ym(out_f), 1.0)
    bc_cells = t_wet * near_out
    # wet and outside are mutually exclusive, so the sums stay 0/1
    flather_u = t_wet * st.xp(out_f) + out_f * st.xp(t_wet)
    flather_v = t_wet * st.yp(out_f) + out_f * st.yp(t_wet)
    return (t_wet, u_wet, v_wet, bc_cells, flather_u, flather_v)


def encode_masks(tmask) -> jnp.ndarray:
    """Pack the six masks into one int8 bitfield (they are constant in
    time): 1 byte/point of HBM instead of six float arrays."""
    return st.pack_mask_bits(derive_masks(tmask, jnp.float32))


@jax.jit
def _face_ssh(sshn_t, t_wet):
    """``(sshn_u, sshn_v)`` as ONE program.  Eagerly, each roll of the
    stacked global array is its own program with a collective permute;
    several of those in flight at once can deadlock the CPU mesh's
    collective rendezvous."""
    return next_sshu(sshn_t, t_wet), next_sshv(sshn_t, t_wet)


def decode_masks(codes, dtype):
    """Unpack :func:`encode_masks` — shifts and ands only, no rolls."""
    return st.unpack_mask_bits(codes, 6, dtype)


class StepPrep(NamedTuple):
    """Time-invariant per-block quantities hoisted out of the sub-step
    loop: decoded masks, their derived booleans/weights, total-depth
    faces and Flather coefficients.  A K-step sweep computes one
    StepPrep and its K sub-steps reuse it."""
    t_wet: object
    u_wet: object
    v_wet: object
    wet_b: object       # t_wet > 0
    cw: object          # t_wet * (rdt/dx) on square cells, else None:
    # folds the continuity wet-cell select into the divergence
    # prefactor (one array multiply replaces scalar-multiply + select;
    # exact — t_wet is exactly 1.0/0.0 and the fluxes are finite
    # wherever results survive)
    bc_b: object        # bc_cells > 0
    flu_b: object       # flather_u > 0
    flv_b: object
    wu: object          # 1 - u_wet/2: next_sshu wet-neighbour weight
    wv: object          # 1 - v_wet/2
    fu: object          # u_wet / (1 + cbfr*rdt): masked friction factor
    fv: object
    ht: object          # T/U/V total-depth bases (scalars or windows)
    hu: object
    hv: object
    cu: object          # -sqrt(g / max(hu, 1e-3)): Flather coefficient
    cv: object


def make_prep(mask_codes, depth, p: Params, dtype, masks=None,
              dx=None, dy=None) -> StepPrep:
    """Build the hoisted sub-step constants (see :class:`StepPrep`).

    ``depth`` follows step_math's convention: scalar (flat bathymetry),
    T-point array, or a pre-derived (ht, hu, hv) tuple.  Static square
    ``dx == dy`` additionally hoists the continuity wet-prefactor
    ``cw`` (see :class:`StepPrep`)."""
    if masks is None:
        masks = decode_masks(mask_codes, dtype)
    t_wet, u_wet, v_wet, bc_cells, flather_u, flather_v = masks
    if isinstance(depth, tuple):
        ht, hu, hv = depth
    elif jnp.ndim(depth) == 0:
        ht = hu = hv = jnp.asarray(depth, dtype)
    else:
        ht = depth
        hu = st.avg_x(ht)
        hv = st.avg_y(ht)
    cu = -jnp.sqrt(p.g / jnp.maximum(hu, 1e-3))
    cv = -jnp.sqrt(p.g / jnp.maximum(hv, 1e-3))
    fric = 1.0 / (1.0 + p.cbfr * p.rdt)
    cw = ((p.rdt / dx) * t_wet
          if (isinstance(dx, (int, float)) and isinstance(dy, (int, float))
              and dx == dy)
          else None)
    return StepPrep(t_wet, u_wet, v_wet,
                    t_wet > 0, cw, bc_cells > 0, flather_u > 0,
                    flather_v > 0,
                    1.0 - 0.5 * u_wet, 1.0 - 0.5 * v_wet,
                    fric * u_wet, fric * v_wet,
                    ht, hu, hv, cu, cv)


def step_math(sshn_t, un, vn, mask_codes, p: Params, dx, dy, fcor, depth,
              forcing, exch_mid=None, masks=None,
              prep: StepPrep | None = None):
    """One complete NEMOLite2D step as a pure stencil chain over shard
    blocks — the physics is written once, for the one-step and the
    K-step paths alike.
    ``mask_codes`` is the static int8 bitfield from :func:`encode_masks`:
    one byte per point of HBM traffic instead of six float mask arrays
    (roofline economics).  Total input reach is 2 cells, so with fresh
    depth-2 halos the chain needs no mid-step communication (pass
    ``exch_mid=None``).  ``masks``/``prep`` optionally supply the
    decoded masks / full hoisted constants (:func:`make_prep`) so
    multi-step (temporal-blocking) callers pay for them once.

    Compiled for a CUDA device, the calls that
    :func:`.nemolite2d_kernel.covers` (float32, flat depth, square
    cells, no mid-step exchange) run as one fused kernel instead
    (:mod:`.nemolite2d_kernel`); its gradient is this function's.
    """
    from . import nemolite2d_kernel as fused
    consts = dict(p=p, dx=dx, dy=dy, fcor=fcor, depth=depth)
    if exch_mid is None and fused.covers(sshn_t, depth, dx, dy):
        return fused.step(functools.partial(plain_step, **consts),
                          sshn_t, un, vn, mask_codes,
                          jnp.asarray(forcing, sshn_t.dtype), p=p, dx=dx,
                          fcor=fcor, depth=depth)
    return plain_step(sshn_t, un, vn, mask_codes, forcing, **consts,
                      exch_mid=exch_mid, masks=masks, prep=prep)


def plain_step(sshn_t, un, vn, mask_codes, forcing, *, p: Params, dx, dy,
               fcor, depth, exch_mid=None, masks=None,
               prep: StepPrep | None = None):
    """:func:`step_math` in ``jax.numpy`` on every platform: the fused
    kernel's reference and its gradient."""
    dtype = sshn_t.dtype
    pr = prep if prep is not None else make_prep(mask_codes, depth, p,
                                                 dtype, masks=masks,
                                                 dx=dx, dy=dy)
    ht, hu, hv = pr.ht, pr.hu, pr.hv

    # U/V-face ssh derived from the freshly-exchanged T ssh (the
    # NEMOLite2D next_sshu/next_sshv kernels, with the wet-neighbour
    # weights hoisted), valid wherever sshn_t's halo is.
    sw = sshn_t * pr.t_wet
    sshn_u = (sw + st.xp(sw)) * pr.wu
    sshn_v = (sw + st.yp(sw)) * pr.wv

    depu = hu + sshn_u
    depv = hv + sshn_v
    z = ht + sshn_t

    if pr.cw is not None:
        # square-cell fast path: the wet-cell select folds into the
        # hoisted prefactor (pr.cw = t_wet * rdt/dx — exactly rdt/dx at
        # wet cells, exactly 0 at dry, so dry cells keep sshn_t and wet
        # cells match continuity() bitwise; one array multiply for a
        # scalar-multiply + select)
        fx = depu * un
        fy = depv * vn
        ssha_t = sshn_t - pr.cw * ((fx - st.xm(fx)) + (fy - st.ym(fy)))
    else:
        ssha_t = continuity(sshn_t, un, vn, depu, depv,
                            rdt=p.rdt, dx=dx, dy=dy)
        ssha_t = jnp.where(pr.wet_b, ssha_t, sshn_t)
    ssha_t = jnp.where(pr.bc_b, jnp.asarray(forcing, dtype), ssha_t)

    if exch_mid is not None:
        ssha_t = exch_mid(ssha_t)

    ua = momentum_u(un, vn, sshn_t, ssha_t, sshn_u, ht, hu, depv,
                    p=p, dx=dx, dy=dy, fcor=fcor,
                    dep_u=depu, z=z, fric=pr.fu)
    va = momentum_v(un, vn, sshn_t, ssha_t, sshn_v, ht, hv, depu,
                    p=p, dx=dx, dy=dy, fcor=fcor,
                    dep_v=depv, z=z, fric=pr.fv)
    ua = jnp.where(pr.flu_b, pr.cu * sshn_u, ua)
    va = jnp.where(pr.flv_b, pr.cv * sshn_v, va)

    return ssha_t, ua, va


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def default_tmask(gnx: int, gny: int, open_north: bool = True) -> np.ndarray:
    """Closed basin with solid walls; optionally an open (Flather/forced)
    boundary along the north edge — the NEMOLite2D canonical domain has
    solid walls on three sides and an open boundary."""
    t = np.ones((gny, gnx), dtype=np.int32)
    t[0, :] = 0
    t[:, 0] = 0
    t[:, -1] = 0
    t[-1, :] = -1 if open_north else 0
    return t


class NemoLite2D:
    """Nonlinear SW solver bound to a grid; the framework's flagship."""

    def __init__(self, grid: dl.Grid, params: Params = Params(),
                 depth: "float | np.ndarray" = 100.0):
        self.grid = grid
        self.p = params
        dtype = grid.dtype

        # prognostic fields
        self.sshn_t = dl.Field(grid, dl.T_POINTS)
        self.sshn_u = dl.Field(grid, dl.U_POINTS)
        self.sshn_v = dl.Field(grid, dl.V_POINTS)
        self.un = dl.Field(grid, dl.U_POINTS)
        self.vn = dl.Field(grid, dl.V_POINTS)
        # Bathymetry: a scalar is the HBM-frugal fast path (depths fold
        # to trace-time constants); a global (gny, gnx) T-point array is
        # streamed per point, with U/V-face depths derived in-step.
        # Edge-replicated scatter: halo cells hold the true neighbour
        # values (ht is time-invariant, so they never go stale) and
        # beyond-domain padding stays positive so 1/dep is bounded
        # (those cells are mask-inert anyway).
        if np.ndim(depth) == 0:
            self.depth = float(depth)
            self._ht = None
        else:
            self.depth = None
            arr = np.asarray(depth, dtype=np.dtype(dtype))
            if arr.min() <= 0:
                raise ValueError("bathymetry must be positive everywhere")
            stacked = layout.stack_global(grid.decomp, arr, mode="edge",
                                          dtype=np.dtype(dtype))
            self._ht = jax.device_put(jnp.asarray(stacked), grid.sharding)

        # One int8 mask array is the only per-point constant the step
        # reads: wet/dry/outside classification with the uniform-shard
        # padding forced to dry so padded cells are inert.  All derived
        # masks (face wetness, Flather faces, forcing cells) are
        # recomputed each step — compute is ~free next to the memory
        # bytes they would otherwise cost (SURVEY §6: HBM roofline).
        tm = grid.tmask
        valid = self._valid_cell_mask()
        tmask_i8 = jnp.where(valid, tm, 0).astype(jnp.int8)
        self._tmask_i8 = jax.device_put(tmask_i8, grid.sharding)
        # one program, not one per roll (see _face_ssh)
        self._mask_codes = jax.device_put(
            jax.jit(encode_masks)(self._tmask_i8), grid.sharding)
        self._t_wet = ((tmask_i8 == 1)).astype(dtype)
        # Coriolis: f-plane scalar from the constant latitude
        # (grid_mod.f90:512-523 fixes gphi = 50 degrees)
        self._fcor = float(2.0 * params.omega * np.sin(50.0 * params.d2r))
        self._step_cache = {}
        self._istep0 = 0
        self._sweep_K = 1

    def _valid_cell_mask(self):
        """Cells representing a real global cell (internal, or a halo cell

        whose global index is inside the domain).  Alignment/remainder
        padding and beyond-domain halo cells are forced dry: a solid-wall
        default exactly where the serial reference would have external
        boundary cells."""
        d = self.grid.decomp
        gx = layout.global_x_index(d)
        gy = layout.global_y_index(d)
        mx = (gx >= 0) & (gx < d.global_nx)
        my = (gy >= 0) & (gy < d.global_ny)
        return jnp.asarray(my[:, None] & mx[None, :])

    # ------------------------------------------------------------------
    def set_steps_per_exchange(self, steps_per_sweep: int) -> None:
        """Communication avoidance: K chained ``step_math`` calls per
        depth-2K exchange (ops/sweep.py)."""
        from ..ops.sweep import set_steps_per_exchange
        set_steps_per_exchange(self, reach=2,
                               steps_per_sweep=steps_per_sweep)

    def _make_sweep(self, K: int):
        """K chained ``step_math`` calls after one depth-2K exchange;
        masks, weights and face depths are hoisted out of the K
        sub-steps.  ``sweep((sshn, un, vn), (codes[, ht]), forcing)``
        with ``forcing`` the K per-sub-step boundary values."""
        from ..ops.sweep import make_stencil_sweep
        p, dx, dy = self.p, self.grid.dx, self.grid.dy

        def prepare(aux):
            codes, *ht = aux
            dep = ((ht[0], st.avg_x(ht[0]), st.avg_y(ht[0])) if ht
                   else self.depth)
            return codes, dep, make_prep(codes, dep, p, self.grid.dtype,
                                         dx=dx, dy=dy)

        def stepf(state, prepared, forcing):
            codes, dep, prep = prepared
            return step_math(*state, codes, p, dx, dy, self._fcor, dep,
                             forcing=forcing, prep=prep)

        return make_stencil_sweep(stepf, spec=self.grid.halo_spec,
                                  steps_per_sweep=K, reach=2,
                                  prepare_fn=prepare)

    # ------------------------------------------------------------------
    def set_initial_ssh(self, ssh_global: np.ndarray) -> None:
        stacked = layout.stack_global(self.grid.decomp,
                                      np.asarray(ssh_global), mode="zeros",
                                      dtype=np.dtype(self.grid.dtype))
        self.sshn_t.set_data(stacked)
        self.sshn_t.halo_exchange(1)
        t_wet = self._t_wet
        self.sshn_u.data, self.sshn_v.data = _face_ssh(self.sshn_t.data,
                                                       t_wet)

    # ------------------------------------------------------------------
    def _block_step(self, exch, istep, sshn_t, un, vn, mask_codes,
                    dep=None):
        p = self.p
        dx, dy = self.grid.dx, self.grid.dy
        spec = self.grid.halo_spec
        h = spec.halo
        if dep is None:
            dep = self.depth

        # one coalesced exchange for the whole state (4 collectives)
        sshn_t, un, vn = exch((sshn_t, un, vn))

        rtime = (istep + 1).astype(sshn_t.dtype) * p.rdt
        forcing = tidal_forcing(rtime, p)

        # With halo width 1 the new surface must cross shard seams
        # between continuity and momentum (the reference's
        # between-dependent-kernels exchange, SURVEY §3.6).  With halo
        # width >= 2 the deep halo lets every shard compute ssha
        # redundantly one ring into its halo, so the whole step is a
        # single communication-free stencil chain.
        exch_mid = (lambda a: exch((a,))[0]) if h < 2 else None
        return step_math(sshn_t, un, vn, mask_codes, p, dx, dy, self._fcor,
                         dep, forcing, exch_mid=exch_mid)

    # ------------------------------------------------------------------
    def _block_step_overlap(self, exch, istep, sshn_t, un, vn, mask_codes,
                            dep=None):
        """Comms/compute-overlapped step (SURVEY §2: 'split interior/

        boundary stencil, overlap ppermute with interior compute').

        The interior is computed from the STALE block — a graph node with
        no dependence on the halo collectives, so XLA's latency-hiding
        scheduler runs the ppermutes underneath it.  Only thin boundary
        bands (the cells within stencil reach of a halo) are recomputed
        from the freshly-exchanged block and pasted over the interior
        result.  Requires the deep-halo (h>=2) communication-free chain.

        The band recompute is extra small-slice work, so this mode only
        pays when communication is latency-bound; it is opt-in
        (``step_program(n, overlap=True)``) and kept correct by tests.
        Its cost on the GPU is not measured.
        """
        p = self.p
        dx, dy = self.grid.dx, self.grid.dy
        spec = self.grid.halo_spec
        h = spec.halo
        w, hgt = spec.tile_nx, spec.tile_ny
        B = 8                                   # band slice thickness

        rtime = (istep + 1).astype(sshn_t.dtype) * p.rdt
        forcing = tidal_forcing(rtime, p)

        def run(s, u, v, c, ht=None):
            # variable bathymetry: face depths derived per (sub-)block;
            # band edges polluted by the avg's wrap are outside the
            # pasted target region, like the state rolls
            dd = ((ht, st.avg_x(ht), st.avg_y(ht)) if ht is not None
                  else self.depth)
            return step_math(s, u, v, c, p, dx, dy, self._fcor,
                             dd, forcing, exch_mid=None)

        # collectives — and, independently, the stale-interior compute
        fresh = exch((sshn_t, un, vn))
        stale = run(sshn_t, un, vn, mask_codes,
                    ht=dep if self._ht is not None else None)

        # boundary bands recomputed from the fresh block.  Valid target
        # cells sit >= 2 from each band-slice edge; bands cover every
        # internal cell within reach 2 of a halo cell.
        out = list(stale)
        ht_blk = dep if self._ht is not None else None

        def paste_rows(r0):
            sl = slice(r0, r0 + B)
            band = run(*(f[sl, :] for f in fresh), mask_codes[sl, :],
                       ht=None if ht_blk is None else ht_blk[sl, :])
            tgt = slice(r0 + 2, r0 + B - 2)
            for k in range(3):
                out[k] = out[k].at[tgt, :].set(band[k][2:B - 2, :])

        def paste_cols(c0):
            sl = slice(c0, c0 + B)
            band = run(*(f[:, sl] for f in fresh), mask_codes[:, sl],
                       ht=None if ht_blk is None else ht_blk[:, sl])
            tgt = slice(c0 + 2, c0 + B - 2)
            for k in range(3):
                out[k] = out[k].at[:, tgt].set(band[k][:, 2:B - 2])

        # south rows [h, h+2) & north rows [h+hgt-2, h+hgt)
        paste_rows(h - 2)
        paste_rows(h + hgt - (B - 2))
        # west cols & east cols
        paste_cols(h - 2)
        paste_cols(h + w - (B - 2))
        return tuple(out)

    def step_program(self, nsteps: int, overlap: bool = False,
                     remat_chunk: int | None = None):
        """``remat_chunk`` bounds reverse-mode AD memory through the
        time loop (``ops/adjoint.py``); needs the one-step path."""
        if remat_chunk is not None and self._sweep_K > 1:
            raise ValueError(
                "remat_chunk needs the one-step differentiable path: "
                "build the flagship without steps_per_sweep")
        grid = self.grid
        if overlap:
            spec = grid.halo_spec
            if spec.repx > 1 or spec.repy > 1:
                raise NotImplementedError(
                    "overlap mode supports one tile per device")
            if spec.halo < 2:
                raise ValueError("overlap mode needs halo_width >= 2")
            if spec.tile_nx < 8 or spec.tile_ny < 8:
                raise ValueError("overlap mode needs tiles >= 8x8")
        if overlap and self._sweep_K > 1:
            raise ValueError(
                "overlap mode runs one step at a time; rebuild with "
                "steps_per_sweep=1 (the K-step sweep already amortises "
                "the exchange it would overlap)")
        key = (nsteps, overlap, remat_chunk)
        if key not in self._step_cache:
            from ..ops.sweep import run_steps
            h = grid.halo_spec.halo
            exch = exchange_multi_fn(grid.halo_spec, depth=min(h, 2) or 1)
            stepper = (self._block_step_overlap if overlap
                       else self._block_step)
            K = self._sweep_K
            sweepK = self._make_sweep(K) if K > 1 else None
            have_ht = self._ht is not None

            def body(istep0, state, mask_codes, *bathy):
                dep = bathy[0] if have_ht else None

                def one(i, s):
                    return stepper(exch, istep0 + i, *s, mask_codes,
                                   dep=dep)

                if remat_chunk is not None:
                    from ..ops.adjoint import checkpointed_fori
                    return checkpointed_fori(nsteps, one, state,
                                             remat_chunk)

                def sweep(j, s):
                    rtimes = (istep0 + j * K + 1 + jnp.arange(K)).astype(
                        s[0].dtype) * self.p.rdt
                    return sweepK(s, (mask_codes,) + bathy,
                                  tidal_forcing(rtimes, self.p))

                return run_steps(nsteps, K, state, sweep, one)

            blk = P("y", "x")
            smapped = jax.shard_map(
                body, mesh=grid.mesh,
                in_specs=(P(), (blk,) * 3, blk) + ((blk,) if have_ht else ()),
                out_specs=(blk,) * 3, check_vma=False)
            self._step_cache[key] = jax.jit(smapped)
        return self._step_cache[key]

    def run(self, nsteps: int) -> None:
        prog = self.step_program(nsteps)
        state = (self.sshn_t.data, self.un.data, self.vn.data)
        bathy = (self._ht,) if self._ht is not None else ()
        out = prog(jnp.int32(self._istep0), state, self._mask_codes, *bathy)
        self.sshn_t.data, self.un.data, self.vn.data = out
        self._istep0 += nsteps
        # keep the derived U/V-face ssh fields in sync for API users
        self.sshn_t.halo_exchange(1)
        self.sshn_u.data, self.sshn_v.data = _face_ssh(self.sshn_t.data,
                                                       self._t_wet)

    @property
    def bathymetry(self):
        """T-point depth: the stacked device array (variable bathymetry)
        or the flat scalar — the shape utils/diagnostics accepts."""
        return self._ht if self._ht is not None else self.depth

    # ------------------------------------------------------------------
    def checksums(self) -> dict:
        return {"sshn": self.sshn_t.checksum(), "un": self.un.checksum(),
                "vn": self.vn.checksum()}

    def gather(self) -> dict:
        return {"sshn": self.sshn_t.gather_inner_data(),
                "un": self.un.gather_inner_data(),
                "vn": self.vn.gather_inner_data()}


def build(gnx: int = 256, gny: int = 256, ndomains=None,
          params: Params = Params(), depth: float = 100.0,
          open_north: bool = True, dtype=None,
          halo_width: int = 2, steps_per_sweep: int = 1) -> NemoLite2D:
    """Convenience constructor: grid + tmask + model.

    The default ``halo_width=2`` is the deep-halo path: one exchange per
    step, no mid-step communication (redundant ring compute instead),
    and on a CUDA device the fused step kernel.  ``halo_width=1`` is
    the reference's schedule: the new surface is exchanged between
    continuity and momentum, so the step stays on the plain ``jnp``
    path on every platform.
    ``steps_per_sweep=K`` runs K steps per (depth-2K) halo exchange and
    deepens the halo to match.
    ``depth`` is a scalar (flat bathymetry, trace-time constant) or a
    global (gny, gnx) T-point depth array (variable bathymetry,
    streamed per point).
    """
    from ..ops.sweep import sweep_halo
    halo_width = sweep_halo(steps_per_sweep, 2, halo_width)
    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                   dl.OFFSET_NE, dtype=dtype)
    grid.decompose(gnx, gny, ndomains=ndomains, halo_width=halo_width)
    dl.grid_init(grid, 1000.0, 1000.0, default_tmask(gnx, gny, open_north))
    model = NemoLite2D(grid, params, depth)
    if steps_per_sweep > 1:
        model.set_steps_per_exchange(steps_per_sweep)
    return model


def main(argv=None):
    """CLI demo: the canonical NEMOLite2D-style run (258^2 domain by
    default, like the GOcean benchmark namelist), printing per-field
    checksums every report interval — drive with
    ``python -m dl_esm_inf_tpu.models.nemolite2d [N] [steps] [hist.nc]``
    (the optional third argument writes a NetCDF history file: one
    ssh/u/v record per report interval).  Returns the model after its
    run."""
    import sys
    import time as _time

    import jax as _jax

    from .gravity_wave import gaussian_eta

    args = list(argv if argv is not None else sys.argv[1:])
    n = int(args[0]) if args else 258
    nsteps = int(args[1]) if len(args) > 1 else 100
    hist_path = args[2] if len(args) > 2 else None   # NetCDF history
    m = build(n, n)
    if nsteps < 1:
        print("nothing to do (nsteps < 1)")
        return m
    m.set_initial_ssh(gaussian_eta(n, n, amp=0.2))
    hist = None
    if hist_path:
        from ..utils.io import NetCDFTimeSeries
        hist = NetCDFTimeSeries(
            hist_path, {"ssh": m.sshn_t, "u": m.un, "v": m.vn},
            global_attrs={"title": f"nemolite2d {n}x{n}"})
    report = max(1, nsteps // 5)
    done = 0
    warmed = False
    dt_total = 0.0
    timed_steps = 0
    while done < nsteps:
        todo = min(report, nsteps - done)
        t0c = _time.perf_counter()
        m.run(todo)
        done += todo
        cs = m.checksums()               # host readback = device fence
        dtc = _time.perf_counter() - t0c
        # Time only FULL report-sized chunks after the first (warmup)
        # one: the first chunk and any odd-sized remainder chunk compile
        # a fresh program, which must stay outside the timed window —
        # and the per-chunk window keeps print/history IO out of the
        # rate (advisor r3).
        if todo == report:
            if warmed:
                timed_steps += todo
                dt_total += dtc
            else:
                warmed = True
        print(f"step {done:6d}  " +
              "  ".join(f"{k}={v:.10E}" for k, v in cs.items()), flush=True)
        if hist is not None:
            hist.append(time=done * m.p.rdt)
    if hist is not None:
        hist.close()
        print(f"history written to {hist_path}")
    if timed_steps:
        dt = dt_total
        rate = f"{n * n * timed_steps / dt / 1e6:.1f} Mpt/s post-warmup"
        print(f"{nsteps} steps of {n}x{n}; {timed_steps} timed in "
              f"{dt:.3f}s ({rate}) [backend={_jax.default_backend()}]")
    else:
        print(f"{nsteps} steps of {n}x{n} done "
              f"(too few full chunks to time past warmup) "
              f"[backend={_jax.default_backend()}]")
    return m


if __name__ == "__main__":
    main()
