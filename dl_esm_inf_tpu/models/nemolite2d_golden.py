"""Independent NumPy golden for the NEMOLite2D physics.

The model's one-step and K-step paths share ``step_math`` (by design:
the physics is written once), so an error in its formulation would pass
every path-equality and invariance test.  This module re-derives the
whole step — next_sshu/v, continuity, donor-cell advection, viscosity,
Coriolis, pressure gradient, semi-implicit bottom friction, bc_ssh,
solid walls, Flather radiation — from the scheme's definition, in pure
NumPy fp64 with a deliberately DIFFERENT formulation:

* zero-filled explicit-slice shifts on a padded global array (the model
  rolls shard blocks and relies on masks/halos to hide the wrap);
* face/corner mass fluxes with explicit 0.5 factors, differenced per
  flux site (the model computes doubled donor-site quantities and rolls
  the combined advection+viscosity result, folding the 0.5 into the
  scalar prefactor);
* wet-neighbour-count division in next_sshu/v (the model uses the
  division-free ``1 - u_wet/2`` weight identity);
* plain division for 1/depth and the friction factor (the model
  multiplies by reciprocals).

Agreement is therefore allclose, not bitwise.  Scheme reference: the
GOcean NEMOLite2D benchmark kernel set (continuity/momentum/bc/next
kernels); the reference library itself ships no physics (SURVEY §2).

Semantics shared with the model (not re-derived — they define the
discrete problem): tmask codes 1 wet / 0 dry / -1 open-sea-outside
(grid_mod.f90:94-102), the NE-offset staggering, and the dry ring the
model forces outside the global domain (mask padding), reproduced here
as a PAD-wide zero ring.
"""
from __future__ import annotations

import numpy as np

PAD = 2  # >= the step's stencil reach


def _zshift(a, dj, di):
    """a[j+dj, i+di] with zero fill — explicit slicing, no wraparound."""
    out = np.zeros_like(a)
    nj, ni = a.shape
    src_j = slice(max(dj, 0), nj + min(dj, 0))
    dst_j = slice(max(-dj, 0), nj + min(-dj, 0))
    src_i = slice(max(di, 0), ni + min(di, 0))
    dst_i = slice(max(-di, 0), ni + min(-di, 0))
    out[dst_j, dst_i] = a[src_j, src_i]
    return out


def _E(a):
    return _zshift(a, 0, 1)


def _W(a):
    return _zshift(a, 0, -1)


def _N(a):
    return _zshift(a, 1, 0)


def _S(a):
    return _zshift(a, -1, 0)


def derive_masks(tmask):
    """t_wet, u_wet, v_wet, bc_cells, flather_u, flather_v (0/1 f64)."""
    t = (tmask == 1).astype(np.float64)
    o = (tmask == -1).astype(np.float64)
    u_wet = t * _E(t)
    v_wet = t * _N(t)
    near_out = np.minimum(_E(o) + _W(o) + _N(o) + _S(o), 1.0)
    bc_cells = t * near_out
    flather_u = t * _E(o) + o * _E(t)
    flather_v = t * _N(o) + o * _N(t)
    return t, u_wet, v_wet, bc_cells, flather_u, flather_v


def _face_ssh(ssh, t_wet, shift):
    """T ssh onto a face as the mean of its WET T neighbours (0 if none)."""
    sw = ssh * t_wet
    cnt = t_wet + shift(t_wet)
    return np.where(cnt > 0, (sw + shift(sw)) / np.maximum(cnt, 1.0), 0.0)


def step(ssh, u, v, masks, ht, hu, hv, p, dx, dy, fcor, forcing):
    """One forward-backward step on the padded arrays."""
    t_wet, u_wet, v_wet, bc_cells, flather_u, flather_v = masks

    sshu = _face_ssh(ssh, t_wet, _E)
    sshv = _face_ssh(ssh, t_wet, _N)
    depu = hu + sshu            # total water depth at U faces
    depv = hv + sshv
    z = ht + ssh                # total water depth at T centres

    # -- continuity: flux divergence onto T cells -------------------------
    fx = depu * u
    fy = depv * v
    ssha = ssh - (p.rdt / dx) * (fx - _W(fx)) - (p.rdt / dy) * (fy - _S(fy))
    ssha = np.where(t_wet > 0, ssha, ssh)          # dry/outside: frozen
    ssha = np.where(bc_cells > 0, forcing, ssha)   # prescribed-ssh forcing

    # -- u momentum -------------------------------------------------------
    # x: donor-cell mass flux at each T centre (west site of face i is T i)
    mT = 0.5 * (u + _W(u)) * z
    advT = mT * np.where(mT > 0, _W(u), u)
    gvT = (u - _W(u)) * z
    adv_x = -(p.rdt / dx) * (_E(advT) - advT)
    vis_x = (p.rdt * p.visc / (dx * dx)) * (_E(gvT) - gvT)
    # y: mass flux at F corners (corner j sits north of U face j)
    mF = 0.5 * (v + _E(v)) * (0.5 * (depv + _E(depv)))
    advF = mF * np.where(mF > 0, u, _N(u))
    gvF = (_N(u) - u) * 0.5 * (depv + _E(depv))
    adv_y = -(p.rdt / dy) * (advF - _S(advF))
    vis_y = (p.rdt * p.visc / (dy * dy)) * (gvF - _S(gvF))

    v4 = 0.25 * (v + _E(v) + _S(v) + _S(_E(v)))
    cor = p.rdt * fcor * v4 * depu
    hpg = -(p.rdt * p.g / dx) * depu * (_E(ssha) - ssha)
    ua = (u * depu + adv_x + vis_x + adv_y + vis_y + cor + hpg) \
        / (1.0 + p.cbfr * p.rdt) / depu
    ua = ua * u_wet                                # solid walls
    flath_u = -np.sqrt(p.g / np.maximum(hu, 1e-3)) * sshu
    ua = np.where(flather_u > 0, flath_u, ua)      # open-boundary radiation

    # -- v momentum (mirror) ----------------------------------------------
    mTv = 0.5 * (v + _S(v)) * z
    advTv = mTv * np.where(mTv > 0, _S(v), v)
    gvTv = (v - _S(v)) * z
    adv_y2 = -(p.rdt / dy) * (_N(advTv) - advTv)
    vis_y2 = (p.rdt * p.visc / (dy * dy)) * (_N(gvTv) - gvTv)

    mFu = 0.5 * (u + _N(u)) * (0.5 * (depu + _N(depu)))
    advFu = mFu * np.where(mFu > 0, v, _E(v))
    gvFu = (_E(v) - v) * 0.5 * (depu + _N(depu))
    adv_x2 = -(p.rdt / dx) * (advFu - _W(advFu))
    vis_x2 = (p.rdt * p.visc / (dx * dx)) * (gvFu - _W(gvFu))

    u4 = 0.25 * (u + _N(u) + _W(u) + _W(_N(u)))
    cor2 = -p.rdt * fcor * u4 * depv
    hpg2 = -(p.rdt * p.g / dy) * depv * (_N(ssha) - ssha)
    va = (v * depv + adv_y2 + vis_y2 + adv_x2 + vis_x2 + cor2 + hpg2) \
        / (1.0 + p.cbfr * p.rdt) / depv
    va = va * v_wet
    flath_v = -np.sqrt(p.g / np.maximum(hv, 1e-3)) * sshv
    va = np.where(flather_v > 0, flath_v, va)

    return ssha, ua, va


def golden_run(tmask, ssh0, nsteps, p, dx, dy, depth, istep0=0):
    """Run the golden model; returns dict(sshn, un, vn) on the global
    (unpadded) domain.

    ``tmask``/``ssh0``: global (gny, gnx) arrays; ``depth`` a scalar or
    a global T-point array; ``p`` the model Params (rdt, cbfr, visc, g,
    omega, d2r, amp, tide_period)."""
    tm = np.pad(np.asarray(tmask, np.int32), PAD)           # dry ring
    ssh = np.pad(np.asarray(ssh0, np.float64), PAD)         # frozen-0 ring
    u = np.zeros_like(ssh)
    v = np.zeros_like(ssh)
    if np.ndim(depth) == 0:
        ht = np.full_like(ssh, float(depth))
        hu = ht
        hv = ht
    else:
        ht = np.pad(np.asarray(depth, np.float64), PAD, mode="edge")
        hu = 0.5 * (ht + _E(ht))
        hv = 0.5 * (ht + _N(ht))
        # edge padding means the zero-filled shift only bites on the
        # outermost ring, which no valid cell reads
        hu[:, -1] = ht[:, -1]
        hv[-1, :] = ht[-1, :]
    masks = derive_masks(tm)
    fcor = 2.0 * p.omega * np.sin(50.0 * p.d2r)             # f-plane, 50N
    for k in range(nsteps):
        rtime = (istep0 + k + 1) * p.rdt
        forcing = p.amp * np.sin(2.0 * np.pi * rtime / p.tide_period)
        ssh, u, v = step(ssh, u, v, masks, ht, hu, hv, p, dx, dy, fcor,
                         forcing)
    sl = slice(PAD, -PAD)
    return {"sshn": ssh[sl, sl], "un": u[sl, sl], "vn": v[sl, sl]}


def compare(got: dict, want: dict, *, rtol: float, atol: float) -> dict:
    """Per-field agreement of a model state with the golden, by the
    ``numpy.testing.assert_allclose`` rule ``|got - want| <= atol +
    rtol * |want|``.  Returns ``{field: {"max_abs", "max_rel",
    "finite", "ok"}}`` for every field of ``want``; a field is ``ok``
    only if every value is finite and within the bound."""
    out = {}
    for k, w in want.items():
        g = np.asarray(got[k], np.float64)
        w = np.asarray(w, np.float64)
        if g.shape != w.shape:
            raise ValueError(f"{k}: shape {g.shape} != golden {w.shape}")
        err = np.abs(g - w)
        finite = bool(np.all(np.isfinite(g)))
        out[k] = {"max_abs": float(err.max()),
                  "max_rel": float((err / np.maximum(np.abs(w),
                                                      1e-300)).max()),
                  "finite": finite,
                  "ok": finite and bool(np.all(err <= atol
                                               + rtol * np.abs(w)))}
    return out
