"""Ensemble Kalman filtering (ETKF) on the ensemble runner.

The second pillar of operational data assimilation next to 4D-Var
(``models/assimilation.py``): instead of an adjoint, the forecast
ensemble itself supplies the covariances.  The reference framework has
no batching concept at all (one ``r2d_field`` is one array,
field_mod.f90:139-166), so this workflow on the reference means M job
launches plus a hand-written MPI analysis code; here it is one program.

The ensemble transform Kalman filter (ETKF, Bishop et al. 2001; the
square-root form of Hunt et al. 2007) maps onto the card by
construction:

* obs-space statistics reduce to an (M, M) matrix and an (M,) vector —
  each shard contributes its local observations via masked ``einsum``
  and one ``psum`` of O(M^2) scalars ships the lot (no observation
  gather, no state gather);
* the (M, M) eigendecomposition is replicated per device (identical
  inputs -> identical weights everywhere);
* the state update is a member-space matmul applied point-wise,
  ``X_a = x̄ + W^T X'`` over every local grid point —
  a large, batched matmul for the tensor cores (every f32 product asks
  for ``precision=HIGHEST``, so the card never rounds it to TF32);
* because every device applies the SAME (M, M) weights, shard-halo
  points transform exactly like their interior twins on the
  neighbouring shard — the analysis needs NO halo exchange and
  decomposition invariance is preserved bitwise-structurally
  (``tests/test_enkf.py``).

Every state field is updated with the same weights (the standard
multivariate update: cross-covariances between the observed field and
the others are implicit in the ensemble), so observing eta corrects
u and v too.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from ..core import layout

HIGHEST = lax.Precision.HIGHEST


def _etkf_weights(S, d, m, inflation):
    """ETKF weight matrix from obs-space moments: returns ``Wtot`` with
    ``Wtot[..., j, k]`` the weight of forecast perturbation j in
    analysis member k.  Batched over any leading dims — the LETKF path
    calls it with per-grid-point ``(ly, lx, M, M)`` moments and XLA
    batches the eigendecomposition over all points.

    ``S = Y'^T R^-1 Y'``, ``d = Y'^T R^-1 (y - Hx̄)``;
    ``P̃^-1 = (m-1) I / inflation + S``;
    ``w̄ = P̃ d``; ``W_a = sqrt(m-1) P̃^(1/2)``; ``Wtot = w̄ 1^T + W_a``.
    """
    dtype = S.dtype
    eye = jnp.eye(m, dtype=dtype)
    pinv = (m - 1) / inflation * eye + S
    lam, q = jnp.linalg.eigh(pinv)
    # pinv is SPD by construction ((m-1)/rho > 0, S PSD); clamp anyway
    # so a degenerate ensemble cannot emit NaNs
    lam = jnp.maximum(lam, jnp.asarray(1e-30, dtype))
    qt = jnp.swapaxes(q, -1, -2)
    p_tilde = jnp.matmul(q / lam[..., None, :], qt, precision=HIGHEST)
    w_mean = jnp.matmul(p_tilde, d[..., None], precision=HIGHEST)[..., 0]
    w_anom = jnp.sqrt(jnp.asarray(m - 1, dtype)) * jnp.matmul(
        q / jnp.sqrt(lam)[..., None, :], qt, precision=HIGHEST)
    return w_mean[..., None] + w_anom


def gaspari_cohn(r):
    """The Gaspari-Cohn 5th-order compactly-supported correlation
    function of ``r = distance / L`` (the standard covariance
    localisation taper; support ``r < 2``)."""
    # clamp before the polynomials: padded/far observations arrive with
    # huge r and x**5 would overflow to inf (inf - inf = NaN inside the
    # discarded branch is fine for where, but keep it clean and cheap)
    r = jnp.minimum(jnp.abs(r), jnp.asarray(3.0, r.dtype))
    near = (-0.25 * r ** 5 + 0.5 * r ** 4 + 0.625 * r ** 3
            - (5.0 / 3.0) * r ** 2 + 1.0)
    rs = jnp.maximum(r, jnp.asarray(1e-12, r.dtype))
    far = ((1.0 / 12.0) * r ** 5 - 0.5 * r ** 4 + 0.625 * r ** 3
           + (5.0 / 3.0) * r ** 2 - 5.0 * r + 4.0 - (2.0 / 3.0) / rs)
    return jnp.where(r <= 1.0, near,
                     jnp.where(r <= 2.0, far, jnp.zeros_like(r)))


class ETKF:
    """Ensemble transform Kalman filter over an ``Ensemble``.

    ``obs_field`` names the observed state field (default the first,
    the surface elevation in every adapter).  Observations arrive as a
    global ``(gny, gnx)`` value array plus a 0/1 mask of observed
    points (default: every wet internal point), with independent error
    std ``sigma``; ``inflation`` is multiplicative covariance
    inflation (rho >= 1 combats sampling noise from finite M).

    ``localization_radius=L`` (physical units) switches to the LETKF
    (Hunt et al. 2007): every grid point computes its own analysis
    from observations within ``2L``, with Gaspari-Cohn-tapered
    R-localisation — the production form for small ensembles, where
    spurious long-range sample covariances otherwise contaminate the
    update.  The per-point (M, M) eigendecompositions run as
    one batched ``eigh`` over all local points and the moments are
    taper-weighted einsums.  At ``inflation=1`` points out of range of
    every observation are left exactly unchanged (the transform
    degenerates to the identity); with ``rho > 1`` their anomalies are
    scaled by ``sqrt(rho)`` per analysis — the standard semantics of
    multiplicative PRIOR inflation, which grows spread without bound
    in never-observed regions over long cycling (use rho = 1, or
    observe everywhere occasionally, if that matters).
    """

    def __init__(self, ensemble, *, obs_field: str | None = None,
                 sigma: float = 0.05, inflation: float = 1.0,
                 localization_radius: float | None = None,
                 obs_level: int = 0, adaptive_inflation: bool = False,
                 inflation_max: float = 2.0):
        self.ens = ensemble
        names = ensemble._field_names
        self._obs_idx = (0 if obs_field is None
                         else names.index(obs_field))
        # multi-level obs field (e.g. an NLayerModel ensemble): observe
        # ONE interface; the member-space update still corrects every
        # level of every field through the ensemble cross-covariances
        levels = ensemble._fields[self._obs_idx].levels
        if levels is None:
            if obs_level != 0:
                raise ValueError("obs_level applies to multi-level "
                                 "observed fields only")
            self._obs_level = None
        else:
            if not (0 <= obs_level < levels):
                raise ValueError(f"obs_level must be in [0, {levels}), "
                                 f"got {obs_level}")
            self._obs_level = int(obs_level)
        if sigma <= 0:
            raise ValueError("sigma must be > 0")
        if inflation < 1.0:
            raise ValueError("inflation must be >= 1 (multiplicative)")
        if localization_radius is not None and localization_radius <= 0:
            raise ValueError("localization_radius must be > 0 "
                             "(physical units; None = global ETKF)")
        if inflation_max < 1.0:
            raise ValueError("inflation_max must be >= 1")
        self.sigma = float(sigma)
        self.inflation = float(inflation)
        self.adaptive_inflation = bool(adaptive_inflation)
        self.inflation_max = float(inflation_max)
        self.localization_radius = (None if localization_radius is None
                                    else float(localization_radius))
        grid = ensemble.grid
        d = grid.decomp
        dtype = np.dtype(grid.dtype)
        # observations are compared on wet internal points only.  The
        # geometric part comes from the host-side layout; the wet mask
        # is a DEVICE op on the model's (possibly sharded) mask — never
        # np.asarray a sharded array in library code (multi-controller
        # processes cannot materialise remote shards).
        wet = jax.device_put(jnp.asarray(
            np.asarray(layout.internal_mask(d), dtype=dtype)),
            grid.sharding)
        model = ensemble.model
        t_wet = getattr(model, "_t_upd", None)
        if t_wet is None:
            t_wet = getattr(model, "_t_wet", None)
        if t_wet is not None:
            wet = wet * t_wet.astype(wet.dtype)
        self._wet = wet
        if self.localization_radius is not None:
            # per-cell GLOBAL indices (halo cells included, so a halo
            # point gets the same distances — hence the same weights —
            # as its interior twin on the neighbouring shard)
            gy = np.asarray(layout.global_y_index(d), np.int32)
            gx = np.asarray(layout.global_x_index(d), np.int32)
            self._gyi = jax.device_put(jnp.asarray(np.broadcast_to(
                gy[:, None], (gy.size, gx.size))), grid.sharding)
            self._gxi = jax.device_put(jnp.asarray(np.broadcast_to(
                gx[None, :], (gy.size, gx.size))), grid.sharding)
        self._prog = None
        self._loc_progs = {}

    # ------------------------------------------------------------------
    def _program(self):
        """One jitted shard_map program: moments -> weights -> update."""
        if self._prog is not None:
            return self._prog
        ens = self.ens
        m = ens.n_members
        oi = self._obs_idx
        lvl = self._obs_level
        mesh = ens.grid.mesh

        def body(obs, obs_w, wet, sig_inv2, rho, *state):
            # local obs weight: observed wet internal points, 1/sigma^2
            w = obs_w * wet * sig_inv2
            eo = state[oi] if lvl is None else state[oi][:, lvl]
            em = jnp.mean(eo, axis=0)
            ep = eo - em[None]
            # obs-space moments: one psum of M^2 + M + 1 scalars total
            S = lax.psum(jnp.einsum("myx,nyx->mn", ep, ep * w[None],
                                    precision=HIGHEST),
                         ("y", "x"))
            d = lax.psum(jnp.einsum("myx,yx->m", ep, (obs - em) * w,
                                    precision=HIGHEST),
                         ("y", "x"))
            wtot = _etkf_weights(S, d, m, rho)
            out = []
            for f in state:
                fm = jnp.mean(f, axis=0)
                fp = f - fm[None]
                # the matmul leg: member-space mix at every local point
                # (ellipsis carries vertical-level axes through)
                out.append(fm[None]
                           + jnp.einsum("mk,m...->k...", wtot, fp,
                                        precision=HIGHEST))
            return tuple(out)

        smapped = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P("y", "x"),) * 3 + (P(),) * 2 + ens._specs,
            out_specs=ens._specs, check_vma=False)
        self._prog = jax.jit(smapped)
        return self._prog

    # ------------------------------------------------------------------
    def _program_localized(self, p_pad: int):
        """LETKF: every grid point solves its own (M, M) analysis from
        Gaspari-Cohn-tapered observations.  One program per padded
        observation count; inside it the obs-space anomalies are one
        psum of a (p, M) matrix, the per-point moments are einsums over
        the taper, the eigendecompositions run BATCHED over all local
        points, and the update is the same member-space mix with
        point-dependent weights.  Weights depend only on a point's
        global coordinates and the global obs set, so halo points
        transform like their interior twins — still no halo exchange."""
        if p_pad in self._loc_progs:
            return self._loc_progs[p_pad]
        ens = self.ens
        m = ens.n_members
        oi = self._obs_idx
        lvl = self._obs_level
        mesh = ens.grid.mesh
        dx, dy = float(ens.grid.dx), float(ens.grid.dy)

        def body(ovals, oyi, oxi, gyi, gxi, wet, sig_inv2, rho, rad,
                 *state):
            dtype = state[oi].dtype
            eo = state[oi] if lvl is None else state[oi][:, lvl]
            em = jnp.mean(eo, axis=0)
            ep = eo - em[None]
            # one-hot extraction of obs-point anomalies/means: an obs
            # lives on exactly one shard's wet internal cell; the psum
            # assembles the global (p, M) matrix everywhere
            sel = ((gyi[None] == oyi[:, None, None])
                   & (gxi[None] == oxi[:, None, None])
                   & (wet > 0)[None]).astype(dtype)
            yp = lax.psum(jnp.einsum("pyx,myx->pm", sel, ep,
                                       precision=HIGHEST), ("y", "x"))
            mo = lax.psum(jnp.einsum("pyx,yx->p", sel, em,
                                       precision=HIGHEST), ("y", "x"))
            innov = ovals - mo
            # per-point Gaspari-Cohn taper of R^-1 (R-localisation);
            # padded slots carry far-away coords -> taper exactly 0
            fy = (gyi.astype(dtype)[None]
                  - oyi.astype(dtype)[:, None, None]) * dy
            fx = (gxi.astype(dtype)[None]
                  - oxi.astype(dtype)[:, None, None]) * dx
            taper = gaspari_cohn(jnp.sqrt(fy * fy + fx * fx) / rad)
            w = taper * sig_inv2
            S = jnp.einsum("pyx,pm,pn->yxmn", w, yp, yp,
                           precision=HIGHEST)
            dloc = jnp.einsum("pyx,pm,p->yxm", w, yp, innov,
                              precision=HIGHEST)
            wtot = _etkf_weights(S, dloc, m, rho)      # (ly, lx, M, M)
            out = []
            for f in state:
                fm = jnp.mean(f, axis=0)
                fp = f - fm[None]
                out.append(fm[None] + jnp.einsum("yxmk,m...yx->k...yx",
                                                 wtot, fp,
                                                 precision=HIGHEST))
            return tuple(out)

        smapped = jax.shard_map(
            body, mesh=mesh,
            in_specs=((P(),) * 3 + (P("y", "x"),) * 3 + (P(),) * 3
                      + ens._specs),
            out_specs=ens._specs, check_vma=False)
        self._loc_progs[p_pad] = jax.jit(smapped)
        return self._loc_progs[p_pad]

    # ------------------------------------------------------------------
    def analysis(self, obs_global, obs_mask=None) -> dict:
        """Assimilate one batch of observations into the ensemble
        (in place).  Returns obs-space diagnostics: RMS innovation of
        the ensemble mean before and after, and the mean spread of the
        observed field before/after (on observed points)."""
        ens = self.ens
        grid = ens.grid
        d = grid.decomp
        dtype = np.dtype(grid.dtype)
        obs = jax.device_put(jnp.asarray(layout.stack_global(
            d, np.asarray(obs_global), mode="zeros", dtype=dtype)),
            grid.sharding)
        if obs_mask is None:
            ow = jnp.ones_like(obs)
        else:
            ow = jnp.asarray(layout.stack_global(
                d, (np.asarray(obs_mask) != 0).astype(dtype),
                mode="zeros", dtype=dtype))
        ow = jax.device_put(ow, grid.sharding)

        before = self._obs_diagnostics(obs, ow)
        if self.adaptive_inflation:
            # Wang & Bishop (2003) innovation statistics: consistency
            # wants <d^2> = spread^2 + sigma^2, so the forecast
            # variance deficit (rms^2 - sigma^2)/spread^2 is the
            # multiplicative inflation that restores it; clipped to
            # [1, inflation_max] and persisted for the next cycle
            rms, spread = before
            est = (rms ** 2 - self.sigma ** 2) / max(spread ** 2, 1e-30)
            self.inflation = float(np.clip(est, 1.0,
                                           self.inflation_max))
        sig_inv2 = jnp.asarray(1.0 / self.sigma ** 2, dtype)
        rho = jnp.asarray(self.inflation, dtype)
        if self.localization_radius is None:
            ens.states = tuple(self._program()(
                obs, ow, self._wet, sig_inv2, rho, *ens.states))
        else:
            # host-side obs list (mask and values are host arrays),
            # padded to a static length so programs are reused
            mask_np = (np.ones((d.global_ny, d.global_nx), bool)
                       if obs_mask is None
                       else np.asarray(obs_mask) != 0)
            iy, ix = np.nonzero(mask_np)
            vals = np.asarray(obs_global)[iy, ix].astype(dtype)
            p_pad = max(64, int(-(-iy.size // 64) * 64))
            far = np.int32(-(2 ** 24))     # taper 0, matches no cell
            oyi = np.full((p_pad,), far, np.int32)
            oxi = np.full((p_pad,), far, np.int32)
            ovals = np.zeros((p_pad,), dtype)
            oyi[: iy.size] = iy
            oxi[: ix.size] = ix
            ovals[: iy.size] = vals
            rad = jnp.asarray(self.localization_radius, dtype)
            ens.states = tuple(self._program_localized(p_pad)(
                jnp.asarray(ovals), jnp.asarray(oyi), jnp.asarray(oxi),
                self._gyi, self._gxi, self._wet, sig_inv2, rho, rad,
                *ens.states))
        after = self._obs_diagnostics(obs, ow)
        return {"rms_innovation_before": before[0],
                "rms_innovation_after": after[0],
                "spread_before": before[1], "spread_after": after[1],
                "inflation": self.inflation}

    def _obs_diagnostics(self, obs, ow):
        """(RMS mean innovation, mean member spread) on observed wet
        internal points — device-resident reductions only."""
        w = ow * self._wet
        npts = jnp.maximum(jnp.sum(w), 1.0)
        eo = self.ens.states[self._obs_idx]
        if self._obs_level is not None:
            eo = eo[:, self._obs_level]
        em = jnp.mean(eo, axis=0)
        rms = jnp.sqrt(jnp.sum((em - obs) ** 2 * w) / npts)
        spread = jnp.sqrt(jnp.sum(jnp.var(eo, axis=0) * w) / npts)
        return float(rms), float(spread)
