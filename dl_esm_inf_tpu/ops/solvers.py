"""Distributed iterative elliptic solvers (PCG + Chebyshev).

The reference library ships no solver — its clients do: semi-implicit
free-surface ocean codes (the GOcean model family dl_esm_inf serves)
need one elliptic solve per time step, and on MPI that means a hand
written CG with halo exchanges inside the matvec and ``MPI_Allreduce``
dot products (the reference's ``global_sum``,
parallel_utils_mod.f90:230-238, is exactly the primitive such clients
call).  This module supplies that capability class in JAX:

* the matvec is "depth-1 halo exchange + local 5-point stencil" on the
  shard's block (``parallel.halo.exchange_fn`` inlined in shard_map);
* dot products are ``lax.psum`` scalars over BOTH mesh axes — the
  in-program form of ``global_sum``;
* the iteration is a ``lax.while_loop`` with a tolerance test — data
  dependent control flow expressed the XLA way, so the WHOLE solve
  (every exchange, every reduction, every iteration) is one compiled
  program with no host round-trips.

Two layers:

:func:`pcg_block` — a generic per-block preconditioned-CG body for use
inside any ``shard_map`` program (the semi-implicit model embeds it in
its time step so step + solve compile as one program).

:class:`HelmholtzSolver` — the ready-made client: ``(I + lam*L) x = b``
on wet T points with no-flux (homogeneous Neumann) walls expressed
purely through the tmask, matching the framework's land philosophy
(grid_mod.f90:94-102: walls are mask values, not special-cased edges).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from ..core import kinds, layout
from ..parallel.halo import exchange_fn, exchange_multi_fn
from . import stencils as st


def pcg_block(matvec, b, x0, weight, *, tol: float, maxiter: int,
              inv_diag=None, axis_names=("y", "x")):
    """Preconditioned conjugate gradients on one shard block.

    Call INSIDE shard_map.  ``matvec`` must accept a local block whose
    halo ring is stale and return ``A x`` valid on internal cells (it
    performs its own halo exchange); halo cells of every iterate are
    garbage by contract and are excluded from dot products by
    ``weight`` (1 on cells counted once globally, 0 on halos/padding —
    ``layout.internal_mask``).  ``inv_diag`` enables Jacobi
    preconditioning.  Every device executes identical scalar control
    flow because the loop condition depends only on psum'd values.

    Returns ``(x, iters, rel_res)`` with ``x``'s halo ring stale.
    """
    acc = jnp.dtype(kinds.sum_dtype())
    w = weight.astype(acc)

    def pdot(u, v):
        s = jnp.sum(u.astype(acc) * v.astype(acc) * w)
        return lax.psum(s, axis_names)

    def pdot2(u1, v1, u2, v2):
        """Two dot products in ONE psum (halves collective count)."""
        s1 = jnp.sum(u1.astype(acc) * v1.astype(acc) * w)
        s2 = jnp.sum(u2.astype(acc) * v2.astype(acc) * w)
        return lax.psum(jnp.stack([s1, s2]), axis_names)

    def prec(r):
        return r * inv_diag if inv_diag is not None else r

    r0 = b - matvec(x0)
    z0 = prec(r0)
    rz_rr = pdot2(r0, z0, r0, r0)
    bb = pdot(b, b)
    # relative tolerance against the preconditioned rhs norm; an all-
    # zero rhs converges immediately (x = x0 if it already solves it)
    tol2 = jnp.asarray(tol, acc) ** 2 * jnp.maximum(
        bb, jnp.asarray(np.finfo(np.dtype(acc)).tiny, acc))

    def cond(carry):
        _x, _r, _p, _rz, rr, k = carry
        return (rr > tol2) & (k < maxiter)

    def body(carry):
        x, r, p, rz, _rr, k = carry
        ap = matvec(p)
        pap = pdot(p, ap)
        alpha = jnp.where(pap != 0, rz / pap, jnp.zeros((), acc))
        x = x + alpha.astype(x.dtype) * p
        r = r - alpha.astype(r.dtype) * ap
        z = prec(r)
        rz_new, rr_new = pdot2(r, z, r, r)
        beta = jnp.where(rz != 0, rz_new / rz, jnp.zeros((), acc))
        p = z + beta.astype(p.dtype) * p
        return (x, r, p, rz_new, rr_new, k + 1)

    x, _r, _p, _rz, rr, k = lax.while_loop(
        cond, body, (x0, r0, z0, rz_rr[0], rz_rr[1], jnp.zeros((),
                                                               jnp.int32)))
    rel = jnp.sqrt(rr / jnp.maximum(bb, jnp.asarray(
        np.finfo(np.dtype(acc)).tiny, acc)))
    return x, k, rel.astype(acc)


def pcg_solve(matvec, b, weight, *, tol: float, maxiter: int,
              inv_diag=None, axis_names=("y", "x"), x0=None):
    """DIFFERENTIABLE per-block solve (same contract as
    :func:`pcg_block`, minus the iteration-count outputs).

    Wraps the CG loop in ``lax.custom_linear_solve`` so reverse-mode AD
    never unrolls the iterations: the VJP solves the SAME symmetric
    system with the downstream cotangent as rhs (implicit-function
    differentiation).  The operator handed to custom_linear_solve must
    be symmetric on the FULL padded block space, which the raw
    exchange-then-stencil matvec is not (halo rows break it): both
    sides are projected with ``weight`` — ``M = P A E P`` is exactly
    the global symmetric operator on canonical (halo-zeroed) vectors
    and zero elsewhere.  Returns the canonical solution (halo cells
    ZERO — exchange it before stencil use).  Gradient pinned against
    finite differences at 1e-8 on 1 and 8 shards
    (tests/test_assimilation.py).
    """
    def sym_mv(x):
        return weight * matvec(weight * x)

    def solve(mvf, rhs):
        start = jnp.zeros_like(rhs) if x0 is None else weight * x0
        x, _k, _rel = pcg_block(mvf, rhs, start, weight, tol=tol,
                                maxiter=maxiter, inv_diag=inv_diag,
                                axis_names=axis_names)
        return weight * x

    return lax.custom_linear_solve(sym_mv, weight * b, solve,
                                   symmetric=True)


def default_tol(dtype) -> float:
    """Dtype-aware default stopping tolerance: 50*eps, floored at
    1e-10 (f64 -> 1e-10, f32 -> 6e-6).  A fixed 1e-10 would make a
    float32 solve grind for hundreds of iterations chasing a residual
    the iterates cannot represent (the recursive CG residual keeps
    shrinking long after the true one floors at ~eps)."""
    return max(float(np.finfo(np.dtype(dtype)).eps) * 50.0, 1e-10)


def helmholtz_coefficients(grid, lam_x, lam_y, diag_extra=None):
    """Stacked-layout face/diagonal coefficient arrays for
    ``A = I + lam*L`` with no-flux walls.

    ``L`` is the negated masked 5-point Laplacian: a face conducts only
    between two solver-active cells (wet AND inside the global domain —
    the same activity rule the gravity-wave model uses for its update
    masks, so shard-halo cells evolve exactly like their interior twins
    on the neighbouring shard and the matvec needs only a depth-1
    exchange).  Returns ``(e, w, n, s, diag)`` device (sharded) arrays.

    ``lam_x``/``lam_y`` are scalars, or ``(gny, gnx)`` global PER-FACE
    coupling arrays (``lam_x[j, i]`` = the face between T cells
    ``(j, i)`` and ``(j, i+1)``, NE-offset U/V-face convention — e.g.
    ``g*H_u*(theta*dt)**2/dx**2`` for variable bathymetry).  Symmetry
    is by construction: both cells sharing a face use the SAME face
    value (``w`` is ``e`` rolled, not an independent product), so the
    operator stays SPD for any positive coefficient field.

    ``diag_extra`` (global ``(gny, gnx)`` array) adds per-cell DIAGONAL
    terms — the Robin/radiation contributions of an implicit open
    boundary (a theta-implicit Flather flux couples a boundary cell
    only to itself, so SPD is preserved for nonnegative extras).
    """
    d = grid.decomp
    gx = layout.global_x_index(d)
    gy = layout.global_y_index(d)
    geo = (((gy >= 0) & (gy < d.global_ny))[:, None]
           & ((gx >= 0) & (gx < d.global_nx))[None, :])
    # halo cells that are COPIES of real cells (periodic wrap, or the
    # plain shard seam) must conduct: exchanging the strict in-domain
    # mask stamps each halo cell with its source cell's validity, and
    # leaves non-wrap outer halos at their stale False.
    from ..parallel import halo as halo_mod
    geo_x = halo_mod.exchange(
        jax.device_put(jnp.asarray(geo, np.dtype(grid.dtype)),
                       grid.sharding),
        grid.mesh, grid.halo_spec, depth=d.halo)
    # built entirely with device-resident jnp ops: the tmask is a
    # SHARDED array that a multi-controller process cannot materialise
    # to numpy (only its addressable shards are local)
    dtype = jnp.dtype(grid.dtype)
    a = ((grid.tmask == 1) & (geo_x > 0.5)).astype(dtype)

    def face(lam):
        """Stacked per-face coupling: scalar, or a global array
        scattered+exchanged so halo faces carry their source face's
        value (grid.scatter_exchanged)."""
        if np.isscalar(lam) or getattr(lam, "ndim", 0) == 0:
            return float(lam)
        return grid.scatter_exchanged(lam, mode="edge", dtype=dtype)

    lx_f, ly_f = face(lam_x), face(lam_y)
    # neighbour activity via global rolls — same shift semantics as the
    # in-program stencils (stale wrap values land outside `act` support)
    e = lx_f * a * jnp.roll(a, -1, 1)
    n = ly_f * a * jnp.roll(a, -1, 0)
    # the opposite-direction coefficients are the SAME face rolled (not
    # an independent product): symmetry — and hence SPD — by
    # construction for any positive coefficient field
    w = jnp.roll(e, 1, 1) * a * jnp.roll(a, 1, 1)
    s = jnp.roll(n, 1, 0) * a * jnp.roll(a, 1, 0)
    diag = 1.0 + e + w + n + s
    if diag_extra is not None:
        diag = diag + a * grid.scatter_exchanged(
            diag_extra, mode="zeros", dtype=dtype)
    return e, w, n, s, diag.astype(dtype)


def chebyshev_iterations(lam_min: float, lam_max: float,
                         tol: float) -> int:
    """Iterations for the Chebyshev error bound
    ``2 * ((sqrt(k)-1)/(sqrt(k)+1))^n <= tol`` with ``k`` the
    eigenvalue-bound condition number."""
    k = lam_max / lam_min
    rho = (np.sqrt(k) - 1.0) / (np.sqrt(k) + 1.0)
    if rho <= 0:
        return 1
    return max(1, int(np.ceil(np.log(2.0 / tol) / -np.log(rho))))


def chebyshev_block(b, x0, *, matvec, lam_min: float, lam_max: float,
                    niters: int, exchange_every=None):
    """Chebyshev iteration on one shard block — NO inner products, so
    zero scalar collectives: the only communication is whatever
    ``matvec`` does.  Needs eigenvalue bounds instead (for the
    Helmholtz operator they are analytic: ``[1, 1 + 4*(lam_x+lam_y)]``
    by Gershgorin, with 1 exact for the Neumann wall operator).  The
    iteration count is static (``chebyshev_iterations``), making the
    whole solve a fixed-shape program — the communication-avoiding
    counterpart of :func:`pcg_block`.

    ``exchange_every=(K, exch_multi_fn)`` selects DEEP-HALO mode:
    ``matvec`` must then omit its exchange, and the iterate triple
    (x, r, d) is jointly refreshed once per K matvecs (each matvec
    consumes one valid halo ring; ``niters`` must be a multiple of K
    and the halo at least K deep).  Requires coefficient/operand halo
    cells to compute exactly like their interior twins.
    """
    theta = 0.5 * (lam_max + lam_min)
    # delta=0 (identity operator, lam_max == lam_min) degenerates to a
    # single Richardson step; the clamp keeps the recurrence finite and
    # algebraically exact in that limit (2*rho1/delta -> 1/theta)
    delta = max(0.5 * (lam_max - lam_min), 1e-30 * theta)
    sigma1 = theta / delta

    def one(carry):
        x, r, d, rho = carry
        x = x + d
        r = r - matvec(d)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        return (x, r, d, rho_new)

    if exchange_every is None:
        r0 = b - matvec(x0)
        carry = (x0, r0, r0 / theta,
                 jnp.asarray(1.0 / sigma1, r0.dtype))
        x, _r, _d, _rho = lax.fori_loop(
            0, niters, lambda _, c: one(c), carry)
        return x

    K, exchK = exchange_every
    if niters % K:
        raise ValueError(f"niters={niters} must be a multiple of "
                         f"steps_per_exchange K={K}")
    b, x0 = exchK((b, x0))               # operands halo-consistent
    r0 = b - matvec(x0)
    carry = (x0, r0, r0 / theta, jnp.asarray(1.0 / sigma1, r0.dtype))

    def block(_, carry):
        x, r, d, rho = carry
        x, r, d = exchK((x, r, d))
        c = (x, r, d, rho)
        for _k in range(K):              # static unroll: K matvecs
            c = one(c)
        return c

    x, _r, _d, _rho = lax.fori_loop(0, niters // K, block, carry)
    return x


def make_helmholtz_matvec(spec, e, w, n, s, diag, exchange: bool = True):
    """Per-block ``x -> (I + lam*L) x`` closure over coefficient blocks
    (themselves shard_map operands): one depth-1 exchange + 5-point
    stencil.  Identity on inactive cells (all faces 0, diag 1), so the
    operator is SPD and dry/padding cells never couple in.
    ``exchange=False`` omits the halo refresh for communication-
    avoiding callers that manage deep halos themselves (each
    application then consumes one valid halo ring)."""
    exch = exchange_fn(spec, depth=1) if exchange else (lambda x: x)

    def matvec(x):
        x = exch(x)
        return (diag * x - e * st.xp(x) - w * st.xm(x)
                - n * st.yp(x) - s * st.ym(x))
    return matvec


class HelmholtzSolver:
    """``(I + lam*L) x = b`` on a grid's wet T points, compiled once.

    ``lam_x/lam_y`` are the nondimensional face couplings (a semi-
    implicit free-surface step uses ``g*H*(theta*dt)**2/dx**2``).  The
    solve is ONE jitted shard_map program; decomposition invariance
    (1-shard == N-shard) holds to reduction-order roundoff.
    """

    def __init__(self, grid, lam_x: float, lam_y: float, *,
                 tol: float | None = None, maxiter: int | None = None,
                 precondition: bool = True, method: str = "cg",
                 steps_per_exchange: int = 1):
        """``method="chebyshev"`` selects the communication-avoiding
        iteration: no inner products (zero scalar collectives; uses
        the analytic eigenvalue bounds ``[1, 1+4(lam_x+lam_y)]``) and
        a STATIC iteration count from the Chebyshev error bound.
        ``steps_per_exchange=K`` (chebyshev only) then runs K matvecs
        per depth-``halo_width`` halo exchange — the solver-level
        analogue of the models' ``set_steps_per_exchange`` — needing
        ``halo_width >= K`` and relying on halo cells computing
        exactly like their interior twins (the coefficient arrays are
        halo-exchanged at build time to guarantee it)."""
        if grid.halo_spec is None:
            raise ValueError("grid must be initialised (grid_init) "
                             "before building a solver")
        if method not in ("cg", "chebyshev"):
            raise ValueError(f"method must be 'cg' or 'chebyshev', "
                             f"got {method!r}")
        self.grid = grid
        self.method = method
        self.tol = float(tol if tol is not None
                         else default_tol(grid.dtype))
        d = grid.decomp
        self.steps_per_exchange = int(steps_per_exchange)
        if self.steps_per_exchange < 1:
            raise ValueError("steps_per_exchange must be >= 1")
        if self.steps_per_exchange > 1:
            if method != "chebyshev":
                raise ValueError(
                    "steps_per_exchange needs method='chebyshev' (CG "
                    "has a dot product between matvecs; there is "
                    "nothing to avoid)")
            if d.halo < self.steps_per_exchange:
                raise ValueError(
                    f"steps_per_exchange={self.steps_per_exchange} "
                    f"needs halo_width >= {self.steps_per_exchange}, "
                    f"grid has {d.halo} (decompose(halo_width=...))")
        self._user_maxiter = maxiter is not None
        self.maxiter = int(maxiter if maxiter is not None
                           else 4 * (d.global_nx + d.global_ny))
        lam_max = (float(np.max(lam_x)) + float(np.max(lam_y)))
        self._lam_bounds = (1.0, 1.0 + 4.0 * lam_max)
        coeffs = helmholtz_coefficients(grid, lam_x, lam_y)
        put = functools.partial(jax.device_put, device=grid.sharding)
        arrs = [put(jnp.asarray(c)) for c in coeffs]
        if self.steps_per_exchange > 1:
            # halo cells must carry their interior twin's coefficients
            # so redundant halo compute reproduces the twin exactly
            from ..parallel import halo as halo_mod
            arrs = [halo_mod.exchange(a, grid.mesh, grid.halo_spec,
                                      depth=d.halo) for a in arrs]
        self._coeffs = tuple(arrs)
        self._inv_diag = put(jnp.asarray(1.0 / coeffs[4])) \
            if precondition else None
        self._weight = put(jnp.asarray(
            layout.internal_mask(d).astype(np.dtype(grid.dtype))))
        self._prog = None

    def _program(self):
        if self._prog is None:
            spec = self.grid.halo_spec
            exch = exchange_fn(spec, depth=1)
            has_pc = self._inv_diag is not None
            acc = jnp.dtype(kinds.sum_dtype())

            if self.method == "cg":
                def body(b, x0, wgt, e, w, n, s, diag, *pc):
                    mv = make_helmholtz_matvec(spec, e, w, n, s, diag)
                    x, k, rel = pcg_block(
                        mv, b, x0, wgt, tol=self.tol,
                        maxiter=self.maxiter,
                        inv_diag=pc[0] if pc else None)
                    return exch(x), k, rel
            else:
                lmin, lmax = self._lam_bounds
                K = self.steps_per_exchange
                # run to the static error bound; the CG-sized default
                # maxiter is not a meaningful cap for a fixed-count
                # iteration (only an EXPLICIT maxiter limits it)
                niters = chebyshev_iterations(lmin, lmax, self.tol)
                niters = -(-niters // K) * K       # round up to K
                if self._user_maxiter:
                    # an explicit maxiter is a hard cap: round DOWN to
                    # a K multiple (but at least one sweep)
                    niters = min(niters,
                                 max(K, (self.maxiter // K) * K))
                H = self.grid.decomp.halo

                def _residual(b, x, wgt, mv1):
                    r = b - mv1(x)       # mv1 refreshes x's halo itself
                    wacc = wgt.astype(acc)
                    rr = lax.psum(jnp.sum(r.astype(acc) ** 2 * wacc),
                                  ("y", "x"))
                    bb = lax.psum(jnp.sum(b.astype(acc) ** 2 * wacc),
                                  ("y", "x"))
                    return jnp.sqrt(rr / jnp.maximum(
                        bb, jnp.asarray(np.finfo(np.dtype(acc)).tiny,
                                        acc)))

                def body(b, x0, wgt, e, w, n, s, diag, *pc):
                    if K == 1:
                        mv = make_helmholtz_matvec(spec, e, w, n, s,
                                                   diag)
                        x = chebyshev_block(b, x0, matvec=mv,
                                            lam_min=lmin,
                                            lam_max=lmax,
                                            niters=niters)
                    else:
                        mv = make_helmholtz_matvec(
                            spec, e, w, n, s, diag, exchange=False)
                        exchH = exchange_multi_fn(spec, depth=H)
                        x = chebyshev_block(
                            b, x0, matvec=mv, lam_min=lmin,
                            lam_max=lmax, niters=niters,
                            exchange_every=(K, exchH))
                    # one verified residual at the end (the
                    # iteration itself is dot-free)
                    mv1 = make_helmholtz_matvec(spec, e, w, n, s,
                                                diag)
                    rel = _residual(b, x, wgt, mv1)
                    return (exch(x),
                            jnp.asarray(niters, jnp.int32),
                            rel.astype(acc))

            in_specs = [P("y", "x")] * (8 + (1 if has_pc else 0))
            smapped = jax.shard_map(
                body, mesh=self.grid.mesh,
                in_specs=tuple(in_specs),
                out_specs=(P("y", "x"), P(), P()), check_vma=False)
            self._prog = jax.jit(smapped)
        return self._prog

    def _residual64_program(self):
        """Jitted ``(b64, x64) -> b64 - A x64`` in float64 (exchange +
        stencil upcast), for iterative refinement."""
        if getattr(self, "_res64", None) is None:
            spec = self.grid.halo_spec

            def body(b, x, e, w, n, s, diag):
                mv = make_helmholtz_matvec(
                    spec, *(c.astype(jnp.float64)
                            for c in (e, w, n, s, diag)))
                return b - mv(x)

            self._res64 = jax.jit(jax.shard_map(
                body, mesh=self.grid.mesh,
                in_specs=(P("y", "x"),) * 7,
                out_specs=P("y", "x"), check_vma=False))
        return self._res64

    def solve_refined(self, b, refine: int = 2):
        """float64-accurate solve at working-precision speed: iterative
        refinement.  Each round solves the correction system in the
        grid's (float32) working precision and evaluates the residual
        in float64, so refinement pays the f64 cost on ONE matvec per
        round instead of the whole iteration.  (What f64 costs against
        f32 on the GPU is not measured.)  Returns ``(x64, info)`` with
        ``info["refined_rel_res"]`` the final f64 residual norm.
        """
        import jax as _jax
        if not _jax.config.jax_enable_x64:
            raise ValueError(
                "solve_refined needs x64 enabled "
                "(jax.config.update('jax_enable_x64', True) or "
                "set_working_precision('float64') at startup)")
        if jnp.dtype(self.grid.dtype).itemsize != 4:
            raise ValueError(
                "solve_refined refines a 4-byte working precision; a "
                "float64 grid solves in f64 directly")
        from ..core.field import Field
        bdat = b.data if isinstance(b, Field) else jnp.asarray(b)
        b64 = bdat.astype(jnp.float64)
        # initial solve at WORKING precision even for an f64 rhs — an
        # f64 bdat would otherwise run the whole iteration in f64
        # (and compile a second program variant)
        bwp = bdat.astype(self.grid.dtype)
        res64 = self._residual64_program()
        acc = jnp.dtype(kinds.sum_dtype())
        w64 = self._weight.astype(acc)
        bb = float(jnp.sum((b64.astype(acc) * w64) ** 2)) or 1.0

        x, info = self.solve(bwp)
        x64 = x.astype(jnp.float64)
        total = info["iterations"]
        converged = info["converged"]
        for _ in range(max(refine, 0)):
            r64 = res64(b64, x64, *self._coeffs)
            d, dinfo = self.solve(r64.astype(self.grid.dtype))
            total += dinfo["iterations"]
            converged = converged and dinfo["converged"]
            x64 = x64 + d.astype(jnp.float64)
        r64 = res64(b64, x64, *self._coeffs)
        rel = float(jnp.sqrt(jnp.sum((r64.astype(acc) * w64) ** 2)
                             / bb))
        return x64, {"iterations": total, "refined_rel_res": rel,
                     "working_rel_res": info["rel_res"],
                     "converged": converged}

    def solve(self, b, x0=None):
        """Solve for the stacked/sharded rhs ``b`` (a T-point Field or
        its ``.data``).  Returns ``(x, info)`` with ``x`` a stacked
        array (halos freshly exchanged) and ``info`` =
        ``{"iterations", "rel_res", "converged"}``."""
        from ..core.field import Field
        bdat = b.data if isinstance(b, Field) else jnp.asarray(b)
        x0dat = ((x0.data if isinstance(x0, Field) else jnp.asarray(x0))
                 if x0 is not None else jnp.zeros_like(bdat))
        prog = self._program()
        args = [bdat, x0dat, self._weight, *self._coeffs]
        if self._inv_diag is not None:
            args.append(self._inv_diag)
        x, k, rel = prog(*args)
        k = int(k)
        rel = float(rel)
        return x, {"iterations": k, "rel_res": rel,
                   "converged": rel <= self.tol}
