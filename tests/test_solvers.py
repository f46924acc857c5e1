"""Distributed CG / Helmholtz solver + semi-implicit model tests.

The solver capability class the reference's clients hand-write over MPI
(CG with halo exchanges in the matvec and global_sum dot products,
parallel_utils_mod.f90:230-238): checked against an INDEPENDENT dense
numpy construction of the masked operator, pinned for decomposition
invariance, and exercised by the semi-implicit model far beyond the
explicit CFL limit.
"""
import numpy as np
import pytest

import dl_esm_inf_tpu as dl
from dl_esm_inf_tpu.core import layout
from dl_esm_inf_tpu.models import semi_implicit as si
from dl_esm_inf_tpu.models.gravity_wave import (default_tmask,
                                                gaussian_eta,
                                                golden_reference)
from dl_esm_inf_tpu.ops.solvers import HelmholtzSolver


def dense_solve(act, lam_x, lam_y, b, wrap=False):
    """Independent dense construction of (I + lam*L) with no-flux walls
    (and optional periodic wrap), solved by numpy.  ``lam_x``/``lam_y``
    may be scalars or per-face arrays (NE convention: ``lam_x[j, i]``
    is the face between cells (j, i) and (j, i+1))."""
    gny, gnx = act.shape
    n = gny * gnx
    A = np.eye(n)

    def idx(j, i):
        return j * gnx + i

    def face(lam, dj, di, j, i):
        if np.isscalar(lam):
            return lam
        if di == 1 or dj == 1:           # my +x/+y face
            return lam[j, i]
        if di == -1:                     # my -x face = west cell's +x
            return lam[j, (i - 1) % gnx]
        return lam[(j - 1) % gny, i]     # -y face

    for j in range(gny):
        for i in range(gnx):
            if not act[j, i]:
                continue
            for dj, di, lam in ((0, 1, lam_x), (0, -1, lam_x),
                                (1, 0, lam_y), (-1, 0, lam_y)):
                jj, ii = j + dj, i + di
                if wrap:
                    jj, ii = jj % gny, ii % gnx
                elif not (0 <= jj < gny and 0 <= ii < gnx):
                    continue
                if act[jj, ii]:
                    lv = face(lam, dj, di, j, i)
                    A[idx(j, i), idx(j, i)] += lv
                    A[idx(j, i), idx(jj, ii)] -= lv
    return np.linalg.solve(A, b.ravel()).reshape(gny, gnx)


def make_grid(gnx, gny, ndom, tmask, bc=dl.BC_EXTERNAL):
    grid = dl.Grid(dl.ARAKAWA_C, (bc, bc, dl.BC_NONE), dl.OFFSET_NE,
                   dtype="float64")
    grid.decompose(gnx, gny, ndomains=ndom)
    dl.grid_init(grid, 1.0, 1.0, tmask)
    return grid


@pytest.mark.parametrize("ndom", [1, 6, 8])
def test_helmholtz_vs_dense(ndom):
    """CG solution == dense numpy solve on an irregular wet mask, and
    the answer is decomposition-invariant (1 == N shards)."""
    rng = np.random.default_rng(0)
    gnx, gny = 20, 12
    tmask = np.ones((gny, gnx), np.int32)
    tmask[0, :] = tmask[-1, :] = 0
    tmask[:, 0] = tmask[:, -1] = 0
    tmask[5:8, 6:9] = 0                      # island
    act = tmask == 1
    b = rng.standard_normal((gny, gnx)) * act
    lam = 7.3
    xd = dense_solve(act, lam, lam, b)

    grid = make_grid(gnx, gny, ndom, tmask)
    s = HelmholtzSolver(grid, lam, lam, tol=1e-12)
    x, info = s.solve(dl.Field(grid, dl.T_POINTS, init_global_data=b))
    xg = layout.unstack_internal(grid.decomp, np.asarray(x))
    assert info["converged"]
    assert np.abs((xg - xd) * act).max() < 1e-10


@pytest.mark.parametrize("ndom", [1, 4])
def test_helmholtz_periodic_vs_dense(ndom):
    """Faces across the periodic seam conduct (the exchanged-validity
    mask in helmholtz_coefficients)."""
    rng = np.random.default_rng(1)
    gn = 16
    tmask = np.ones((gn, gn), np.int32)
    tmask[3:5, 9:12] = 0
    act = tmask == 1
    b = rng.standard_normal((gn, gn)) * act
    xd = dense_solve(act, 3.0, 3.0, b, wrap=True)

    grid = make_grid(gn, gn, ndom, tmask, bc=dl.BC_PERIODIC)
    s = HelmholtzSolver(grid, 3.0, 3.0, tol=1e-12)
    x, info = s.solve(dl.Field(grid, dl.T_POINTS, init_global_data=b))
    xg = layout.unstack_internal(grid.decomp, np.asarray(x))
    assert info["converged"]
    assert np.abs((xg - xd) * act).max() < 1e-10


@pytest.mark.parametrize("ndom,method", [(8, "cg"), (8, "chebyshev"),
                                          (1, "cg")])
def test_helmholtz_variable_coefficients_vs_dense(ndom, method):
    """Per-face coupling arrays (the variable-bathymetry case): both
    solvers match the dense construction, and the operator stays SPD
    because opposite-direction coefficients are the same face value."""
    rng = np.random.default_rng(8)
    gnx, gny = 18, 14
    tmask = np.ones((gny, gnx), np.int32)
    tmask[0, :] = tmask[-1, :] = 0
    tmask[:, 0] = tmask[:, -1] = 0
    tmask[6:9, 4:7] = 0
    act = tmask == 1
    lam_x = rng.uniform(0.5, 8.0, (gny, gnx))
    lam_y = rng.uniform(0.5, 8.0, (gny, gnx))
    b = rng.standard_normal((gny, gnx)) * act
    xd = dense_solve(act, lam_x, lam_y, b)

    grid = make_grid(gnx, gny, ndom, tmask)
    s = HelmholtzSolver(grid, lam_x, lam_y, tol=1e-12, method=method)
    x, info = s.solve(dl.Field(grid, dl.T_POINTS, init_global_data=b))
    xg = layout.unstack_internal(grid.decomp, np.asarray(x))
    assert info["converged"], info
    assert np.abs((xg - xd) * act).max() < 1e-9


def test_helmholtz_unpreconditioned_and_zero_rhs():
    gnx = gny = 16
    tmask = default_tmask(gnx, gny)
    act = tmask == 1
    rng = np.random.default_rng(2)
    b = rng.standard_normal((gny, gnx)) * act
    xd = dense_solve(act, 2.0, 2.0, b)
    grid = make_grid(gnx, gny, 4, tmask)
    s = HelmholtzSolver(grid, 2.0, 2.0, tol=1e-12, precondition=False)
    x, info = s.solve(dl.Field(grid, dl.T_POINTS, init_global_data=b))
    xg = layout.unstack_internal(grid.decomp, np.asarray(x))
    assert info["converged"]
    assert np.abs((xg - xd) * act).max() < 1e-10
    # zero rhs: immediate convergence to x = 0
    z, zinfo = s.solve(np.zeros_like(np.asarray(x)))
    assert zinfo["iterations"] == 0
    assert float(np.abs(np.asarray(z)).max()) == 0.0


@pytest.mark.parametrize("ndom", [1, 8])
def test_chebyshev_vs_dense(ndom):
    """The dot-free Chebyshev solver reaches the same solution as the
    dense solve using only the analytic eigenvalue bounds."""
    rng = np.random.default_rng(3)
    gnx, gny = 20, 12
    tmask = np.ones((gny, gnx), np.int32)
    tmask[0, :] = tmask[-1, :] = 0
    tmask[:, 0] = tmask[:, -1] = 0
    tmask[4:7, 10:13] = 0
    act = tmask == 1
    b = rng.standard_normal((gny, gnx)) * act
    lam = 4.0
    xd = dense_solve(act, lam, lam, b)

    grid = make_grid(gnx, gny, ndom, tmask)
    s = HelmholtzSolver(grid, lam, lam, tol=1e-11, method="chebyshev")
    x, info = s.solve(dl.Field(grid, dl.T_POINTS, init_global_data=b))
    xg = layout.unstack_internal(grid.decomp, np.asarray(x))
    assert info["converged"], info
    assert np.abs((xg - xd) * act).max() < 1e-9


def test_chebyshev_comm_avoiding_matches_plain():
    """steps_per_exchange=4 (one depth-4 exchange per 4 matvecs, halo
    twins recomputed redundantly) reproduces the per-matvec-exchange
    iteration EXACTLY — same arithmetic per internal cell."""
    rng = np.random.default_rng(4)
    gnx = gny = 24
    tmask = np.ones((gny, gnx), np.int32)
    tmask[0, :] = tmask[-1, :] = 0
    tmask[:, 0] = tmask[:, -1] = 0
    act = tmask == 1
    b = rng.standard_normal((gny, gnx)) * act
    lam = 3.0
    results = []
    # maxiter pins the (K-rounded) iteration count so all three
    # variants run EXACTLY 68 iterations: any difference is then a
    # violation of the halo-twin redundant-compute contract, not a
    # convergence-depth artifact.  Measured: <= 1 ulp.
    for ndom, K in ((1, 1), (8, 1), (8, 4)):
        grid = dl.Grid(dl.ARAKAWA_C,
                       (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                       dl.OFFSET_NE, dtype="float64")
        grid.decompose(gnx, gny, ndomains=ndom, halo_width=max(K, 1))
        dl.grid_init(grid, 1.0, 1.0, tmask)
        s = HelmholtzSolver(grid, lam, lam, tol=1e-13, maxiter=68,
                            method="chebyshev", steps_per_exchange=K)
        x, info = s.solve(dl.Field(grid, dl.T_POINTS,
                                   init_global_data=b))
        assert info["iterations"] == 68
        assert info["rel_res"] < 1e-10, info
        results.append(layout.unstack_internal(grid.decomp,
                                               np.asarray(x)))
    # plain (K=1) decomposition-invariant...
    np.testing.assert_allclose(results[0], results[1], rtol=0,
                               atol=1e-15)
    # ...and comm-avoiding == plain on the same mesh
    np.testing.assert_allclose(results[1], results[2], rtol=0,
                               atol=1e-15)


@pytest.mark.parametrize("ndom,K", [(1, 1), (1, 4), (8, 4)])
def test_chebyshev_comm_avoiding_f32_matches_plain(ndom, K):
    """In float32 the comm-avoiding Chebyshev (K iterations per
    depth-K exchange) reproduces the one-exchange-per-iteration
    solve at f32 roundoff, on 1 and 8 shards."""
    rng = np.random.default_rng(5)
    N = 128
    tmask = np.ones((N, N), np.int32)
    tmask[0, :] = tmask[-1, :] = 0
    tmask[:, 0] = tmask[:, -1] = 0
    tmask[40:60, 50:80] = 0
    b = (rng.standard_normal((N, N)) * (tmask == 1)).astype(np.float32)

    def solve(**kw):
        k = kw.get("steps_per_exchange", 1)
        grid = dl.Grid(dl.ARAKAWA_C,
                       (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                       dl.OFFSET_NE, dtype="float32")
        grid.decompose(N, N, ndomains=ndom, halo_width=max(k, 1))
        dl.grid_init(grid, 1.0, 1.0, tmask)
        # tol far below f32 so maxiter pins the iteration count
        s = HelmholtzSolver(grid, 6.0, 6.0, maxiter=64, tol=1e-30, **kw)
        x, info = s.solve(dl.Field(grid, dl.T_POINTS,
                                   init_global_data=b))
        assert info["iterations"] == 64
        assert info["rel_res"] < 1e-5
        return layout.unstack_internal(grid.decomp, np.asarray(x))

    plain = solve(method="chebyshev")
    fused = solve(method="chebyshev", steps_per_exchange=K)
    np.testing.assert_allclose(fused, plain, rtol=0, atol=5e-6)


def test_chebyshev_explicit_maxiter_is_a_hard_cap():
    """With steps_per_exchange, the K-rounding must round DOWN under
    an explicit maxiter (regression: 65 rounded up to 68)."""
    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                   dl.OFFSET_NE, dtype="float64")
    grid.decompose(24, 24, ndomains=4, halo_width=4)
    dl.grid_init(grid, 1.0, 1.0, default_tmask(24, 24))
    s = HelmholtzSolver(grid, 3.0, 3.0, tol=1e-13, maxiter=65,
                        method="chebyshev", steps_per_exchange=4)
    b = np.zeros((24, 24))
    b[5, 5] = 1.0
    _, info = s.solve(dl.Field(grid, dl.T_POINTS, init_global_data=b))
    assert info["iterations"] == 64


def test_semi_implicit_chebyshev_not_truncated_when_stiff():
    """A stiff (large-dt) implicit step must iterate to the Chebyshev
    bound, not the CG-sized default maxiter (regression: silent
    truncation left the solve at ~0.3 residual reduction)."""
    N = 16
    eta0 = gaussian_eta(N, N, amp=0.5)
    mc = si.build(N, N, dt=10.0, depth=10.0, solver="chebyshev",
                  tol=1e-10)
    mc.set_initial_eta(eta0)
    info = mc.run(2)
    assert info["cg_iterations_per_step"] > 4 * (N + N)  # beyond old cap
    # reference trajectory: CG with an explicit generous budget
    mg = si.build(N, N, dt=10.0, depth=10.0, tol=1e-10, maxiter=6000)
    mg.set_initial_eta(eta0)
    mg.run(2)
    for k in ("eta", "u", "v"):
        np.testing.assert_allclose(mc.gather()[k], mg.gather()[k],
                                   rtol=0, atol=1e-7)


def test_chebyshev_guards():
    grid = make_grid(16, 16, 4, default_tmask(16, 16))
    with pytest.raises(ValueError, match="chebyshev"):
        HelmholtzSolver(grid, 1.0, 1.0, steps_per_exchange=2)
    with pytest.raises(ValueError, match="halo_width"):
        HelmholtzSolver(grid, 1.0, 1.0, method="chebyshev",
                        steps_per_exchange=2)
    with pytest.raises(ValueError, match="method"):
        HelmholtzSolver(grid, 1.0, 1.0, method="sor")


def test_iterative_refinement_reaches_f64_accuracy():
    """solve_refined: float32 correction solves + float64 residuals
    recover f64-level accuracy (the platform's mixed-precision
    economics: f64 costs ~9x, so only one matvec per round pays it)."""
    rng = np.random.default_rng(7)
    gnx = gny = 20
    tmask = default_tmask(gnx, gny)
    act = tmask == 1
    # the rhs a float32 field actually stores (refinement recovers the
    # exact f64 solution OF THE STORED PROBLEM; the rhs rounding is
    # not its to undo)
    b = (rng.standard_normal((gny, gnx)) * act).astype(
        np.float32).astype(np.float64)
    lam = 5.0                                   # exact in f32
    xd = dense_solve(act, lam, lam, b)          # f64 truth

    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                   dl.OFFSET_NE, dtype="float32")
    grid.decompose(gnx, gny, ndomains=8)
    dl.grid_init(grid, 1.0, 1.0, tmask)
    s = HelmholtzSolver(grid, lam, lam)
    fb = dl.Field(grid, dl.T_POINTS, init_global_data=b)

    x32, _ = s.solve(fb)
    err32 = np.abs((layout.unstack_internal(grid.decomp,
                                            np.asarray(x32)) - xd)
                   * act).max()
    x64, info = s.solve_refined(fb, refine=2)
    err64 = np.abs((layout.unstack_internal(grid.decomp,
                                            np.asarray(x64)) - xd)
                   * act).max()
    assert x64.dtype == np.float64
    assert err64 < 1e-12
    assert err64 < 1e-5 * max(err32, 1e-12)     # genuinely refined
    assert info["refined_rel_res"] < 1e-13

    with pytest.raises(ValueError, match="4-byte"):
        HelmholtzSolver(make_grid(16, 16, 4, default_tmask(16, 16)),
                        1.0, 1.0).solve_refined(
                            np.zeros((18 * 2, 18 * 2)))


def test_solver_requires_initialised_grid():
    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                   dl.OFFSET_NE)
    with pytest.raises(ValueError, match="grid_init"):
        HelmholtzSolver(grid, 1.0, 1.0)


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_solver_fuzz_random_masks(seed):
    """Random wet masks (incl. disconnected ponds and isolated cells)
    at random coupling strengths: CG and Chebyshev both match the
    dense construction on an 8-shard mesh."""
    rng = np.random.default_rng(seed)
    gnx, gny = int(rng.integers(12, 25)), int(rng.integers(12, 25))
    tmask = (rng.random((gny, gnx)) < 0.7).astype(np.int32)
    tmask[0, :] = tmask[-1, :] = 0
    tmask[:, 0] = tmask[:, -1] = 0
    act = tmask == 1
    if not act.any():
        pytest.skip("all-dry draw")
    lam_x = float(rng.uniform(0.1, 30.0))
    lam_y = float(rng.uniform(0.1, 30.0))
    b = rng.standard_normal((gny, gnx)) * act
    xd = dense_solve(act, lam_x, lam_y, b)

    grid = make_grid(gnx, gny, 8, tmask)
    for kw in (dict(), dict(method="chebyshev")):
        s = HelmholtzSolver(grid, lam_x, lam_y, tol=1e-12, **kw)
        x, info = s.solve(dl.Field(grid, dl.T_POINTS,
                                   init_global_data=b))
        xg = layout.unstack_internal(grid.decomp, np.asarray(x))
        assert info["converged"], (kw, info)
        assert np.abs((xg - xd) * act).max() < 1e-9, kw


# ---------------------------------------------------------------------
# semi-implicit model


def test_semi_implicit_stability_beyond_cfl_and_mass():
    """Wave CFL ~ 20: the explicit scheme detonates in a handful of
    steps; Crank-Nicolson stays bounded and conserves mass to solver
    tolerance (no-flux faces telescope)."""
    N = 48
    m = si.build(N, N, dt=2.0, theta=0.5, depth=10.0, tol=1e-10)
    m.set_initial_eta(gaussian_eta(N, N, amp=1.0))
    m.run(5)
    m0 = m.mass()
    amax0 = float(np.abs(m.gather()["eta"]).max())
    m.run(100)
    g = m.gather()
    assert np.isfinite(g["eta"]).all()
    assert np.abs(g["eta"]).max() < 2.0 * max(amax0, 1.0)
    assert abs(m.mass() - m0) <= 1e-8 * max(abs(m0), 1.0)


def test_semi_implicit_converges_to_explicit():
    """At explicit-stable dt the CN trajectory approaches the explicit
    golden reference as dt -> 0 (the two schemes solve the same PDE;
    their difference is O(dt)).  Calibrated: 2.1e-2 at dt=0.02,
    1.0e-2 at dt=0.01 (N=64, T=2)."""
    N = 64
    depth, gconst = 10.0, 9.81
    tm = default_tmask(N, N)
    eta0 = gaussian_eta(N, N, amp=0.5)
    wet = tm == 1
    errs = []
    for dt, nst in ((0.02, 100), (0.01, 200)):
        gold = golden_reference(eta0, tm, 1.0, 1.0, dt, nst,
                                g=gconst, depth=depth)
        m = si.build(N, N, dt=dt, theta=0.5, depth=depth, g=gconst,
                     tol=1e-12)
        m.set_initial_eta(eta0)
        m.run(nst)
        got = m.gather()["eta"]
        ref = gold["eta"] * wet
        errs.append(np.abs(got * wet - ref).max() / np.abs(ref).max())
    assert errs[0] < 3e-2
    assert errs[1] < 0.65 * errs[0]          # first-order in dt


def test_semi_implicit_decomposition_invariance():
    """1-shard == 8-shard trajectories (the make-or-break invariant)."""
    N = 40
    eta0 = gaussian_eta(N, N, amp=0.7)
    results = []
    for ndom in (1, 8):
        m = si.build(N, N, ndomains=ndom, dt=1.0, depth=5.0, tol=1e-11)
        m.set_initial_eta(eta0)
        m.run(20)
        results.append(m.gather())
    for k in ("eta", "u", "v"):
        np.testing.assert_allclose(results[0][k], results[1][k],
                                   rtol=0, atol=1e-9)


def test_semi_implicit_chebyshev_solver_matches_cg():
    """The dot-free in-step solver reproduces the CG trajectory at
    solver tolerance, and rejects differentiable mode."""
    N = 32
    eta0 = gaussian_eta(N, N, amp=0.6)
    got = {}
    for solver in ("cg", "chebyshev"):
        m = si.build(N, N, dt=1.0, depth=10.0, tol=1e-11, solver=solver)
        m.set_initial_eta(eta0)
        info = m.run(10)
        got[solver] = m.gather()
        assert info["cg_iterations"] > 0
    for k in ("eta", "u", "v"):
        np.testing.assert_allclose(got["chebyshev"][k], got["cg"][k],
                                   rtol=0, atol=1e-8)
    with pytest.raises(ValueError, match="solver='cg'"):
        si.build(N, N, solver="chebyshev", differentiable=True)
    with pytest.raises(ValueError, match="solver"):
        si.build(N, N, solver="jacobi")


def test_semi_implicit_variable_bathymetry():
    """depth=<(gny,gnx) array>: a uniform array reproduces the scalar
    path, and a ridge bathymetry stays stable at wave CFL ~ 14 (on the
    DEEP side) while conserving mass to solver tolerance."""
    N = 40
    eta0 = gaussian_eta(N, N, amp=0.5)

    flat = si.build(N, N, dt=1.0, depth=10.0, tol=1e-11)
    flat.set_initial_eta(eta0)
    flat.run(10)
    arr = si.build(N, N, dt=1.0, depth=np.full((N, N), 10.0),
                   tol=1e-11)
    arr.set_initial_eta(eta0)
    arr.run(10)
    for k in ("eta", "u", "v"):
        np.testing.assert_allclose(arr.gather()[k], flat.gather()[k],
                                   rtol=0, atol=1e-9)

    # a mid-domain ridge: depth 20 -> 2 and back
    ht = np.full((N, N), 20.0)
    ht[:, N // 3: 2 * N // 3] = 2.0
    m = si.build(N, N, dt=1.0, depth=ht, tol=1e-11)
    m.set_initial_eta(eta0)
    m.run(5)
    m0 = m.mass()
    amax0 = float(np.abs(m.gather()["eta"]).max())
    m.run(60)
    g = m.gather()
    assert np.isfinite(g["eta"]).all()
    assert np.abs(g["eta"]).max() < 2.0 * max(amax0, 1.0)
    assert abs(m.mass() - m0) <= 1e-8 * max(abs(m0), 1.0)

    with pytest.raises(ValueError, match="positive"):
        si.build(N, N, depth=np.zeros((N, N)))
    with pytest.raises(ValueError, match="gny"):
        si.build(N, N, depth=np.ones((3, 3)))


def _energy(g):
    return float((g["eta"] ** 2).sum() + (g["u"] ** 2).sum()
                 + (g["v"] ** 2).sum())


def test_open_boundary_radiates_waves_out():
    """The implicit Flather boundary is radiative: a bump launched at
    the north boundary EXITS an open basin (energy drains) while a
    closed basin keeps it."""
    N = 32
    e0 = np.roll(gaussian_eta(N, N, amp=0.5, width=0.08), 10, axis=0)
    es = {}
    for open_n in (False, True):
        m = si.build(N, N, dt=0.5, depth=10.0, tol=1e-11,
                     open_north=open_n)
        m.set_initial_eta(e0)
        m.run(80)
        es[open_n] = _energy(m.gather())
    assert es[True] < 0.15 * es[False]


def test_open_boundary_steady_state_and_invariance():
    """Constant external elevation fills the basin to that level
    through the radiative inflow; 1-shard == 8-shard."""
    N = 32
    A = 0.05
    got = {}
    for ndom in (1, 8):
        m = si.build(N, N, ndomains=ndom, dt=1.0, depth=10.0,
                     tol=1e-11, open_north=True, bc_amp=A)
        m.run(120)
        got[ndom] = m.gather()
    wet = default_tmask(N, N)
    wet[-1, 1:-1] = 1
    wetb = wet == 1
    assert np.abs(got[8]["eta"][wetb] - A).max() < 0.05 * A
    assert np.abs(got[8]["v"]).max() < 0.05 * A
    for k in ("eta", "u", "v"):
        np.testing.assert_allclose(got[1][k], got[8][k], rtol=0,
                                   atol=1e-9)


def test_open_boundary_guards():
    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_EXTERNAL, dl.BC_PERIODIC, dl.BC_NONE),
                   dl.OFFSET_NE, dtype="float64")
    grid.decompose(16, 16, ndomains=1)
    dl.grid_init(grid, 1.0, 1.0)
    with pytest.raises(ValueError, match="periodic"):
        si.SemiImplicitModel(grid, dt=1.0, open_north=True)


def test_backward_euler_dissipates():
    """theta=1 damps the wave field; theta outside [0.5, 1] rejected."""
    N = 32
    e0 = gaussian_eta(N, N, amp=1.0)

    def energy(theta):
        m = si.build(N, N, dt=0.5, theta=theta, depth=10.0, tol=1e-11)
        m.set_initial_eta(e0)
        m.run(40)
        g = m.gather()
        return float((g["eta"] ** 2).sum()
                     + (g["u"] ** 2 + g["v"] ** 2).sum())

    assert energy(1.0) < 0.5 * energy(0.5)
    with pytest.raises(ValueError, match="theta"):
        si.build(N, N, theta=0.4)
    with pytest.raises(ValueError, match="theta"):
        si.build(N, N, theta=1.2)
