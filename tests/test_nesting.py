"""One-way grid nesting (models/nesting.py).

Three invariants pin the nest seam:

* ratio=1 is EXACT — the bilinear and time-blend weights degenerate to
  the identity, so the child interior equals the parent window to the
  last bit after any number of steps (the nesting analogue of the
  1-shard == N-shard invariant).
* decomposition invariance — a 1-domain parent + 1-domain child equals
  the 8-device nest to fp64 roundoff.
* refinement buys accuracy — against a uniformly-fine truth run, the
  nested child beats the bilinear-interpolated coarse parent on an
  under-resolved bump.
"""
import numpy as np
import pytest

from dl_esm_inf_tpu.models import gravity_wave as gw
from dl_esm_inf_tpu.models.nesting import (NestSet, OneWayNest,
                                            _t_point_plan)


def _build_parent(gnx, gny, ndom, dt, depth=10.0, width=0.08):
    parent = gw.build(gnx, gny, ndomains=ndom, dt=dt, depth=depth)
    parent.set_initial_eta(gw.gaussian_eta(gnx, gny, width=width))
    return parent


def test_ratio1_child_matches_parent_bitwise():
    parent = _build_parent(48, 48, 1, dt=0.02)
    nest = OneWayNest(parent, origin=(12, 12), shape=(24, 24), ratio=1,
                      child_ndomains=1)
    nest.sync_from_parent()
    nest.run(30)
    pg = parent.eta.gather_inner_data()
    cg = nest.child.eta.gather_inner_data()
    # Child interior (inside land ring + boundary ring) vs the parent
    # window: identical stencils on identical data -> identical bits.
    np.testing.assert_array_equal(cg[2:-2, 2:-2], pg[14:34, 14:34])
    # u/v likewise (faces strictly inside the ring evolve by the same
    # updates from the same etas).
    pu = parent.u.gather_inner_data()
    cu = nest.child.u.gather_inner_data()
    np.testing.assert_array_equal(cu[2:-2, 2:-3], pu[14:34, 14:33])


def test_nest_decomposition_invariance():
    runs = []
    for pdom, cdom in ((1, 1), (None, None)):   # None -> all 8 devices
        parent = _build_parent(64, 64, pdom, dt=0.02)
        nest = OneWayNest(parent, origin=(16, 16), shape=(32, 32),
                          ratio=2, child_ndomains=cdom)
        nest.sync_from_parent()
        nest.run(20)
        runs.append((parent.eta.gather_inner_data(),
                     nest.child.eta.gather_inner_data()))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(runs[0][1], runs[1][1], rtol=0, atol=1e-12)


def test_ring_time_staggering():
    """After one parent step the ring holds the alpha=(r-1)/r blend of
    the parent's pre/post states (start-of-substep convention)."""
    r = 3
    parent = _build_parent(48, 48, 1, dt=0.02)
    eta_pre = parent.eta.gather_inner_data()
    nest = OneWayNest(parent, origin=(12, 12), shape=(20, 20), ratio=r,
                      child_ndomains=1)
    nest.sync_from_parent()
    nest.run(1)
    eta_post = parent.eta.gather_inner_data()

    cny, cnx = nest.child.grid.decomp.global_ny, nest.child.grid.decomp.global_nx
    ring = np.zeros((cny, cnx), bool)
    ring[1, 1:-1] = ring[-2, 1:-1] = True
    ring[1:-1, 1] = ring[1:-1, -2] = True
    ry, rx = np.nonzero(ring)
    y0, x0, wy, wx = _t_point_plan(ry, rx, 12, 12, r, 48, 48)

    def bilin(pg):
        return ((1 - wy) * ((1 - wx) * pg[y0, x0] + wx * pg[y0, x0 + 1])
                + wy * ((1 - wx) * pg[y0 + 1, x0] + wx * pg[y0 + 1, x0 + 1]))

    a = (r - 1) / r
    want = (1 - a) * bilin(eta_pre) + a * bilin(eta_post)
    got = nest.child.eta.gather_inner_data()[ry, rx]
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


def test_refinement_improves_accuracy():
    """Under-resolved bump: the r=3 nested child tracks a uniformly-fine
    truth run far better than the bilinearly-interpolated coarse parent."""
    r, depth, dt = 3, 10.0, 0.05
    sigma = 1.2                       # physical units ~ 1.2 coarse cells

    def analytic(n, dx):
        x = (np.arange(n) + 0.5) * dx
        r2 = ((x - 16.0)[None, :] ** 2 + (x - 16.0)[:, None] ** 2)
        return np.exp(-r2 / (2 * sigma ** 2))

    nsteps = 10
    # Truth: uniformly fine over the whole domain.
    fine = gw.build(32 * r, 32 * r, ndomains=None, dt=dt / r,
                    depth=depth, dx=1.0 / r, dy=1.0 / r)
    fine.set_initial_eta(analytic(32 * r, 1.0 / r))
    fine.run(nsteps * r)
    truth = fine.eta.gather_inner_data()

    parent = gw.build(32, 32, ndomains=None, dt=dt, depth=depth)
    parent.set_initial_eta(analytic(32, 1.0))
    nest = OneWayNest(parent, origin=(8, 8), shape=(16, 16), ratio=r)
    nest.child.set_initial_eta(analytic(32 * r, 1.0 / r)
                               [8 * r:24 * r, 8 * r:24 * r])
    nest.run(nsteps)

    # Compare on the child interior, inset from the prescribed ring;
    # child cell (cy, cx) is collocated with fine cell (8r+cy, 8r+cx).
    inset = 6
    cg = nest.child.eta.gather_inner_data()[inset:-inset, inset:-inset]
    tr = truth[8 * r + inset:24 * r - inset, 8 * r + inset:24 * r - inset]
    err_nested = np.sqrt(np.mean((cg - tr) ** 2))

    pg = parent.eta.gather_inner_data()
    y, x = np.mgrid[8 * r + inset:24 * r - inset, 8 * r + inset:24 * r - inset]
    y0, x0, wy, wx = _t_point_plan(y.ravel() - 8 * r, x.ravel() - 8 * r,
                                   8, 8, r, 32, 32)
    interp = ((1 - wy) * ((1 - wx) * pg[y0, x0] + wx * pg[y0, x0 + 1])
              + wy * ((1 - wx) * pg[y0 + 1, x0] + wx * pg[y0 + 1, x0 + 1]))
    err_coarse = np.sqrt(np.mean((interp.reshape(cg.shape) - tr) ** 2))

    assert err_nested < 0.5 * err_coarse, (err_nested, err_coarse)
    assert err_nested < 0.05 * np.sqrt(np.mean(tr ** 2))


def test_two_way_ratio1_is_identity():
    """At r=1 the restriction feeds back exactly the values the parent
    already holds, so a two-way nest leaves the parent trajectory
    bitwise equal to a solo parent run."""
    solo = _build_parent(48, 48, 1, dt=0.02)
    solo.run(25)
    parent = _build_parent(48, 48, 1, dt=0.02)
    nest = OneWayNest(parent, origin=(12, 12), shape=(24, 24), ratio=1,
                      two_way=True, child_ndomains=1)
    nest.sync_from_parent()
    nest.run(25)
    np.testing.assert_array_equal(parent.eta.gather_inner_data(),
                                  solo.eta.gather_inner_data())
    np.testing.assert_array_equal(parent.u.gather_inner_data(),
                                  solo.u.gather_inner_data())


def test_two_way_decomposition_invariance():
    runs = []
    for pdom, cdom in ((1, 1), (None, None)):
        parent = _build_parent(64, 64, pdom, dt=0.02)
        nest = OneWayNest(parent, origin=(16, 16), shape=(32, 32),
                          ratio=2, two_way=True, child_ndomains=cdom)
        nest.sync_from_parent()
        nest.run(15)
        runs.append((parent.eta.gather_inner_data(),
                     nest.child.eta.gather_inner_data()))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(runs[0][1], runs[1][1], rtol=0, atol=1e-12)


def test_two_way_feedback_improves_parent():
    """The AGRIF update phase: with an under-resolved bump the two-way
    parent tracks the fine truth far better than the one-way parent."""
    r, depth, dt, sigma, nsteps = 3, 10.0, 0.05, 1.2, 10

    def analytic(n, dx):
        x = (np.arange(n) + 0.5) * dx
        r2 = ((x - 16.0)[None, :] ** 2 + (x - 16.0)[:, None] ** 2)
        return np.exp(-r2 / (2 * sigma ** 2))

    fine = gw.build(32 * r, 32 * r, ndomains=None, dt=dt / r,
                    depth=depth, dx=1.0 / r, dy=1.0 / r)
    fine.set_initial_eta(analytic(32 * r, 1.0 / r))
    fine.run(nsteps * r)
    truth = fine.eta.gather_inner_data()
    # Restrict the truth to coarse cells (conservative r x r mean).
    truth_c = truth.reshape(32, r, 32, r).mean((1, 3))

    errs = {}
    for two_way in (False, True):
        parent = gw.build(32, 32, ndomains=None, dt=dt, depth=depth)
        parent.set_initial_eta(analytic(32, 1.0))
        nest = OneWayNest(parent, origin=(8, 8), shape=(16, 16),
                          ratio=r, two_way=two_way)
        nest.child.set_initial_eta(analytic(32 * r, 1.0 / r)
                                   [8 * r:24 * r, 8 * r:24 * r])
        nest.run(nsteps)
        pg = parent.eta.gather_inner_data()
        # compare inside the feedback region (window inset 3 cells)
        errs[two_way] = np.sqrt(np.mean(
            (pg[11:21, 11:21] - truth_c[11:21, 11:21]) ** 2))
    assert errs[True] < 0.6 * errs[False], errs


def test_nestset_one_way_children_independent():
    """Sibling one-way children in one program are bitwise identical to
    running each nest alone (they cannot see each other or perturb the
    parent)."""
    windows = (((8, 8), (20, 20), 2), ((36, 32), (20, 24), 1))

    def make(two_children):
        parent = _build_parent(64, 64, 1, dt=0.02)
        picks = windows if two_children else windows[:1]
        nests = [OneWayNest(parent, origin=o, shape=s, ratio=rr,
                            child_ndomains=1) for o, s, rr in picks]
        for n in nests:
            n.sync_from_parent()
        return parent, nests

    parent_set, nests_set = make(True)
    NestSet(nests_set).run(15)
    parent_solo, nests_solo = make(False)
    nests_solo[0].run(15)
    np.testing.assert_array_equal(parent_set.eta.gather_inner_data(),
                                  parent_solo.eta.gather_inner_data())
    np.testing.assert_array_equal(
        nests_set[0].child.eta.gather_inner_data(),
        nests_solo[0].child.eta.gather_inner_data())


def test_nestset_mixed_decomposition_invariance():
    runs = []
    for dom in (1, None):
        parent = _build_parent(64, 64, dom, dt=0.02)
        n1 = OneWayNest(parent, origin=(8, 8), shape=(20, 20), ratio=2,
                        two_way=True, child_ndomains=dom)
        n2 = OneWayNest(parent, origin=(36, 32), shape=(20, 24), ratio=3,
                        child_ndomains=dom)
        for n in (n1, n2):
            n.sync_from_parent()
        NestSet([n1, n2]).run(10)
        runs.append((parent.eta.gather_inner_data(),
                     n1.child.eta.gather_inner_data(),
                     n2.child.eta.gather_inner_data()))
    for a, b in zip(runs[0], runs[1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_telescoping_r1_bitwise():
    """A nest within a nest, everything at ratio=1: the innermost child
    still reproduces the root parent window to the last bit — the
    exactness invariant survives composition."""
    parent = _build_parent(64, 64, 1, dt=0.02)
    mid = OneWayNest(parent, origin=(16, 16), shape=(32, 32), ratio=1,
                     child_ndomains=1)
    mid.sync_from_parent()
    inner = OneWayNest(mid.child, origin=(8, 8), shape=(16, 16), ratio=1,
                       child_ndomains=1)
    inner.sync_from_parent()
    NestSet([mid, inner]).run(20)
    pg = parent.eta.gather_inner_data()
    mg = mid.child.eta.gather_inner_data()
    ig = inner.child.eta.gather_inner_data()
    np.testing.assert_array_equal(mg[2:-2, 2:-2], pg[18:46, 18:46])
    np.testing.assert_array_equal(ig[2:-2, 2:-2], pg[26:38, 26:38])


def test_telescoping_two_way_cascade_invariance():
    """The full AGRIF cascade — inner feeds mid feeds parent, refined
    r=2 twice — is decomposition-invariant."""
    runs = []
    for dom in (1, None):
        parent = _build_parent(64, 64, dom, dt=0.02)
        mid = OneWayNest(parent, origin=(16, 16), shape=(32, 32),
                         ratio=2, two_way=True, child_ndomains=dom)
        mid.sync_from_parent()
        inner = OneWayNest(mid.child, origin=(16, 16), shape=(32, 32),
                           ratio=2, two_way=True, child_ndomains=dom)
        inner.sync_from_parent()
        NestSet([mid, inner]).run(6)
        runs.append((parent.eta.gather_inner_data(),
                     mid.child.eta.gather_inner_data(),
                     inner.child.eta.gather_inner_data()))
    for a, b in zip(runs[0], runs[1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        assert np.isfinite(a).all()


def test_nest_program_is_differentiable():
    """The adjoint flows through the whole coupled step — parent step,
    ring gathers/scatters, child substeps, and two-way feedback — so
    4D-Var machinery composes with nesting (== central differences)."""
    import jax
    import jax.numpy as jnp

    parent = _build_parent(32, 32, 1, dt=0.02)
    nest = OneWayNest(parent, origin=(8, 8), shape=(16, 16), ratio=2,
                      two_way=True, child_ndomains=1)
    nest.sync_from_parent()
    prog = nest.step_program(3)
    p, c = parent, nest.child
    tree0 = (((c.eta.data, c.u.data, c.v.data), ()),)

    def loss(p_eta):
        out = prog(((p_eta, p.u.data, p.v.data), tree0))
        return jnp.sum(out[1][0][0][0] ** 2)     # child eta energy

    g = jax.grad(loss)(p.eta.data)
    v = jnp.asarray(np.random.RandomState(0).normal(
        size=np.shape(p.eta.data)), p.eta.data.dtype)
    eps = 1e-6
    fd = (loss(p.eta.data + eps * v) - loss(p.eta.data - eps * v)) / (2 * eps)
    np.testing.assert_allclose(float(jnp.vdot(g, v)), float(fd),
                               rtol=1e-6)
    assert float(jnp.sum(jnp.abs(g))) > 0.0


def test_nestset_rejections():
    p1 = _build_parent(64, 64, 1, dt=0.02)
    p2 = _build_parent(64, 64, 1, dt=0.02)
    n1 = OneWayNest(p1, origin=(8, 8), shape=(20, 20), ratio=2)
    with pytest.raises(ValueError, match="same parent"):
        NestSet([n1, OneWayNest(p2, origin=(36, 32), shape=(20, 20),
                                ratio=2)])
    a = OneWayNest(p1, origin=(8, 8), shape=(20, 20), ratio=2,
                   two_way=True)
    b = OneWayNest(p1, origin=(16, 16), shape=(20, 20), ratio=2,
                   two_way=True)
    with pytest.raises(ValueError, match="disjoint"):
        NestSet([a, b])
    with pytest.raises(ValueError, match="at least one"):
        NestSet([])


def test_rejects_bad_windows():
    parent = _build_parent(48, 48, 1, dt=0.02)
    with pytest.raises(ValueError, match="outside the parent"):
        OneWayNest(parent, origin=(40, 40), shape=(16, 16), ratio=2)
    with pytest.raises(ValueError, match="boundary ring must be wet"):
        # window touching the parent's land ring
        OneWayNest(parent, origin=(0, 0), shape=(16, 16), ratio=2)
    with pytest.raises(ValueError, match="ratio"):
        OneWayNest(parent, origin=(8, 8), shape=(16, 16), ratio=0)
    ca = gw.build(64, 64, ndomains=1, dt=0.02, depth=10.0,
                  steps_per_sweep=2)
    with pytest.raises(ValueError, match="one-step path"):
        OneWayNest(ca, origin=(16, 16), shape=(16, 16), ratio=2)
