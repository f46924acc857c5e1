"""Kernel schedules: the PSyclone-generated-PSy-layer analogue.

A Schedule compiles a kernel SEQUENCE into one program with halo
exchanges planned statically from the metadata — exchanges appear
exactly where a stale off-point read needs one, and results must equal
the eager per-kernel invoke() chain.
"""
import numpy as np
import pytest

import dl_esm_inf_tpu as dl
from dl_esm_inf_tpu.api.kernel_meta import (
    GO_READ, GO_READWRITE, GO_SUM, GO_WRITE, GO_CT, GO_CU, GO_CV,
    GO_R_SCALAR, GridProp, Schedule,
    go_arg, go_stencil, invoke, invoke_schedule, kernel)
from dl_esm_inf_tpu.ops import stencils as st


def make_grid(gnx=12, gny=10, ndom=4, halo=1):
    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                   dl.OFFSET_NE)
    grid.decompose(gnx, gny, ndomains=ndom, halo_width=halo)
    dl.grid_init(grid, 1.0, 1.0)
    return grid


@kernel(args=[go_arg(GO_WRITE, GO_CT),
              go_arg(GO_READ, GO_CT, go_stencil(0, 11, 0)),
              go_arg(GO_READ, GO_R_SCALAR)])
def east_plus(out, x, a):
    return st.xp(x) + a


@kernel(args=[go_arg(GO_WRITE, GO_CT), go_arg(GO_READ, GO_CT)])
def double(out, x):
    return 2.0 * x


@kernel(args=[go_arg(GO_SUM, GO_R_SCALAR), go_arg(GO_READ, GO_CT)])
def total(x):
    import jax.numpy as jnp
    return jnp.sum(x)


def setup(grid):
    gny, gnx = grid.global_ny, grid.global_nx
    vals = np.arange(gnx * gny, dtype=float).reshape(gny, gnx)
    a = dl.Field(grid, dl.T_POINTS, init_global_data=vals)
    b = dl.Field(grid, dl.T_POINTS)
    c = dl.Field(grid, dl.T_POINTS)
    return a, b, c


def test_schedule_matches_eager_invokes():
    """A dependent chain (stencil reads what the previous kernel wrote,
    across shard seams) through one compiled schedule == the eager
    per-kernel invoke sequence."""
    ga, gb = make_grid(), make_grid()
    a1, b1, c1 = setup(ga)
    a2, b2, c2 = setup(gb)

    invoke(east_plus, b1, a1, 3.0)
    invoke(east_plus, c1, b1, 1.0)    # reads b across seams
    invoke(double, b1, c1)

    sched = Schedule((east_plus, b2, a2, 3.0),
                     (east_plus, c2, b2, 1.0),
                     (double, b2, c2))
    sched()
    for f1, f2, name in ((b1, b2, "b"), (c1, c2, "c")):
        np.testing.assert_array_equal(f2.gather_inner_data(),
                                      f1.gather_inner_data(),
                                      err_msg=name)


def test_exchange_plan_is_minimal():
    """The static plan exchanges exactly the stale off-point reads:
    call 0 (first use of a), call 1 (b was just written); the pointwise
    call 2 adds none."""
    grid = make_grid()
    a, b, c = setup(grid)
    sched = Schedule((east_plus, b, a, 3.0),
                     (east_plus, c, b, 1.0),
                     (double, b, c))
    assert set(sched.exchanges) == {0, 1}
    # a clean field is NOT re-exchanged: reading a again off-point
    sched2 = Schedule((east_plus, b, a, 3.0),
                      (east_plus, c, a, 1.0))
    assert set(sched2.exchanges) == {0}
    # just a's slot (slot 0 is b: first use order follows declaration)
    assert sched2.exchanges[0][0] == (1,)


def test_schedule_reductions_and_rerun():
    """Reductions flow out in order; re-running the schedule reuses the
    compiled program on the updated fields."""
    grid = make_grid(8, 8, 4)
    vals = np.ones((8, 8))
    a = dl.Field(grid, dl.T_POINTS, init_global_data=vals)
    b = dl.Field(grid, dl.T_POINTS)
    sched = Schedule((double, b, a), (total, b))
    s1 = sched()
    # b == 2 at internal points; sum covers the whole stacked block
    # (zero halos) = 2 * 64
    assert s1 == 128.0
    s2 = sched()                    # same inputs -> same result
    assert s2 == 128.0


def test_schedule_scalar_rebind():
    """Scalars can change per run without recompiling."""
    grid = make_grid(8, 8, 2)
    a, b, _ = setup(grid)
    sched = Schedule((east_plus, b, a, 0.0))
    sched(scalars=[5.0])
    m = b.internal_mask_np()
    want_plus5 = b.get_data()[m].copy()
    sched(scalars=[0.0])
    got = b.get_data()[m]
    np.testing.assert_allclose(want_plus5 - got,
                               np.full_like(got, 5.0), rtol=1e-12)


def test_schedule_rebind_cannot_clobber_grid_scalars():
    """scalars=[...] rebinds ONLY the user scalars: hidden grid-property
    constants (dx here) keep their grid values, and the expected count
    is the user-scalar count."""
    @kernel(args=[go_arg(GO_WRITE, GO_CT),
                  go_arg(GO_READ, GO_CT),
                  go_arg(GO_READ, GO_R_SCALAR),
                  go_arg(GO_READ, GridProp.GRID_DX_CONST)])
    def scale(out, x, a, dx):
        return a * x * dx

    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                   dl.OFFSET_NE)
    grid.decompose(8, 8, ndomains=2)
    dl.grid_init(grid, 2.5, 2.5)      # dx = 2.5
    x = dl.Field(grid, dl.T_POINTS, init_global_data=np.ones((8, 8)))
    out = dl.Field(grid, dl.T_POINTS)
    sched = Schedule((scale, out, x, 3.0))
    sched(scalars=[4.0])              # rebinds a only; dx stays 2.5
    m = out.internal_mask_np()
    assert np.allclose(out.get_data()[m], 4.0 * 2.5)
    with pytest.raises(ValueError, match="1 user scalar"):
        sched(scalars=[4.0, 9.0])     # dx is not rebindable


def test_schedule_depth_guard_and_arity():
    # a serial halo-0 grid cannot satisfy any off-point read
    grid0 = dl.Grid(dl.ARAKAWA_C,
                    (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                    dl.OFFSET_NE)
    grid0.decompose(12, 10, ndomains=1, halo_width=0)
    dl.grid_init(grid0, 1.0, 1.0)
    a0, b0, _ = setup(grid0)
    with pytest.raises(ValueError, match="halo depth"):
        Schedule((east_plus, b0, a0, 1.0))

    grid = make_grid(halo=1)
    a, b, _ = setup(grid)
    with pytest.raises(TypeError, match="caller arguments"):
        Schedule((east_plus, b, a))   # missing the scalar


def test_invoke_schedule_convenience_and_gridprops():
    """invoke_schedule() + grid-property argument in a schedule."""
    grid = make_grid(8, 8, 2)
    a, b, _ = setup(grid)

    @kernel(args=[go_arg(GO_WRITE, GO_CT),
                  go_arg(GO_READ, GO_CT),
                  go_arg(GO_READ, GridProp.GRID_DX_CONST)])
    def scale_dx(out, x, dx):
        return x * dx

    invoke_schedule((scale_dx, b, a))
    m = b.internal_mask_np()
    np.testing.assert_allclose(b.get_data()[m], a.get_data()[m] * 1.0,
                               rtol=1e-12)


def test_flagship_kernel_in_schedule():
    """The shipped continuity_psy kernel runs in a schedule and matches
    its eager invoke."""
    from dl_esm_inf_tpu.models import nemolite2d as nl

    ga, gb = make_grid(12, 10, 4), make_grid(12, 10, 4)
    rng = np.random.default_rng(7)

    def fields(grid):
        f = {n: dl.Field(grid, p,
                         init_global_data=rng.normal(size=(10, 12)) + 5)
             for n, p in (("sshn", dl.T_POINTS), ("un", dl.U_POINTS),
                          ("vn", dl.V_POINTS), ("depu", dl.U_POINTS),
                          ("depv", dl.V_POINTS))}
        f["ssha"] = dl.Field(grid, dl.T_POINTS)
        return f

    rng = np.random.default_rng(7)
    fa = fields(ga)
    rng = np.random.default_rng(7)
    fb = fields(gb)
    invoke(nl.continuity_psy, fa["ssha"], fa["sshn"], fa["un"], fa["vn"],
           fa["depu"], fa["depv"], 20.0)
    invoke_schedule((nl.continuity_psy, fb["ssha"], fb["sshn"], fb["un"],
                     fb["vn"], fb["depu"], fb["depv"], 20.0))
    np.testing.assert_array_equal(fb["ssha"].gather_inner_data(),
                                  fa["ssha"].gather_inner_data())


# ---------------------------------------------------------------------------
# Fused (one exchange per application batch) schedule execution
# ---------------------------------------------------------------------------

def make_fused_grid(gnx=32, gny=32, ndom=4, halo=4):
    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                   dl.OFFSET_NE)
    grid.decompose(gnx, gny, ndomains=ndom, halo_width=halo, align_y=8)
    dl.grid_init(grid, 1.0, 1.0)
    return grid


def fused_chain_fields(grid):
    gny, gnx = grid.global_ny, grid.global_nx
    vals = np.arange(gnx * gny, dtype=float).reshape(gny, gnx)
    a = dl.Field(grid, dl.T_POINTS, init_global_data=vals)
    b = dl.Field(grid, dl.T_POINTS)
    c = dl.Field(grid, dl.T_POINTS)
    return a, b, c


def test_fused_schedule_matches_jnp_schedule():
    """The whole kernel sequence as ONE sweep (single up-front
    exchange, redundant halo compute) == the jnp schedule with its
    mid-chain exchanges, on internal points, across shard seams."""
    g1, g2 = make_fused_grid(), make_fused_grid()
    a1, b1, c1 = fused_chain_fields(g1)
    a2, b2, c2 = fused_chain_fields(g2)
    calls = lambda a, b, c: ((east_plus, b, a, 3.0),
                             (double, c, b),
                             (east_plus, c, c, 0.5))
    Schedule(*calls(a1, b1, c1))()
    Schedule(*calls(a2, b2, c2)).fused()
    for f1, f2 in ((b1, b2), (c1, c2)):
        np.testing.assert_allclose(f2.gather_inner_data(),
                                   f1.gather_inner_data(),
                                   rtol=1e-12, atol=1e-12)


def test_fused_schedule_repeats_and_scalars():
    """repeats=K applies the sequence K times per single exchange (the
    comm-avoiding transform); per-call user scalars still rebind."""
    g1, g2 = make_fused_grid(halo=8), make_fused_grid(halo=8)
    a1, b1, _ = fused_chain_fields(g1)
    a2, b2, _ = fused_chain_fields(g2)
    # sequence: b = xp(a) + s ; a = 2*b   (depth 1 per repeat)
    s1 = Schedule((east_plus, b1, a1, 1.5), (double, a1, b1))
    s2 = Schedule((east_plus, b2, a2, 1.5), (double, a2, b2))
    for _ in range(3):
        s1(scalars=[2.5])
    s2.fused(scalars=[2.5], repeats=3)
    for f1, f2 in ((a1, a2), (b1, b2)):
        np.testing.assert_allclose(f2.gather_inner_data(),
                                   f1.gather_inner_data(),
                                   rtol=1e-12, atol=1e-12)


def test_fused_schedule_grid_property_array():
    """garray constants (per-point grid properties) reach the fused
    sweep as read-only operands."""
    @kernel(args=[go_arg(GO_WRITE, GO_CT), go_arg(GO_READ, GO_CT),
                  go_arg(GO_READ, GridProp.GRID_AREA_T)])
    def scale_area(out, x, area):
        return x * area

    g1, g2 = make_fused_grid(), make_fused_grid()
    a1, b1, _ = fused_chain_fields(g1)
    a2, b2, _ = fused_chain_fields(g2)
    Schedule((scale_area, b1, a1))()
    Schedule((scale_area, b2, a2)).fused()
    np.testing.assert_allclose(b2.gather_inner_data(),
                               b1.gather_inner_data(),
                               rtol=1e-12, atol=1e-12)


def test_fused_schedule_guards():
    grid = make_fused_grid(halo=1)
    a, b, c = fused_chain_fields(grid)
    # reductions are jnp-schedule-only
    with pytest.raises(NotImplementedError, match="reduction"):
        Schedule((total, a)).fused()
    # halo too shallow for the sequence's dataflow erosion (the chain
    # b<-a then c<-b erodes 2: staleness propagates through b)
    sched = Schedule((east_plus, b, a, 1.0), (east_plus, c, b, 1.0))
    assert sched.fused_erosion(1) == 2
    with pytest.raises(ValueError, match="halo_width=2"):
        sched.fused()


def test_fused_schedule_overdecomposed():
    """Fused schedules ride the per-tile sweep on over-decomposed
    grids too (16 logical tiles on <= 8 devices)."""
    g1 = make_fused_grid(ndom=1)
    g2 = make_fused_grid(ndom=16)
    assert g2.halo_spec.repx * g2.halo_spec.repy > 1
    a1, b1, c1 = fused_chain_fields(g1)
    a2, b2, c2 = fused_chain_fields(g2)
    calls = lambda a, b, c: ((east_plus, b, a, 3.0), (double, c, b))
    Schedule(*calls(a1, b1, c1))()
    Schedule(*calls(a2, b2, c2)).fused()
    np.testing.assert_allclose(c2.gather_inner_data(),
                               c1.gather_inner_data(),
                               rtol=1e-12, atol=1e-12)


def test_fused_schedule_fuzz():
    """Seeded random kernel chains (random shifts/scalars/space masks,
    random grids incl. over-decomposition and periodic wrap) pinned
    against the jnp schedule on internal points."""
    import jax.numpy as jnp
    from dl_esm_inf_tpu.api.kernel_meta import (GO_ALL_PTS,
                                                GO_INTERNAL_PTS)

    rng = np.random.default_rng(42)
    shifts = {  # (stencil, fn) pairs of matching depth
        "E": (go_stencil(0, 11, 0), st.xp),
        "W": (go_stencil(0, 110, 0), st.xm),
        "N": (go_stencil(10, 10, 0), st.yp),
        "S": (go_stencil(0, 10, 10), st.ym),
        "EE": (go_stencil(0, 12, 0), lambda a: st.xp(st.xp(a))),
    }
    for trial in range(6):
        wrap = bool(rng.integers(0, 2))
        gnx = int(rng.choice([24, 32, 40]))
        gny = int(rng.choice([24, 32, 40]))
        ndom = int(rng.choice([1, 4, 8, 16]))
        n_calls = int(rng.integers(1, 4))
        names = rng.choice(list(shifts), size=n_calls)
        depth_total = sum(2 if n == "EE" else 1 for n in names)
        halo = max(depth_total, 1)

        def build():
            bcs = ((dl.BC_PERIODIC, dl.BC_PERIODIC, dl.BC_NONE) if wrap
                   else (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE))
            g = dl.Grid(dl.ARAKAWA_C, bcs, dl.OFFSET_NE)
            g.decompose(gnx, gny, ndomains=ndom, halo_width=halo,
                        align_y=8)
            dl.grid_init(g, 1.0, 1.0)
            vals = rng.standard_normal((gny, gnx))
            return (dl.Field(g, dl.T_POINTS, init_global_data=vals),
                    dl.Field(g, dl.T_POINTS))

        try:
            fa1, fb1 = build()
            fa2, fb2 = build()
        except ValueError:
            continue   # indivisible periodic decomposition etc.

        # identical initial data for both builds
        fa2.data = jnp.asarray(np.asarray(fa1.data))

        calls1, calls2 = [], []
        cur1, cur2 = fa1, fa2
        scal = []
        for nm in names:
            sten, fn = shifts[nm]
            s = float(rng.uniform(-1, 1))
            scal.append(s)
            space = (GO_ALL_PTS if rng.integers(0, 3) == 0
                     else GO_INTERNAL_PTS)

            @kernel(args=[go_arg(GO_WRITE, GO_CT),
                          go_arg(GO_READ, GO_CT, sten),
                          go_arg(GO_READ, GO_R_SCALAR)],
                    iterates_over=space, name=f"fz_{trial}_{nm}")
            def kf(out, x, a, fn=fn):
                return fn(x) + a

            calls1.append((kf, fb1, cur1, s))
            calls2.append((kf, fb2, cur2, s))
            cur1, cur2 = fb1, fb2

        Schedule(*calls1)()
        Schedule(*calls2).fused()
        np.testing.assert_allclose(
            fb2.gather_inner_data(), fb1.gather_inner_data(),
            rtol=1e-12, atol=1e-12,
            err_msg=f"trial {trial}: {list(names)} wrap={wrap} "
                    f"ndom={ndom} {gnx}x{gny}")


def test_fused_schedule_per_repeat_scalars():
    """scalars may be one row PER REPEAT (e.g. a time-varying
    forcing): fused(repeats=K) == K sequential jnp-schedule calls with
    the per-step values."""
    g1, g2 = make_fused_grid(halo=8), make_fused_grid(halo=8)
    a1, b1, _ = fused_chain_fields(g1)
    a2, b2, _ = fused_chain_fields(g2)
    s1 = Schedule((east_plus, b1, a1, 0.0), (double, a1, b1))
    s2 = Schedule((east_plus, b2, a2, 0.0), (double, a2, b2))
    series = [[0.25], [-1.0], [3.5]]
    for row in series:
        s1(scalars=row)
    s2.fused(scalars=series, repeats=3)
    for f1, f2 in ((a1, a2), (b1, b2)):
        np.testing.assert_allclose(f2.gather_inner_data(),
                                   f1.gather_inner_data(),
                                   rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="per-repeat scalars"):
        s2.fused(scalars=[[1.0]], repeats=3)


def test_fused_program_scratch_slot_matches_jnp():
    """Multi-step driver with a written-before-read SCRATCH slot (r5):
    b is recomputed inside every sequence, a feeds forward.  The light
    loop streams b as read-only background and the final full sweep
    emits it; all slots must equal nsteps jnp schedule calls."""
    g1, g2 = make_fused_grid(halo=8), make_fused_grid(halo=8)
    a1, b1, _ = fused_chain_fields(g1)
    a2, b2, _ = fused_chain_fields(g2)
    s1 = Schedule((east_plus, b1, a1, 1.5), (double, a1, b1))
    s2 = Schedule((east_plus, b2, a2, 1.5), (double, a2, b2))
    for _ in range(4):
        s1(scalars=[1.5])
    s2.fused_program(4)(scalars=[1.5])
    for f1, f2 in ((a1, a2), (b1, b2)):
        np.testing.assert_allclose(f2.gather_inner_data(),
                                   f1.gather_inner_data(),
                                   rtol=1e-12, atol=1e-12)


def test_fused_program_multi_mask_written_slot_is_carried():
    """A written-before-read slot ALSO written under a SECOND
    iteration-space mask (interior compute -> stencil read ->
    whole-array BC write) must classify as CARRIED, not scratch: the
    second mask's cells carry values across applications, which the
    scratch background re-seed would silently lose (r5 review finding,
    confirmed by repro before the fix)."""
    from dl_esm_inf_tpu.api.kernel_meta import GO_ALL_PTS

    @kernel(args=[go_arg(GO_READWRITE, GO_CT)],
            iterates_over=GO_ALL_PTS, name="bc_fill_all")
    def bc_fill(b):
        return b * 0.5 + 21.0

    @kernel(args=[go_arg(GO_READWRITE, GO_CT)], name="incr_int")
    def incr(x):
        return x + 1.0

    def build(g):
        a, b, c = fused_chain_fields(g)
        return (a, b, c), Schedule(
            (east_plus, b, a, 0.0),      # b: interior mask write
            (east_plus, c, b, 0.0),      # stencil read of b
            (bc_fill, b),                # b: SECOND (all-points) mask
            (incr, a))                   # a feeds forward
    g1, g2 = make_fused_grid(halo=8), make_fused_grid(halo=8)
    f1, s1 = build(g1)
    f2, s2 = build(g2)
    for _ in range(3):
        s1()
    s2.fused_program(3)()
    for x1, x2, nm in zip(f1, f2, "abc"):
        np.testing.assert_allclose(x2.gather_inner_data(),
                                   x1.gather_inner_data(),
                                   rtol=1e-12, atol=1e-12, err_msg=nm)


def test_fused_program_readwrite_first_touch_is_carried():
    """A slot whose FIRST touch is READWRITE reads its previous value:
    it must classify as carried, never scratch — a misclassification
    would collapse the n-step loop to one step (x+1 instead of x+3)."""
    @kernel(args=[go_arg(GO_READWRITE, GO_CT)])
    def incr(x):
        return x + 1.0

    g1, g2 = make_fused_grid(halo=8), make_fused_grid(halo=8)
    a1, _, _ = fused_chain_fields(g1)
    a2, _, _ = fused_chain_fields(g2)
    s1 = Schedule((incr, a1))
    s2 = Schedule((incr, a2))
    for _ in range(3):
        s1()
    s2.fused_program(3)()
    np.testing.assert_allclose(a2.gather_inner_data(),
                               a1.gather_inner_data(),
                               rtol=1e-12, atol=1e-12)


def test_fused_program_multilevel_scratch():
    """A levels=3 scratch slot rides the multi-step driver: it is a
    read-only background during the loop steps and is emitted by the
    final sweep."""
    @kernel(args=[go_arg(GO_WRITE, GO_CT),
                  go_arg(GO_READ, GO_CT, go_stencil(0, 11, 0))],
            name="east_to_levels")
    def east3(out3, x):            # 2D result broadcasts to all levels
        return st.xp(x)

    @kernel(args=[go_arg(GO_WRITE, GO_CT), go_arg(GO_READ, GO_CT)],
            name="level_mean")
    def sumlev(out, x3):
        return x3.sum(axis=0) * 0.25

    def fields(grid):
        gny, gnx = grid.global_ny, grid.global_nx
        vals = np.arange(gnx * gny, dtype=float).reshape(gny, gnx)
        a = dl.Field(grid, dl.T_POINTS, init_global_data=vals)
        w3 = dl.Field(grid, dl.T_POINTS, levels=3)
        return a, w3

    g1, g2 = make_fused_grid(halo=8), make_fused_grid(halo=8)
    a1, w1 = fields(g1)
    a2, w2 = fields(g2)
    s1 = Schedule((east3, w1, a1), (sumlev, a1, w1))
    s2 = Schedule((east3, w2, a2), (sumlev, a2, w2))
    for _ in range(3):
        s1()
    s2.fused_program(3)()
    np.testing.assert_allclose(a2.gather_inner_data(),
                               a1.gather_inner_data(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(w2.gather_inner_data(),
                               w1.gather_inner_data(),
                               rtol=1e-12, atol=1e-12)


def test_fused_schedule_flat_scalars_with_0d_values():
    """A flat scalar row holding 0-d array values must NOT be
    misdetected as per-repeat rows (review finding)."""
    import jax.numpy as jnp
    g1, g2 = make_fused_grid(), make_fused_grid()
    a1, b1, _ = fused_chain_fields(g1)
    a2, b2, _ = fused_chain_fields(g2)
    s1 = Schedule((east_plus, b1, a1, 0.0))
    s2 = Schedule((east_plus, b2, a2, 0.0))
    s1(scalars=[5.0])
    s2.fused(scalars=[jnp.float64(5.0)])
    np.testing.assert_allclose(b2.gather_inner_data(),
                               b1.gather_inner_data(), rtol=1e-12)


def test_schedule_consts_deduplicated():
    """Grid-property arrays requested by several kernels bind ONE
    const slot (the fused sweep would otherwise stream duplicate aux
    planes into every tile)."""
    @kernel(args=[go_arg(GO_WRITE, GO_CT), go_arg(GO_READ, GO_CT),
                  go_arg(GO_READ, GridProp.GRID_AREA_T)])
    def area_scale(out, x, area):
        return x * area

    grid = make_fused_grid()
    a, b, c = fused_chain_fields(grid)
    sched = Schedule((area_scale, b, a), (area_scale, c, b),
                     (area_scale, c, c))
    assert len(sched._consts) == 1
    sched()
    # dx = dy = 1 here so area == 1: the chain is three identity scales
    np.testing.assert_allclose(c.gather_inner_data(),
                               a.gather_inner_data(), rtol=1e-12)


def test_schedule_rejects_wrong_kernel_arity():
    """A kernel body returning fewer outputs than its declared WRITE
    args must raise, not silently drop writes (review finding)."""
    @kernel(args=[go_arg(GO_WRITE, GO_CT), go_arg(GO_WRITE, GO_CT),
                  go_arg(GO_READ, GO_CT)])
    def forgot_second(out1, out2, x):
        return 2.0 * x          # should return a 2-tuple

    grid = make_grid()
    a, b, c = setup(grid)
    with pytest.raises(ValueError, match="declares 2 written"):
        Schedule((forgot_second, b, c, a))()


def test_fused_schedule_more_than_eight_masks():
    """More than 8 write masks chunk into several packed planes (the
    int8 code holds 8 — review regression)."""
    grid = make_fused_grid()
    gny, gnx = grid.global_ny, grid.global_nx
    vals = np.arange(gnx * gny, dtype=float).reshape(gny, gnx)
    src = dl.Field(grid, dl.T_POINTS, init_global_data=vals)
    outs1 = [dl.Field(grid, dl.T_POINTS) for _ in range(9)]
    outs2 = [dl.Field(grid, dl.T_POINTS) for _ in range(9)]

    kerns = []
    for k in range(9):
        @kernel(args=[go_arg(GO_WRITE, GO_CT), go_arg(GO_READ, GO_CT)],
                name=f"scale9_{k}")
        def kf(out, x, k=k):
            return (k + 1.0) * x
        kerns.append(kf)

    Schedule(*[(kf, o, src) for kf, o in zip(kerns, outs1)])()
    Schedule(*[(kf, o, src) for kf, o in zip(kerns, outs2)]).fused()
    for k, (o1, o2) in enumerate(zip(outs1, outs2)):
        np.testing.assert_allclose(o2.gather_inner_data(),
                                   o1.gather_inner_data(),
                                   rtol=1e-12, err_msg=str(k))


def test_fused_schedule_multilevel_matches_jnp_schedule():
    """levels=N fields fuse as N streamed planes — the nlayer tier
    (verdict r3 #7): an nlayer-style forward-backward sequence
    (pressure cumsum down the stack, reverse-cumsum flux) as metadata
    kernels on levels=3 fields, run twice per schedule, fused == jnp —
    including a read-only 3-level forcing (aux planes) and a 2D
    vertical-sum diagnostic (mixed leads) in the same chain."""
    import jax.numpy as jnp

    @kernel(args=[go_arg(GO_READWRITE, GO_CU),
                  go_arg(GO_READWRITE, GO_CV),
                  go_arg(GO_READ, GO_CT, go_stencil(10, 11, 0)),
                  go_arg(GO_READ, GO_R_SCALAR)])
    def mom3(u, v, eta, dt):
        p = jnp.cumsum(0.6 * eta, axis=0)        # pressure down the stack
        return (u - dt * (st.xp(p) - p),
                v - dt * (st.yp(p) - p))

    @kernel(args=[go_arg(GO_READWRITE, GO_CT),
                  go_arg(GO_READ, GO_CU, go_stencil(0, 110, 0)),
                  go_arg(GO_READ, GO_CV, go_stencil(0, 10, 10)),
                  go_arg(GO_READ, GO_CT),
                  go_arg(GO_READ, GO_R_SCALAR)])
    def cont3(eta, u, v, frc, dt):
        div = (u - st.xm(u)) + (v - st.ym(v))
        flux = jnp.flip(jnp.cumsum(jnp.flip(0.8 * div, 0), axis=0), 0)
        return eta - dt * flux + dt * frc

    @kernel(args=[go_arg(GO_WRITE, GO_CT), go_arg(GO_READ, GO_CT)])
    def vsum(out, x):
        return x.sum(axis=0)

    def fields(grid):
        gny, gnx = grid.global_ny, grid.global_nx
        rng = np.random.default_rng(7)
        g3 = 0.1 * rng.standard_normal((3, gny, gnx))
        eta = dl.Field(grid, dl.T_POINTS, init_global_data=g3, levels=3)
        u = dl.Field(grid, dl.U_POINTS, levels=3)
        v = dl.Field(grid, dl.V_POINTS, levels=3)
        frc = dl.Field(grid, dl.T_POINTS, init_global_data=0.01 * g3,
                       levels=3)
        c = dl.Field(grid, dl.T_POINTS)
        return eta, u, v, frc, c

    g1, g2 = make_fused_grid(), make_fused_grid()
    e1, u1, v1, f1, c1 = fields(g1)
    e2, u2, v2, f2, c2 = fields(g2)
    dt = 0.05
    calls = lambda e, u, v, f, c: (
        (mom3, u, v, e, dt), (cont3, e, u, v, f, dt),
        (mom3, u, v, e, dt), (cont3, e, u, v, f, dt),
        (vsum, c, e))
    Schedule(*calls(e1, u1, v1, f1, c1))()
    Schedule(*calls(e2, u2, v2, f2, c2)).fused()
    for x1, x2, name in ((e1, e2, "eta"), (u1, u2, "u"), (v1, v2, "v"),
                         (c1, c2, "vsum")):
        np.testing.assert_allclose(x2.gather_inner_data(),
                                   x1.gather_inner_data(),
                                   rtol=1e-12, atol=1e-12, err_msg=name)


def test_fused_schedule_multilevel_2d_result_broadcasts():
    """A kernel that returns a 2D block for a levels=N written slot
    broadcasts to every level in the jnp schedule (numpy semantics);
    the fused path must match, not slice rows off the 2D array
    (round-4 self-review), and a wrong level count must raise."""
    import jax.numpy as jnp

    @kernel(args=[go_arg(GO_WRITE, GO_CT), go_arg(GO_READ, GO_CT)])
    def set_all_levels(out3, c2):              # (h, w) result, levels=3 slot
        return 2.0 * c2

    @kernel(args=[go_arg(GO_READWRITE, GO_CT,
                         go_stencil(0, 11, 0))])
    def relax(e):
        return 0.5 * (e + jnp.stack([st.xp(e[k]) for k in range(3)]))

    def fields(grid):
        rng = np.random.default_rng(3)
        c = dl.Field(grid, dl.T_POINTS, init_global_data=rng.standard_normal(
            (grid.global_ny, grid.global_nx)))
        e = dl.Field(grid, dl.T_POINTS, levels=3)
        return e, c

    g1, g2 = make_fused_grid(), make_fused_grid()
    e1, c1 = fields(g1)
    e2, c2 = fields(g2)
    calls = lambda e, c: ((set_all_levels, e, c), (relax, e))
    Schedule(*calls(e1, c1))()
    Schedule(*calls(e2, c2)).fused()
    np.testing.assert_allclose(e2.gather_inner_data(),
                               e1.gather_inner_data(),
                               rtol=1e-12, atol=1e-12)

    @kernel(args=[go_arg(GO_WRITE, GO_CT), go_arg(GO_READ, GO_CT)])
    def wrong_levels(out3, c2):
        return jnp.stack([c2, c2])             # 2 planes for levels=3

    g3 = make_fused_grid()
    e3, c3 = fields(g3)
    with pytest.raises(ValueError, match="level planes"):
        Schedule((wrong_levels, e3, c3)).fused()
