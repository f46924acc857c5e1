"""NEMOLite2D-class nonlinear SW: infrastructure-correctness tests.

The decisive infrastructure test is decomposition invariance: the same
global stencil program must produce bit-identical (fp64 allclose)
results on 1 shard and on N shards — shard seams, halo exchanges and
masked padding must be invisible.  Physics sanity: closed-basin mass
conservation, stability, wall conditions.
"""
import numpy as np
import pytest

from dl_esm_inf_tpu.models import nemolite2d as nl
from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta


def build(gnx=48, gny=40, ndom=1, open_north=False, **kw):
    m = nl.build(gnx, gny, ndomains=ndom, open_north=open_north, **kw)
    m.set_initial_ssh(gaussian_eta(gnx, gny, amp=1.0))
    return m


@pytest.mark.parametrize("ndom", [4, 6])
@pytest.mark.parametrize("open_north", [False, True])
def test_decomposition_invariance(ndom, open_north, halo_width=2):
    """The default deep halo computes the new surface redundantly in
    the halo ring."""
    m1 = build(ndom=1, open_north=open_north, halo_width=halo_width)
    mn = build(ndom=ndom, open_north=open_north, halo_width=halo_width)
    m1.run(50)
    mn.run(50)
    g1, gn = m1.gather(), mn.gather()
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(gn[k], g1[k], rtol=1e-12, atol=1e-13,
                                   err_msg=k)


@pytest.mark.parametrize("ndom", [4, 6])
@pytest.mark.parametrize("open_north", [False, True])
def test_decomposition_invariance_halo1(ndom, open_north):
    """Halo width 1 exchanges the new surface between continuity and
    momentum."""
    test_decomposition_invariance(ndom, open_north, halo_width=1)


def test_closed_basin_mass_conservation():
    m = build(open_north=False)
    wet = m.sshn_t.internal_mask_np() & (np.asarray(m.grid.tmask) == 1)
    vol0 = float(np.asarray(m.sshn_t.data)[wet].sum())
    m.run(200)
    vol = float(np.asarray(m.sshn_t.data)[wet].sum())
    assert abs(vol - vol0) < 1e-8 * max(1.0, abs(vol0))


def test_stability_and_motion():
    m = build()
    s0 = m.gather()["sshn"]
    m.run(100)
    g = m.gather()
    for k, v in g.items():
        assert np.all(np.isfinite(v)), k
    assert not np.allclose(g["sshn"], s0, atol=1e-9)
    # solid walls: no normal flow through them
    np.testing.assert_array_equal(g["un"][:, 0], 0.0)
    np.testing.assert_array_equal(g["un"][:, -2:], 0.0)
    np.testing.assert_array_equal(g["vn"][0, :], 0.0)
    np.testing.assert_array_equal(g["vn"][-2:, :], 0.0)


def test_chunked_equals_monolithic():
    ma = build(ndom=4)
    mb = build(ndom=4)
    ma.run(60)
    for _ in range(6):
        mb.run(10)
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(mb.gather()[k], ma.gather()[k],
                                   rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("ndom", [1, 4])
def test_jnp_comm_avoidance_matches_per_step(ndom):
    """K chained jnp steps per depth-2K exchange must equal
    the per-step schedule; 7 steps exercises the sweep remainder."""
    ma = nl.build(48, 40, ndomains=ndom, halo_width=4, open_north=True)
    mb = nl.build(48, 40, ndomains=ndom, halo_width=4, open_north=True)
    mb.set_steps_per_exchange(2)
    from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta as ge
    for m in (ma, mb):
        m.set_initial_ssh(ge(48, 40, amp=0.5))
    ma.run(7)
    mb.run(7)
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(mb.gather()[k], ma.gather()[k],
                                   rtol=1e-12, atol=1e-13, err_msg=k)


def test_build_steps_per_sweep_without_pallas():
    """build(steps_per_sweep=K) must select the comm-avoiding schedule
    and deepen the halo to match."""
    m = nl.build(32, 32, ndomains=1, steps_per_sweep=2)
    assert m._sweep_K == 2
    assert m.grid.halo_spec.halo >= 4


def test_jnp_comm_avoidance_guards():
    m = nl.build(32, 32, ndomains=1, halo_width=2)
    with pytest.raises(ValueError, match="halo_width"):
        m.set_steps_per_exchange(2)


def test_long_run_1024_steps_stable_and_invariant():
    """1024 steps (BASELINE horizon): finite state, closed-basin mass
    conserved, and 1-shard == 4-shard to fp64 roundoff."""
    m1 = build(ndom=1, open_north=False)
    m4 = build(ndom=4, open_north=False)
    wet = m1.sshn_t.internal_mask_np() & (np.asarray(m1.grid.tmask) == 1)
    vol0 = float(np.asarray(m1.sshn_t.data)[wet].sum())
    m1.run(1024)
    m4.run(1024)
    g1, g4 = m1.gather(), m4.gather()
    for k in ("sshn", "un", "vn"):
        assert np.all(np.isfinite(g1[k])), k
        np.testing.assert_allclose(g4[k], g1[k], rtol=1e-10, atol=1e-11,
                                   err_msg=k)
    vol = float(np.asarray(m1.sshn_t.data)[wet].sum())
    assert abs(vol - vol0) < 1e-7 * max(1.0, abs(vol0))


def test_open_boundary_forcing_pumps_water():
    """With the north boundary open and tidal forcing, the basin volume
    oscillates — the bc_ssh/Flather path is actually live."""
    m = build(open_north=True)
    wet = m.sshn_t.internal_mask_np() & (np.asarray(m.grid.tmask) == 1)
    vol0 = float(np.asarray(m.sshn_t.data)[wet].sum())
    m.run(100)
    vol = float(np.asarray(m.sshn_t.data)[wet].sum())
    assert abs(vol - vol0) > 1e-6


def test_continuity_kernel_vs_numpy():
    """Pin the continuity indexing with an independent NumPy slice
    formulation on one shard."""
    m = build(gnx=16, gny=12, ndom=1)
    m.run(1)  # arbitrary state
    import jax.numpy as jnp
    sshn = np.asarray(m.sshn_t.data)
    un = np.asarray(m.un.data)
    vn = np.asarray(m.vn.data)
    depu = m.depth + np.asarray(m.sshn_u.data)
    depv = m.depth + np.asarray(m.sshn_v.data)
    dx = dy = m.grid.dx
    got = np.asarray(nl.continuity(jnp.asarray(sshn), jnp.asarray(un),
                                   jnp.asarray(vn), jnp.asarray(depu),
                                   jnp.asarray(depv),
                                   rdt=m.p.rdt, dx=dx, dy=dy))
    # independent slicing version at interior cells
    fx = depu * un * dy
    fy = depv * vn * dx
    want = sshn.copy()
    want[1:-1, 1:-1] = sshn[1:-1, 1:-1] - (
        (fx[1:-1, 1:-1] - fx[1:-1, 0:-2]) +
        (fy[1:-1, 1:-1] - fy[0:-2, 1:-1])) * m.p.rdt / (dx * dy)
    np.testing.assert_allclose(got[1:-1, 1:-1], want[1:-1, 1:-1],
                               rtol=1e-12)


def test_overlap_step_matches_plain():
    """Interior/boundary-split overlapped step must equal the plain step
    exactly (jnp path, fp64): the split is pure restructuring."""
    import jax.numpy as jnp
    for ndom in (1, 4):
        ma = nl.build(48, 40, ndomains=ndom, halo_width=2, open_north=True)
        mb = nl.build(48, 40, ndomains=ndom, halo_width=2, open_north=True)
        from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta
        ma.set_initial_ssh(gaussian_eta(48, 40, amp=0.5))
        mb.set_initial_ssh(gaussian_eta(48, 40, amp=0.5))
        # run a: plain; run b: overlapped
        pa = ma.step_program(30)
        pb = mb.step_program(30, overlap=True)
        sa = pa(jnp.int32(0), (ma.sshn_t.data, ma.un.data, ma.vn.data),
                ma._mask_codes)
        sb = pb(jnp.int32(0), (mb.sshn_t.data, mb.un.data, mb.vn.data),
                mb._mask_codes)
        for k, (a, b) in enumerate(zip(sa, sb)):
            # compare in-domain internal points only (halo/pad cells
            # legitimately differ: plain computes them, overlap pastes).
            # Tolerance: the two programs compile differently, so XLA's
            # FMA/excess-precision choices differ by ~1 ulp per step.
            ma.sshn_t.data = a
            mb.sshn_t.data = b
            np.testing.assert_allclose(mb.sshn_t.gather_inner_data(),
                                       ma.sshn_t.gather_inner_data(),
                                       rtol=1e-12, atol=1e-13,
                                       err_msg=f"ndom={ndom} field {k}")


def test_overlap_variable_bathymetry_matches_plain():
    """Overlap mode with a sloping bottom (previously rejected) equals
    the plain step at every internal point."""
    import jax.numpy as jnp
    gnx, gny = 48, 40
    yy = np.linspace(0.0, 1.0, gny)[:, None]
    xx = np.linspace(0.0, 1.0, gnx)[None, :]
    depth = 70.0 + 40.0 * yy + 10.0 * np.sin(2 * np.pi * xx)
    for ndom in (1, 4):
        ma = nl.build(gnx, gny, ndomains=ndom, halo_width=2,
                      open_north=True, depth=depth)
        mb = nl.build(gnx, gny, ndomains=ndom, halo_width=2,
                      open_north=True, depth=depth)
        for m in (ma, mb):
            m.set_initial_ssh(gaussian_eta(gnx, gny, amp=0.5))
        pa = ma.step_program(30)
        pb = mb.step_program(30, overlap=True)
        sa = pa(jnp.int32(0), (ma.sshn_t.data, ma.un.data, ma.vn.data),
                ma._mask_codes, ma._ht)
        sb = pb(jnp.int32(0), (mb.sshn_t.data, mb.un.data, mb.vn.data),
                mb._mask_codes, mb._ht)
        for k, (a, b) in enumerate(zip(sa, sb)):
            ma.sshn_t.data = a
            mb.sshn_t.data = b
            np.testing.assert_allclose(mb.sshn_t.gather_inner_data(),
                                       ma.sshn_t.gather_inner_data(),
                                       rtol=1e-12, atol=1e-13,
                                       err_msg=f"ndom={ndom} field {k}")


def test_overlap_guards():
    m = build(gnx=16, gny=16, ndom=1, halo_width=1)
    with pytest.raises(ValueError, match="halo_width"):
        m.step_program(1, overlap=True)
