"""Over-decomposition: more logical subdomains than devices.

Each device carries a (repy x repx) block of logical tiles; intra-device
halo seams are local strip shifts and device edges ride the same
ppermutes (parallel/halo.py).  The reference carries a multi-subdomain-
per-rank mapping table its comms never support (parallel_mod.f90:141-152,
parallel_comms_mod.f90:295) — here it is live, so a 32-shard process
grid validates on the 8-device CPU mesh.
"""
import numpy as np
import pytest

import dl_esm_inf_tpu as dl
from dl_esm_inf_tpu.models import nemolite2d as nl
from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta
from dl_esm_inf_tpu.testing import hill_stacked, init_field_hill

POISON = -666.0
TOL = 1e-8


def make_grid(gnx, gny, ndom=None, ndx=None, ndy=None, halo_width=1,
              bcs=None):
    grid = dl.Grid(dl.ARAKAWA_C,
                   bcs or (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                   dl.OFFSET_NE)
    grid.decompose(gnx, gny, ndomains=ndom, ndomainx=ndx, ndomainy=ndy,
                   halo_width=halo_width)
    dl.grid_init(grid, 1.0, 1.0)
    return grid


def test_mesh_mapping_exposed():
    """32 logical tiles on 8 devices: the spec records the repeats and
    the device mesh divides the process grid."""
    grid = make_grid(64, 64, ndx=8, ndy=4)
    spec = grid.halo_spec
    assert (spec.nprocx, spec.nprocy) == (8, 4)
    assert spec.meshx * spec.meshy == grid.mesh.size <= 8
    assert spec.repx * spec.meshx == 8 and spec.repy * spec.meshy == 4
    assert spec.repx > 1 or spec.repy > 1


@pytest.mark.parametrize("ndx,ndy", [
    (8, 4),     # 32 tiles on 8 devices (4x over-decomposed)
    (16, 1),    # 1D x over-decomposition
    (1, 16),    # 1D y
    (3, 6),     # 18 tiles; odd factors
    (2, 2),     # control: fits the devices exactly (rep = 1)
])
@pytest.mark.parametrize("points", [dl.T_POINTS, dl.U_POINTS])
def test_hill_halos_overdecomposed(ndx, ndy, points):
    """The reference's hill oracle (test_halos.f90) over every logical
    tile of an over-decomposed grid: depth-1 halos exact, no-neighbour
    strips untouched."""
    from test_halo_exchange import check_hill_halos
    grid = make_grid(48, 48, ndx=ndx, ndy=ndy)
    fld = dl.Field(grid, points)
    init_field_hill(fld, POISON)
    fld.halo_exchange(1)
    check_hill_halos(fld, depth=1)


def test_hill_halos_overdecomposed_depth2():
    from test_halo_exchange import check_hill_halos
    grid = make_grid(48, 40, ndx=8, ndy=4, halo_width=2)
    fld = dl.Field(grid, dl.T_POINTS)
    init_field_hill(fld, POISON)
    fld.halo_exchange(2)
    check_hill_halos(fld, depth=2)


def test_corners_propagate_between_tiles_on_one_device():
    """Diagonal corner values must cross intra-device tile seams too."""
    from test_halo_exchange import check_hill_halos
    grid = make_grid(32, 32, ndx=4, ndy=4)   # 16 tiles, 8 devices
    fld = dl.Field(grid, dl.T_POINTS)
    init_field_hill(fld, POISON)
    fld.halo_exchange(1)
    data = fld.get_data()
    oracle = hill_stacked(fld)
    d = grid.decomp
    for rank in (0, 5, 10):                  # SW, interior, interior
        sy, sx = d.shard_slices(rank)
        r = fld.internal_region(rank)
        got = data[sy, sx][r.ystop, r.xstop]
        want = oracle[sy, sx][r.ystop, r.xstop]
        assert abs(got - want) < TOL, rank


@pytest.mark.parametrize("ndom", [32, 18])
def test_flagship_decomposition_invariance_overdecomposed(ndom):
    """1 shard == N>devices shards to fp64 roundoff on the flagship —
    the make-or-break test, now at process-grid sizes the device count
    could never reach before."""
    def build(n):
        m = nl.build(48, 40, ndomains=n, open_north=True)
        m.set_initial_ssh(gaussian_eta(48, 40, amp=1.0))
        return m

    m1, mn = build(1), build(ndom)
    assert (mn.grid.halo_spec.repx * mn.grid.halo_spec.repy) > 1
    m1.run(50)
    mn.run(50)
    g1, gn = m1.gather(), mn.gather()
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(gn[k], g1[k], rtol=1e-12, atol=1e-13,
                                   err_msg=k)


def test_periodic_overdecomposed():
    """Doubly-periodic client (shallow) on 16 tiles / 8 devices equals
    the 1-shard run: wrap seams cross device AND tile boundaries."""
    from dl_esm_inf_tpu.models import shallow as sh
    eta0 = np.random.default_rng(3).normal(size=(32, 32)) * 0.1
    ma = sh.build(32, 32, ndomains=1, dt=0.01)
    mb = sh.build(32, 32, ndomains=16, dt=0.01)
    for m in (ma, mb):
        m.set_initial_eta(eta0)
    ma.run(20)
    mb.run(20)
    for k in ("eta", "u", "v"):
        np.testing.assert_allclose(mb.gather()[k], ma.gather()[k],
                                   rtol=1e-12, atol=1e-13, err_msg=k)


def test_checkpoint_roundtrip_overdecomposed(tmp_path):
    """Orbax global-form checkpoint: save on 4 shards, restore onto an
    over-decomposed 32-tile grid."""
    from dl_esm_inf_tpu.utils import checkpoint
    m4 = nl.build(48, 40, ndomains=4, open_north=True)
    m4.set_initial_ssh(gaussian_eta(48, 40, amp=0.5))
    m4.run(10)
    f4 = {"sshn_t": m4.sshn_t, "un": m4.un, "vn": m4.vn}
    checkpoint.save_fields_orbax(str(tmp_path / "ck"), f4, step=10)

    m32 = nl.build(48, 40, ndomains=32, open_north=True)
    f32 = {"sshn_t": m32.sshn_t, "un": m32.un, "vn": m32.vn}
    checkpoint.load_fields_orbax(str(tmp_path / "ck"), f32)
    for k in f4:
        np.testing.assert_array_equal(f32[k].gather_inner_data(),
                                      f4[k].gather_inner_data(),
                                      err_msg=k)


def test_flagship_pallas_overdecomposed():
    """The K-step sweep on an over-decomposed grid (ppermute exchange
    between sweeps, intra-device seams as local strip shifts): 32
    tiles on 8 devices equal the 1-shard run to fp64 roundoff, with
    K=2 so the deep-halo schedule also crosses the intra-device tile
    seams."""
    gnx, gny = 64, 48
    m1 = nl.build(gnx, gny, ndomains=1, open_north=True)
    mo = nl.build(gnx, gny, ndomains=32, open_north=True,
                  steps_per_sweep=2)
    spec = mo.grid.halo_spec
    assert spec.repx * spec.repy > 1     # genuinely over-decomposed
    ssh0 = gaussian_eta(gnx, gny, amp=0.5)
    m1.set_initial_ssh(ssh0)
    mo.set_initial_ssh(ssh0)
    m1.run(24)
    mo.run(24)
    g1, go = m1.gather(), mo.gather()
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(go[k], g1[k], rtol=1e-12, atol=1e-13,
                                   err_msg=k)


def test_tracer_overdecomposed():
    """The sixth model family over-decomposed: 24 logical tiles on 8
    devices, van-Leer (reach 2) with K=2 steps per exchange — equal
    to the 1-shard run, and
    tracer mass stays exact across the intra-device tile seams."""
    from dl_esm_inf_tpu.models import tracer as tr
    gnx, gny = 48, 48
    x = (np.arange(gnx) - gnx / 2 + 0.5) / gnx
    psi = 0.4 * np.exp(-((x[None, :] ** 2 + x[:, None] ** 2) / 0.18))
    u, v = tr.streamfunction_velocities(psi)
    c0 = gaussian_eta(gnx, gny, amp=1.0) + 0.01

    m1 = tr.build(gnx, gny, ndomains=1, dt=0.2, u=u, v=v, kappa=0.02)
    m1.set_initial_tracer(c0)
    m1.run(12)

    mo = tr.build(gnx, gny, ndomains=24, dt=0.2, u=u, v=v, kappa=0.02,
                  steps_per_sweep=2)
    spec = mo.grid.halo_spec
    assert spec.repx * spec.repy > 1
    mo.set_initial_tracer(c0)
    mass0 = mo.mass()
    mo.run(12)
    assert abs(mo.mass() - mass0) <= 1e-12 * abs(mass0)
    np.testing.assert_allclose(mo.gather()["c"], m1.gather()["c"],
                               rtol=1e-12, atol=1e-13)
