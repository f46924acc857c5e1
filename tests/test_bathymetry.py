"""Variable bathymetry: T-point depth array instead of a scalar.

The reference library carries per-point scale-factor/depth arrays on
the grid (grid_mod.f90:121-138); this is the client-side analogue the
real NEMOLite2D benchmark needs (its kernels take ht/hu/hv fields).
"""
import numpy as np
import pytest

from dl_esm_inf_tpu.models import nemolite2d as nl
from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta


def sloped_depth(gnx, gny, lo=40.0, hi=90.0):
    """Sloped basin; max total depth 100 m keeps the gravity-wave CFL
    at the flat-bottom baseline (c*dt*sqrt(2)/dx ~ 0.89)."""
    y = np.linspace(lo, hi, gny)[:, None]
    x = np.linspace(0.0, 10.0, gnx)[None, :]
    return (y + x).astype(np.float64)


def build(gnx=48, gny=40, ndom=1, depth=100.0, **kw):
    m = nl.build(gnx, gny, ndomains=ndom, open_north=True, depth=depth,
                 **kw)
    m.set_initial_ssh(gaussian_eta(gnx, gny, amp=0.5))
    return m


def test_constant_array_equals_scalar():
    """A constant depth array must reproduce the scalar fast path."""
    ma = build(depth=100.0)
    mb = build(depth=np.full((40, 48), 100.0))
    ma.run(30)
    mb.run(30)
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(mb.gather()[k], ma.gather()[k],
                                   rtol=1e-12, atol=1e-13, err_msg=k)


@pytest.mark.parametrize("ndom", [4, 6])
def test_decomposition_invariance_sloped(ndom):
    m1 = build(ndom=1, depth=sloped_depth(48, 40))
    mn = build(ndom=ndom, depth=sloped_depth(48, 40))
    m1.run(50)
    mn.run(50)
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(mn.gather()[k], m1.gather()[k],
                                   rtol=1e-12, atol=1e-13, err_msg=k)


def test_mass_conservation_sloped_closed_basin():
    m = nl.build(48, 40, ndomains=4, open_north=False,
                 depth=sloped_depth(48, 40))
    m.set_initial_ssh(gaussian_eta(48, 40, amp=0.5))
    wet = m.sshn_t.internal_mask_np() & (np.asarray(m.grid.tmask) == 1)
    vol0 = float(np.asarray(m.sshn_t.data)[wet].sum())
    m.run(200)
    g = m.gather()
    assert all(np.isfinite(v).all() for v in g.values())
    vol = float(np.asarray(m.sshn_t.data)[wet].sum())
    assert abs(vol - vol0) < 1e-8 * max(1.0, abs(vol0))


@pytest.mark.parametrize("sweep", [1, 2])
def test_pallas_matches_jnp_sloped(sweep):
    gnx, gny = 96, 64
    """Variable bathymetry through the K-step sweep (face depths
    derived once per sweep) on 4 shards == the one-step path on one
    shard."""
    ma = nl.build(gnx, gny, ndomains=1, open_north=True,
                  depth=sloped_depth(gnx, gny), halo_width=2 * sweep)
    mb = nl.build(gnx, gny, ndomains=4, open_north=True,
                  depth=sloped_depth(gnx, gny), halo_width=2 * sweep,
                  steps_per_sweep=sweep)
    for m in (ma, mb):
        m.set_initial_ssh(gaussian_eta(gnx, gny, amp=0.5))
    ma.run(5)
    mb.run(5)
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(mb.gather()[k], ma.gather()[k],
                                   rtol=1e-12, atol=1e-13, err_msg=k)


def test_nonpositive_depth_rejected():
    bad = sloped_depth(32, 32)
    bad[3, 4] = 0.0
    with pytest.raises(ValueError, match="positive"):
        nl.build(32, 32, ndomains=1, depth=bad)


def test_bathymetry_from_netcdf(tmp_path):
    """The NEMO-style input workflow end to end: bathymetry written as
    a raw array to NetCDF (prep path), read back with load_netcdf, and
    driven through the flagship — identical to the in-memory array."""
    from dl_esm_inf_tpu.utils import io as dio

    ht = sloped_depth(48, 40)
    p = str(tmp_path / "bathy.nc")
    dio.dump_netcdf({"ht": ht, "tmask": np.ones((40, 48), np.int64)}, p,
                    global_attrs={"title": "prep"})
    d = dio.load_netcdf(p)
    assert d["variables"]["tmask"].dtype == np.int32   # int64 narrowed
    ma = build(ndom=4, depth=ht)
    mb = build(ndom=4, depth=d["variables"]["ht"])
    ma.run(30)
    mb.run(30)
    for k in ("sshn", "un", "vn"):
        np.testing.assert_array_equal(mb.gather()[k], ma.gather()[k],
                                      err_msg=k)
