"""Aux subsystems: checkpoint/resume, profiling report, config, io."""
import os

import numpy as np
import pytest

import dl_esm_inf_tpu as dl
from dl_esm_inf_tpu.models import nemolite2d as nl
from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta
from dl_esm_inf_tpu.utils import checkpoint, config, io as dio, profiling


def build(ndom=4, gnx=32, gny=24):
    m = nl.build(gnx, gny, ndomains=ndom, open_north=False)
    m.set_initial_ssh(gaussian_eta(gnx, gny, amp=0.5))
    return m


def test_checkpoint_roundtrip_same_mesh(tmp_path):
    m = build()
    m.run(20)
    path = str(tmp_path / "ck.npz")
    checkpoint.save_model(path, m)
    m2 = build()
    checkpoint.load_model(path, m2)
    assert m2._istep0 == 20
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(m2.gather()[k], m.gather()[k],
                                   rtol=1e-12, atol=1e-14)
    # resumed run == uninterrupted run
    m.run(20)
    m2.run(20)
    np.testing.assert_allclose(m2.gather()["sshn"], m.gather()["sshn"],
                               rtol=1e-12, atol=1e-13)


def test_checkpoint_across_mesh_shapes(tmp_path):
    """Save on 6 shards, restore on 1 — elastic restart through the
    global form (capability the reference entirely lacks)."""
    m6 = build(ndom=6)
    m6.run(10)
    path = str(tmp_path / "ck.npz")
    checkpoint.save_model(path, m6)
    m1 = build(ndom=1)
    checkpoint.load_model(path, m1)
    m6.run(10)
    m1.run(10)
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(m1.gather()[k], m6.gather()[k],
                                   rtol=1e-12, atol=1e-13, err_msg=k)


def test_checkpoint_missing_field(tmp_path):
    m = build()
    path = str(tmp_path / "ck.npz")
    checkpoint.save_fields(path, {"only": m.sshn_t})
    with pytest.raises(KeyError):
        checkpoint.load_fields(path, {"other": m.sshn_t})


def test_checkpoint_orbax_roundtrip(tmp_path):
    """Sharded orbax checkpoint (global-form on disk, no host gather),
    same decomposition: every internal point restores exactly and the
    resumed run equals the uninterrupted one."""
    m = build()
    m.run(10)
    want = {k: fld.gather_inner_data() for k, fld in
            (("sshn_t", m.sshn_t), ("un", m.un), ("vn", m.vn))}
    fields = {"sshn_t": m.sshn_t, "un": m.un, "vn": m.vn}
    checkpoint.save_fields_orbax(str(tmp_path / "ck"), fields, step=10)
    m.run(7)    # diverge
    step = checkpoint.load_fields_orbax(str(tmp_path / "ck"), fields)
    assert step == 10
    for k, fld in fields.items():
        np.testing.assert_array_equal(fld.gather_inner_data(), want[k])


def test_checkpoint_orbax_across_mesh_shapes(tmp_path):
    """Save on 4 shards, restore on 8 — the PRODUCTION (gather-free)
    checkpoint backend now survives a mesh-shape change: the on-disk
    logical array is global-form, so orbax reads each new device's
    sub-range directly."""
    m4 = build(ndom=4)
    m4.run(10)
    f4 = {"sshn_t": m4.sshn_t, "un": m4.un, "vn": m4.vn}
    checkpoint.save_fields_orbax(str(tmp_path / "ck"), f4, step=10)

    m8 = build(ndom=8)
    f8 = {"sshn_t": m8.sshn_t, "un": m8.un, "vn": m8.vn}
    step = checkpoint.load_fields_orbax(str(tmp_path / "ck"), f8)
    assert step == 10
    m8._istep0 = step
    for k in f4:
        np.testing.assert_array_equal(f8[k].gather_inner_data(),
                                      f4[k].gather_inner_data(), err_msg=k)
    # resumed on the new mesh == continued on the old mesh
    m4.run(20)
    m8.run(20)
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(m8.gather()[k], m4.gather()[k],
                                   rtol=1e-12, atol=1e-13, err_msg=k)


def test_comms_schedule():
    m = nl.build(32, 24, ndomains=6, open_north=False, halo_width=2)
    sched = profiling.comms_schedule(m.grid.halo_spec, depth=2)
    with pytest.raises(ValueError, match="depth"):
        profiling.comms_schedule(
            nl.build(32, 24, ndomains=6, halo_width=1).grid.halo_spec,
            depth=2)
    axes = {(e["axis"], e["direction"]) for e in sched}
    assert axes == {("x", "east"), ("x", "west"),
                    ("y", "north"), ("y", "south")}
    east = next(e for e in sched if e["direction"] == "east")
    # 32x24 domain on 6 shards -> 3x2 process grid: x pairs (0,1),(1,2)
    assert east["pairs"] == [(0, 1), (1, 2)]
    assert east["strip"][1] == 2  # depth


def test_decomposition_report():
    d = dl.decompose(10, 10, ndomains=4)
    rep = profiling.decomposition_report(d)
    assert "2x2" in rep and "load imbalance" in rep
    assert rep.count("subdomain[") == 4


def test_step_timer():
    t = profiling.StepTimer()
    with t.measure():
        pass
    assert t.summary()["n"] == 1 and t.best >= 0


def test_config_env(monkeypatch):
    monkeypatch.setenv("DL_ESM_ALIGNMENT", "64")
    monkeypatch.setenv("GOCEAN_OMP_GRID", "4x2")
    monkeypatch.setenv("JPIGLO", "100")
    cfg = config.read_env()
    assert cfg.alignment == 64
    assert cfg.tile_grid == (4, 2)
    assert cfg.jpiglo == 100 and cfg.jpjglo is None
    assert config.parse_grid_dims("bad") is None
    assert config.parse_grid_dims("ax2") is None


def test_gocean_omp_grid_seeds_decompose(monkeypatch):
    # GOCEAN_OMP_GRID shapes the decomposition when no explicit sizing
    # is given (the moral port of field_mod.f90:1473-1503)
    monkeypatch.setenv("GOCEAN_OMP_GRID", "4x2")
    g = dl.Grid(dl.ARAKAWA_C,
                (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                dl.OFFSET_NE)
    d = g.decompose(32, 24)
    assert (d.nprocx, d.nprocy) == (4, 2)
    # explicit arguments win over the environment
    g2 = dl.Grid(dl.ARAKAWA_C,
                 (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                 dl.OFFSET_NE)
    d2 = g2.decompose(32, 24, ndomainx=2, ndomainy=2)
    assert (d2.nprocx, d2.nprocy) == (2, 2)
    # malformed values fall back to the all-devices default
    monkeypatch.setenv("GOCEAN_OMP_GRID", "nonsense")
    g3 = dl.Grid(dl.ARAKAWA_C,
                 (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                 dl.OFFSET_NE)
    d3 = g3.decompose(32, 24)
    assert d3.nprocx * d3.nprocy == dl.parallel.environment.num_devices()


def test_dump_netcdf_scipy_roundtrip(tmp_path):
    """The NetCDF-3 writer against scipy's INDEPENDENT reader: dims,
    coords, data, and attributes of 2D + multi-level fields."""
    scipy_io = pytest.importorskip("scipy.io")
    m = build(ndom=4, gnx=8, gny=6)
    g3 = np.stack([np.arange(48.0).reshape(6, 8) + 100 * k
                   for k in range(3)])
    f3 = dl.Field(m.grid, dl.T_POINTS, init_global_data=g3, levels=3)
    p = str(tmp_path / "out.nc")
    dio.dump_netcdf({"ssh": m.sshn_t, "temp": f3}, p,
                    global_attrs={"title": "dl_esm_inf_tpu dump",
                                  "step": 7})
    with scipy_io.netcdf_file(p, "r", mmap=False) as nc:
        assert nc.title == b"dl_esm_inf_tpu dump"
        assert int(nc.step) == 7     # scipy unpacks length-1 attrs
        assert nc.dimensions["x"] == 8
        assert nc.dimensions["y"] == 6
        assert nc.dimensions["z"] == 3
        np.testing.assert_allclose(nc.variables["x"][:],
                                   (np.arange(8) + 1) * m.grid.dx)
        np.testing.assert_allclose(
            nc.variables["ssh"][:], np.asarray(m.sshn_t.gather_inner_data()))
        np.testing.assert_allclose(nc.variables["temp"][:], g3)
        assert nc.variables["ssh"].coordinates == b"y x"

    # single field, list form, and mixed extents get suffixed dims
    m2 = build(ndom=1, gnx=12, gny=6)
    p2 = str(tmp_path / "two.nc")
    dio.dump_netcdf([m.sshn_t, m2.sshn_t], p2, names=["a", "b"])
    with scipy_io.netcdf_file(p2, "r", mmap=False) as nc:
        assert nc.variables["a"].shape == (6, 8)
        assert nc.variables["b"].shape == (6, 12)
        assert nc.dimensions["x"] == 8 and nc.dimensions["x12"] == 12


def test_load_netcdf_roundtrip_and_foreign(tmp_path):
    """The pure-numpy NetCDF reader: round-trip through our writer AND
    a scipy-written file with a record dimension (the NEMO-style input
    case: time-varying forcing / bathymetry from third-party files)."""
    scipy_io = pytest.importorskip("scipy.io")
    m = build(ndom=4, gnx=8, gny=6)
    p = str(tmp_path / "rt.nc")
    dio.dump_netcdf({"ssh": m.sshn_t}, p, global_attrs={"step": 3})
    d = dio.load_netcdf(p)
    np.testing.assert_array_equal(
        d["variables"]["ssh"], np.asarray(m.sshn_t.gather_inner_data()))
    np.testing.assert_allclose(d["variables"]["x"],
                               (np.arange(8) + 1) * m.grid.dx)
    assert int(d["attributes"]["step"]) == 3
    assert d["variable_attrs"]["ssh"]["coordinates"] == "y x"

    # independent producer, record + fixed vars (multi- and single-
    # record-var layouts differ: the latter is unpadded per record)
    pf = str(tmp_path / "foreign.nc")
    with scipy_io.netcdf_file(pf, "w") as nc:
        nc.createDimension("time", None)
        nc.createDimension("x", 3)
        v = nc.createVariable("h", "f8", ("time", "x"))
        v[0] = [1.0, 2.0, 3.0]
        v[1] = [4.0, 5.0, 6.0]
        s = nc.createVariable("n", "i4", ("time",))
        s[0] = 7
        s[1] = 8
        f = nc.createVariable("fix", "f4", ("x",))
        f[:] = [9.0, 10.0, 11.0]
        f.units = "m"
    d = dio.load_netcdf(pf)
    assert d["dimensions"] == {"time": 2, "x": 3}
    assert d["variables"]["h"].tolist() == [[1, 2, 3], [4, 5, 6]]
    assert d["variables"]["n"].tolist() == [7, 8]
    assert d["variables"]["fix"].tolist() == [9.0, 10.0, 11.0]
    assert d["variable_attrs"]["fix"]["units"] == "m"

    po = str(tmp_path / "single.nc")
    with scipy_io.netcdf_file(po, "w") as nc:
        nc.createDimension("time", None)
        nc.createDimension("x", 3)
        v = nc.createVariable("only", "i2", ("time", "x"))
        for r in range(3):
            v[r] = [3 * r + 1, 3 * r + 2, 3 * r + 3]
    d = dio.load_netcdf(po)
    assert d["variables"]["only"].tolist() == [[1, 2, 3], [4, 5, 6],
                                               [7, 8, 9]]

    # CDF-2 (64-bit offsets) leg
    p2 = str(tmp_path / "cdf2.nc")
    with scipy_io.netcdf_file(p2, "w", version=2) as nc:
        nc.createDimension("x", 5)
        v = nc.createVariable("a", "f8", ("x",))
        v[:] = [1.0, 2.0, 3.0, 4.0, 5.0]
    assert open(p2, "rb").read(4)[3] == 2
    assert dio.load_netcdf(p2)["variables"]["a"].tolist() == [
        1.0, 2.0, 3.0, 4.0, 5.0]

    with pytest.raises(ValueError, match="not a NetCDF-3"):
        bad = str(tmp_path / "bad.nc")
        open(bad, "wb").write(b"HDF\x05notnetcdf3")
        dio.load_netcdf(bad)


def test_netcdf_timeseries(tmp_path):
    """Streaming record-dimension output: snapshots appended straight
    to disk, read back by scipy (independent) and load_netcdf."""
    scipy_io = pytest.importorskip("scipy.io")
    m = build(ndom=4, gnx=8, gny=6)
    p = str(tmp_path / "hist.nc")
    snaps = []
    with dio.NetCDFTimeSeries(p, {"ssh": m.sshn_t},
                              global_attrs={"title": "hist"}) as ts:
        for k in range(3):
            m.run(5)
            snaps.append(np.asarray(m.sshn_t.gather_inner_data()).copy())
            ts.append(time=5.0 * (k + 1))
        with pytest.raises(ValueError, match="share one grid"):
            m2 = build(ndom=1, gnx=12, gny=6)
            dio.NetCDFTimeSeries(str(tmp_path / "bad.nc"),
                                 {"a": m.sshn_t, "b": m2.sshn_t})
    d = dio.load_netcdf(p)
    assert d["dimensions"] == {"time": 3, "y": 6, "x": 8}
    assert d["variables"]["time"].tolist() == [5.0, 10.0, 15.0]
    for k in range(3):
        np.testing.assert_array_equal(d["variables"]["ssh"][k], snaps[k])
    with scipy_io.netcdf_file(p, "r", mmap=False) as nc:
        assert nc.title == b"hist"
        np.testing.assert_array_equal(nc.variables["ssh"][2], snaps[2])


def test_netcdf_int_narrowing_and_flush(tmp_path):
    """Advisor r3: integer narrowing must be range-checked (dump) and
    kind-consistent (time series), and append() must flush so the
    documented mid-stream readability actually holds on disk."""
    m = build(ndom=1, gnx=8, gny=6)

    # raw int64 within range -> int32 payload, exact round-trip
    a64 = np.arange(48, dtype=np.int64).reshape(6, 8) * 100000
    p = str(tmp_path / "ints.nc")
    dio.dump_netcdf({"codes": a64}, p)
    d = dio.load_netcdf(p)
    assert d["variables"]["codes"].dtype == np.int32
    np.testing.assert_array_equal(d["variables"]["codes"], a64)

    # out of int32 range -> refuse, never wrap
    bad = a64.copy()
    bad[0, 0] = 2**31 + 5
    with pytest.raises(ValueError, match="int32 range"):
        dio.dump_netcdf({"codes": bad}, str(tmp_path / "bad.nc"))

    # time series: int64 field stays integer (i4), not float32
    fi = dl.Field(m.grid, dl.T_POINTS, dtype=np.int64,
                  init_global_data=np.arange(48).reshape(6, 8) * 10**6)
    pts = str(tmp_path / "ints_ts.nc")
    ts = dio.NetCDFTimeSeries(pts, {"n": fi})
    ts.append(time=1.0)
    # mid-stream (pre-close): append flushed, so a reader sees record 1
    mid = dio.load_netcdf(pts)
    assert mid["dimensions"]["time"] == 1
    assert mid["variables"]["n"].dtype == np.int32
    np.testing.assert_array_equal(mid["variables"]["n"][0],
                                  np.arange(48).reshape(6, 8) * 10**6)
    # an out-of-range record refuses instead of wrapping
    fi.set_data(np.full(m.grid.array_shape, 2**31 + 7, np.int64))
    with pytest.raises(ValueError, match="range"):
        ts.append(time=2.0)
    ts.close()

    # SAME-width unsigned -> signed (uint32 -> i4) wraps at >= 2**31
    # without a width change: the range check must key on exact-dtype
    # representability, not on itemsize narrowing (advisor r3 +
    # round-4 self-review)
    fu = dl.Field(m.grid, dl.T_POINTS, dtype=np.uint32,
                  init_global_data=np.full((6, 8), 2**31 + 9, np.uint32))
    tsu = dio.NetCDFTimeSeries(str(tmp_path / "u32_ts.nc"), {"u": fu})
    with pytest.raises(ValueError, match="range"):
        tsu.append(time=1.0)
    tsu.close()


def test_dump_field(tmp_path):
    m = build(ndom=4, gnx=8, gny=6)
    p = str(tmp_path / "fld.npz")
    dio.dump_field(m.sshn_t, p)
    d = dio.load_dump(p)
    assert d["data"].shape == (6, 8)
    assert d["x"][0] == m.grid.dx
    pd = str(tmp_path / "fld.dat")
    dio.dump_field(m.sshn_t, pd, fmt="dat")
    lines = open(pd).read().strip().split("\n\n")
    assert len(lines) == 6  # one block per row
