"""REAL multi-process execution — the reference CI's ``mpirun -np 2``
analogue (makefile-test.yml:59), with jax.distributed stitching two
4-device processes into one 8-device mesh.

This is the only test that executes the multi-controller code paths for
real: environment.initialise()'s jax.distributed bring-up, halo
exchanges whose seams cross a PROCESS boundary, cross-process psum
checksums, and the process_allgather-based gathers.  Results must equal
this (single-process, 8-device) test process running the identical
program.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import dl_esm_inf_tpu as dl
from dl_esm_inf_tpu.testing import init_field_hill

HERE = os.path.dirname(os.path.abspath(__file__))


def _run_gang(tmp_path_factory, nproc, port, ndev=4, mode="full"):
    """Spawn one jax.distributed gang of ``nproc`` workers and return
    process 0's results.  Gangs run one at a time (module-scoped
    fixtures resolve sequentially) — concurrent XLA:CPU collective
    programs deadlock (CLAUDE.md)."""
    out = str(tmp_path_factory.mktemp(f"mp{nproc}") / "mp0.npz")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(HERE)] + sys.path)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "mp_worker.py"),
         str(pid), str(nproc), out, str(port), str(ndev), mode],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(nproc)]
    logs = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"{nproc}-process workers timed out")
        logs.append(o)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    return dict(np.load(out))


@pytest.fixture(scope="module")
def mp_results(tmp_path_factory):
    return _run_gang(tmp_path_factory, nproc=2, port=12957)


@pytest.fixture(scope="module")
def mp4_results(tmp_path_factory):
    """np=4, 2 devices each: 8-device mesh whose PROCESS seams land on
    both mesh axes at once (the reference CI's np=4 xy-split,
    dist_mem/Makefile:64-80)."""
    return _run_gang(tmp_path_factory, nproc=4, port=12961, ndev=2,
                     mode="core")


@pytest.fixture(scope="module")
def mp6_results(tmp_path_factory):
    """np=6, 1 device each: the reference CI's forced NON-SQUARE 3x2
    process grid (makefile-test.yml:59-63) — every seam is a process
    seam."""
    return _run_gang(tmp_path_factory, nproc=6, port=12963, ndev=1,
                     mode="core")


def test_multiprocess_matches_single_process(mp_results):
    """The 2-process 8-device run reproduces this process's own
    single-controller 8-device run bit-for-bit."""
    gnx, gny = 24, 20
    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                   dl.OFFSET_NE)
    grid.decompose(gnx, gny, ndomains=8)
    dl.grid_init(grid, 1.0, 1.0)
    fld = dl.Field(grid, dl.T_POINTS)
    init_field_hill(fld, -666.0)
    fld.halo_exchange(1)
    np.testing.assert_array_equal(mp_results["hill"], fld.get_data())

    ones = dl.Field(grid, dl.T_POINTS,
                    init_global_data=np.ones((gny, gnx)))
    assert float(mp_results["gsum"]) == float(dl.field_checksum(ones))
    assert float(mp_results["gsum"]) == gnx * gny

    vals = np.arange(gnx * gny, dtype=float).reshape(gny, gnx)
    np.testing.assert_array_equal(mp_results["roundtrip"], vals + 1.0)


def test_multiprocess_periodic_and_checkpoint(mp_results):
    """Periodic wrap crossing the process boundary + the orbax
    sharded checkpoint cycle (each process writes only its shards)."""
    pgrid = dl.Grid(dl.ARAKAWA_C,
                    (dl.BC_PERIODIC, dl.BC_PERIODIC, dl.BC_NONE),
                    dl.OFFSET_NE)
    pgrid.decompose(16, 16, ndomains=8)
    dl.grid_init(pgrid, 1.0, 1.0)
    pf = dl.Field(pgrid, dl.T_POINTS,
                  init_global_data=np.arange(256.0).reshape(16, 16))
    pf.halo_exchange(1)
    np.testing.assert_array_equal(mp_results["periodic"], pf.get_data())
    assert float(mp_results["ck_ok"]) == 1.0


def test_multiprocess_flagship_matches(mp_results):
    from dl_esm_inf_tpu.models import nemolite2d as nl
    from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta

    m = nl.build(32, 32, ndomains=8, open_north=True)
    m.set_initial_ssh(gaussian_eta(32, 32, amp=0.2))
    m.run(10)
    g = m.gather()
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(mp_results[f"nl_{k}"], g[k],
                                   rtol=1e-12, atol=1e-13, err_msg=k)


def _check_core_legs(results, ndom):
    """hill + checksum + round-trip + flagship vs THIS process's own
    single-controller run at the same decomposition (bit-for-bit)."""
    gnx, gny = 24, 20
    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                   dl.OFFSET_NE)
    grid.decompose(gnx, gny, ndomains=ndom)
    dl.grid_init(grid, 1.0, 1.0)
    fld = dl.Field(grid, dl.T_POINTS)
    init_field_hill(fld, -666.0)
    fld.halo_exchange(1)
    np.testing.assert_array_equal(results["hill"], fld.get_data())

    ones = dl.Field(grid, dl.T_POINTS,
                    init_global_data=np.ones((gny, gnx)))
    assert float(results["gsum"]) == float(dl.field_checksum(ones))
    assert float(results["gsum"]) == gnx * gny

    vals = np.arange(gnx * gny, dtype=float).reshape(gny, gnx)
    np.testing.assert_array_equal(results["roundtrip"], vals + 1.0)

    from dl_esm_inf_tpu.models import nemolite2d as nl
    from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta
    m = nl.build(32, 32, ndomains=ndom, open_north=True)
    m.set_initial_ssh(gaussian_eta(32, 32, amp=0.2))
    m.run(10)
    g = m.gather()
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(results[f"nl_{k}"], g[k],
                                   rtol=1e-12, atol=1e-13, err_msg=k)


def test_multiprocess_np4_xy_seams_match_single_process(mp4_results):
    """4 REAL processes x 2 devices: a process boundary on BOTH mesh
    axes at once (reference np=4 xy-split, dist_mem/Makefile:64-80)."""
    _check_core_legs(mp4_results, ndom=8)


def test_multiprocess_np6_nonsquare_matches_single_process(mp6_results):
    """6 REAL processes x 1 device: the reference's forced non-square
    3x2 process grid (makefile-test.yml:59-63)."""
    import dl_esm_inf_tpu.core.decomposition as dc
    px, py = dc.choose_process_grid(6, 24, 20)
    assert {px, py} == {2, 3}, "np=6 must force a non-square grid"
    _check_core_legs(mp6_results, ndom=6)


def test_launcher(tmp_path):
    """python -m dl_esm_inf_tpu.launch: the mpirun-style local launcher
    spawns N processes that see one global mesh with zero platform
    boilerplate in the user script."""
    from dl_esm_inf_tpu.launch import launch
    script = tmp_path / "prog.py"
    script.write_text(
        "import dl_esm_inf_tpu as dl\n"
        "import jax, numpy as np\n"
        "dl.initialise()\n"
        "assert jax.process_count() == 2, jax.process_count()\n"
        "assert len(jax.devices()) == 4\n"
        "grid = dl.Grid(dl.ARAKAWA_C,\n"
        "               (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),\n"
        "               dl.OFFSET_NE)\n"
        "grid.decompose(8, 8, ndomains=4)\n"
        "dl.grid_init(grid, 1.0, 1.0)\n"
        "f = dl.Field(grid, dl.T_POINTS,\n"
        "             init_global_data=np.ones((8, 8)))\n"
        "assert dl.field_checksum(f) == 64.0\n")
    env = dict(os.environ)
    for k in list(env):
        if k.startswith(("JAX_", "XLA_")):
            env.pop(k)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(HERE)] + sys.path)
    rc = launch(str(script), [], num_processes=2,
                devices_per_process=2, base_env=env)
    assert rc == 0


def test_launch_aborts_gang_on_rank_failure(tmp_path):
    """A dying rank terminates the rest immediately (mpirun-style
    abort), instead of survivors blocking until a coordinator
    timeout."""
    import time as _time
    from dl_esm_inf_tpu.launch import launch

    script = tmp_path / "boom.py"
    script.write_text(
        "import os, sys, time\n"
        "if os.environ['JAX_PROCESS_ID'] == '1':\n"
        "    sys.exit(3)\n"
        "time.sleep(120)\n")
    t0 = _time.monotonic()
    rc = launch(str(script), [], num_processes=2)
    assert rc == 3
    assert _time.monotonic() - t0 < 60


def test_multiprocess_fused_schedule_matches(mp_results):
    """The fused schedule tier (one deep exchange per sweep) across REAL
    process boundaries == the same program single-process."""
    from dl_esm_inf_tpu.api.kernel_meta import (GO_READ, GO_WRITE,
                                                GO_CT, Schedule, go_arg,
                                                go_stencil, kernel)
    from dl_esm_inf_tpu.ops import stencils as st

    @kernel(args=[go_arg(GO_WRITE, GO_CT),
                  go_arg(GO_READ, GO_CT, go_stencil(0, 11, 0))])
    def sp_east(out, x):
        return st.xp(x)

    fgrid = dl.Grid(dl.ARAKAWA_C,
                    (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                    dl.OFFSET_NE)
    fgrid.decompose(32, 32, ndomains=8, halo_width=2, align_y=8)
    dl.grid_init(fgrid, 1.0, 1.0)
    fa = dl.Field(fgrid, dl.T_POINTS,
                  init_global_data=np.arange(32.0 * 32).reshape(32, 32))
    fb = dl.Field(fgrid, dl.T_POINTS)
    Schedule((sp_east, fb, fa), (sp_east, fb, fb)).fused()
    np.testing.assert_array_equal(mp_results["fused_sched"],
                                  fb.gather_inner_data())


def test_multiprocess_semi_implicit_matches(mp_results):
    """The in-step CG's psum dot products cross the process boundary:
    the 2-process implicit run matches the single-process one (tiny
    reduction-order drift amplified through alpha/beta is the only
    allowed difference)."""
    from dl_esm_inf_tpu.models import semi_implicit as si
    m = si.build(24, 24, ndomains=8, dt=1.0, depth=10.0, tol=1e-11)
    m.set_initial_eta(si.gaussian_eta(24, 24, amp=0.5))
    m.run(5)
    g = m.gather()
    for k in ("eta", "u", "v"):
        np.testing.assert_allclose(mp_results[f"si_{k}"], g[k],
                                   rtol=0, atol=1e-9)

    mo = si.build(24, 24, ndomains=8, dt=1.0, depth=10.0, tol=1e-11,
                  open_north=True, bc_amp=0.05)
    mo.run(5)
    go = mo.gather()
    for k in ("eta", "u", "v"):
        np.testing.assert_allclose(mp_results[f"sio_{k}"], go[k],
                                   rtol=0, atol=1e-9)


def test_multiprocess_etkf_matches(mp_results):
    """Ensemble forecast + ETKF analysis + forecast across REAL process
    boundaries == single-process: the psum'd (M, M) obs moments and the
    replicated eigendecomposition agree to reduction-order roundoff."""
    from dl_esm_inf_tpu.models import gravity_wave as gwm
    from dl_esm_inf_tpu.models.enkf import ETKF
    from dl_esm_inf_tpu.models.ensemble import Ensemble
    from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta

    gm = gwm.build(24, 24, ndomains=8, dt=0.05, depth=10.0)
    rng = np.random.default_rng(5)
    base = gaussian_eta(24, 24, amp=0.3)
    ens = Ensemble(gm, 4)
    ens.set_member_states(0, np.stack(
        [base + 0.1 * rng.standard_normal((24, 24)) for _ in range(4)]))
    ens.run(4)
    ETKF(ens, sigma=0.02).analysis(gaussian_eta(24, 24, amp=0.35))
    ens.run(2)
    for k, v in ens.gather_all().items():
        np.testing.assert_allclose(mp_results[f"ek_{k}"], v,
                                   rtol=0, atol=1e-9)

    omask = np.zeros((24, 24))
    omask[3:21:3, 3:21:3] = 1.0
    ETKF(ens, sigma=0.02, localization_radius=4.0).analysis(
        gaussian_eta(24, 24, amp=0.3), obs_mask=omask)
    ens.run(2)
    for k, v in ens.gather_all().items():
        np.testing.assert_allclose(mp_results[f"lk_{k}"], v,
                                   rtol=0, atol=1e-9)


def test_multiprocess_tracer_matches(mp_results):
    """The van-Leer tracer (reach-2 stencil, limiter at ragged wet
    edges) across REAL process boundaries == single-process."""
    from dl_esm_inf_tpu.models import tracer as trm
    from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta

    tu, tv = trm.streamfunction_velocities(
        0.4 * gaussian_eta(24, 24, amp=1.0, width=0.2))
    mt = trm.build(24, 24, ndomains=8, dt=0.2, u=tu, v=tv, kappa=0.02)
    mt.set_initial_tracer(gaussian_eta(24, 24, amp=1.0) + 0.01)
    mt.run(8)
    np.testing.assert_allclose(mp_results["tr_c"], mt.gather()["c"],
                               rtol=0, atol=1e-12)
