"""The K-step sweep schedule (ops/sweep.py) vs the one-step path: K
steps after one depth-K*reach exchange share the step's physics, so
interior results must agree to roundoff on every client, at every
state dtype the grid supports.
"""
import numpy as np
import pytest

from dl_esm_inf_tpu.models import nemolite2d as nl
from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta


def _build(steps_per_sweep=1, gnx=96, gny=64, ndomains=1, dtype=None):
    m = nl.build(gnx, gny, ndomains=ndomains, halo_width=2,
                 open_north=True, steps_per_sweep=steps_per_sweep,
                 dtype=dtype)
    m.set_initial_ssh(gaussian_eta(gnx, gny, amp=0.5))
    return m


@pytest.mark.parametrize("K", [2, 3])
def test_fused_step_matches_jnp(K):
    ma = _build()
    mb = _build(steps_per_sweep=K)
    ma.run(6)
    mb.run(6)
    ga, gb = ma.gather(), mb.gather()
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(gb[k], ga[k], rtol=1e-12, atol=1e-13,
                                   err_msg=k)
        assert np.all(np.isfinite(gb[k])), k


def test_fused_step_single_tile():
    """A shard no wider than its halo ring plus a few cells: the whole
    block is eroded ring but the interior still matches."""
    ma = _build(gnx=12, gny=10, ndomains=4)
    mb = _build(steps_per_sweep=2, gnx=12, gny=10, ndomains=4)
    ma.run(3)
    mb.run(3)
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(mb.gather()[k], ma.gather()[k],
                                   rtol=1e-12, atol=1e-13, err_msg=k)


@pytest.mark.parametrize("ndom", [1, 4])
def test_temporal_blocking_matches_plain(ndom):
    """K=2 (one depth-4 exchange per 2 steps) must reproduce the
    per-step schedule exactly; 7 steps exercises the sweep
    remainder."""
    ma = _build(ndomains=ndom)
    mb = _build(steps_per_sweep=2, ndomains=ndom)
    ma.run(7)
    mb.run(7)
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(mb.gather()[k], ma.gather()[k],
                                   rtol=1e-12, atol=1e-13, err_msg=k)


def test_temporal_blocking_guards():
    m = nl.build(32, 32, ndomains=1, halo_width=2)
    with pytest.raises(ValueError, match="halo_width >= 4"):
        m.set_steps_per_exchange(2)


@pytest.mark.parametrize("sweep,nsteps", [(1, 5), (3, 7)])
def test_gravity_wave_sweep_matches_jnp(sweep, nsteps):
    """Second client on the sweep engine (reach-1 physics); K=3 with 7
    steps exercises sweeps + remainder."""
    from dl_esm_inf_tpu.models import gravity_wave as gw
    gnx, gny = 96, 64
    ma = gw.build(gnx, gny, ndomains=4)
    mb = gw.build(gnx, gny, ndomains=4, steps_per_sweep=sweep)
    for m in (ma, mb):
        m.set_initial_eta(gaussian_eta(gnx, gny, amp=0.5))
    ma.run(nsteps)
    mb.run(nsteps)
    for k in ("eta", "u", "v"):
        np.testing.assert_allclose(mb.gather()[k], ma.gather()[k],
                                   rtol=1e-12, atol=1e-13, err_msg=k)


def test_gravity_wave_sweep_vs_golden():
    from dl_esm_inf_tpu.models import gravity_wave as gw
    gnx, gny = 96, 64
    m = gw.build(gnx, gny, ndomains=4, steps_per_sweep=4)
    eta0 = gaussian_eta(gnx, gny, amp=0.5)
    m.set_initial_eta(eta0)
    m.run(40)
    want = gw.golden_reference(eta0, gw.default_tmask(gnx, gny), 1.0, 1.0,
                               m.dt, 40, depth=m.depth)
    got = m.gather()
    for k in ("eta", "u", "v"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("sweep,nsteps", [(1, 5), (4, 10)])
def test_shallow_sweep_matches_jnp(sweep, nsteps):
    """Third client: SW offset + doubly-periodic wrap riding the
    depth-K exchange between sweeps (no masks at all)."""
    from dl_esm_inf_tpu.models import shallow as sh
    gnx, gny = 96, 64
    ma = sh.build(gnx, gny, ndomains=4, dt=0.01)
    mb = sh.build(gnx, gny, ndomains=4, dt=0.01, steps_per_sweep=sweep)
    eta0 = np.random.default_rng(0).normal(size=(gny, gnx)) * 0.1
    for m in (ma, mb):
        m.set_initial_eta(eta0)
    ma.run(nsteps)
    mb.run(nsteps)
    for k in ("eta", "u", "v"):
        np.testing.assert_allclose(mb.gather()[k], ma.gather()[k],
                                   rtol=1e-12, atol=1e-13, err_msg=k)


def test_fused_step_guards():
    with pytest.raises(ValueError, match="steps_per_sweep"):
        nl.build(32, 32, ndomains=1, steps_per_sweep=0)
    from dl_esm_inf_tpu.ops.sweep import make_stencil_sweep
    m = nl.build(32, 32, ndomains=1, halo_width=2)
    with pytest.raises(ValueError, match="halo_width >= 6"):
        make_stencil_sweep(lambda s, p, c: s, spec=m.grid.halo_spec,
                           steps_per_sweep=3, reach=2)
    m = nl.build(32, 32, ndomains=1, steps_per_sweep=2)
    with pytest.raises(ValueError, match="overlap"):
        m.step_program(4, overlap=True)


# Tolerances by state dtype, fixed before the runs: the K-step and the
# one-step programs evaluate the same operations in the same order, but
# XLA may keep a fused intermediate at higher precision in one program
# and round it in the other — an ulp of the state dtype per step.
_SWEEP_TOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 6e-2}


@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("client", ["nemolite2d", "gravity_wave"])
def test_sweep_state_dtypes(client, dtype, K):
    """The engine takes any state dtype (the compiled-kernel refusals
    of f64 and bf16 state are gone): K-step == one-step per client."""
    import importlib
    mod = importlib.import_module(f"dl_esm_inf_tpu.models.{client}")
    gnx, gny = 48, 40

    def make(k):
        if client == "nemolite2d":
            m = mod.build(gnx, gny, ndomains=4, halo_width=2, dtype=dtype,
                          steps_per_sweep=k)
            m.set_initial_ssh(gaussian_eta(gnx, gny, amp=0.5))
        else:
            m = mod.build(gnx, gny, ndomains=4, dtype=dtype,
                          steps_per_sweep=k)
            m.set_initial_eta(gaussian_eta(gnx, gny, amp=0.5))
        m.run(2 * K + 1)
        return m.gather()

    ga, gb = make(1), make(K)
    tol = _SWEEP_TOL[dtype]
    for k in ga:
        a = np.asarray(ga[k], np.float64)
        b = np.asarray(gb[k], np.float64)
        assert np.all(np.isfinite(b)), k
        np.testing.assert_allclose(b, a, rtol=tol,
                                   atol=tol * max(np.abs(a).max(), 1e-30),
                                   err_msg=f"{client} {dtype} K={K} {k}")


@pytest.mark.parametrize("model", ["gravity_wave", "shallow", "twolayer"])
def test_jnp_comm_avoidance_reach1_models(model):
    """set_steps_per_exchange (K jnp steps per depth-K exchange) must
    equal the per-step schedule on every reach-1 client; 7 steps
    exercises the remainder."""
    import importlib
    mod = importlib.import_module(f"dl_esm_inf_tpu.models.{model}")
    gnx, gny = 96, 64

    def init(m):
        if model == "twolayer":
            m.set_initial(eta1_global=gaussian_eta(gnx, gny, amp=0.5))
        elif model == "shallow":
            m.set_initial_eta(gaussian_eta(gnx, gny, amp=0.3))
        else:
            m.set_initial_eta(gaussian_eta(gnx, gny, amp=0.5))
        return m

    dt = {"gravity_wave": 0.05, "shallow": 0.01, "twolayer": 0.01}[model]
    ma = init(mod.build(gnx, gny, ndomains=4, dt=dt))
    mb = init(mod.build(gnx, gny, ndomains=4, dt=dt, halo_width=3))
    mb.set_steps_per_exchange(3)
    ma.run(7)
    mb.run(7)
    ga, gb = ma.gather(), mb.gather()
    for k in ga:
        np.testing.assert_allclose(gb[k], ga[k], rtol=1e-12, atol=1e-13,
                                   err_msg=f"{model} {k}")


def test_step_program_cache_hits():
    m = _build(gnx=64, gny=32)
    assert m.step_program(10) is m.step_program(10)
    assert m.step_program(10) is not m.step_program(10, overlap=True)
