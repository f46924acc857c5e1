"""Tracer transport (models/tracer.py): exact conservation through the
tmask, golden-reference equality, decomposition invariance, TVD
monotonicity, K-step sweep equality, and the DA compositions
(ensemble ETKF + 4D-Var source inversion)."""
import numpy as np
import pytest

from dl_esm_inf_tpu.models import tracer as tr
from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta


def _blob(N, amp=1.0):
    return gaussian_eta(N, N, amp=amp, width=0.08) + amp * 0.01


def _rotating(N):
    """Divergence-free rotating velocities from a streamfunction."""
    x = (np.arange(N) - N / 2 + 0.5) / N
    psi = 0.4 * np.exp(-((x[None, :] ** 2 + x[:, None] ** 2) / 0.18))
    return tr.streamfunction_velocities(psi)


@pytest.mark.parametrize("scheme", ["upwind", "vanleer"])
def test_mass_conserved_exactly(scheme):
    """Flux form + no-flux walls: tracer mass drift at roundoff over
    100 steps of rotation + diffusion."""
    N = 32
    u, v = _rotating(N)
    m = tr.build(N, N, dt=0.2, u=u, v=v, kappa=0.05, scheme=scheme)
    m.set_initial_tracer(_blob(N))
    m0 = m.mass()
    m.run(100)
    assert abs(m.mass() - m0) <= 1e-12 * abs(m0)


@pytest.mark.parametrize("scheme", ["upwind", "vanleer"])
def test_matches_golden_reference(scheme):
    """1-shard and 8-shard runs equal the independent NumPy golden."""
    N = 32
    u, v = _rotating(N)
    c0 = _blob(N)
    tmask = np.ones((N, N), np.int32)
    tmask[0, :] = tmask[-1, :] = tmask[:, 0] = tmask[:, -1] = 0
    # an interior island exercises the wet-face masking of the limiter
    tmask[12:15, 18:21] = 0
    want = tr.golden_reference(c0, tmask, u, v, dt=0.2, nsteps=40,
                               kappa=0.02, scheme=scheme)
    wet = tmask == 1
    for ndom in (1, 8):
        m = tr.build(N, N, ndomains=ndom, dt=0.2, u=u, v=v, kappa=0.02,
                     scheme=scheme, tmask=tmask)
        m.set_initial_tracer(c0)
        m.run(40)
        got = m.gather()["c"]
        np.testing.assert_allclose(got[wet], want[wet], rtol=0,
                                   atol=1e-12)


def test_tvd_no_new_extrema():
    """Both schemes keep the tracer inside its initial wet-point range
    (monotonicity/positivity at CFL < 1); the limited scheme smears a
    step profile far less than donor-cell."""
    N = 48
    c0 = np.zeros((N, N))
    c0[:, 8:16] = 1.0            # step profile advecting east
    final = {}
    for scheme in ("upwind", "vanleer"):
        m = tr.build(N, N, dt=0.5, u=0.5, v=0.0, scheme=scheme)
        m.set_initial_tracer(c0)
        m.run(40)                # travels 10 cells
        c = m.gather()["c"]
        assert c.min() >= -1e-13 and c.max() <= 1.0 + 1e-13, scheme
        final[scheme] = c
    mid = N // 2
    # interface sharpness: count cells with intermediate values
    smear = {k: int(((v[mid] > 0.05) & (v[mid] < 0.95)).sum())
             for k, v in final.items()}
    assert smear["vanleer"] < smear["upwind"]


@pytest.mark.parametrize("scheme,K", [("upwind", 1), ("upwind", 4),
                                      ("vanleer", 1), ("vanleer", 2)])
def test_pallas_interpret_matches_jnp(scheme, K):
    """The K-step sweep on 4 shards equals the one-step path on one
    shard — same step math, reach 1 and 2; K=1 pins decomposition
    invariance alone.  Tolerance is ONE ulp (atol 1e-15 on O(1e-2)
    values): XLA:CPU's excess-precision mul+add contraction differs at
    the two programs' fusion boundaries at a handful of points
    (measured 1.7e-18, i.e. the last bit); the selects, rolls and
    masks are pinned exactly by the conservation and golden tests
    above."""
    N = 32
    u, v = _rotating(N)
    c0 = _blob(N)
    mj = tr.build(N, N, ndomains=1, dt=0.2, u=u, v=v, kappa=0.02,
                  scheme=scheme)
    mj.set_initial_tracer(c0)
    mj.run(8)
    mp = tr.build(N, N, ndomains=4, dt=0.2, u=u, v=v, kappa=0.02,
                  scheme=scheme, steps_per_sweep=K)
    mp.set_initial_tracer(c0)
    mp.run(8)
    np.testing.assert_allclose(mp.gather()["c"], mj.gather()["c"],
                               rtol=0, atol=1e-15)


def test_comm_avoiding_jnp_sweep_matches():
    """K chained steps per depth-2K exchange (vanleer reach 2) == the
    plain per-step-exchange path."""
    N = 32
    u, v = _rotating(N)
    c0 = _blob(N)
    m1 = tr.build(N, N, dt=0.2, u=u, v=v, scheme="vanleer")
    m1.set_initial_tracer(c0)
    m1.run(6)
    m2 = tr.build(N, N, dt=0.2, u=u, v=v, scheme="vanleer",
                  steps_per_sweep=2)
    m2.set_initial_tracer(c0)
    m2.run(6)
    np.testing.assert_array_equal(m2.gather()["c"], m1.gather()["c"])


def test_source_inversion_4dvar():
    """The DA composition: observing the tracer field at two later
    times recovers the initial release by L-BFGS on the AD gradient
    (the pollutant source-identification workflow)."""
    from dl_esm_inf_tpu.core import layout
    from dl_esm_inf_tpu.models.assimilation import assimilate
    N = 24
    u, v = _rotating(N)
    c_true = _blob(N, amp=0.8)
    truth = tr.build(N, N, dt=0.3, u=u, v=v, kappa=0.01)
    truth.set_initial_tracer(c_true)
    obs = {}
    done = 0
    for t in (5, 10):
        truth.run(t - done)
        done = t
        obs[t] = truth.gather()["c"]

    m = tr.build(N, N, dt=0.3, u=u, v=v, kappa=0.01)
    res = assimilate(m, obs, iters=60, optimizer="lbfgs",
                     remat_chunk=2)
    hist = res["cost_history"]
    assert hist[-1] < 1e-8 * hist[0]
    wet = layout.unstack_internal(
        m.grid.decomp, np.asarray(m._t_upd)).astype(bool)
    err = np.abs((res["eta0"] - c_true) * wet).max()
    assert err < 1e-3 * np.abs(c_true).max()


def test_ensemble_and_etkf_compose():
    """The tracer rides the ensemble runner (members bitwise equal to
    sequential runs) and the ETKF analysis reduces the innovation."""
    from dl_esm_inf_tpu.models.enkf import ETKF
    from dl_esm_inf_tpu.models.ensemble import Ensemble
    N, M = 24, 4
    u, v = _rotating(N)
    rng = np.random.default_rng(2)
    base = _blob(N)
    perts = np.stack([0.1 * rng.standard_normal((N, N))
                      for _ in range(M)])

    truth = tr.build(N, N, dt=0.3, u=u, v=v)
    truth.set_initial_tracer(base + perts.mean(0)
                             + 0.4 * (perts[0] - perts[2]))
    truth.run(5)
    y = truth.gather()["c"]

    m = tr.build(N, N, dt=0.3, u=u, v=v)
    ens = Ensemble(m, M)
    ens.set_member_states(0, base + perts)
    ens.run(5)
    # member 0 == a sequential run of the same start (1-ulp tolerance:
    # the batched and single programs fuse differently on XLA:CPU and
    # its excess-precision mul+add contraction flips the last bit at a
    # few points — same story as the interpret-equality test above)
    seq = tr.build(N, N, dt=0.3, u=u, v=v)
    seq.set_initial_tracer(base + perts[0])
    seq.run(5)
    np.testing.assert_allclose(ens.member(0)["c"], seq.gather()["c"],
                               rtol=0, atol=1e-14)

    diag = ETKF(ens, sigma=1e-3).analysis(y)
    assert diag["rms_innovation_after"] < 0.2 * diag[
        "rms_innovation_before"]


def _coupled(N, ndom=None, **kw):
    from dl_esm_inf_tpu.models import nemolite2d as nl
    fs = nl.build(N, N, ndomains=ndom, open_north=True,
                  halo_width=2)
    return tr.CoupledTracer(fs, **kw)


def test_coupled_flow_untouched_and_mass_conserved():
    """Online coupling: the coupled flagship trajectory equals a plain
    flagship run (the tracer is passive), and tracer mass is conserved
    through the evolving flow."""
    from dl_esm_inf_tpu.models import nemolite2d as nl
    N = 32
    ssh0 = gaussian_eta(N, N, amp=0.2)
    plain = nl.build(N, N, open_north=True, halo_width=2)
    plain.set_initial_ssh(ssh0)
    plain.run(12)

    ct = _coupled(N, kappa=0.01)
    ct.flagship.set_initial_ssh(ssh0)
    ct.set_initial_tracer(_blob(N))
    m0 = ct.mass()
    ct.run(12)
    assert abs(ct.mass() - m0) <= 1e-12 * abs(m0)
    g, gp = ct.gather(), plain.gather()
    for k in ("sshn", "un", "vn"):
        # 1-ulp tolerance: different program shape -> different XLA
        # fusion/contraction choices (same story as the tests above)
        np.testing.assert_allclose(g[k], gp[k], rtol=0, atol=1e-13)


def test_coupled_quiescent_matches_standalone():
    """With a quiescent flagship (zero initial state, no forcing
    reaching the interior in 6 steps... the tide only enters through
    the open boundary), a diffusion-only coupled tracer matches the
    standalone model with u = v = 0 where the flow is still zero —
    pinned globally for the first steps of a CLOSED basin."""
    from dl_esm_inf_tpu.models import nemolite2d as nl
    N = 24
    c0 = _blob(N)
    fs = nl.build(N, N, open_north=False,
                  halo_width=2)         # closed, quiescent basin
    kappa = 1.0e4                       # dx = 1 km, dt 20 s -> 0.2/axis
    ct = tr.CoupledTracer(fs, kappa=kappa)
    ct.set_initial_tracer(c0)
    ct.run(6)

    # standalone twin on a MATCHING grid (the flagship's 1 km spacing)
    msa = tr.build(N, N, dt=fs.p.rdt, u=0.0, v=0.0, kappa=kappa,
                   dx=1000.0, dy=1000.0)
    msa.set_initial_tracer(c0)
    msa.run(6)
    np.testing.assert_allclose(ct.gather()["c"], msa.gather()["c"],
                               rtol=0, atol=1e-13)


def test_coupled_decomposition_invariant():
    """1-shard == 8-shard for the coupled run."""
    N = 32
    ssh0 = gaussian_eta(N, N, amp=0.2)
    got = {}
    for ndom in (1, 8):
        ct = _coupled(N, ndom=ndom, kappa=0.01)
        ct.flagship.set_initial_ssh(ssh0)
        ct.set_initial_tracer(_blob(N))
        ct.run(10)
        got[ndom] = ct.gather()
    for k in got[1]:
        np.testing.assert_allclose(got[8][k], got[1][k],
                                   rtol=0, atol=1e-11)


def test_coupled_source_inversion_through_evolving_flow():
    """4D-Var drives the COUPLED model: observing the plume at two
    later times recovers the initial release while the tidal flow
    evolves underneath (the flow state is captured as constants; the
    adjoint runs through advection BY that evolving flow).  Uses the
    checkpointed loop and the obs_state_index observation selector."""
    from dl_esm_inf_tpu.core import layout
    from dl_esm_inf_tpu.models.assimilation import assimilate
    N = 32
    c_true = _blob(N, amp=0.8)

    truth = _coupled(N, kappa=0.01)
    truth.flagship.set_initial_ssh(gaussian_eta(N, N, amp=0.2))
    truth.set_initial_tracer(c_true)
    obs, done = {}, 0
    for t in (5, 10):
        truth.run(t - done)
        done = t
        obs[t] = truth.gather()["c"]

    m = _coupled(N, kappa=0.01)
    m.flagship.set_initial_ssh(gaussian_eta(N, N, amp=0.2))
    res = assimilate(m, obs, iters=50, optimizer="lbfgs",
                     remat_chunk=2, obs_state_index=3)
    hist = res["cost_history"]
    assert hist[-1] < 1e-8 * hist[0]
    wet = layout.unstack_internal(
        m.grid.decomp, np.asarray(m._t_upd)).astype(bool)
    err = np.abs((res["eta0"] - c_true) * wet).max()
    assert err < 1e-3 * np.abs(c_true).max()


def test_coupled_ensemble_plume_obs_corrects_flow():
    """Ensembles of ONLINE-COUPLED members: each advances its own flow
    and tracer in one program (members == sequential coupled runs),
    and an ETKF analysis of the PLUME corrects the FLOW through the
    ensemble cross-covariances — the source/flow-inference workflow."""
    from dl_esm_inf_tpu.models.enkf import ETKF
    from dl_esm_inf_tpu.models.ensemble import Ensemble
    N, M = 32, 5
    rng = np.random.default_rng(3)
    base = gaussian_eta(N, N, amp=0.2)
    perts = np.stack([0.05 * rng.standard_normal((N, N))
                      for _ in range(M)])
    c0 = _blob(N)

    def fresh(ssh0):
        ct = _coupled(N, kappa=0.01)
        ct.flagship.set_initial_ssh(ssh0)
        ct.set_initial_tracer(c0)
        return ct

    truth = fresh(base + perts.mean(0) + 0.5 * (perts[0] - perts[2]))
    truth.run(8)
    y = truth.gather()["c"]

    ens = Ensemble(fresh(base), M)
    ens.set_member_states(0, np.stack([base + p for p in perts]))
    ens.run(8)
    # member 0 == its sequential coupled run (1-ulp program-pair tol)
    seq = fresh(base + perts[0])
    seq.run(8)
    gm0 = ens.member(0)
    gs = seq.gather()
    for a, b in (("ssh", "sshn"), ("u", "un"), ("v", "vn"),
                 ("c", "c")):
        np.testing.assert_allclose(gm0[a], gs[b], rtol=0, atol=1e-13,
                                   err_msg=a)

    before = ens.gather_all()
    diag = ETKF(ens, obs_field="c", sigma=1e-3).analysis(y)
    after = ens.gather_all()
    assert diag["rms_innovation_after"] < 0.7 * diag[
        "rms_innovation_before"]
    # the flow moved too: plume observations inform the velocities
    assert np.abs(after["u"] - before["u"]).max() > 1e-7
    assert np.abs(after["ssh"] - before["ssh"]).max() > 1e-7


def test_guards():
    with pytest.raises(ValueError, match="scheme"):
        tr.build(16, 16, scheme="weno")
    # a direct TracerModel on a too-shallow halo fails at build time
    # with a clear message, not an opaque trace error (review fix)
    import dl_esm_inf_tpu as dl
    g1 = dl.Grid(dl.ARAKAWA_C,
                 (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                 dl.OFFSET_NE)
    g1.decompose(16, 16, halo_width=1)
    dl.grid_init(g1, 1.0, 1.0)
    with pytest.raises(ValueError, match="halo_width >= 2"):
        tr.TracerModel(g1, dt=0.1, u=0.1, v=0.0, scheme="vanleer")
    from dl_esm_inf_tpu.models import nemolite2d as nl
    with pytest.raises(TypeError, match="NemoLite2D"):
        tr.CoupledTracer(object())
    fsp = nl.build(32, 32, steps_per_sweep=2)
    with pytest.raises(ValueError, match="one-step path"):
        tr.CoupledTracer(fsp)
