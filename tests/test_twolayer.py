"""Two-layer SW: six-field state on the framework + sweep engine."""
import numpy as np
import pytest

from dl_esm_inf_tpu.models import twolayer as tl
from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta


def build(gnx=48, gny=40, ndom=1, **kw):
    m = tl.build(gnx, gny, ndomains=ndom, dt=0.01, **kw)
    m.set_initial(eta1_global=gaussian_eta(gnx, gny, amp=0.5),
                  eta2_global=-gaussian_eta(gnx, gny, amp=2.0))
    return m


@pytest.mark.parametrize("ndom", [1, 4])
def test_allclose_vs_golden(ndom):
    gnx, gny, nsteps = 48, 40, 100
    m = build(gnx, gny, ndom)
    e1 = gaussian_eta(gnx, gny, amp=0.5)
    e2 = -gaussian_eta(gnx, gny, amp=2.0)
    m.run(nsteps)
    want = tl.golden_reference(e1, e2, tl.default_tmask(gnx, gny),
                               1.0, 1.0, m.dt, nsteps)
    got = m.gather()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12,
                                   err_msg=k)


def test_decomposition_invariance():
    m1 = build(ndom=1)
    m6 = build(ndom=6)
    m1.run(60)
    m6.run(60)
    for k, v in m1.gather().items():
        np.testing.assert_allclose(m6.gather()[k], v, rtol=1e-12,
                                   atol=1e-13, err_msg=k)


def test_baroclinic_mode_is_live():
    """An interface displacement with flat surface must evolve (the
    internal mode), and total mass per layer is conserved."""
    gnx = gny = 48
    m = tl.build(gnx, gny, ndomains=4, dt=0.01)
    m.set_initial(eta2_global=gaussian_eta(gnx, gny, amp=3.0))
    g0 = m.gather()
    wet = tl.default_tmask(gnx, gny) == 1
    m.run(400)
    g = m.gather()
    assert not np.allclose(g["eta2"], g0["eta2"], atol=1e-6)
    # the interlayer coupling must imprint the interface on the
    # (initially flat) surface — decoupled layers would leave eta1 ~ 0
    assert np.abs(g["eta1"][wet]).max() > 1e-4
    for k in ("eta1", "eta2"):
        assert np.all(np.isfinite(g[k])), k
        assert abs(g[k][wet].sum() - g0[k][wet].sum()) < 1e-8


@pytest.mark.parametrize("sweep,nsteps", [(1, 5), (4, 10)])
def test_sweep_matches_jnp(sweep, nsteps):
    """K steps per exchange on 4 shards == one step per exchange on one
    shard (K=1 pins decomposition invariance alone)."""
    ma = build(96, 64, ndom=1)
    mb = build(96, 64, ndom=4, steps_per_sweep=sweep)
    mb.set_initial(eta1_global=gaussian_eta(96, 64, amp=0.5),
                   eta2_global=-gaussian_eta(96, 64, amp=2.0))
    ma.run(nsteps)
    mb.run(nsteps)
    ga, gb = ma.gather(), mb.gather()
    for k in ga:
        np.testing.assert_allclose(gb[k], ga[k], rtol=1e-12, atol=1e-13,
                                   err_msg=k)
