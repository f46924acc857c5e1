"""N-layer stacked SW on multi-level fields: golden, invariance,
reduction to the two-layer model, conservation."""
import numpy as np
import pytest

from dl_esm_inf_tpu.models import nlayer as nlm
from dl_esm_inf_tpu.models import twolayer as tl
from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta


def init_eta(gnx, gny, layers, seed=0):
    e = np.zeros((layers, gny, gnx))
    e[0] = gaussian_eta(gnx, gny, amp=0.5)
    if layers > 1:
        e[1] = -gaussian_eta(gnx, gny, amp=2.0)
    return e


@pytest.mark.parametrize("layers", [1, 3, 5])
def test_vs_golden(layers):
    gnx, gny = 48, 40
    m = nlm.build(gnx, gny, ndomains=4, dt=0.01, layers=layers)
    e0 = init_eta(gnx, gny, layers)
    m.set_initial(e0)
    m.run(60)
    want = nlm.golden_reference(e0, nlm.default_tmask(gnx, gny),
                               1.0, 1.0, 0.01, 60)
    got = m.gather()
    for k in ("eta", "u", "v"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-11,
                                   atol=1e-13, err_msg=k)


def test_decomposition_invariance():
    gnx, gny, layers = 40, 32, 4
    e0 = init_eta(gnx, gny, layers)
    m1 = nlm.build(gnx, gny, ndomains=1, dt=0.01, layers=layers)
    m8 = nlm.build(gnx, gny, ndomains=8, dt=0.01, layers=layers)
    for m in (m1, m8):
        m.set_initial(e0)
        m.run(40)
    g1, g8 = m1.gather(), m8.gather()
    for k in ("eta", "u", "v"):
        np.testing.assert_allclose(g8[k], g1[k], rtol=1e-12, atol=1e-13,
                                   err_msg=k)


def test_two_layers_reduce_to_twolayer_model():
    """layers=2 with matching parameters reproduces the independent
    two-layer implementation (different state layout and level
    coupling code)."""
    gnx, gny = 40, 32
    e1 = gaussian_eta(gnx, gny, amp=0.5)
    e2 = -gaussian_eta(gnx, gny, amp=2.0)

    mn = nlm.build(gnx, gny, ndomains=4, dt=0.01, layers=2,
                   gp=0.02, thickness=[20.0, 80.0])
    mn.set_initial(np.stack([e1, e2]))
    mt = tl.build(gnx, gny, ndomains=4, dt=0.01, gp=0.02,
                  h1=20.0, h2=80.0)
    mt.set_initial(eta1_global=e1, eta2_global=e2)
    mn.run(50)
    mt.run(50)
    gn, gt = mn.gather(), mt.gather()
    np.testing.assert_allclose(gn["eta"][0], gt["eta1"], rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(gn["eta"][1], gt["eta2"], rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(gn["u"][0], gt["u1"], rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(gn["v"][1], gt["v2"], rtol=1e-10,
                               atol=1e-12)


def test_per_interface_volume_conserved():
    """Closed basin: every interface displacement integrates to a
    constant (each is the divergence of a masked transport)."""
    gnx, gny, layers = 40, 40, 3
    m = nlm.build(gnx, gny, ndomains=4, dt=0.01, layers=layers)
    e0 = init_eta(gnx, gny, layers)
    m.set_initial(e0)
    wet = nlm.default_tmask(gnx, gny) == 1
    v0 = [m.gather()["eta"][k][wet].sum() for k in range(layers)]
    m.run(150)
    v1 = [m.gather()["eta"][k][wet].sum() for k in range(layers)]
    for k in range(layers):
        assert abs(v1[k] - v0[k]) < 1e-8 * max(1.0, abs(v0[k])), k
    for arr in m.gather().values():
        assert np.all(np.isfinite(arr))


def test_jnp_comm_avoidance_matches_per_step():
    """K chained jnp steps per depth-K exchange equals the per-step
    schedule (7 steps exercises the remainder)."""
    gnx, gny, layers = 48, 40, 3
    e0 = init_eta(gnx, gny, layers)
    ma = nlm.build(gnx, gny, ndomains=4, dt=0.01, layers=layers)
    mb = nlm.build(gnx, gny, ndomains=4, dt=0.01, layers=layers,
                   halo_width=3)
    mb.set_steps_per_exchange(3)
    for m in (ma, mb):
        m.set_initial(e0)
    ma.run(7)
    mb.run(7)
    ga, gb = ma.gather(), mb.gather()
    for k in ("eta", "u", "v"):
        np.testing.assert_allclose(gb[k], ga[k], rtol=1e-12, atol=1e-13,
                                   err_msg=k)


@pytest.mark.parametrize("sweep,nsteps", [(1, 5), (3, 7)])
def test_pallas_sweep_matches_jnp(sweep, nsteps):
    """The multi-level K-step sweep on 4 shards equals the one-step
    path on one shard; K=3 with 7 steps exercises sweeps + remainder,
    K=1 pins decomposition invariance alone."""
    gnx, gny, layers = 96, 64, 3
    e0 = init_eta(gnx, gny, layers)
    ma = nlm.build(gnx, gny, ndomains=1, dt=0.01, layers=layers)
    mb = nlm.build(gnx, gny, ndomains=4, dt=0.01, layers=layers,
                   steps_per_sweep=sweep)
    for m in (ma, mb):
        m.set_initial(e0)
    ma.run(nsteps)
    mb.run(nsteps)
    ga, gb = ma.gather(), mb.gather()
    for k in ("eta", "u", "v"):
        np.testing.assert_allclose(gb[k], ga[k], rtol=1e-12, atol=1e-13,
                                   err_msg=k)


def test_validation():
    with pytest.raises(ValueError, match="layers"):
        nlm.build(16, 16, ndomains=1, layers=0)
    with pytest.raises(ValueError, match="thickness"):
        nlm.build(16, 16, ndomains=1, layers=2, thickness=[10.0, -1.0])
