"""Flagship model vs the independent NumPy golden (nemolite2d_golden).

Closes the shared-step_math blind spot: both production paths (one step
per exchange, and the K-step sweep) are pinned against a from-the-definition NumPy
re-derivation with different shift mechanics, different flux siting and
different rounding order — a formulation error in step_math cannot pass
here by being shared.  BASELINE.json's north star is fp64 allclose at
1024 steps for this model class.
"""
import numpy as np
import pytest

from dl_esm_inf_tpu.models import nemolite2d as nl
from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta

from dl_esm_inf_tpu.models.nemolite2d_golden import compare, golden_run


def _run_model(gnx, gny, nsteps, ssh0, *, depth=100.0, open_north=True,
               ndom=1, steps_per_sweep=1):
    m = nl.build(gnx, gny, ndomains=ndom, open_north=open_north,
                 depth=depth, steps_per_sweep=steps_per_sweep)
    m.set_initial_ssh(ssh0)
    m.run(nsteps)
    return m


def _golden(m, gnx, gny, nsteps, ssh0, depth=100.0, open_north=True):
    return golden_run(nl.default_tmask(gnx, gny, open_north), ssh0,
                      nsteps, m.p, m.grid.dx, m.grid.dy, depth)


def test_golden_short_horizon_tight():
    """10 steps: every term of every kernel is live (open boundary,
    nonzero advection) and must match to near-roundoff before any
    error accumulation blurs the comparison."""
    gnx, gny = 34, 30
    ssh0 = gaussian_eta(gnx, gny, amp=0.2)
    m = _run_model(gnx, gny, 10, ssh0)
    want = _golden(m, gnx, gny, 10, ssh0)
    got = m.gather()
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-11, atol=1e-13,
                                   err_msg=k)


@pytest.mark.parametrize("ndom", [1, 4])
def test_golden_1024_steps_jnp(ndom):
    """The BASELINE horizon on the jnp path, 1 shard and 4 shards."""
    gnx, gny = 34, 30
    ssh0 = gaussian_eta(gnx, gny, amp=0.2)
    m = _run_model(gnx, gny, 1024, ssh0, ndom=ndom)
    want = _golden(m, gnx, gny, 1024, ssh0)
    got = m.gather()
    for k in ("sshn", "un", "vn"):
        assert np.all(np.isfinite(got[k])), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, atol=1e-10,
                                   err_msg=k)


def test_golden_closed_basin():
    """Solid walls everywhere (no forcing): pure interior dynamics."""
    gnx, gny = 34, 30
    ssh0 = gaussian_eta(gnx, gny, amp=0.5)
    m = _run_model(gnx, gny, 300, ssh0, open_north=False, ndom=4)
    want = _golden(m, gnx, gny, 300, ssh0, open_north=False)
    got = m.gather()
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-11,
                                   err_msg=k)


def test_golden_variable_bathymetry():
    """Sloping depth: the streamed-ht path and derived face depths."""
    gnx, gny = 34, 30
    ssh0 = gaussian_eta(gnx, gny, amp=0.2)
    yy = np.linspace(0.0, 1.0, gny)[:, None]
    xx = np.linspace(0.0, 1.0, gnx)[None, :]
    depth = 60.0 + 50.0 * yy + 15.0 * np.sin(3.0 * np.pi * xx)
    m = _run_model(gnx, gny, 300, ssh0, depth=depth, ndom=4)
    want = _golden(m, gnx, gny, 300, ssh0, depth=depth)
    got = m.gather()
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-11,
                                   err_msg=k)


def test_golden_1024_steps_pallas_interpret():
    """The K=4 sweep (one depth-8 exchange per 4 steps) on 4 shards
    against the golden at the BASELINE horizon, so the deep-halo
    schedule is also under the oracle."""
    gnx, gny = 64, 32
    ssh0 = gaussian_eta(gnx, gny, amp=0.2)
    m = _run_model(gnx, gny, 1024, ssh0, ndom=4, steps_per_sweep=4)
    want = _golden(m, gnx, gny, 1024, ssh0)
    got = m.gather()
    for k in ("sshn", "un", "vn"):
        assert np.all(np.isfinite(got[k])), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, atol=1e-10,
                                   err_msg=k)


def test_compare_helper_accepts_the_model():
    """The comparison chip_smoke.py prints: the model after 10 steps
    is within the stated bound of the golden, field by field."""
    gnx, gny = 34, 30
    ssh0 = gaussian_eta(gnx, gny, amp=0.2)
    m = _run_model(gnx, gny, 10, ssh0, ndom=4)
    rep = compare(m.gather(), _golden(m, gnx, gny, 10, ssh0),
                  rtol=1e-11, atol=1e-13)
    assert sorted(rep) == ["sshn", "un", "vn"]
    for k, r in rep.items():
        assert r["ok"] and r["finite"], (k, r)
        assert 0.0 <= r["max_abs"] <= 1e-11, (k, r)


@pytest.mark.parametrize("fault", ["offset", "nan", "shape"])
def test_compare_helper_rejects_faults(fault):
    """A perturbed, non-finite or mis-shaped state is not ``ok``."""
    want = {"sshn": np.linspace(-1.0, 1.0, 12).reshape(3, 4)}
    got = {"sshn": want["sshn"].copy()}
    if fault == "offset":
        got["sshn"][1, 2] += 1e-3
    elif fault == "nan":
        got["sshn"][0, 0] = np.nan
    else:
        got["sshn"] = got["sshn"][:, :3]
        with pytest.raises(ValueError, match="shape"):
            compare(got, want, rtol=1e-6, atol=1e-9)
        return
    r = compare(got, want, rtol=1e-6, atol=1e-9)["sshn"]
    assert not r["ok"]
    assert r["finite"] == (fault != "nan")
    assert compare(want, want, rtol=0.0, atol=0.0)["sshn"]["ok"]
