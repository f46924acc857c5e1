"""The PSy-style flagship (pure metadata kernels + one Schedule) vs
the production model.

models/nemolite2d_psy.py is the GOcean-client shape: every kernel
declared with go_arg metadata, the step bound as one Schedule.  All
three execution tiers must reproduce the production jnp model, which
is itself pinned to the independent NumPy golden — so the metadata
layer's exchange planning, masking and fused-sweep transform are all
under the golden transitively."""
import numpy as np
import pytest

from dl_esm_inf_tpu.models import nemolite2d as nl
from dl_esm_inf_tpu.models.nemolite2d_psy import NemoLite2DPsy
from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta

GNX, GNY, NSTEPS = 34, 30, 30


def production(ndom=4):
    m = nl.build(GNX, GNY, ndomains=ndom)
    m.set_initial_ssh(gaussian_eta(GNX, GNY, amp=0.2))
    m.run(NSTEPS)
    return m.gather()


@pytest.fixture(scope="module")
def prod():
    return production()


def check(got, want, tol=1e-10):
    for k in ("sshn", "un", "vn"):
        assert np.all(np.isfinite(got[k])), k
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=k)


def run_psy(ndom=4, **run_kw):
    m = NemoLite2DPsy(GNX, GNY, ndomains=ndom)
    m.set_initial_ssh(gaussian_eta(GNX, GNY, amp=0.2))
    m.run(NSTEPS, **run_kw)
    return m.gather()


def test_psy_jnp_schedule_matches_production(prod):
    """Tier 2: one jnp program per step, exchanges planned statically
    from the metadata."""
    check(run_psy(), prod)


def test_psy_fused_schedule_matches_production(prod):
    """Tier 3: the whole step as ONE sweep (single up-front exchange
    at the sequence's total erosion depth 3)."""
    check(run_psy(fused=True), prod)


def test_psy_fused_repeats_deep_blocking(prod):
    """repeats>1 — several applications per exchange, unlocked by the
    r5 dataflow erosion (the naive per-call sum said 5 per repeat and
    barred repeats>1 at halo 8): fused_program(nsteps,
    repeats=3) at halo 8 == production, and the erosion/repeats API
    pins the flagship's dataflow values."""
    m = NemoLite2DPsy(GNX, GNY, ndomains=4, halo_width=8)
    s = m._sched
    assert [s.fused_erosion(k) for k in (1, 2, 3)] == [3, 5, 7]
    assert s.max_fused_repeats() == 3
    m.set_initial_ssh(gaussian_eta(GNX, GNY, amp=0.2))
    r = 3
    run = s.fused_program(NSTEPS // r, repeats=r)
    run(scalars=[[m._scalars_at(i * r + j) for j in range(r)]
                 for i in range(NSTEPS // r)])
    check(m.gather(), prod)


def test_psy_default_halo_allows_two_repeats():
    """The default halo_width=5 model admits repeats=2 under the
    dataflow erosion (5), where the old sum-of-depths (10) refused."""
    m = NemoLite2DPsy(GNX, GNY, ndomains=1)
    assert m._sched.max_fused_repeats() == 2


def test_psy_max_repeats_raises_on_too_shallow_halo():
    """max_fused_repeats must never return a value fused() would then
    reject: at the jnp-tier halo (1) even one application erodes 3,
    and the method says so with the required halo_width (review r5)."""
    import pytest

    m = NemoLite2DPsy(GNX, GNY, ndomains=1, halo_width=1)
    with pytest.raises(ValueError, match="halo_width=3"):
        m._sched.max_fused_repeats()


def test_psy_single_shard_matches(prod):
    """Serial (1x1 mesh) == distributed — the stub/MPI duality at the
    metadata layer."""
    check(run_psy(ndom=1), prod)


def test_psy_non_default_params():
    """Non-default physics constants (incl. g) flow into EVERY psy
    kernel — a partial Params in the momentum wrappers once mixed the
    default g into the pressure gradient (review finding)."""
    p = nl.Params(g=1.62, visc=0.3, cbfr=0.001, amp=0.15)
    m1 = nl.build(GNX, GNY, ndomains=4, params=p)
    m1.set_initial_ssh(gaussian_eta(GNX, GNY, amp=0.2))
    m1.run(20)
    m2 = NemoLite2DPsy(GNX, GNY, ndomains=4, params=p)
    m2.set_initial_ssh(gaussian_eta(GNX, GNY, amp=0.2))
    m2.run(20)
    check(m2.gather(), m1.gather())
