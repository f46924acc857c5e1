"""Tests that need the card: each compiles a client's step at benchmark
width for the GPU and compares it with its reference.  They skip
elsewhere; ``python chip_smoke.py`` runs them on the card (phase 6)."""
import numpy as np
import pytest

N = 1024


@pytest.mark.gpu
def test_flagship_sweep_matches_one_step_on_gpu(gpu):
    """1024^2 f32 flagship: the K=4 sweep equals the one-step path to
    an f32 ulp per step (FMA contraction may differ between the two
    programs), and the step's memory fits the card."""
    import jax.numpy as jnp
    from dl_esm_inf_tpu.models import nemolite2d as nl
    from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta

    out = {}
    for K in (1, 4):
        m = nl.build(N, N, ndomains=1, dtype=jnp.float32, halo_width=2,
                     steps_per_sweep=K)
        m.set_initial_ssh(gaussian_eta(N, N, amp=0.2))
        args = (jnp.int32(0), (m.sshn_t.data, m.un.data, m.vn.data),
                m._mask_codes)
        mem = m.step_program(K).lower(*args).compile().memory_analysis()
        print(f"K={K} {mem}")
        m.run(12)
        out[K] = m.gather()
    for k in out[1]:
        a = np.asarray(out[4][k], np.float64)
        b = np.asarray(out[1][k], np.float64)
        assert np.all(np.isfinite(a)), k
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), k


@pytest.mark.gpu
def test_gravity_wave_golden_on_gpu(gpu):
    """1024^2 f32 gravity wave (K=8) against the f64 NumPy golden."""
    import jax.numpy as jnp
    from dl_esm_inf_tpu.models import gravity_wave as gw

    m = gw.build(N, N, ndomains=1, dt=0.005, dtype=jnp.float32,
                 steps_per_sweep=8)
    eta0 = gw.gaussian_eta(N, N, amp=0.5)
    m.set_initial_eta(eta0)
    m.run(40)
    want = gw.golden_reference(eta0, gw.default_tmask(N, N), 1.0, 1.0,
                               m.dt, 40, depth=m.depth)
    got = m.gather()
    for k in ("eta", "u", "v"):
        a = np.asarray(got[k], np.float64)
        assert np.abs(a - want[k]).max() <= 1e-4 * np.abs(want[k]).max(), k


@pytest.mark.gpu
def test_fused_kernel_on_gpu(gpu):
    """1024^2 f32: the flagship step lowers to its fused kernel on the
    card, matches the plain jnp step on the stencil cells, and
    differentiates through the plain step's vjp."""
    import functools
    import jax
    import jax.numpy as jnp
    from dl_esm_inf_tpu.models import nemolite2d as nl
    from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta

    m = nl.build(N, N, ndomains=1, dtype=jnp.float32, halo_width=2)
    m.set_initial_ssh(gaussian_eta(N, N, amp=0.2))
    m.run(5)
    state = (m.sshn_t.data, m.un.data, m.vn.data, m._mask_codes,
             jnp.float32(0.03))
    cfg = dict(p=m.p, dx=m.grid.dx, dy=m.grid.dy, fcor=m._fcor,
               depth=m.depth)

    def fused(s, u, v, c, f):
        return nl.step_math(s, u, v, c, cfg["p"], cfg["dx"], cfg["dy"],
                            cfg["fcor"], cfg["depth"], f)

    plain = functools.partial(nl.plain_step, **cfg)
    assert "triton" in jax.jit(fused).lower(*state).as_text()
    got, want = jax.jit(fused)(*state), jax.jit(plain)(*state)
    for g, w in zip(got, want):
        g = np.asarray(g)[1:-2, 1:-2]
        w = np.asarray(w)[1:-2, 1:-2]
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()

    def loss(step, s):
        return sum(jnp.sum(o * o) for o in step(s, *state[1:]))
    gk = np.asarray(jax.jit(jax.grad(functools.partial(loss, fused)))(
        state[0]))
    gp = np.asarray(jax.jit(jax.grad(functools.partial(loss, plain)))(
        state[0]))
    assert np.abs(gk - gp).max() <= 1e-4 * np.abs(gp).max()
