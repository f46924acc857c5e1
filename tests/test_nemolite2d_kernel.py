"""The flagship's fused GPU kernel (models/nemolite2d_kernel.py), run in
the Pallas interpreter against the plain ``jax.numpy`` step: the same
arithmetic on the stencil's cells, the input passed through on the ring
it cannot fill, the plain step's gradient, and the choice of path.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dl_esm_inf_tpu.models import nemolite2d as nl
from dl_esm_inf_tpu.models import nemolite2d_kernel as nk
from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta

FORCING = 0.03


def _state(gnx, gny, halo=2):
    """A flagship block a few steps in, with noise on the velocities so
    both donor-cell branches are taken."""
    m = nl.build(gnx, gny, ndomains=1, dtype=jnp.float32, halo_width=halo)
    m.set_initial_ssh(gaussian_eta(gnx, gny, amp=0.2))
    m.run(3)
    rng = np.random.default_rng(0)
    noise = [jnp.asarray(rng.standard_normal(m.un.data.shape) * 0.01,
                         jnp.float32) for _ in range(2)]
    state = (m.sshn_t.data, m.un.data + noise[0], m.vn.data + noise[1],
             m._mask_codes, jnp.float32(FORCING))
    return m, state


def _plain(m):
    return functools.partial(nl.plain_step, p=m.p, dx=m.grid.dx,
                             dy=m.grid.dy, fcor=m._fcor, depth=m.depth)


def _kernel(m, interpret=True):
    return functools.partial(nk.step, _plain(m), p=m.p, dx=m.grid.dx,
                             fcor=m._fcor, depth=m.depth,
                             interpret=interpret)


@pytest.mark.parametrize("gnx,gny", [(64, 64), (37, 42), (140, 9), (1, 1)])
def test_kernel_matches_plain_step(gnx, gny):
    """Stencil cells agree with the jnp step to f32 roundoff (the
    interpreter and XLA:CPU may contract multiply-adds differently);
    ring cells (row/column 0, the last two) hold the input exactly."""
    m, state = _state(gnx, gny)
    got = jax.jit(_kernel(m))(*state)
    want = jax.jit(_plain(m))(*state)
    for g, w, x, name in zip(got, want, state, ("ssh", "u", "v")):
        g, w, x = np.asarray(g), np.asarray(w), np.asarray(x)
        assert g.shape == w.shape
        inner = (slice(1, -2), slice(1, -2))
        scale = max(float(np.abs(w[inner]).max(initial=0.0)), 1e-30)
        np.testing.assert_allclose(g[inner], w[inner], rtol=0,
                                   atol=4e-7 * scale, err_msg=name)
        ring = np.ones(g.shape, bool)
        ring[inner] = False
        np.testing.assert_array_equal(g[ring], x[ring], err_msg=name)


def test_kernel_gradient_is_the_plain_steps():
    """The backward pass is the plain step's vjp; only the cotangent
    (twice the outputs here) carries the forward's roundoff."""
    m, state = _state(24, 20)

    def loss(step, s, u):
        out = step(s, u, *state[2:])
        return sum(jnp.sum(o * o) for o in out)

    for argnum in (0, 1):
        gk = jax.grad(functools.partial(loss, _kernel(m)), argnum)(
            *state[:2])
        gp = jax.grad(functools.partial(loss, _plain(m)), argnum)(
            *state[:2])
        gp = np.asarray(gp)
        np.testing.assert_allclose(np.asarray(gk), gp, rtol=0,
                                   atol=1e-5 * np.abs(gp).max())


@pytest.mark.parametrize("case,served", [
    ("flagship", True), ("float64", False), ("bfloat16", False),
    ("bathymetry", False), ("rectangular", False), ("members", False)])
def test_kernel_covers(case, served):
    """The kernel serves float32 2D blocks on flat depth and square
    cells; everything else stays on the jnp step."""
    a = jnp.zeros((8, 8), jnp.float32)
    args = {"flagship": (a, 100.0, 1e3, 1e3),
            "float64": (a.astype(jnp.float64), 100.0, 1e3, 1e3),
            "bfloat16": (a.astype(jnp.bfloat16), 100.0, 1e3, 1e3),
            "bathymetry": (a, a + 100.0, 1e3, 1e3),
            "rectangular": (a, 100.0, 1e3, 2e3),
            "members": (jnp.zeros((2, 8, 8), jnp.float32), 100.0, 1e3,
                        1e3)}[case]
    assert nk.covers(*args) is served


def test_step_math_lowers_the_plain_step_off_cuda():
    """Off a CUDA device the dispatch lowers only the jnp branch: the
    program holds no Triton call and matches the plain step bitwise."""
    m, state = _state(32, 32)
    f = jax.jit(lambda s, u, v, c, fo: nl.step_math(
        s, u, v, c, m.p, m.grid.dx, m.grid.dy, m._fcor, m.depth, fo))
    assert "triton" not in f.lower(*state).as_text()
    got = f(*state)
    want = jax.jit(_plain(m))(*state)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("K,ndom", [(1, 1), (4, 1), (2, 4)])
def test_model_steps_through_the_kernel(monkeypatch, K, ndom):
    """The kernel inside step_program (one-step and K-step sweeps, one
    and four domains) reproduces the jnp path's interior: the ring it
    passes through is never read as a result."""
    def run(kernel):
        m = nl.build(40, 36, ndomains=ndom, dtype=jnp.float32,
                     halo_width=2, steps_per_sweep=K)
        m.set_initial_ssh(gaussian_eta(40, 36, amp=0.2))
        with monkeypatch.context() as mp:
            if kernel:
                mp.setattr(nk, "step",
                           functools.partial(nk.step, interpret=True))
            m.run(6)
        return m.gather()

    got, want = run(True), run(False)
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-6 * scale, err_msg=k)
