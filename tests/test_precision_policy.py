"""Precision policy: the same model at float32 / bfloat16 vs the fp64
reference semantics (core/kinds.py — the reference pins GO_WP=double;
the policy here makes precision configurable)."""
import numpy as np
import pytest

import jax.numpy as jnp

from dl_esm_inf_tpu.models import nemolite2d as nl
from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta


def run(dtype, nsteps=20, ndom=4):
    m = nl.build(48, 40, ndomains=ndom, open_north=True, dtype=dtype)
    m.set_initial_ssh(gaussian_eta(48, 40, amp=0.5))
    m.run(nsteps)
    return m.gather()


def test_float32_tracks_float64():
    g64 = run(jnp.float64)
    g32 = run(jnp.float32)
    for k in ("sshn", "un", "vn"):
        assert g32[k].dtype == np.float32
        scale = np.abs(g64[k]).max() or 1.0
        np.testing.assert_allclose(g32[k].astype(np.float64) / scale,
                                   g64[k] / scale, atol=5e-5, err_msg=k)


def test_bfloat16_runs_and_is_sane():
    """bf16 is an experimentation dtype: stable and qualitatively right
    (checksums accumulate in f32 so they stay finite and comparable)."""
    g64 = run(jnp.float64, nsteps=10)
    gbf = run(jnp.bfloat16, nsteps=10)
    for k in ("sshn", "un", "vn"):
        got = gbf[k].astype(np.float64)
        assert np.all(np.isfinite(got)), k
        scale = np.abs(g64[k]).max() or 1.0
        np.testing.assert_allclose(got / scale, g64[k] / scale,
                                   atol=0.05, err_msg=k)


def test_float32_decomposition_invariance():
    """Seam/mask machinery must be dtype-agnostic: 1 shard == 6 shards
    to f32 roundoff."""
    g1 = run(jnp.float32, ndom=1)
    g6 = run(jnp.float32, ndom=6)
    for k in ("sshn", "un", "vn"):
        np.testing.assert_allclose(g6[k], g1[k], rtol=2e-6, atol=1e-7,
                                   err_msg=k)


def test_sin64_faithful():
    """ops/trig: the faithful-f64 sine (built from faithful add/mul,
    whatever the backend's own f64 sin lowering; it carries the fp64
    parity of the tidal forcing)."""
    from dl_esm_inf_tpu.ops import trig

    xs = np.concatenate([
        np.linspace(-20.0, 20.0, 4001),
        np.array([0.0, 1e-12, -1e-12, np.pi / 4, np.pi / 2, np.pi,
                  3 * np.pi / 2, 2 * np.pi, 1e5, -1e5]),
    ])
    np.testing.assert_allclose(np.asarray(trig.sin64(xs)), np.sin(xs),
                               rtol=0, atol=2e-15)
    np.testing.assert_allclose(np.asarray(trig.cos64(xs)), np.cos(xs),
                               rtol=0, atol=2e-15)
    # dispatch: f64 -> polynomial path, f32 -> jnp.sin untouched
    assert trig.sin_wp(jnp.float32(1.0)).dtype == jnp.float32
    assert trig.sin_wp(jnp.float64(1.0)).dtype == jnp.float64
    assert trig.cos_wp(jnp.float32(1.0)).dtype == jnp.float32
