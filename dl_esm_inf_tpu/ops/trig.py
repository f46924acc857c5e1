"""Faithful float64 trigonometry, independent of the backend's ``sin``.

The fp64 parity of NEMOLite2D against its NumPy golden rests on the
tidal forcing: it injects the sine's error at the open boundary every
step, so an f32-accurate f64 sine (~1.5e-8 absolute at x=1) compounds
to ~1e-4 relative by 1024 steps.  A backend whose f64 ``sin`` lowering
is not faithful would break that parity.

:func:`sin_wp` rules it out: for float64 inputs it evaluates sine from
the primitives that are faithful everywhere — Cody-Waite two-constant
reduction by pi/2 and Taylor polynomials on [-pi/4, pi/4] (truncation
< 4e-18, below f64 roundoff) — and for float32 inputs it stays with
``jnp.sin`` (the performance path is untouched).  The reference gets
faithful sine from libm (model time -> forcing, e.g. its clients'
bc_ssh analogues).  On the H100, ``jnp.sin`` in float64 is itself
faithful (``chip_smoke.py`` phase 4 prints both against libm), so
ROADMAP lists this module for retirement.
"""
from __future__ import annotations

import jax.numpy as jnp

# pi/2 split with a 33-significant-bit high word (fdlibm's PIO2_1), so
# n * _PIO2_1 is EXACT in f64 for |n| < 2^20 and the Cody-Waite
# residual (x - n*hi) - n*lo carries full precision to |x| ~ 1e6.
_PIO2_1 = 1.57079632673412561417e+00
_PIO2_1T = 6.07710050650619224932e-11

# Taylor coefficients (exact 1/k! to f64): truncation at |r| <= pi/4 is
# (pi/4)^17/17! ~ 4e-18 for sine, (pi/4)^18/18! for cosine.
_SIN_C = (1.0, -1.0 / 6, 1.0 / 120, -1.0 / 5040, 1.0 / 362880,
          -1.0 / 39916800, 1.0 / 6227020800, -1.0 / 1307674368000)
_COS_C = (1.0, -1.0 / 2, 1.0 / 24, -1.0 / 720, 1.0 / 40320,
          -1.0 / 3628800, 1.0 / 479001600, -1.0 / 87178291200)


def _poly(r2, coeffs):
    acc = jnp.asarray(coeffs[-1], r2.dtype)
    for c in reversed(coeffs[:-1]):
        acc = acc * r2 + c
    return acc


def _reduce(x):
    """(r, q): x = q*(pi/2) + r with |r| <= pi/4, q the quadrant."""
    n = jnp.floor(x * (2.0 / jnp.pi) + 0.5)
    r = (x - n * _PIO2_1) - n * _PIO2_1T
    return r, jnp.mod(n.astype(jnp.int32), 4)


def _from_quadrant(r, q):
    r2 = r * r
    s = r * _poly(r2, _SIN_C)
    c = _poly(r2, _COS_C)
    mag = jnp.where((q == 0) | (q == 2), s, c)
    sign = jnp.where((q == 0) | (q == 1), 1.0, -1.0)
    return sign * mag


def sin64(x):
    """sin(x) for float64 ``x`` from faithful f64 add/mul only.

    Accurate to ~1 ulp for |x| up to ~1e6 (the 33-bit Cody-Waite
    window); model times/phases are far below that.
    """
    x = jnp.asarray(x, jnp.float64)
    r, q = _reduce(x)
    return _from_quadrant(r, q)


def cos64(x):
    """cos(x): the same reduction, one quadrant ahead."""
    x = jnp.asarray(x, jnp.float64)
    r, q = _reduce(x)
    return _from_quadrant(r, jnp.mod(q + 1, 4))


def sin_wp(x):
    """Working-precision sine: faithful-f64 :func:`sin64` when ``x`` is
    float64 (module docstring), ``jnp.sin`` otherwise (the f32/bf16
    fast paths)."""
    if jnp.result_type(x) == jnp.float64:
        return sin64(x)
    return jnp.sin(x)


def cos_wp(x):
    if jnp.result_type(x) == jnp.float64:
        return cos64(x)
    return jnp.cos(x)


__all__ = ["sin64", "cos64", "sin_wp", "cos_wp"]
