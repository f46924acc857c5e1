"""Precision policy for the framework.

The reference library pins everything to IEEE double precision
(``GO_WP = SELECTED_REAL_KIND(12,307)``, reference
finite_difference/src/kind_params_mod.f90:9).  Double precision moves
twice the bytes of single precision through a bandwidth-bound stencil,
so the policy here is a *configurable* working precision:

* ``float64`` — bit-compatible semantics with the reference (requires
  ``jax_enable_x64``; used for validation, CPU test meshes and goldens).
* ``float32`` — the performance dtype (the default without x64).
* ``bfloat16`` — available for experimentation; checksums still accumulate
  in float32.

Select via :func:`set_working_precision`, or the ``DL_ESM_DTYPE``
environment variable (read once at import).  This mirrors the reference's
env-var driven configuration style (``DL_ESM_ALIGNMENT``,
reference grid_mod.f90:349-363).
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

_DTYPE_NAMES = {
    "float64": jnp.float64,
    "f64": jnp.float64,
    "double": jnp.float64,
    "float32": jnp.float32,
    "f32": jnp.float32,
    "bfloat16": jnp.bfloat16,
    "bf16": jnp.bfloat16,
}

_working_dtype = None


def _default_dtype():
    env = os.environ.get("DL_ESM_DTYPE", "").strip().lower()
    if env:
        if env not in _DTYPE_NAMES:
            raise ValueError(
                f"DL_ESM_DTYPE={env!r} not understood; expected one of "
                f"{sorted(_DTYPE_NAMES)}")
        return _DTYPE_NAMES[env]
    # Honour x64 mode if the user enabled it (matches GO_WP = double),
    # otherwise use float32.
    if jax.config.jax_enable_x64:
        return jnp.float64
    return jnp.float32


def set_working_precision(dtype) -> None:
    """Set the working precision (``go_wp`` analogue) for new grids/fields."""
    global _working_dtype
    if isinstance(dtype, str):
        if dtype.lower() not in _DTYPE_NAMES:
            raise ValueError(
                f"working precision {dtype!r} not understood; expected "
                f"one of {sorted(_DTYPE_NAMES)}")
        dtype = _DTYPE_NAMES[dtype.lower()]
    dtype = jnp.dtype(dtype)
    if dtype == jnp.dtype(jnp.float64) and not jax.config.jax_enable_x64:
        raise ValueError(
            "float64 working precision requires jax_enable_x64; call "
            "jax.config.update('jax_enable_x64', True) before importing "
            "or creating arrays.")
    _working_dtype = dtype


def wp():
    """The current working-precision dtype (reference ``GO_WP``)."""
    global _working_dtype
    if _working_dtype is None:
        _working_dtype = jnp.dtype(_default_dtype())
    return _working_dtype


def sum_dtype():
    """Accumulation dtype for checksums / reductions.

    Checksums in the reference are fp64 (field_mod.f90:1289-1307).  We
    accumulate in fp64 when x64 is on, else float32 (documented deviation:
    fp32 mode states its tolerance per-test).
    """
    if jax.config.jax_enable_x64:
        return jnp.dtype(jnp.float64)
    return jnp.dtype(jnp.float32)


def np_wp():
    """NumPy view of the working precision (for host-side golden models)."""
    return np.dtype(wp())
