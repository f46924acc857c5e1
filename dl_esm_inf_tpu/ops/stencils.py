"""Stencil primitives for local shard blocks.

The reference library provides no kernels — clients write Fortran loops
over ``internal`` bounds (doc/api.rst:240-337).  Here
kernels are pure jnp functions over a shard's *local block* (halo ring
included), composed inside one ``shard_map`` program per time step, so
XLA fuses the whole step into a minimal number of HBM passes.

Shifts replace index arithmetic: ``xp(a)[j, i] == a[j, i+1]``.  Because
every block carries a halo ring, shifts are local; values that wrap
around the block edge land in halo/padding cells and are never read as
results (the pad-and-mask contract).  All helpers work on any 2D array.
"""
from __future__ import annotations

import jax.numpy as jnp


def xp(a):
    """a[j, i+1] (east neighbour)."""
    return jnp.roll(a, -1, -1)


def xm(a):
    """a[j, i-1] (west neighbour)."""
    return jnp.roll(a, 1, -1)


def yp(a):
    """a[j+1, i] (north neighbour)."""
    return jnp.roll(a, -1, -2)


def ym(a):
    """a[j-1, i] (south neighbour)."""
    return jnp.roll(a, 1, -2)


def shift(a, dx: int = 0, dy: int = 0):
    """a[j+dy, i+dx]."""
    out = a
    if dy:
        out = jnp.roll(out, -dy, -2)
    if dx:
        out = jnp.roll(out, -dx, -1)
    return out


def ddx(a, dx: float):
    """(a[j, i+1] - a[j, i]) / dx — forward difference onto U faces."""
    return (xp(a) - a) / dx


def ddx_back(a, dx: float):
    """(a[j, i] - a[j, i-1]) / dx — backward difference onto T centres."""
    return (a - xm(a)) / dx


def ddy(a, dy: float):
    return (yp(a) - a) / dy


def ddy_back(a, dy: float):
    return (a - ym(a)) / dy


def avg_x(a):
    """0.5*(a[j,i] + a[j,i+1]) — T->U interpolation (NE offset)."""
    return 0.5 * (a + xp(a))


def avg_x_back(a):
    """0.5*(a[j,i-1] + a[j,i]) — U->T interpolation (NE offset)."""
    return 0.5 * (a + xm(a))


def avg_y(a):
    return 0.5 * (a + yp(a))


def avg_y_back(a):
    return 0.5 * (a + ym(a))


def pack_mask_bits(masks) -> jnp.ndarray:
    """Pack 0/1 masks (constant in time) into one int8 bitfield: one
    byte per point of HBM traffic instead of one float array per mask
    (roofline economics); decoded with shifts and ands, no rolls."""
    masks = list(masks)
    if len(masks) > 8:
        raise ValueError(
            f"pack_mask_bits holds at most 8 masks in the int8 code, "
            f"got {len(masks)}; split into two codes")
    code = sum((jnp.asarray(m).astype(jnp.int32) << k)
               for k, m in enumerate(masks))
    return code.astype(jnp.int8)


def unpack_mask_bits(codes, n: int, dtype):
    """Inverse of :func:`pack_mask_bits` — shifts and ands only."""
    c = codes.astype(jnp.int32)
    return tuple(((c >> k) & 1).astype(dtype) for k in range(n))
