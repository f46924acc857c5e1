"""The flagship step as one GPU kernel (Pallas, Triton route).

XLA:GPU compiles :func:`~.nemolite2d.step_math` into a handful of
fusions that write their intermediates to device memory between them.
This kernel computes one output tile of (ssha, ua, va) per program from
masked, shifted loads of the state and the int8 mask code: every
intermediate stays in registers, and the continuity result is recomputed
at the two shifts momentum reads instead of being stored and re-read.
It is the same arithmetic as ``step_math``'s square-cell, flat-depth
path, in the same order.

:func:`step` picks the kernel when the program is lowered for a CUDA
device and the plain ``step_math`` elsewhere; its gradient is the plain
step's (the kernel has no transpose).  :func:`covers` says which calls
the kernel serves; the others stay on ``step_math``.

Tiling.  Reads reach rows and columns -1..+2 around an output cell.
Tiles start at column 0, so the unshifted loads are 16-byte aligned and
vectorise (anchoring them at column 1 cost 20% at 4096^2, PERF.md), and
at row 1, so no row is read before the array.  Loads index the
flattened state with masks: a lane left of column 0 or past the end
reads 0 and is never used.  The ring the stencil cannot fill (row and
column 0, the last two rows and columns) passes its input through.
Those cells are never valid after a step on either path (step_math's
rolls wrap there), and on the domain's edge they are dry cells, where
the plain step also keeps ssh and gives zero velocity.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Tile of one program: 8 rows of 128 columns, 4 warps — the fastest of
# the shapes tried at 4096^2 on the H100 (PERF.md).
BLOCK_ROWS, BLOCK_COLS, NUM_WARPS = 8, 128, 4


def covers(sshn_t, depth, dx, dy) -> bool:
    """Does the kernel serve this call of ``step_math``?  float32 2D
    blocks (with int32 flat indices) with a flat (scalar) depth and
    static square cells."""
    static = (int, float)
    return (sshn_t.dtype == jnp.float32 and sshn_t.ndim == 2
            and sshn_t.size < 2**31
            and isinstance(depth, static) and isinstance(dx, static)
            and isinstance(dy, static) and dx == dy)


def _kernel(f_ref, s_ref, u_ref, v_ref, c_ref, so_ref, uo_ref, vo_ref, *,
            p, dx, fcor, depth):
    H, W = so_ref.shape
    BM, BN = BLOCK_ROWS, BLOCK_COLS
    i, j = pl.program_id(0), pl.program_id(1)
    r0 = 1 + i * BM
    c0 = j * BN
    rows = r0 + jnp.arange(BM, dtype=jnp.int32)
    cols = c0 + jnp.arange(BN, dtype=jnp.int32)
    dt = s_ref.dtype
    memo = {}

    def at(name, fn):
        """``fn(dj, di)`` evaluated once per offset."""
        def get(dj, di):
            if (name, dj, di) not in memo:
                memo[name, dj, di] = fn(dj, di)
            return memo[name, dj, di]
        return get

    def window(ref, dj, di):
        rr, cc = rows + dj, cols + di
        inside = (rr < H)[:, None] & ((cc >= 0) & (cc < W))[None, :]
        return plgpu.load(ref.at[(rr * W)[:, None] + cc[None, :]],
                          mask=inside, other=0)

    S = at("S", functools.partial(window, s_ref))
    U = at("U", functools.partial(window, u_ref))
    V = at("V", functools.partial(window, v_ref))
    C = at("C", lambda dj, di: window(c_ref, dj, di).astype(jnp.int32))

    def bit(k):
        return lambda dj, di: (C(dj, di) >> k) & 1
    # encode_masks' order: t_wet, u_wet, v_wet, bc_cells, flather_u/v
    t_wet = at("t", lambda dj, di: bit(0)(dj, di).astype(dt))
    u_wet = at("u", lambda dj, di: bit(1)(dj, di).astype(dt))
    v_wet = at("v", lambda dj, di: bit(2)(dj, di).astype(dt))

    fric = 1.0 / (1.0 + p.cbfr * p.rdt)
    cflat = -float(np.sqrt(p.g / max(depth, 1e-3)))
    forcing = plgpu.load(f_ref.at[0])

    # next_sshu/v, total depths and fluxes (step_math)
    sw = at("sw", lambda dj, di: S(dj, di) * t_wet(dj, di))
    ssu = at("ssu", lambda dj, di: (sw(dj, di) + sw(dj, di + 1))
             * (1.0 - 0.5 * u_wet(dj, di)))
    ssv = at("ssv", lambda dj, di: (sw(dj, di) + sw(dj + 1, di))
             * (1.0 - 0.5 * v_wet(dj, di)))
    depu = at("depu", lambda dj, di: depth + ssu(dj, di))
    depv = at("depv", lambda dj, di: depth + ssv(dj, di))
    z = at("z", lambda dj, di: depth + S(dj, di))
    fx = at("fx", lambda dj, di: depu(dj, di) * U(dj, di))
    fy = at("fy", lambda dj, di: depv(dj, di) * V(dj, di))

    def _ssha(dj, di):                          # continuity + bc_ssh
        cw = (p.rdt / dx) * t_wet(dj, di)
        a = S(dj, di) - cw * ((fx(dj, di) - fx(dj, di - 1))
                              + (fy(dj, di) - fy(dj - 1, di)))
        return jnp.where(bit(3)(dj, di) > 0, forcing, a)
    ssha = at("ssha", _ssha)

    # momentum_u
    def _wx(dj, di):
        un, umx = U(dj, di), U(dj, di - 1)
        su = un + umx
        u_dw = jnp.where(su > 0, umx, un)
        return (((-0.5 * p.rdt / dx) * (su * u_dw)
                 + (p.rdt * p.visc / (dx * dx)) * (un - umx)) * z(dj, di))
    wx = at("wx", _wx)
    wvv = at("wvv", lambda dj, di: V(dj, di) + V(dj, di + 1))

    def _wy(dj, di):
        un, upy = U(dj, di), U(dj + 1, di)
        w = wvv(dj, di)
        dep_f2 = depv(dj, di) + depv(dj, di + 1)
        u_dn = jnp.where(w > 0, un, upy)
        return (((-0.25 * p.rdt / dx) * (w * u_dn)
                 + (0.5 * p.rdt * p.visc / (dx * dx)) * (upy - un))
                * dep_f2)
    wy = at("wy", _wy)

    corhpg = (((0.25 * p.rdt * fcor) * (wvv(0, 0) + wvv(-1, 0))
               + (-p.rdt * p.g / dx) * (ssha(0, 1) - ssha(0, 0)))
              * depu(0, 0))
    ua = (U(0, 0) + ((wx(0, 1) - wx(0, 0)) + (wy(0, 0) - wy(-1, 0))
                     + corhpg) * (1.0 / depu(0, 0))) * (fric * u_wet(0, 0))
    ua = jnp.where(bit(4)(0, 0) > 0, cflat * ssu(0, 0), ua)

    # momentum_v
    def _wyv(dj, di):
        vn, vmy = V(dj, di), V(dj - 1, di)
        sv = vn + vmy
        v_ds = jnp.where(sv > 0, vmy, vn)
        return (((-0.5 * p.rdt / dx) * (sv * v_ds)
                 + (p.rdt * p.visc / (dx * dx)) * (vn - vmy)) * z(dj, di))
    wyv = at("wyv", _wyv)
    wuu = at("wuu", lambda dj, di: U(dj, di) + U(dj + 1, di))

    def _wxv(dj, di):
        vn, xpv = V(dj, di), V(dj, di + 1)
        w = wuu(dj, di)
        dep_f2 = depu(dj, di) + depu(dj + 1, di)
        v_de = jnp.where(w > 0, vn, xpv)
        return (((-0.25 * p.rdt / dx) * (w * v_de)
                 + (0.5 * p.rdt * p.visc / (dx * dx)) * (xpv - vn))
                * dep_f2)
    wxv = at("wxv", _wxv)

    corhpg_v = (((-0.25 * p.rdt * fcor) * (wuu(0, 0) + wuu(0, -1))
                 + (-p.rdt * p.g / dx) * (ssha(1, 0) - ssha(0, 0)))
                * depv(0, 0))
    va = (V(0, 0) + ((wyv(1, 0) - wyv(0, 0)) + (wxv(0, 0) - wxv(0, -1))
                     + corhpg_v) * (1.0 / depv(0, 0))) * (fric * v_wet(0, 0))
    va = jnp.where(bit(5)(0, 0) > 0, cflat * ssv(0, 0), va)

    # the stencil's cells; the ring keeps its input (row 0 from the
    # first tile row's loads at offset -1)
    inside = (rows < H)[:, None] & (cols < W)[None, :]
    stencil = ((rows < H - 2)[:, None]
               & ((cols >= 1) & (cols < W - 2))[None, :])
    first_row = (rows == 1)[:, None] & (cols < W)[None, :] & (i == 0)
    for ref, new, x in ((so_ref, ssha(0, 0), S), (uo_ref, ua, U),
                        (vo_ref, va, V)):
        plgpu.store(ref.at[pl.ds(r0, BM), pl.ds(c0, BN)],
                    jnp.where(stencil, new, x(0, 0)).astype(dt),
                    mask=inside)
        plgpu.store(ref.at[pl.ds(r0 - 1, BM), pl.ds(c0, BN)], x(-1, 0),
                    mask=first_row)


def _pallas_step(sshn_t, un, vn, mask_codes, forcing, *, p, dx, fcor, depth,
                 interpret=False):
    H, W = sshn_t.shape
    out = jax.ShapeDtypeStruct((H, W), sshn_t.dtype)
    call = pl.pallas_call(
        functools.partial(_kernel, p=p, dx=float(dx), fcor=float(fcor),
                          depth=float(depth)),
        out_shape=(out, out, out),
        grid=(pl.cdiv(max(H - 1, 1), BLOCK_ROWS), pl.cdiv(W, BLOCK_COLS)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret, name="nemolite2d_step")
    f = jnp.reshape(jnp.asarray(forcing, sshn_t.dtype), (1,))
    return call(f, *(a.reshape(-1) for a in (sshn_t, un, vn, mask_codes)))


def step(plain, sshn_t, un, vn, mask_codes, forcing, *, p, dx, fcor, depth,
         interpret=False):
    """``(ssha, ua, va)`` of one step: the kernel where the program is
    lowered for CUDA (or everywhere, with ``interpret=True``, in the
    Pallas interpreter), ``plain(sshn_t, un, vn, mask_codes, forcing)``
    elsewhere.  ``plain`` is also the kernel's gradient."""
    kern = functools.partial(_pallas_step, p=p, dx=dx, fcor=fcor,
                             depth=depth, interpret=interpret)

    @jax.custom_vjp
    def fused(*args):
        return kern(*args)

    def fwd(*args):
        return kern(*args), args

    def bwd(args, ct):
        _, vjp = jax.vjp(plain, *args)
        return vjp(ct)

    fused.defvjp(fwd, bwd)
    args = (sshn_t, un, vn, mask_codes, forcing)
    if interpret:
        return fused(*args)
    return lax.platform_dependent(*args, cuda=fused, default=plain)
