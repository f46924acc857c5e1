"""K-step stencil sweeps: the communication-avoiding schedule.

A client model whose step is a bounded-reach stencil chain over shard
blocks advances K steps after ONE halo exchange at depth ``K * reach``:
each step erodes ``reach`` valid halo cells, and the shard computes the
eroded ring redundantly instead of communicating again (the deep-halo
argument).  The reference hardwires exchange depth 1
(parallel_comms_mod.f90:48), so it cannot express this schedule.

Everything is plain ``jax.numpy`` over the whole shard block, left to
XLA to fuse.  This module is the one place that knows how K steps
compose with the exchange; the client models supply their step.
"""
from __future__ import annotations

from jax import lax

from ..parallel.halo import exchange_multi_fn


def sweep_halo(steps_per_sweep: int, reach: int, halo_width: int) -> int:
    """The halo width a model ``build()`` decomposes with: at least
    ``halo_width`` and deep enough for K steps of ``reach``."""
    K = int(steps_per_sweep)
    if K < 1:
        raise ValueError(f"steps_per_sweep must be >= 1, got {K}")
    return max(halo_width, K * reach) if K > 1 else halo_width


def set_steps_per_exchange(model, *, reach: int,
                           steps_per_sweep: int) -> None:
    """Select K chained steps per depth-K*reach exchange on ``model``
    (sets ``model._sweep_K`` and clears its program cache).  Needs
    ``halo_width >= K*reach``."""
    K = int(steps_per_sweep)
    if K < 1:
        raise ValueError(f"steps_per_sweep must be >= 1, got {K}")
    need = K * reach
    if model.grid.halo_spec.halo < need:
        raise ValueError(
            f"steps_per_sweep={K} needs halo_width >= {need}")
    model._sweep_K = K
    model._step_cache.clear()


def make_stencil_sweep(step_fn, *, spec, steps_per_sweep: int = 1,
                       reach: int = 1, total_reach: int | None = None,
                       prepare_fn=None):
    """Build ``sweep(state, aux=(), scalars=None) -> state`` for one
    shard block (call it inside ``shard_map``).

    The sweep exchanges the ``state`` tuple's halos once, at depth
    ``total_reach`` (default ``K * reach``), runs
    ``prepare_fn(aux)`` once (time-invariant set-up hoisted out of the
    sub-steps; default passes ``aux`` through), then applies
    ``step_fn(state, prepared, scalars[k])`` for k = 0..K-1.
    ``scalars`` is indexed by sub-step (e.g. a (K,) forcing series, or
    (K, n) rows); ``None`` passes ``None``.  ``total_reach`` overrides
    the uniform erosion for step chains that erode unevenly (a kernel
    schedule erodes more on its first application, see
    ``api/kernel_meta.py``); 0 skips the exchange.

    Halo cells beyond the valid ring hold block-wrapped values after
    the sweep; they are exactly the cells the next exchange overwrites
    or the masks keep inert."""
    K = int(steps_per_sweep)
    if K < 1:
        raise ValueError(f"steps_per_sweep must be >= 1, got {K}")
    total = K * reach if total_reach is None else int(total_reach)
    if total > spec.halo:
        raise ValueError(
            f"a sweep of {K} step(s) erodes {total} halo cells; it needs "
            f"halo_width >= {total}, the decomposition has {spec.halo}")
    exch = exchange_multi_fn(spec, depth=total) if total else tuple

    def sweep(state, aux=(), scalars=None):
        state = exch(tuple(state))
        prepared = prepare_fn(tuple(aux)) if prepare_fn else tuple(aux)
        for k in range(K):
            state = tuple(step_fn(state, prepared,
                                  None if scalars is None else scalars[k]))
        return state

    return sweep


def run_steps(nsteps: int, steps_per_sweep: int, state, sweep, step):
    """Advance ``state`` by ``nsteps`` inside one program:
    ``nsteps // K`` calls of ``sweep(j, state)`` (K steps each, j the
    sweep index), then the ``nsteps % K`` remaining steps as
    ``step(i, state)`` with ``i`` the absolute step index.  With K = 1
    every step goes through ``step``."""
    K = int(steps_per_sweep)
    base = 0
    if K > 1 and nsteps >= K:
        state = lax.fori_loop(0, nsteps // K, sweep, state)
        base = (nsteps // K) * K
    if nsteps > base:
        state = lax.fori_loop(base, nsteps, step, state)
    return state
