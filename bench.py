#!/usr/bin/env python
"""Headline benchmark: NEMOLite2D step throughput on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Mpt/s/chip", "vs_baseline": N}

* value        — grid points advanced per second on one card by the
                 flagship nonlinear shallow-water model (1024^2, f32,
                 K=4 steps per exchange, steady state).
* vs_baseline  — fraction of the copy-bandwidth roofline for the step's
                 minimal state traffic (3 f32 reads + 3 f32 writes +
                 1 int8 mask read = 25 B/pt), with the bandwidth of a
                 large copy measured in the same process.  The
                 reference publishes no performance numbers
                 (BASELINE.md), so the bar is speed-of-light on the
                 card itself.

One process drives the card.  Without a GPU the script exits non-zero
and prints no result: a CPU time is not a device metric.  Every time is
wall clock around work that ends in ``block_until_ready``, after a
warm-up call that compiles the program.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

METRIC = "nemolite2d-1024sq-f32-fused-step-throughput"
N = 1024
BYTES_PER_POINT = 3 * 4 + 3 * 4 + 1      # read ssh,u,v; write 3; mask


def _best(f, reps=5):
    """Fastest of ``reps`` timed calls of ``f`` (which must block)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        f()
        best = min(best, time.perf_counter() - t0)
    return best


def measure_copy_gbps(jax, jnp, n=40):
    """Copy bandwidth (GB/s): a 256 MB f32 array read and written once
    per pass, in jitted loops of ``n`` and ``2n`` passes; the bandwidth
    is the longer loop's.  Also returns the check that every pass
    streams the array: the ratio of the two loops' times (2 when each
    pass costs the same) and the bytes XLA's cost analysis counts for
    the longer loop, over the array's size."""
    x = jnp.zeros((8192, 8192), jnp.float32)
    t = {}
    for k in (n, 2 * n):
        chain = jax.jit(lambda v, k=k: jax.lax.fori_loop(
            0, k, lambda i, a: a * 1.0000001 + 0.5, v))
        chain(x).block_until_ready()
        t[k] = _best(lambda: chain(x).block_until_ready())
    cost = chain.lower(x).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    check = {"passes": [n, 2 * n], "time_ratio": t[2 * n] / t[n],
             "cost_analysis_bytes_over_array_bytes":
                 float(cost.get("bytes accessed", float("nan")))
                 / x.nbytes}
    return 2 * x.nbytes * 2 * n / t[2 * n] / 1e9, check


def step_time(prog, args, nsteps):
    """Seconds per step of an ``nsteps``-step program."""
    prog(*args)[0].block_until_ready()          # compile + warm
    return _best(lambda: prog(*args)[0].block_until_ready()) / nsteps


def measure_client_models(jnp, nsteps=200):
    """Secondary clients on the K-step sweep, for ``detail.models``."""
    from dl_esm_inf_tpu.models import gravity_wave as gw
    from dl_esm_inf_tpu.models import tracer as tc
    from dl_esm_inf_tpu.models import twolayer as tl

    f32 = jnp.float32
    gwm = gw.build(N, N, dt=0.005, steps_per_sweep=8, dtype=f32)
    gwm.set_initial_eta(gw.gaussian_eta(N, N, amp=0.1))
    tlm = tl.build(N, N, steps_per_sweep=8)
    tcu, tcv = tc.streamfunction_velocities(
        gw.gaussian_eta(N, N, amp=20.0, width=0.2))
    tcm = tc.build(N, N, dt=0.2, u=tcu, v=tcv, kappa=0.02,
                   scheme="vanleer", steps_per_sweep=4)
    tcm.set_initial_tracer(gw.gaussian_eta(N, N, amp=1.0) + 0.01)
    configs = (
        ("gravity_wave_K8", gwm,
         (gwm.eta.data, gwm.u.data, gwm.v.data,
          gwm._t_upd, gwm._u_wet, gwm._v_wet)),
        ("twolayer_K8", tlm,
         (tlm.eta1.data, tlm.eta2.data, tlm.u1.data, tlm.v1.data,
          tlm.u2.data, tlm.v2.data, tlm._t_upd, tlm._u_wet, tlm._v_wet)),
        ("tracer_vanleer_K4", tcm,
         (tcm.c.data, tcm._u, tcm._v, tcm._t_upd, tcm._u_wet,
          tcm._v_wet)),
    )
    out = {}
    for name, m, args in configs:
        t = step_time(m.step_program(nsteps), args, nsteps)
        out[name] = {"us_per_step": t * 1e6,
                     "gpts_per_s": N * N / t / 1e9}
    return out


def measure_psy_fused(nsteps=66):
    """The PSy-layer flagship (metadata kernels + one Schedule) on its
    fused tier, at the deepest repeat count its halo allows."""
    from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta
    from dl_esm_inf_tpu.models.nemolite2d_psy import NemoLite2DPsy

    psy = NemoLite2DPsy(N, N, ndomains=1, halo_width=8)
    psy.set_initial_ssh(gaussian_eta(N, N, amp=0.2))
    r = psy._sched.max_fused_repeats()
    run = psy._sched.fused_program(nsteps, repeats=r)
    rows = [[psy._scalars_at(i * r + j) for j in range(r)]
            for i in range(nsteps)]

    def go():
        run(scalars=rows)
        psy.sshn_t.data.block_until_ready()

    go()
    per_step = _best(go, reps=3) / (nsteps * r)
    return {"us_per_step": per_step * 1e6,
            "gpts_per_s": N * N / per_step / 1e9,
            "repeats_per_sweep": r}


def measure_solver(jax):
    """The comm-avoiding Chebyshev Helmholtz solve (K=4 iterations per
    exchange) at the flagship scale."""
    import dl_esm_inf_tpu as dl
    from dl_esm_inf_tpu.ops.solvers import HelmholtzSolver

    tmask = np.ones((N, N), np.int32)
    tmask[0, :] = tmask[-1, :] = 0
    tmask[:, 0] = tmask[:, -1] = 0
    grid = dl.Grid(dl.ARAKAWA_C,
                   (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                   dl.OFFSET_NE, dtype="float32")
    grid.decompose(N, N, halo_width=4)
    dl.grid_init(grid, 1.0, 1.0, tmask)
    s = HelmholtzSolver(grid, 50.0, 50.0, method="chebyshev",
                        steps_per_exchange=4)
    rng = np.random.default_rng(0)
    b = dl.Field(grid, dl.T_POINTS, init_global_data=(
        rng.standard_normal((N, N)) * (tmask == 1)).astype(np.float32))
    x, info = s.solve(b)                       # compile + warm
    if not info["converged"]:
        raise RuntimeError(f"Chebyshev solve did not converge: {info}")
    t = _best(lambda: jax.block_until_ready(s.solve(b)[0]), reps=3)
    return {"solve_ms": t * 1e3, "iterations": info["iterations"]}


def main():
    import jax

    from dl_esm_inf_tpu.utils import compilation_cache
    compilation_cache.enable()           # before the backend starts
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2

    import jax.numpy as jnp
    from dl_esm_inf_tpu.models import nemolite2d as nl
    from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta

    m = nl.build(N, N, steps_per_sweep=4, dtype=jnp.float32)
    m.set_initial_ssh(gaussian_eta(N, N, amp=0.2))
    nsteps = 600
    args = (jnp.int32(0), (m.sshn_t.data, m.un.data, m.vn.data),
            m._mask_codes)
    per_step = step_time(m.step_program(nsteps), args, nsteps)
    out = m.step_program(nsteps)(*args)
    if not all(bool(jnp.isfinite(a).all()) for a in out):
        raise RuntimeError("non-finite flagship state")
    bw, copy_check = measure_copy_gbps(jax, jnp)
    mpts = N * N / per_step / 1e6
    roofline_mpts = bw * 1e9 / BYTES_PER_POINT / 1e6

    models = measure_client_models(jnp)
    models["psy_fused_flagship"] = measure_psy_fused()
    models["helmholtz_cheb_K4"] = measure_solver(jax)
    print(json.dumps({
        "metric": METRIC,
        "value": mpts,
        "unit": "Mpt/s/chip",
        "vs_baseline": mpts / roofline_mpts,
        "detail": {
            "us_per_step": per_step * 1e6,
            "measured_copy_gbps": bw,
            "copy_loop_check": copy_check,
            "roofline_mpts": roofline_mpts,
            "steps_per_sweep": m._sweep_K,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "models": models,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
