#!/usr/bin/env python
"""Smoke run of dl_esm_inf_tpu on an NVIDIA GPU, through the entry
points a user calls, at the flagship's real width.

    python chip_smoke.py              # one card: phases 1-6
    python chip_smoke.py --four       # four cards: the 2x2-mesh flagship
                                      # and the one-card run it matches

Phases (one card):

1. the platform is ``gpu``; the card's name and power limit;
2. ``models.example_model``: four checksums of 4.00000000E+01;
3. the flagship at 4096^2 float32 (16.8 M points, about 4x the card's
   L2 in state), one step per exchange (K=1) and four (K=4), built as a
   user builds it: ``memory_analysis()`` and ``cost_analysis()`` of one
   sweep, 10 steps against the NumPy golden, and the time of 200 steps
   through ``step_program``, in turns with the same programs compiled
   with the fused kernel withheld (what XLA makes of the plain ``jnp``
   step); then the CLI, ``nemolite2d.main``, for 10 steps against the
   golden;
4. the flagship in float64 at 258^2 (the GOcean default), 1024 steps
   against the golden, and how far ``jnp.sin`` in float64 is from the
   libm sine on the card;
5. each other K-step client once at 1024^2 against its own K=1 path;
6. the tests marked ``gpu``, in this process.

Every phase that fails ends the run with a non-zero exit code, and a
run without a GPU exits non-zero before printing any result.  One
process drives the card(s).  The last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import numpy as np

# f32 model against the f64 golden after 10 steps: each step rounds
# ~10^2 operations at the f32 unit roundoff 6e-8, and the differences
# in the momentum terms cancel to ~1e-2 of the state, so the state
# drifts by ~1e-5 of its scale.  The bound is relative to each field's
# largest magnitude (velocities start at zero, so a pointwise rtol
# alone would judge roundoff on near-zero values).
F32_GOLDEN_RTOL, F32_GOLDEN_ATOL_SCALE = 1e-4, 1e-4
# the float64 golden bound of tests/test_nemolite2d_golden.py
F64_GOLDEN_RTOL, F64_GOLDEN_ATOL = 1e-8, 1e-10
# a K-step client against its own K=1 path in f32: the same operations
# in the same order, but XLA may contract a multiply-add into an FMA in
# one program and not the other — an f32 ulp per step, relative to the
# field's scale
F32_PATH_TOL = 1e-4


def card_lines():
    """``name, power.limit`` of each card, from nvidia-smi (a separate
    process that does not import JAX)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def _max_rel(a, b):
    """max |a - b| over max |b| (0 when both vanish)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = float(np.abs(b).max())
    return float(np.abs(a - b).max()) / scale if scale else 0.0


def check_paths(name, got: dict, want: dict, tol):
    """Field-by-field agreement of two runs, relative to field scale."""
    worst = 0.0
    for k in want:
        if not np.all(np.isfinite(np.asarray(got[k], np.float64))):
            raise AssertionError(f"{name}: non-finite {k}")
        worst = max(worst, _max_rel(got[k], want[k]))
    print(f"  {name}: max |diff| / max |ref| = {worst:.3e} "
          f"(tol {tol:.0e})", flush=True)
    if worst > tol:
        raise AssertionError(f"{name}: {worst:.3e} > {tol:.0e}")


def check_golden(label, got, want, rtol, atol_scale=None, atol=None):
    from dl_esm_inf_tpu.models.nemolite2d_golden import compare
    for k, w in want.items():
        a = atol if atol is not None else atol_scale * float(
            np.abs(w).max())
        r = compare({k: got[k]}, {k: w}, rtol=rtol, atol=a)[k]
        print(f"  {label} {k}: max_abs {r['max_abs']:.3e}  max_rel "
              f"{r['max_rel']:.3e}  (rtol {rtol:.0e}, atol {a:.3e})",
              flush=True)
        if not r["ok"]:
            raise AssertionError(f"{label} {k} outside the golden bound")


def best_time(f, reps=3):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        f()
        best = min(best, time.perf_counter() - t0)
    return best


def _one(x):
    """cost_analysis() is a dict, or a one-element list of dicts."""
    return x[0] if isinstance(x, (list, tuple)) else x


def phase_example():
    from dl_esm_inf_tpu.models import example_model
    sums = example_model.run()
    for name, val in sums.items():
        if f"{val:.8E}" != "4.00000000E+01":
            raise AssertionError(f"example_model {name} checksum {val}")


def flagship_args(m):
    import jax.numpy as jnp
    state = (m.sshn_t.data, m.un.data, m.vn.data)
    return (jnp.int32(0), state, m._mask_codes)


def xla_only():
    """Within this context, programs traced for the flagship take the
    plain ``jnp`` step on every platform: the fused kernel is withheld,
    so XLA compiles the step itself."""
    from unittest import mock
    from dl_esm_inf_tpu.models import nemolite2d_kernel as nk
    return mock.patch.object(nk, "covers", lambda *a: False)


def engine_program(N, K, engine, ssh0, golden, ntime):
    """The flagship built as a user builds it, its sweep's analyses
    printed, 10 steps checked against the golden; returns the state
    after them, and the warmed ``ntime``-step program with its
    arguments.  ``engine`` is "kernel" (what the platform picks) or
    "xla" (inside :func:`xla_only`)."""
    import jax.numpy as jnp
    from dl_esm_inf_tpu.models import nemolite2d as nl

    m = nl.build(N, N, ndomains=1, dtype=jnp.float32, steps_per_sweep=K)
    m.set_initial_ssh(ssh0)
    comp = m.step_program(K).lower(*flagship_args(m)).compile()
    hlo = comp.as_text()
    kernels = hlo.count("__gpu$xla.gpu.triton")
    fusions = len(re.findall(r"=\s*\S+\s+fusion\(", hlo))
    bpp = float(_one(comp.cost_analysis()).get(
        "bytes accessed", float("nan"))) / (N * N * K)
    print(f"  K={K} {engine}: {kernels} fused-kernel call(s), {fusions} "
          f"fusions per sweep of {K}; cost_analysis {bpp:.2f} B/pt/step "
          f"(minimal 25; XLA counts no bytes of a kernel call)",
          flush=True)
    print(f"  K={K} {engine} memory_analysis: {comp.memory_analysis()}",
          flush=True)
    if kernels != (K if engine == "kernel" else 0):
        raise AssertionError(f"K={K} {engine}: {kernels} fused-kernel "
                             f"calls in a sweep of {K} steps")
    m.run(10)
    state = m.gather()
    check_golden(f"K={K} {engine} 10 steps vs golden", state, golden,
                 F32_GOLDEN_RTOL, atol_scale=F32_GOLDEN_ATOL_SCALE)
    prog, args = m.step_program(ntime), flagship_args(m)
    prog(*args)[0].block_until_ready()               # compile + warm
    return state, (prog, args)


def phase_flagship(N, card, ntime):
    import contextlib

    import dl_esm_inf_tpu as dl
    from dl_esm_inf_tpu.models import nemolite2d as nl
    from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta
    from dl_esm_inf_tpu.models.nemolite2d_golden import golden_run

    ssh0 = gaussian_eta(N, N, amp=0.2)
    p = nl.Params()
    golden = golden_run(nl.default_tmask(N, N, True), ssh0, 10, p,
                        1000.0, 1000.0, 100.0)
    for K in (1, 4):
        states, progs = {}, {}
        for engine in ("kernel", "xla"):
            with (xla_only() if engine == "xla"
                  else contextlib.nullcontext()):
                states[engine], progs[engine] = engine_program(
                    N, K, engine, ssh0, golden, ntime)
        # the same arithmetic in the same order
        check_paths(f"K={K} kernel vs xla after 10 steps", states["kernel"],
                    states["xla"], F32_PATH_TOL)
        print(f"  K={K} kernel vs xla bitwise: " + ", ".join(
            f"{k}={np.array_equal(a, states['xla'][k])}"
            for k, a in states["kernel"].items()), flush=True)
        # in turns, so a drift of the card's clock touches both alike
        for engine in ("kernel", "xla", "xla", "kernel"):
            prog, args = progs[engine]
            us = best_time(
                lambda: prog(*args)[0].block_until_ready()) / ntime * 1e6
            print(f"  K={K} {engine} {N}^2 f32: {us:.2f} us/step, "
                  f"{N * N / us:.1f} Mpt/s over {ntime} steps through "
                  f"step_program [{card}]", flush=True)
        del states, progs, prog, args

    # the CLI, as ``python -m dl_esm_inf_tpu.models.nemolite2d N 10``
    # runs it, in this process.  Its dtype is the working precision,
    # which x64 mode (on for phase 4) would make float64.
    dl.set_working_precision("float32")
    m = nl.main([str(N), "10"])
    if m.grid.dtype != np.float32:
        raise AssertionError(f"the CLI ran in {m.grid.dtype}")
    check_golden("CLI 10 steps vs golden", m.gather(), golden,
                 F32_GOLDEN_RTOL, atol_scale=F32_GOLDEN_ATOL_SCALE)


def phase_f64(N, nsteps):
    import jax
    import jax.numpy as jnp
    import dl_esm_inf_tpu as dl
    from dl_esm_inf_tpu.models import nemolite2d as nl
    from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta
    from dl_esm_inf_tpu.models.nemolite2d_golden import golden_run
    from dl_esm_inf_tpu.ops.trig import sin64

    dl.set_working_precision("float64")
    ssh0 = gaussian_eta(N, N, amp=0.2)
    m = nl.build(N, N, ndomains=1, dtype=jnp.float64)
    m.set_initial_ssh(ssh0)
    m.run(nsteps)
    want = golden_run(nl.default_tmask(N, N, True), ssh0, nsteps, m.p,
                      m.grid.dx, m.grid.dy, 100.0)
    check_golden(f"f64 {N}^2 {nsteps} steps vs golden", m.gather(), want,
                 F64_GOLDEN_RTOL, atol=F64_GOLDEN_ATOL)
    x = np.linspace(-200.0, 200.0, 1 << 20)
    ref = np.sin(x)
    xs = jnp.asarray(x, jnp.float64)
    for name, f in (("jnp.sin", jnp.sin), ("ops.trig.sin64", sin64)):
        got = np.asarray(jax.jit(f)(xs))
        print(f"  f64 max|{name}(x) - libm sin(x)| on [-200, 200]: "
              f"{np.abs(got - ref).max():.3e}", flush=True)


def phase_clients(N, nsteps):
    import jax.numpy as jnp
    import dl_esm_inf_tpu as dl
    from dl_esm_inf_tpu.models import gravity_wave as gw
    from dl_esm_inf_tpu.models import tracer as tc
    from dl_esm_inf_tpu.models import twolayer as tl
    from dl_esm_inf_tpu.models.nemolite2d_psy import NemoLite2DPsy
    from dl_esm_inf_tpu.ops.solvers import HelmholtzSolver

    dl.set_working_precision("float32")
    eta0 = gw.gaussian_eta(N, N, amp=0.5)

    def gravity(k):
        m = gw.build(N, N, ndomains=1, dt=0.005, dtype=jnp.float32,
                     steps_per_sweep=k)
        m.set_initial_eta(eta0)
        m.run(nsteps)
        return m.gather()
    check_paths("gravity wave K=8 vs K=1", gravity(8), gravity(1),
                F32_PATH_TOL)

    def twolayer(k):
        m = tl.build(N, N, ndomains=1, dt=0.01, steps_per_sweep=k)
        m.set_initial(eta1_global=eta0, eta2_global=-4.0 * eta0)
        m.run(nsteps)
        return m.gather()
    check_paths("two-layer K=8 vs K=1", twolayer(8), twolayer(1),
                F32_PATH_TOL)

    u, v = tc.streamfunction_velocities(
        gw.gaussian_eta(N, N, amp=20.0, width=0.2))

    def tracer(k):
        m = tc.build(N, N, ndomains=1, dt=0.2, u=u, v=v, kappa=0.02,
                     scheme="vanleer", steps_per_sweep=k)
        m.set_initial_tracer(gw.gaussian_eta(N, N, amp=1.0) + 0.01)
        m.run(nsteps)
        return m.gather()
    check_paths("van-Leer tracer K=4 vs K=1", tracer(4), tracer(1),
                F32_PATH_TOL)

    tmask = gw.default_tmask(N, N)
    b = (np.random.default_rng(0).standard_normal((N, N))
         * (tmask == 1)).astype(np.float32)

    def cheb(k):
        grid = dl.Grid(dl.ARAKAWA_C,
                       (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                       dl.OFFSET_NE, dtype="float32")
        grid.decompose(N, N, ndomains=1, halo_width=k)
        dl.grid_init(grid, 1.0, 1.0, tmask)
        s = HelmholtzSolver(grid, 50.0, 50.0, method="chebyshev",
                            steps_per_exchange=k)
        x, info = s.solve(dl.Field(grid, dl.T_POINTS, init_global_data=b))
        if not info["converged"]:
            raise AssertionError(f"Chebyshev K={k} not converged: {info}")
        print(f"  Chebyshev K={k}: {info['iterations']} iterations, "
              f"rel_res {info['rel_res']:.2e} (tol {s.tol:.0e})",
              flush=True)
        from dl_esm_inf_tpu.core import layout
        return {"x": layout.unstack_internal(grid.decomp, np.asarray(x))}
    check_paths("Chebyshev K=4 vs K=1", cheb(4), cheb(1), F32_PATH_TOL)

    psy_steps = 3 * max(1, nsteps // 6)

    def psy(fused):
        m = NemoLite2DPsy(N, N, ndomains=1, halo_width=8)
        m.set_initial_ssh(gw.gaussian_eta(N, N, amp=0.2))
        if fused:
            r = m._sched.max_fused_repeats()
            run = m._sched.fused_program(psy_steps // r, repeats=r)
            run(scalars=[[m._scalars_at(i * r + j) for j in range(r)]
                         for i in range(psy_steps // r)])
        else:
            m.run(psy_steps)
        return m.gather()
    check_paths("NemoLite2DPsy fused_program vs schedule", psy(True),
                psy(False), F32_PATH_TOL)


def phase_gpu_tests():
    """The ``gpu``-marked tests, in this process (a second JAX process
    could not reserve the card)."""
    import os
    from pathlib import Path

    import pytest
    os.environ["DL_ESM_TESTS_ON_DEVICE"] = "1"
    files = [str(p) for p in sorted(Path("tests").glob("test_*.py"))
             if "mark.gpu" in p.read_text()]
    rc = (pytest.main(["-q", "-s", "-m", "gpu", "-p", "no:cacheprovider",
                       *files])
          if files else pytest.ExitCode.NO_TESTS_COLLECTED)
    if rc == pytest.ExitCode.NO_TESTS_COLLECTED:
        print("  no tests carry the gpu marker", flush=True)
    elif rc != pytest.ExitCode.OK:
        raise AssertionError(f"gpu tests failed (pytest exit {rc})")


def phase_four(N, nsteps):
    import jax.numpy as jnp
    from dl_esm_inf_tpu.models import nemolite2d as nl
    from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta

    ssh0 = gaussian_eta(N, N, amp=0.2)
    for K in (1, 4):
        runs = {}
        for ndom in (4, 1):
            m = nl.build(N, N, ndomains=ndom, dtype=jnp.float32,
                         steps_per_sweep=K)
            m.set_initial_ssh(ssh0)
            m.run(nsteps)
            if ndom == 4:
                d = m.grid.decomp
                print(f"  K={K} 4 cards: {d.nprocx}x{d.nprocy} domains on "
                      f"a {dict(m.grid.mesh.shape)} mesh; checksums "
                      + "  ".join(f"{k}={v:.10E}"
                                  for k, v in m.checksums().items()),
                      flush=True)
            runs[ndom] = m.gather()
        # the step has no reductions, so the seams must be invisible
        # to the last bit
        for k in runs[1]:
            a, b = runs[4][k], runs[1][k]
            if not np.all(np.isfinite(a)):
                raise AssertionError(f"K={K} 4-card {k} non-finite")
            bitwise = bool(np.array_equal(a, b))
            print(f"  K={K} {k}: 4 cards vs 1 card: bitwise={bitwise}, "
                  f"max |diff| / max |ref| = {_max_rel(a, b):.3e} "
                  f"(required: bitwise)", flush=True)
            if not bitwise:
                raise AssertionError(f"K={K} {k}: 4-card run differs")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card flagship path only")
    ns = ap.parse_args(argv)

    import jax
    jax.config.update("jax_enable_x64", True)   # phase 4 needs float64
    from dl_esm_inf_tpu.utils import compilation_cache
    compilation_cache.enable()           # before the backend starts
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {devs[0].platform!r}",
              file=sys.stderr)
        return 2
    want = 4 if ns.four else 1
    if len(devs) < want:
        print(f"chip_smoke.py needs {want} device(s), found {len(devs)}",
              file=sys.stderr)
        return 2
    lines = card_lines()
    for ln in lines[:want]:
        print(f"card: {ln}", flush=True)
    card = lines[0]

    if ns.four:
        phases = [("four-card flagship", lambda: phase_four(8192, 50))]
    else:
        phases = [
            ("example_model", phase_example),
            ("flagship f32", lambda: phase_flagship(4096, card, 200)),
            ("flagship f64", lambda: phase_f64(258, 1024)),
            ("K-step clients", lambda: phase_clients(1024, 24)),
            ("gpu tests", phase_gpu_tests),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        print(f"phase {name}", flush=True)
        fn()
        print(f"phase {name}: passed in {time.perf_counter() - t0:.1f} s",
              flush=True)

    print(f"card: {card}")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
