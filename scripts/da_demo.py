#!/usr/bin/env python
"""End-to-end data-assimilation demo: the full stack on one page.

Truth run -> perturbed ensemble forecast -> cycled LETKF analyses
(adaptive inflation) -> hybrid 4D-EnVar reanalysis of the initial
state.  Runs on the default backend (the GPU) or any CPU mesh:

    python scripts/da_demo.py
    python scripts/da_demo.py --cpu    # forced 8-device CPU mesh, f64

Every stage prints the quantitative check the test suite pins
(innovation reduction per cycle, sustained spread under adaptive
inflation, hybrid recovery error vs the static transform).
"""
import sys

if "--cpu" in sys.argv:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", True)

# enable AFTER the platform pin: CPU entries are ISA-capped and live
# in a per-host subdirectory (utils/compilation_cache.py)
from dl_esm_inf_tpu.utils import compilation_cache  # noqa: E402

compilation_cache.enable()

import numpy as np  # noqa: E402


def smooth_noise(rng, N, ncut=3):
    z = np.fft.rfft2(rng.standard_normal((N, N)))
    ky = np.abs(np.fft.fftfreq(N) * N)[:, None]
    kx = (np.fft.rfftfreq(N) * N)[None, :]
    f = np.fft.irfft2(np.where((ky <= ncut) & (kx <= ncut), z, 0),
                      s=(N, N))
    return f / np.abs(f).max()


def main():
    from dl_esm_inf_tpu.models import gravity_wave as gw
    from dl_esm_inf_tpu.models.assimilation import assimilate
    from dl_esm_inf_tpu.models.enkf import ETKF
    from dl_esm_inf_tpu.models.ensemble import Ensemble

    N, M, fsteps, cycles = 48, 8, 6, 4
    rng = np.random.default_rng(0)
    base = gw.gaussian_eta(N, N, amp=0.3)
    perts = np.stack([0.2 * smooth_noise(rng, N) for _ in range(M)])
    eta_true = (base + perts.mean(0) + 0.5 * (perts[1] - perts[3])
                + 0.05 * smooth_noise(rng, N))

    print(f"== truth run ({N}x{N} gravity wave, {cycles} x {fsteps} "
          f"steps) ==")
    truth = gw.build(N, N, dt=0.05, depth=10.0)
    truth.set_initial_eta(eta_true)
    obs = []
    for _ in range(cycles):
        truth.run(fsteps)
        obs.append(truth.gather()["eta"])

    print(f"== cycled LETKF ({M} members, localization 6 cells, "
          "adaptive inflation) ==")
    ens = Ensemble(gw.build(N, N, dt=0.05, depth=10.0), M)
    ens.set_member_states(0, base + perts)
    filt = ETKF(ens, sigma=1e-3, localization_radius=6.0,
                adaptive_inflation=True, inflation_max=10.0)
    for i, y in enumerate(obs):
        ens.run(fsteps)
        d = filt.analysis(y)
        print(f"  cycle {i + 1}: innovation {d['rms_innovation_before']:.4f}"
              f" -> {d['rms_innovation_after']:.4f}   spread "
              f"{d['spread_before']:.4f} -> {d['spread_after']:.4f}   "
              f"rho={d['inflation']:.2f}")
        assert d["rms_innovation_after"] < d["rms_innovation_before"]

    print("== hybrid 4D-EnVar reanalysis of the initial state "
          "(sparse obs: 1 point in 16) ==")
    ow = np.zeros((N, N))
    ow[2::4, 2::4] = 1.0
    sparse_obs = {(k + 1) * fsteps: o for k, o in enumerate(obs[:2])}
    ens0 = Ensemble(gw.build(N, N, dt=0.05, depth=10.0), M)
    ens0.set_member_states(0, base + perts)
    err = {}
    for mode in ("static sqrt-B", "hybrid EnVar"):
        m = gw.build(N, N, dt=0.05, depth=10.0)
        res = assimilate(
            m, sparse_obs, iters=60, optimizer="lbfgs", obs_weight=ow,
            smooth_scale=2.0, background_weight=1e-5,
            ensemble=ens0 if mode == "hybrid EnVar" else None)
        e = np.sqrt(np.mean((res["eta0"][1:-1, 1:-1]
                             - eta_true[1:-1, 1:-1]) ** 2))
        err[mode] = e
        extra = ""
        if "ensemble_weights" in res:
            a = res["ensemble_weights"]
            extra = f"   weights: a1={a[1]:+.2f} a3={a[3]:+.2f}"
        print(f"  {mode:13s}: cost {res['cost_history'][0]:.3e} -> "
              f"{res['cost_history'][-1]:.3e}   RMS err {e:.4f}{extra}")
    assert err["hybrid EnVar"] < err["static sqrt-B"]
    print("DA DEMO PASS")


if __name__ == "__main__":
    main()
