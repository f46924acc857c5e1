#!/usr/bin/env python
"""Weak-scaling harness (BASELINE config #5).

Fixes the per-shard tile size and grows the global domain with the
device count, reporting per-card throughput and efficiency vs the
1-device run.  On a host with several GPUs one process drives them all
(the halo exchange is a ``ppermute`` that XLA hands to NCCL); ``--cpu``
runs the same program on a virtual CPU mesh (mechanism check only).

Usage:
    python scripts/scaling.py [--tile 1024] [--steps 200] [--devices 1,2,4]
    python scripts/scaling.py --cpu          # force the virtual CPU mesh
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tile", type=int, default=512,
                    help="per-shard tile size (tile x tile points)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--devices", type=str, default="")
    ap.add_argument("--cpu", action="store_true",
                    help="force an 8-device virtual CPU mesh")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
    # enable AFTER the platform pin: CPU entries live in a per-host
    # fingerprint subdirectory (utils/compilation_cache.py)
    from dl_esm_inf_tpu.utils import compilation_cache
    compilation_cache.enable()
    import jax.numpy as jnp
    from dl_esm_inf_tpu.core.decomposition import choose_process_grid
    from dl_esm_inf_tpu.models import nemolite2d as nl
    from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta

    ndev_avail = len(jax.devices())
    counts = ([int(c) for c in args.devices.split(",") if c]
              if args.devices else
              sorted({n for n in (1, 2, 4, 8, ndev_avail)
                      if n <= ndev_avail}))
    # On a virtual CPU mesh the devices share ONE host's cores, so
    # per-chip "efficiency" falls as 1/n BY CONSTRUCTION — those rows
    # validate the harness and the sharded program only.  Name the
    # field accordingly so the artifact cannot be read as hardware
    # weak-scaling.
    on_cpu_mesh = jax.default_backend() == "cpu"
    eff_field = ("cpu_mesh_contention_eff" if on_cpu_mesh
                 else "weak_scaling_eff")
    rows = []
    base = None
    for n in counts:
        px, py = choose_process_grid(n, 1, 1)
        gnx, gny = args.tile * px, args.tile * py
        m = nl.build(gnx, gny, ndomains=n, halo_width=2)
        m.set_initial_ssh(gaussian_eta(gnx, gny, amp=0.2))
        state = (m.sshn_t.data, m.un.data, m.vn.data)
        prog = m.step_program(args.steps)
        prog(jnp.int32(0), state, m._mask_codes)[0].block_until_ready()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            prog(jnp.int32(0), state, m._mask_codes)[0].block_until_ready()
            best = min(best, time.perf_counter() - t0)
        per_step = best / args.steps
        gpts = gnx * gny / per_step
        per_chip = gpts / n
        if base is None:
            base = per_chip
        row = {"devices": n, "grid": f"{gnx}x{gny}",
               "pts_per_s": round(gpts / 1e6, 1),
               "pts_per_s_per_chip_M": round(per_chip / 1e6, 1),
               eff_field: round(per_chip / base, 4)}
        if on_cpu_mesh:
            row["note"] = ("mechanism-only: virtual CPU devices share "
                           "one host's cores, so this ratio falls as "
                           "1/n by construction; NOT hardware "
                           "weak-scaling efficiency")
        rows.append(row)
        print(json.dumps(rows[-1]), flush=True)

    dev = jax.devices()[0]
    print(json.dumps({"summary": rows, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    sys.exit(main())
