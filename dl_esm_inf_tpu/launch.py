"""Local multi-process launcher: ``python -m dl_esm_inf_tpu.launch``.

The moral equivalent of ``mpirun -np N python script.py`` for the
multi-controller JAX model: spawns N copies of a script, each a JAX
process, wired together through the env protocol
:func:`~.parallel.environment.initialise` understands
(``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID``).  On a cluster the resource manager plays this
role; locally this launcher runs one process per GPU of the host (each
rank sees only its own card through ``CUDA_VISIBLE_DEVICES``), or, with
``--devices-per-process``, N virtual CPU devices per process — exactly
as the reference CI oversubscribes MPI ranks on one VM
(makefile-test.yml:59).

    python -m dl_esm_inf_tpu.launch -n 2 my_model_script.py [args...]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(base: dict, pid: int, num_processes: int, port: int,
             devices_per_process: int | None = None) -> dict:
    """The environment of rank ``pid``: the coordinator protocol, plus
    either ``devices_per_process`` forced virtual CPU devices or ONE
    card — the ``pid``-th of the cards ``base`` makes visible (all of
    the host's when it names none).  A JAX process claims every card it
    can see, so without this each rank would reserve all of them."""
    env = dict(base)
    env["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
    env["JAX_NUM_PROCESSES"] = str(num_processes)
    env["JAX_PROCESS_ID"] = str(pid)
    if devices_per_process:
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "") +
            f" --xla_force_host_platform_device_count="
            f"{devices_per_process}").strip()
        env["DL_ESM_FORCE_CPU_DEVICES"] = str(devices_per_process)
        return env
    visible = [c for c in env.get("CUDA_VISIBLE_DEVICES", "").split(",")
               if c.strip()]
    if visible and pid >= len(visible):
        raise ValueError(
            f"rank {pid} has no card: CUDA_VISIBLE_DEVICES lists "
            f"{len(visible)}")
    env["CUDA_VISIBLE_DEVICES"] = visible[pid] if visible else str(pid)
    return env


def launch(script: str, args, num_processes: int = 2,
           devices_per_process: int | None = None,
           port: int | None = None, base_env: dict | None = None) -> int:
    """Spawn ``num_processes`` copies of ``script``; returns the first
    nonzero exit code (0 if all succeed).  ``port=None`` picks a free
    coordinator port (concurrent launches on one box must not collide);
    ``base_env`` overrides the inherited environment."""
    if port is None:
        port = _free_port()
    procs = []
    for pid in range(num_processes):
        env = rank_env(os.environ if base_env is None else base_env, pid,
                       num_processes, port, devices_per_process)
        procs.append(subprocess.Popen(
            [sys.executable, script, *args], env=env))
    # Poll the whole gang: if any rank dies with a nonzero status,
    # terminate the rest immediately (an mpirun-style abort) instead
    # of letting survivors block in distributed init until the JAX
    # coordinator timeout; on interrupt, no orphans are left holding
    # the coordinator port.
    rc = 0
    try:
        live = list(procs)
        while live:
            time.sleep(0.2)
            still = []
            for p in live:
                code = p.poll()
                if code is None:
                    still.append(p)
                elif code != 0:
                    rc = rc or code
            live = still
            if rc:                       # first failure aborts the gang
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return rc


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-n", "--num-processes", type=int, default=2)
    ap.add_argument("--devices-per-process", type=int, default=None,
                    help="force this many virtual CPU devices per "
                         "process (local testing); omit to give each "
                         "process one GPU")
    ap.add_argument("--port", type=int, default=None,
                    help="coordinator port (default: pick a free one)")
    ap.add_argument("script")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    ns = ap.parse_args(argv)
    sys.exit(launch(ns.script, ns.args, ns.num_processes,
                    ns.devices_per_process, ns.port))


if __name__ == "__main__":
    main()
