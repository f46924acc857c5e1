"""Parallel execution environment.

JAX analogue of the reference's parallel facade
(parallel_mod.f90:42-63, gocean_mod.F90:22-57) and of the swappable
MPI/serial backends (parallel_utils_mod.f90 / parallel_utils_stub_mod.f90).

The reference achieves serial/distributed duality by swapping one source
file at build time; here the same program runs unchanged on a 1-device or
an N-device :class:`jax.sharding.Mesh` — the mesh *is* the backend.  There
is no process-private state to initialise beyond recording which devices
participate, and no message plumbing: communication is expressed as XLA
collectives over the mesh (see parallel/halo.py, parallel/collectives.py).

"Rank" terminology: the analogue of an MPI rank is a *shard index* in the
mesh (0-based, x-fastest like the reference's rank ordering).  Because JAX
is single-program over all shards, per-rank control flow lives in masks,
not branches; :func:`get_rank`/:func:`on_master` report the host process
(for logging) exactly like the reference's master-only prints
(gocean_mod.F90:92-97).
"""
from __future__ import annotations

import jax

_devices: list | None = None
_initialised: bool = False


class GOceanStop(RuntimeError):
    """Raised by :func:`stop` — analogue of gocean_stop -> parallel_abort

    (gocean_mod.F90:50-57).  In an SPMD JAX program every process raises,
    which is the moral equivalent of MPI_Abort.
    """


def initialise(devices=None, multihost: bool | None = None) -> None:
    """Analogue of gocean_initialise()/parallel_init (gocean_mod.F90:22-34).

    Records the device pool used for subsequent decompositions.  Safe to
    call more than once.

    Multi-host: when launched under a multi-host coordinator (env vars
    ``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``
    or an autodetected platform), pass ``multihost=True`` (or leave the
    default, which turns it on if a coordinator address is present) to
    run ``jax.distributed.initialize()`` first — the moral equivalent of
    the reference's ``mpi_init`` (parallel_utils_mod.f90:77-90).
    ``jax.devices()`` then spans all processes, halo exchanges cross
    process boundaries transparently, and the rest of the framework is
    unchanged.
    """
    global _devices, _initialised
    import os
    force = os.environ.get("DL_ESM_FORCE_CPU_DEVICES")
    if force and not _initialised:
        # local multi-process testing (dl_esm_inf_tpu.launch
        # --devices-per-process): claim N virtual CPU devices BEFORE
        # the backend comes up; harmless no-op if it already has.
        try:
            jax.config.update("jax_platforms", "cpu")
            jax.config.update("jax_num_cpu_devices", int(force))
        except RuntimeError:
            pass
    if multihost is None:
        multihost = bool(os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if multihost and not _initialised:
        # Must run BEFORE any backend initialisation — do not probe
        # jax.process_count() first (it initialises the backend and
        # dooms distributed.initialize()); let the no-op/raise behaviour
        # of a second initialize() handle re-entry instead.  jax itself
        # only auto-reads the coordinator address; process count/id come
        # from cluster autodetection (e.g. SLURM) OR from our env
        # protocol below (the mpirun-style launch the multi-process
        # tests use).
        kwargs = {}
        if os.environ.get("JAX_NUM_PROCESSES"):
            missing = [k for k in ("JAX_COORDINATOR_ADDRESS",
                                   "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")
                       if not os.environ.get(k)]
            if missing:
                raise RuntimeError(
                    "multi-process env protocol incomplete: set all of "
                    "JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and "
                    f"JAX_PROCESS_ID (missing: {', '.join(missing)})")
            kwargs = dict(
                coordinator_address=os.environ["JAX_COORDINATOR_ADDRESS"],
                num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
                process_id=int(os.environ["JAX_PROCESS_ID"]))
        try:
            jax.distributed.initialize(**kwargs)
        except RuntimeError as e:
            if "already" not in str(e).lower():
                raise
    _devices = list(devices) if devices is not None else list(jax.devices())
    _initialised = True


def finalise() -> None:
    """Analogue of gocean_finalise() (gocean_mod.F90:39-44)."""
    global _devices, _initialised
    _devices = None
    _initialised = False


def is_initialised() -> bool:
    return _initialised


def devices() -> list:
    if _devices is None:
        initialise()
    return _devices


def num_devices() -> int:
    return len(devices())


def get_rank() -> int:
    """Host-process index (for logging; reference ranks are 1-based, we use 0)."""
    return jax.process_index()


def get_num_ranks() -> int:
    return jax.process_count()


def on_master() -> bool:
    """True on the logging master (reference parallel_mod.f90:337-340)."""
    return jax.process_index() == 0


def stop(message: str = "") -> None:
    """Analogue of gocean_stop (gocean_mod.F90:50-57)."""
    raise GOceanStop(message)
