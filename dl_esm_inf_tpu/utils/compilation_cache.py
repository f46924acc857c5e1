"""Persistent XLA compilation cache.

JAX's persistent compilation cache keys a serialized executable on
(HLO, backend fingerprint): with an on-disk directory, a re-run of the
same program skips its compile.  The reference has no analogue (Fortran
is compiled ahead of time — the property this restores to a JIT
runtime).

Directory rules (:func:`enable`):

* ``$JAX_COMPILATION_CACHE_DIR``, if set, is the cache — used as is,
  and no other directory is set;
* otherwise ``<repo>/.jax_cache`` (a fixed path: the path is part of
  what makes a later run hit), with CPU-backend entries in a
  per-host-fingerprint subdirectory (below).

CPU isolation: XLA:CPU entries are ahead-of-time HOST machine code,
loaded back through a machine-feature check (``cpu_aot_loader.cc``)
that jax's cache key does not cover.  Two defenses, for the CPU backend
only:

* ``--xla_cpu_max_isa=AVX2``: at AVX512, XLA embeds the LLVM *tuning*
  pseudo-features ``+prefer-no-scatter``/``+prefer-no-gather`` in the
  serialized executable, and the loader's host-feature enumeration
  never contains them — so EVERY reload errors "could lead to
  execution errors such as SIGILL", even written-and-read on one
  machine.  Capping codegen at AVX2 keeps the compile feature set
  inside what the check accepts: reloads are clean and the cache
  speedup remains.  The CPU mesh is a correctness harness, not a
  benchmark, so vector width does not matter there.
* a per-host-fingerprint SUBDIRECTORY (:func:`cache_dir_for`), so a
  cache directory shared across machines can never serve another
  host's AOT code.

Call :func:`enable` before the first compilation and AFTER pinning the
platform (``JAX_PLATFORMS`` or ``jax.config.update("jax_platforms",
...)``) or initialising the backend, so the CPU decision sees the
platform the process really uses.
"""
from __future__ import annotations

import hashlib
import os
import platform
from pathlib import Path

#: Repo-root cache directory (this file lives at
#: <repo>/dl_esm_inf_tpu/utils/compilation_cache.py).
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def host_fingerprint() -> str:
    """12-hex digest of the host CPU feature set (+ jax version).

    Two hosts whose /proc/cpuinfo feature flags differ may not share
    XLA:CPU AOT executables; hosts with identical flags may.  The jax
    version is folded in because the serialization format itself is
    version-bound."""
    import jax

    feats = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.split(":")[0].strip().lower() in ("flags",
                                                          "features"):
                    feats += " " + " ".join(
                        sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        feats += " " + platform.processor()
    digest = hashlib.sha256(
        f"{feats}|jax={jax.__version__}".encode()).hexdigest()
    return digest[:12]


def _cpu_backend() -> bool:
    """Does this process compile for the CPU backend?

    Decided without initialising a backend: the pinned platform list
    (``JAX_PLATFORMS`` or an in-process pin) if there is one, else the
    backend already initialised.  A process with neither is treated as
    an accelerator process."""
    import jax

    plats = getattr(jax.config, "jax_platforms", None)
    if plats:
        return str(plats).split(",")[0].strip() == "cpu"
    from jax._src import xla_bridge
    if xla_bridge._backends:  # noqa: SLF001 — read-only peek; the
        # public jax.default_backend() would INITIALISE a backend,
        # which must not happen before the caller's pins
        return jax.default_backend() == "cpu"
    return False


def cache_dir_for(root: Path, cpu: bool) -> Path:
    """The directory a backend's entries live in under ``root``."""
    return root / f"cpu-{host_fingerprint()}" if cpu else root


def enable(path: str | os.PathLike | None = None) -> str:
    """Point JAX's persistent compilation cache at a directory, by the
    module docstring's rules; an explicit ``path`` takes the place of
    the repo default.  Min-entry thresholds are zeroed, so every
    executable is persisted.  Returns the directory used (and creates
    it)."""
    import jax

    cpu = _cpu_backend()
    if cpu and "xla_cpu_max_isa" not in os.environ.get("XLA_FLAGS", ""):
        # must land before XLA builds its DebugOptions (first compile);
        # appended, never replacing (a caller may have pinned e.g.
        # --xla_force_host_platform_device_count)
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_cpu_max_isa=AVX2").strip()
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir and path is None:
        cache_dir = Path(env_dir)
    else:
        cache_dir = cache_dir_for(Path(path or DEFAULT_DIR), cpu)
    cache_dir.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(cache_dir))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return str(cache_dir)
