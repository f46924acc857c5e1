"""Process-hygiene regression tests.

* No module-global compiled-program cache anywhere in the package may
  be unbounded: a long-lived service cycling through grids/meshes must
  not grow without limit.  (The reference has no JIT caches at all —
  its map_comms lists are one-per-grid and freed with the grid.)
* The persistent compile cache lives where ``JAX_COMPILATION_CACHE_DIR``
  says, else at the fixed ``<repo>/.jax_cache``.  XLA:CPU entries are
  host machine code; they are isolated per host fingerprint so a cache
  directory shared across machines can never serve an executable
  compiled for different CPU features (``cpu_aot_loader.cc`` "could
  lead to execution errors such as SIGILL").
* The device entry points (``bench.py``, ``chip_smoke.py``) fail,
  printing no result, where there is no GPU.
* The launcher gives each rank one card.
"""
from __future__ import annotations

import importlib
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

_REPO = Path(__file__).resolve().parents[1]


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = (str(_REPO) + os.pathsep
                         + env.get("PYTHONPATH", ""))
    # do NOT inherit the suite's forced 8-device flag: the children
    # must run the 1-device configuration a real standalone run gets,
    # and a collective-heavy multi-device child beside the suite's
    # live CPU mesh is the measured-SIGABRT class CLAUDE.md forbids
    env.pop("XLA_FLAGS", None)
    return env


def test_no_unbounded_lru_caches():
    """Every functools cache defined in the package is bounded."""
    import dl_esm_inf_tpu

    offenders = []
    for info in pkgutil.walk_packages(dl_esm_inf_tpu.__path__,
                                      "dl_esm_inf_tpu."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if not getattr(obj, "__module__", "").startswith(
                    "dl_esm_inf_tpu"):
                continue
            if callable(getattr(obj, "cache_info", None)) \
                    and hasattr(obj, "cache_clear"):
                if obj.cache_info().maxsize is None:
                    offenders.append(f"{info.name}.{name}")
    assert not offenders, (
        f"unbounded lru_cache(maxsize=None) caches: {sorted(offenders)}")


def test_cpu_cache_dir_is_host_fingerprinted(tmp_path):
    """enable() under a CPU platform pin lands in the per-host subdir
    (the suite's conftest pinned jax_platforms=cpu before any import),
    while accelerator processes keep the shared root."""
    from dl_esm_inf_tpu.utils import compilation_cache as cc

    try:
        d = Path(cc.enable(tmp_path))
        assert d == tmp_path / f"cpu-{cc.host_fingerprint()}"
        assert d.is_dir()
    finally:
        cc.enable()   # restore the suite's shared cache directory
    assert cc.cache_dir_for(tmp_path, cpu=False) == tmp_path
    assert cc.cache_dir_for(tmp_path, cpu=True).name.startswith("cpu-")


def test_cpu_persistent_cache_round_trip_clean(tmp_path):
    """A CPU-backend write-then-read of the persistent cache emits no
    cpu_aot_loader machine-feature complaints, and its entries live in
    the fingerprint subdirectory, never the shared root."""
    code = (
        "import os, sys\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from dl_esm_inf_tpu.utils import compilation_cache\n"
        "compilation_cache.enable(sys.argv[1])\n"
        "import jax.numpy as jnp\n"
        "print(float(jax.jit(lambda x: (x * 2 + 1).sum())"
        "(jnp.ones((64, 64)))))\n")
    for run in ("write", "read"):
        r = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                           capture_output=True, text=True, timeout=600,
                           cwd=_REPO, env=_child_env())
        assert r.returncode == 0, (run, r.stderr[-2000:])
        assert "cpu_aot_loader" not in r.stderr, (run, r.stderr[-2000:])
        assert "SIGILL" not in r.stderr, (run, r.stderr[-2000:])
    from dl_esm_inf_tpu.utils import compilation_cache as cc

    sub = tmp_path / f"cpu-{cc.host_fingerprint()}"
    assert sub.is_dir() and any(sub.iterdir()), "no entries persisted"
    assert not [p for p in tmp_path.iterdir() if p.is_file()], (
        "CPU entries leaked into the shared root")


@pytest.mark.parametrize("where", ["env", "default"])
def test_cache_dir_rules(tmp_path, monkeypatch, where):
    """``$JAX_COMPILATION_CACHE_DIR`` is used as is (no subdirectory, no
    other directory set); without it the cache is the fixed repo
    directory, CPU entries in the host-fingerprint subdirectory."""
    from dl_esm_inf_tpu.utils import compilation_cache as cc

    if where == "env":
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = tmp_path
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = cc.DEFAULT_DIR / f"cpu-{cc.host_fingerprint()}"
    try:
        got = Path(cc.enable())
        assert got == want
        import jax
        assert jax.config.jax_compilation_cache_dir == str(want)
    finally:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        cc.enable()   # restore the suite's shared cache directory
    assert cc.DEFAULT_DIR == _REPO / ".jax_cache"


@pytest.mark.parametrize("pin,cpu", [("cpu", True), ("cuda", False)])
def test_cache_platform_comes_from_the_pin(pin, cpu):
    """The CPU decision reads the pinned platform (here
    ``JAX_PLATFORMS``) without starting a backend."""
    code = ("from dl_esm_inf_tpu.utils import compilation_cache as cc\n"
            "from jax._src import xla_bridge\n"
            "print(cc._cpu_backend(), bool(xla_bridge._backends))\n")
    env = _child_env()
    env["JAX_PLATFORMS"] = pin
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=_REPO, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == [str(cpu), "False"]


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_device_scripts_fail_without_a_gpu(script):
    """On the CPU each exits non-zero and prints no result line."""
    env = _child_env()
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, str(_REPO / script)],
                       capture_output=True, text=True, timeout=600,
                       cwd=_REPO, env=env)
    assert r.returncode != 0, r.stdout[-2000:]
    assert '"ok": true' not in r.stdout
    assert not [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert "needs a GPU" in r.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    """``chip_smoke.py`` alone in a directory has nothing to drive."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((_REPO / "chip_smoke.py").read_text())
    env = _child_env()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ""
    r = subprocess.run([sys.executable, str(lone)], capture_output=True,
                       text=True, timeout=600, cwd=tmp_path, env=env)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("visible,want", [
    (None, ["0", "1", "2"]), ("4,5,6,7", ["4", "5", "6"])])
def test_launch_gives_each_rank_one_card(visible, want):
    """Without forced CPU devices, rank i sees only the i-th visible
    card, and every rank gets the coordinator protocol."""
    from dl_esm_inf_tpu.launch import rank_env

    base = {"PATH": "/bin"}
    if visible is not None:
        base["CUDA_VISIBLE_DEVICES"] = visible
    for pid in range(3):
        env = rank_env(base, pid, 3, 1234)
        assert env["CUDA_VISIBLE_DEVICES"] == want[pid]
        assert env["JAX_COORDINATOR_ADDRESS"] == "localhost:1234"
        assert env["JAX_NUM_PROCESSES"] == "3"
        assert env["JAX_PROCESS_ID"] == str(pid)
        assert "DL_ESM_FORCE_CPU_DEVICES" not in env
    assert base == {"PATH": "/bin", **(
        {} if visible is None else {"CUDA_VISIBLE_DEVICES": visible})}


def test_launch_forced_cpu_devices_and_too_many_ranks():
    from dl_esm_inf_tpu.launch import rank_env

    env = rank_env({"XLA_FLAGS": "--foo"}, 1, 2, 99,
                   devices_per_process=4)
    assert env["XLA_FLAGS"] == (
        "--foo --xla_force_host_platform_device_count=4")
    assert env["DL_ESM_FORCE_CPU_DEVICES"] == "4"
    assert "CUDA_VISIBLE_DEVICES" not in env
    with pytest.raises(ValueError, match="rank 2 has no card"):
        rank_env({"CUDA_VISIBLE_DEVICES": "0,1"}, 2, 3, 99)
