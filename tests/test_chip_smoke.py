"""The phases of ``chip_smoke.py`` at small sizes on the CPU mesh: each
compares what it runs with its reference and fails loudly when they
part.  On the card the script runs them at full size."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

_REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke(monkeypatch):
    """The script as a module; the working precision its phases set is
    restored afterwards."""
    from dl_esm_inf_tpu.core import kinds

    monkeypatch.setattr(kinds, "_working_dtype", kinds._working_dtype)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", _REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("phase,args", [
    ("phase_f64", (34, 64)),
    ("phase_clients", (48, 12)),
    ("phase_four", (64, 10)),
])
def test_phase_passes_on_cpu(smoke, phase, args, capsys):
    """The reference comparisons hold at small size (the four-domain
    run bitwise equal to one domain on four CPU devices)."""
    getattr(smoke, phase)(*args)
    out = capsys.readouterr().out
    if phase == "phase_four":
        assert "bitwise=False" not in out
        assert out.count("bitwise=True") == 6


def test_flagship_phase_requires_the_fused_kernel(smoke):
    """Where the step does not lower to the fused kernel (every
    platform but CUDA), the flagship phase fails before it times
    anything."""
    with pytest.raises(AssertionError, match="0 fused-kernel calls"):
        smoke.phase_flagship(32, "cpu", 4)


def test_xla_only_withholds_the_kernel(smoke):
    """Inside ``xla_only`` the kernel covers no call; outside it covers
    the flagship's float32 blocks again."""
    import jax.numpy as jnp
    from dl_esm_inf_tpu.models import nemolite2d_kernel as nk

    a = jnp.zeros((8, 8), jnp.float32)
    with smoke.xla_only():
        assert not nk.covers(a, 100.0, 1e3, 1e3)
    assert nk.covers(a, 100.0, 1e3, 1e3)


def test_check_paths_fails_past_its_tolerance(smoke):
    ref = {"x": np.ones((4, 4))}
    smoke.check_paths("same", {"x": ref["x"] + 1e-6}, ref, 1e-4)
    with pytest.raises(AssertionError, match="far"):
        smoke.check_paths("far", {"x": ref["x"] + 1e-3}, ref, 1e-4)
    with pytest.raises(AssertionError, match="non-finite"):
        smoke.check_paths("nan", {"x": ref["x"] * np.nan}, ref, 1e-4)
