"""Profiling, tracing and comms observability.

The reference has no tracing — only compile-time DEBUG/DEBUG_COMMS
printf gates (parallel_comms_mod.f90:41-43) and decomposition statistics
(parallel_mod.f90:319-330).  Upgrades:

* :class:`StepTimer` — wall-clock step timing with a device fence and
  the slope method (two chain lengths) that cancels fixed dispatch/RPC
  latency (see bench.py).
* :func:`trace` — context manager around ``jax.profiler`` producing a
  TensorBoard-compatible device trace.
* :func:`comms_schedule` — the DEBUG_COMMS analogue: the static
  neighbour schedule a halo spec will execute (direction, peer pairs,
  strip shapes), readable without running anything — the moral
  equivalent of dumping map_comms' send/recv lists.
* :func:`decomposition_report` — go_decompose's load-imbalance banner.
"""
from __future__ import annotations

import contextlib
import time

from ..core.decomposition import Decomposition
from ..parallel.halo import HaloSpec, _perms


class StepTimer:
    """Accumulates per-call wall times around a fenced device call."""

    def __init__(self):
        self.times: list[float] = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    @property
    def best(self) -> float:
        return min(self.times) if self.times else float("nan")

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    def summary(self) -> dict:
        return {"n": len(self.times), "best_s": self.best,
                "mean_s": self.mean}


@contextlib.contextmanager
def trace(logdir: str):
    """Device trace via the JAX profiler (view in TensorBoard/Perfetto)."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def comms_schedule(spec: HaloSpec, depth: int = 1) -> list[dict]:
    """The static message schedule one exchange executes.

    Each entry is one ppermute phase: axis, direction, the (src, dst)
    LOGICAL-TILE pairs, and the strip shape in elements.  With one tile
    per device (repx == repy == 1) tile indices ARE device indices;
    under over-decomposition, pairs whose tiles share a device are
    local strip moves and only the device-crossing pairs become
    collective messages.  The analogue of the reference's per-message
    DEBUG_COMMS logs (parallel_comms_mod.f90:1613-1661), but available
    statically.
    """
    if depth < 1 or depth > spec.halo:
        raise ValueError(
            f"halo-exchange depth {depth} outside [1, halo={spec.halo}] "
            "— this schedule could never be executed")
    sched = []
    h, d = spec.halo, depth
    if spec.nprocx > 1 or spec.wrap_x:
        fwd, bwd = _perms(spec.nprocx, spec.wrap_x)
        sched.append({"axis": "x", "direction": "east",
                      "pairs": fwd, "strip": (spec.local_ny, d),
                      "src_cols": (h + spec.tile_nx - d, h + spec.tile_nx),
                      "dst_cols": (h - d, h)})
        sched.append({"axis": "x", "direction": "west",
                      "pairs": bwd, "strip": (spec.local_ny, d),
                      "src_cols": (h, h + d),
                      "dst_cols": (h + spec.tile_nx, h + spec.tile_nx + d)})
    if spec.nprocy > 1 or spec.wrap_y:
        fwd, bwd = _perms(spec.nprocy, spec.wrap_y)
        sched.append({"axis": "y", "direction": "north",
                      "pairs": fwd, "strip": (d, spec.local_nx),
                      "src_rows": (h + spec.tile_ny - d, h + spec.tile_ny),
                      "dst_rows": (h - d, h)})
        sched.append({"axis": "y", "direction": "south",
                      "pairs": bwd, "strip": (d, spec.local_nx),
                      "src_rows": (h, h + d),
                      "dst_rows": (h + spec.tile_ny, h + spec.tile_ny + d)})
    return sched


def decomposition_report(decomp: Decomposition) -> str:
    """Human-readable decomposition + load-imbalance banner

    (reference parallel_mod.f90:292-330)."""
    st = decomp.imbalance_stats()
    lines = [
        f"go_decompose: using grid of {decomp.nprocx}x{decomp.nprocy}",
        f"Tile width = {decomp.tile_nx}, tile height = {decomp.tile_ny}",
    ]
    for r, s in enumerate(decomp.subdomains):
        g, i = s.global_, s.internal
        lines.append(
            f"subdomain[{r}] global ({g.xstart}:{g.xstop})"
            f"({g.ystart}:{g.ystop}), interior ({i.xstart}:{i.xstop})"
            f"({i.ystart}:{i.ystop})")
    lines += [
        f"Mean sub-domain size = {st['mean_pts']:.1f} pts",
        f"Min,max sub-domain size (pts) = {st['min_pts']},{st['max_pts']}",
        f"Domain load imbalance (%) = {st['imbalance_pct']:.2f}",
        f"Max sub-domain dims are {st['max_width']}x{st['max_height']}",
    ]
    return "\n".join(lines)
