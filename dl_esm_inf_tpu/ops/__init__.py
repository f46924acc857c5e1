"""Per-shard compute: stencil primitives and the K-step sweep schedule."""
from . import stencils  # noqa: F401
from . import sweep  # noqa: F401
from .sweep import make_stencil_sweep, set_steps_per_exchange  # noqa: F401
