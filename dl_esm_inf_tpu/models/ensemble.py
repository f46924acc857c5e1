"""Ensemble execution: M perturbed replicas of a model in ONE program.

Ensemble forecasting is the bread-and-butter workflow of the codes the
reference serves; on MPI it means M separate job launches (the
reference has no batching concept — one `r2d_field` is one array,
field_mod.f90:139-166).  Here an ensemble is just a leading
axis: every stencil/mask op broadcasts over `(M, ly, lx)` blocks
unchanged, and the halo exchange already carries leading dimensions —
coalescing ALL members' edge strips into the same 4 messages per step
(`parallel/halo._exchange_block`), so the collective count is
independent of ensemble size.  The per-member arithmetic is the exact
op sequence of the single run: members are bitwise-identical to
running the base model M times (`tests/test_ensemble.py`).

Works with any jnp-path explicit model exposing the `_block_step(exch,
*state, *masks)` protocol (gravity_wave, shallow, twolayer).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core import layout
from ..parallel import halo as halo_mod
from ..parallel.halo import exchange_multi_fn


def _adapt(model):
    """(names, state fields, mask arrays, step_fn, exch_depth) for a
    supported model; ``step_fn(exch, state, masks, istep) -> state`` is
    the per-block step used inside shard_map (``istep`` is the global
    step index, for models with time-dependent forcing) and
    ``exch_depth`` the halo depth its per-step exchange needs."""
    from . import (gravity_wave, nemolite2d, semi_implicit, shallow,
                   tracer, twolayer)
    def plain(exch, st_, mk, istep):
        return tuple(model._block_step(exch, *st_, *mk))

    if isinstance(model, gravity_wave.GravityWaveModel):
        return (("eta", "u", "v"), (model.eta, model.u, model.v),
                (model._t_upd, model._u_wet, model._v_wet), plain, 1)
    if isinstance(model, tracer.TracerModel):
        # steady velocities ride as member-shared mask-like operands
        return (("c",), (model.c,),
                (model._u, model._v, model._t_upd, model._u_wet,
                 model._v_wet), plain, model.reach)
    if isinstance(model, tracer.CoupledTracer):
        # online-coupled members: each advances its OWN flow and
        # tracer; observing the plume corrects the flow through the
        # ensemble cross-covariances (tests/test_enkf.py)
        fs = model.flagship
        if fs._ht is not None:
            raise ValueError("coupled-tracer ensembles support flat "
                             "bathymetry")
        dx, dy = model.grid.dx, model.grid.dy

        def step_ct(exch, st_, mk, istep):
            ssh, un, vn, c = exch(tuple(st_))
            rtime = (istep + 1).astype(ssh.dtype) * fs.p.rdt
            forcing = nemolite2d.tidal_forcing(rtime, fs.p)
            ssh2, un2, vn2 = nemolite2d.step_math(
                ssh, un, vn, mk[0], fs.p, dx, dy, fs._fcor, fs.depth,
                forcing)
            c2 = tracer.tracer_step(
                c, un * mk[2], vn * mk[3], mk[1], mk[2], mk[3],
                dx=dx, dy=dy, dt=fs.p.rdt, kappa=model.kappa,
                scheme=model.scheme)
            return ssh2, un2, vn2, c2

        return (("ssh", "u", "v", "c"),
                (fs.sshn_t, fs.un, fs.vn, model.c),
                (fs._mask_codes, model._t_upd, model._u_wet,
                 model._v_wet), step_ct, 2)
    if isinstance(model, shallow.ShallowModel):
        return (("eta", "u", "v"), (model.eta, model.u, model.v), (),
                plain, 1)
    if isinstance(model, twolayer.TwoLayerModel):
        return (("eta1", "eta2", "u1", "v1", "u2", "v2"),
                (model.eta1, model.eta2, model.u1, model.v1,
                 model.u2, model.v2),
                (model._t_upd, model._u_wet, model._v_wet), plain, 1)
    from . import nlayer
    if isinstance(model, nlayer.NLayerModel):
        # multi-level fields: states are (M, L, ly, lx); the step math
        # is leading-dim agnostic and the exchange carries both axes
        return (("eta", "u", "v"), (model.eta, model.u, model.v),
                (model._t_upd, model._u_wet, model._v_wet), plain, 1)
    if isinstance(model, semi_implicit.SemiImplicitModel):
        # the in-step Helmholtz solve must be member-independent: the
        # dot-free Chebyshev iteration broadcasts over the member axis,
        # while CG's psum dot products would sum ACROSS members
        if model.solver != "chebyshev":
            raise ValueError(
                "an ensemble of implicit models needs "
                "solver='chebyshev': CG's dot products would couple "
                "the members into one scalar")
        masks = (model._t_upd, model._u_wet, model._v_wet,
                 model._weight, *model._coeffs, model._hu, model._hv,
                 model._obc)

        def step_si(exch, st_, mk, istep):
            return tuple(model._block_step(exch, istep, *st_,
                                           *mk)[:3])

        return (("eta", "u", "v"), (model.eta, model.u, model.v),
                masks, step_si, 1)
    if isinstance(model, nemolite2d.NemoLite2D):
        if getattr(model, "_ht", None) is not None:
            raise ValueError(
                "flagship ensembles support flat bathymetry (the "
                "variable-bathymetry operand plumbing is per-model; "
                "build without depth=<array>)")

        def step_nl(exch, st_, mk, istep):
            # the tidal forcing is time-dependent: istep threads the
            # GLOBAL step index through the member-broadcast step
            return tuple(model._block_step(exch, istep, *st_, *mk))

        # deep-halo builds (halo_width >= 2) run the communication-free
        # reach-2 chain in _block_step, which needs a depth-2 refresh —
        # the same depth the model's own step_program uses
        depth = min(model.grid.halo_spec.halo, 2) or 1
        return (("ssh", "u", "v"),
                (model.sshn_t, model.un, model.vn),
                (model._mask_codes,), step_nl, depth)
    raise TypeError(f"no ensemble adapter for {type(model).__name__}; "
                    "supported: GravityWaveModel, ShallowModel, "
                    "TwoLayerModel, NLayerModel, "
                    "SemiImplicitModel(chebyshev), NemoLite2D, "
                    "TracerModel")


class Ensemble:
    """M replicas of ``model``'s state advancing under one jit."""

    def __init__(self, model, n_members: int):
        if n_members < 1:
            raise ValueError("n_members must be >= 1")
        self.model = model
        self.n_members = int(n_members)
        (self._field_names, self._fields, self._masks,
         self._step_fn, self._exch_depth) = _adapt(model)
        self.grid = model.grid
        # per-field: the block axes are always the LAST TWO; any other
        # leading axes (member, vertical level) are replicated
        self._specs = tuple(
            P(*([None] * (f.data.ndim - 1)), "y", "x")
            for f in self._fields)
        self._shardings = tuple(NamedSharding(self.grid.mesh, s)
                                for s in self._specs)
        # every member starts from the base model's current state
        self.states = tuple(
            jax.device_put(jnp.broadcast_to(
                f.data, (self.n_members,) + f.data.shape), sh)
            for f, sh in zip(self._fields, self._shardings))
        # continue the base model's clock: time-dependent forcing in
        # the members picks up where the base run left off
        self._istep0 = int(getattr(model, "_istep0", 0))
        self._prog_cache = {}

    # ------------------------------------------------------------------
    def set_member_states(self, field_index: int, globals_m) -> None:
        """Load per-member initial data for one state field from an
        ``(M, gny, gnx)`` — or, for a multi-level field,
        ``(M, levels, gny, gnx)`` — global array (scatter + halo
        exchange)."""
        globals_m = np.asarray(globals_m)
        if globals_m.shape[0] != self.n_members:
            raise ValueError(f"expected leading dim {self.n_members}, "
                             f"got {globals_m.shape}")
        d = self.grid.decomp
        dt = np.dtype(self._fields[field_index].dtype)

        def stack(g):
            if g.ndim == 2:
                return layout.stack_global(d, g, mode="zeros", dtype=dt)
            return np.stack([stack(lvl) for lvl in g])

        stacked = np.stack([stack(g) for g in globals_m])
        arr = jax.device_put(jnp.asarray(stacked),
                             self._shardings[field_index])
        arr = halo_mod.exchange(arr, self.grid.mesh, self.grid.halo_spec,
                                depth=d.halo)
        states = list(self.states)
        states[field_index] = arr
        self.states = tuple(states)

    # ------------------------------------------------------------------
    def step_program(self, nsteps: int):
        if nsteps not in self._prog_cache:
            step_fn = self._step_fn
            exch = exchange_multi_fn(self.grid.halo_spec,
                                     depth=self._exch_depth)
            n_state = len(self._fields)

            def body(istep0, *args):
                state = args[:n_state]
                masks = args[n_state:]

                def one(i, s):
                    return step_fn(exch, s, masks, istep0 + i)

                return lax.fori_loop(0, nsteps, one, state)

            smapped = jax.shard_map(
                body, mesh=self.grid.mesh,
                in_specs=((P(),) + self._specs
                          + (P("y", "x"),) * len(self._masks)),
                out_specs=self._specs, check_vma=False)
            self._prog_cache[nsteps] = jax.jit(smapped)
        return self._prog_cache[nsteps]

    def run(self, nsteps: int) -> None:
        prog = self.step_program(nsteps)
        self.states = tuple(prog(jnp.int32(self._istep0), *self.states,
                                 *self._masks))
        self._istep0 += nsteps

    # ------------------------------------------------------------------
    def member(self, i: int) -> dict:
        """Gathered global fields of member ``i`` (internal points;
        multi-process runs gather across hosts like Field does)."""
        from ..parallel.collectives import gather_to_host
        d = self.grid.decomp
        return {k: gather_to_host(layout.unstack_internal(d, s[i]))
                for k, s in zip(self._names(), self.states)}

    def gather_all(self) -> dict:
        """All members' global fields: ``{name: (M, gny, gnx)}``."""
        from ..parallel.collectives import gather_to_host
        d = self.grid.decomp
        return {k: gather_to_host(layout.unstack_internal(d, s))
                for k, s in zip(self._names(), self.states)}

    def save(self, path: str) -> None:
        """Checkpoint all members (global internal form + the model
        clock) to one ``.npz`` — cycling DA needs restarts.  Uses the
        multi-controller-safe gather, so every process may write (or
        gate on ``jax.process_index() == 0``)."""
        g = self.gather_all()
        np.savez(path, __step__=np.int64(self._istep0), **g)

    def load(self, path: str) -> None:
        """Restore member states saved by :meth:`save` (scatter + halo
        exchange per field; the clock resumes)."""
        with np.load(path) as data:
            for i, name in enumerate(self._field_names):
                self.set_member_states(i, data[name])
            self._istep0 = int(data["__step__"])

    def mean_and_spread(self) -> tuple[dict, dict]:
        """Ensemble mean and standard deviation per state field."""
        g = self.gather_all()
        return ({k: v.mean(axis=0) for k, v in g.items()},
                {k: v.std(axis=0) for k, v in g.items()})

    def _names(self):
        return self._field_names
