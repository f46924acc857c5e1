"""Variational data assimilation (4D-Var) on the differentiable stack.

The framework's time step is a pure jitted function, so the ADJOINT
MODEL — the thing operational assimilation systems at the codes the
reference serves spend person-years hand-writing and re-validating
after every physics change — is one `jax.grad` call: reverse-mode AD
flows through the whole shard_map program (`lax.fori_loop` unrolls as
scan, `ppermute` transposes to the reverse permutation, `psum` to a
broadcast).  `tests/test_assimilation.py` pins the gradient against
central finite differences and runs a twin experiment that recovers an
initial state from sparse noisy observations.

Usage::

    m = gravity_wave.build(64, 64, dt=0.05)
    obs = {10: eta_at_10, 20: eta_at_20}        # global (gny, gnx)
    result = assimilate(m, obs, iters=200)
    result["eta0"]                              # recovered initial eta
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..core import layout


def _trajectory_runner(model):
    """``(runner, wet_t_mask, make_state)`` for a supported model: the
    runner is a ``(prog, state, base_step) -> state`` closure binding
    the model's non-state operands (``base_step`` = global index of the
    segment's first step, for time-dependent forcing) and
    ``make_state(x0)`` builds the rest-start state tuple from the
    optimisation variable; raises for non-differentiable
    configurations."""
    from .gravity_wave import GravityWaveModel
    from .nemolite2d import NemoLite2D
    from .semi_implicit import SemiImplicitModel
    from .tracer import CoupledTracer, TracerModel

    def rest3(x0):
        return (x0, jnp.zeros_like(x0), jnp.zeros_like(x0))

    if isinstance(model, CoupledTracer):
        # source inversion THROUGH the evolving flow: the flow's
        # current state is captured as constants; the control is the
        # initial tracer (state index 3 — pass obs_state_index=3)
        fs = model.flagship
        if fs._ht is not None:
            raise ValueError("coupled-tracer 4D-Var supports flat "
                             "bathymetry")
        ops = (fs._mask_codes, model._t_upd, model._u_wet,
               model._v_wet)
        flow0 = (fs.sshn_t.data, fs.un.data, fs.vn.data)
        off = int(fs._istep0)     # forcing continuity with the flow
        return ((lambda prog, st, base: prog(jnp.int32(base + off),
                                             *st, *ops)),
                model._t_upd,
                lambda x0: flow0 + (x0,))
    if isinstance(model, TracerModel):
        if model._sweep_K > 1:
            raise ValueError(
                "4D-Var needs the one-step differentiable path: build "
                "the tracer model without steps_per_sweep")
        ops = (model._u, model._v, model._t_upd, model._u_wet,
               model._v_wet)
        return ((lambda prog, st, base: prog(*st, *ops)), model._t_upd,
                lambda x0: (x0,))
    if isinstance(model, GravityWaveModel):
        if model._sweep_K > 1:
            raise ValueError(
                "4D-Var needs the one-step differentiable path: build "
                "the model without steps_per_sweep")
        ops = (model._t_upd, model._u_wet, model._v_wet)
        return ((lambda prog, st, base: prog(*st, *ops)),
                model._t_upd, rest3)
    from .shallow import ShallowModel
    from .twolayer import TwoLayerModel
    if isinstance(model, ShallowModel):
        if model._sweep_K > 1:
            raise ValueError(
                "4D-Var needs the one-step differentiable path: build "
                "the model without steps_per_sweep")
        ones = jnp.ones_like(model.eta.data)   # all-wet periodic
        return ((lambda prog, st, base: prog(*st)), ones, rest3)
    if isinstance(model, TwoLayerModel):
        if model._sweep_K > 1:
            raise ValueError(
                "4D-Var needs the one-step differentiable path: build "
                "the model without steps_per_sweep")
        ops = (model._t_upd, model._u_wet, model._v_wet)

        def rest6(x0):
            z = jnp.zeros_like(x0)
            return (x0, z, z, z, z, z)   # observe the TOP interface

        return ((lambda prog, st, base: prog(*st, *ops)),
                model._t_upd, rest6)
    if isinstance(model, SemiImplicitModel):
        if not model.differentiable:
            raise ValueError(
                "build the semi-implicit model with differentiable="
                "True: the raw CG while_loop has no reverse rule; the "
                "custom_linear_solve wrapper differentiates implicitly")
        ops = (model._t_upd, model._u_wet, model._v_wet, model._weight,
               *model._coeffs, model._hu, model._hv, model._obc,
               model._inv_diag)
        return ((lambda prog, st, base: prog(
            jnp.int32(base), *st, *ops)[:3]), model._t_upd, rest3)
    if isinstance(model, NemoLite2D):
        # the NONLINEAR flagship: jax.grad flows through the upwind
        # flux selections (a.e.-valid subgradients) and the tidal
        # forcing's step index
        if getattr(model, "_ht", None) is not None:
            raise ValueError("flagship 4D-Var supports flat bathymetry")
        return ((lambda prog, st, base: prog(
            jnp.int32(base), tuple(st), model._mask_codes)),
                model._t_wet, rest3)
    raise TypeError("assimilation drives the GravityWaveModel, "
                    "ShallowModel, TwoLayerModel, SemiImplicitModel, "
                    "NemoLite2D or TracerModel interface, got "
                    f"{type(model).__name__}")


def control_smoother(model, scale: float = 2.0):
    """Diffusion-operator square-root-B (Weaver & Courtier 2001): a
    jitted, differentiable map ``w -> x`` applying ``n`` explicit
    masked-diffusion steps so a unit impulse in the control variable
    becomes a quasi-Gaussian of std ~``scale`` grid cells in the state.

    The operational control-variable transform: with sparse
    observations, minimising over ``w`` (instead of the state itself)
    builds in the background-error correlation structure — increments
    are smooth by construction and information spreads to unobserved
    points.  Land is respected through the same masked-gradient
    Laplacian the tracer model uses (no smoothing across coastlines).
    """
    import jax as _jax
    from jax.sharding import PartitionSpec as _P
    from ..ops import stencils as st
    from ..parallel.halo import exchange_multi_fn

    grid = model.grid
    alpha = 0.25                       # 2D explicit stability limit
    n = max(1, int(np.ceil(scale * scale / (2 * alpha))))
    dtype = np.dtype(grid.dtype)
    ones = jnp.ones(grid.array_shape, dtype)
    uw = getattr(model, "_u_wet", None)
    vw = getattr(model, "_v_wet", None)
    tu = getattr(model, "_t_upd", None)
    uw = ones if uw is None else uw
    vw = ones if vw is None else vw
    tu = ones if tu is None else tu
    exch = exchange_multi_fn(grid.halo_spec, depth=1)

    def body(w, uw, vw, tu):
        def one(_, w):
            (w,) = exch((w,))
            gx = (st.xp(w) - w) * uw       # cell units (dx = dy = 1)
            gy = (st.yp(w) - w) * vw
            lap = (gx - st.xm(gx)) + (gy - st.ym(gy))
            return jnp.where(tu > 0, w + alpha * lap, w)

        return jax.lax.fori_loop(0, n, one, w)

    smapped = _jax.shard_map(
        body, mesh=grid.mesh, in_specs=(_P("y", "x"),) * 4,
        out_specs=_P("y", "x"), check_vma=False)
    prog = _jax.jit(smapped)
    return lambda w: prog(w, uw, vw, tu)


def hybrid_controls(model, ensemble, *, smooth_scale: float = 2.0,
                    beta=(1.0, 1.0)):
    """Hybrid 4D-EnVar control variables (the production configuration
    of the operational centres): the initial-state increment is

        x0 = beta_s * B^(1/2) w  +  beta_e * X' a / sqrt(M-1)

    — a smooth static-covariance part (:func:`control_smoother`) plus a
    flow-DEPENDENT part spanned by the forecast-ensemble anomalies
    ``X'`` of the observed field.  Returns ``(transform, penalty,
    zero_control)``: ``transform`` maps the ``{"w": grid, "a": (M,)}``
    control pytree to the stacked initial state, ``penalty`` is the
    preconditioned background term ``||w||^2 + ||a||^2``, and
    ``zero_control()`` builds the rest start.  The ensemble states are
    captured as constants (the standard EnVar linearisation: the
    ensemble is not re-run inside the minimisation).
    """
    beta_s, beta_e = (float(beta[0]), float(beta[1]))
    sm = control_smoother(model, smooth_scale)
    eo = ensemble.states[0]
    em = jnp.mean(eo, axis=0)
    norm = 1.0 / np.sqrt(max(ensemble.n_members - 1, 1))
    anoms = (eo - em[None]) * norm            # (M, Y, X), sharded

    def transform(x):
        inc = beta_e * jnp.einsum("k,kyx->yx", x["a"], anoms,
                                 precision=lax.Precision.HIGHEST)
        return beta_s * sm(x["w"]) + inc

    def penalty(x):
        return (jnp.sum(x["w"] ** 2)
                + jnp.sum(x["a"] ** 2).astype(x["w"].dtype))

    def zero_control():
        w = jnp.zeros_like(em)
        return {"w": w,
                "a": jnp.zeros((ensemble.n_members,), w.dtype)}

    return transform, penalty, zero_control


def make_cost_fn(model, observations: dict, obs_weight=None,
                 background=None, background_weight: float = 0.0,
                 remat_chunk: int | None = None,
                 control_transform=None, control_penalty=None,
                 obs_state_index: int = 0):
    """Build ``cost(eta0_stacked) -> scalar``: the 4D-Var objective

    ``sum_t ||eta_t - obs_t||^2_w  [+ b_w * ||eta0 - background||^2_w]``
    over a trajectory started from rest at ``eta0``.  ``observations``
    maps step number (>=1) to a global ``(gny, gnx)`` array; the misfit
    is evaluated on wet internal points only.  ``obs_state_index``
    selects WHICH state field is observed (0 = the surface elevation
    in every runner; e.g. 2 = v for drifter-style velocity
    observations — pass the face-wet mask via ``obs_weight`` if land-
    adjacent faces should be excluded).  Returns ``(cost_fn,
    pack, unpack)`` where ``pack`` lifts a global initial eta into the
    stacked optimisation variable and ``unpack`` is its inverse.

    ``remat_chunk`` checkpoints each segment's time loop so the
    adjoint's memory is bounded — O(n/c + c) state copies per
    n-step segment instead of O(n) full intermediate sets — at the
    cost of one extra forward pass (``ops/adjoint.py``).  Use
    ``remat_chunk ~ sqrt(longest segment)`` for production-length
    windows; gradients are unchanged (``tests/test_remat.py``).

    ``control_transform`` (e.g. :func:`control_smoother`) makes the
    optimisation variable a CONTROL vector ``w`` with initial state
    ``x0 = transform(w)``: the Weaver-Courtier change of variables
    that builds background-error correlations into the increments.
    The background term is then: ``control_penalty(x)`` when given
    (the preconditioned-J_b form, hybrid EnVar), else a STATE-space
    misfit ``||transform(x) - background||^2_w`` when a physical
    ``background`` is supplied, else ``||w||^2_w``.  ``unpack``
    always returns the physical state.
    """
    run_seg, t_mask, make_state = _trajectory_runner(model)
    if not observations:
        raise ValueError("observations must map step -> global array")
    steps = sorted(observations)
    if steps[0] < 1:
        raise ValueError("observation steps must be >= 1")
    grid = model.grid
    d = grid.decomp
    dtype = np.dtype(grid.dtype)
    w = jnp.asarray(layout.internal_mask(d).astype(dtype)) * t_mask
    if obs_weight is not None:
        w = w * jnp.asarray(layout.stack_global(
            d, np.asarray(obs_weight), mode="zeros", dtype=dtype))
    obs_stacked = {
        t: jax.device_put(jnp.asarray(layout.stack_global(
            d, np.asarray(o), mode="zeros", dtype=dtype)), grid.sharding)
        for t, o in observations.items()}
    # one cached program per distinct segment length
    segs = [steps[0]] + [b - a for a, b in zip(steps, steps[1:])]
    progs = {n: model.step_program(n, remat_chunk=remat_chunk)
             for n in set(segs)}
    bg = (jax.device_put(jnp.asarray(layout.stack_global(
        d, np.asarray(background), mode="zeros", dtype=dtype)),
        grid.sharding) if background is not None else None)

    def cost(x):
        if control_transform is not None:
            eta0 = control_transform(x)
            if not background_weight:
                reg = jnp.zeros((), w.dtype)
            elif control_penalty is not None:
                # preconditioned J_b: regularise the control itself
                reg = background_weight * control_penalty(x)
            elif bg is not None:
                # a PHYSICAL background compares in state space (the
                # control lives in a different norm)
                reg = background_weight * jnp.sum((eta0 - bg) ** 2 * w)
            else:
                reg = background_weight * jnp.sum(x ** 2 * w)
        else:
            eta0 = x
            reg = (background_weight * jnp.sum((eta0 - bg) ** 2 * w)
                   if bg is not None else jnp.zeros((), w.dtype))
        state = make_state(eta0)
        c = reg
        base = 0
        for n, t in zip(segs, steps):
            state = run_seg(progs[n], state, base)
            base = t
            c = c + jnp.sum((state[obs_state_index]
                             - obs_stacked[t]) ** 2 * w)
        return c

    def pack(eta0_global):
        return jax.device_put(jnp.asarray(layout.stack_global(
            d, np.asarray(eta0_global), mode="zeros", dtype=dtype)),
            grid.sharding)

    def unpack(x_stacked):
        if control_transform is not None:
            x_stacked = control_transform(x_stacked)
        return np.asarray(layout.unstack_internal(d, x_stacked))

    return cost, pack, unpack


def assimilate(model, observations: dict, *, iters: int = 200,
               learning_rate: float = 0.2, first_guess=None,
               obs_weight=None, background=None,
               background_weight: float = 0.0,
               remat_chunk: int | None = None,
               optimizer: str = "adam",
               smooth_scale: float | None = None,
               ensemble=None, hybrid_beta=(1.0, 1.0),
               obs_state_index: int = 0) -> dict:
    """Twin-experiment-ready 4D-Var: recover the initial surface
    elevation that best explains ``observations`` under ``model``'s
    dynamics, by descent on the AD gradient of the trajectory misfit.

    ``optimizer="adam"`` (default; ``learning_rate`` applies) or
    ``"lbfgs"`` — the operational 4D-Var workhorse (quasi-Newton with
    zoom linesearch; ``learning_rate`` is ignored, the linesearch picks
    the step).  L-BFGS typically needs ~10x fewer iterations on these
    quadratic-dominated objectives; each iteration runs extra
    forward-cost evaluations inside the same jitted program for the
    linesearch.

    ``smooth_scale=L`` optimises a CONTROL vector through the
    diffusion-operator square-root-B (:func:`control_smoother`):
    increments become smooth at scale ~L cells and sparse observations
    inform their neighbourhoods — the operational change of variables.

    ``ensemble=Ensemble(...)`` upgrades this to HYBRID 4D-EnVar
    (:func:`hybrid_controls`): the increment combines the static
    sqrt-B part with the ensemble-anomaly span, weighted by
    ``hybrid_beta=(beta_static, beta_ens)`` — flow-dependent errors
    are corrected through the ensemble directions while the smoother
    covers the rest.  ``background_weight`` then scales the
    preconditioned penalty ``||w||^2 + ||a||^2``.

    Returns ``{"eta0": global array, "cost_history": [...],
    "grad_norm": float}`` (``eta0`` is always the physical state;
    hybrid runs add ``"ensemble_weights"``).
    """
    import optax

    if ensemble is not None:
        if first_guess is not None:
            raise ValueError("hybrid 4D-EnVar starts from the zero "
                             "control; first_guess is not supported")
        transform, penalty, zero_control = hybrid_controls(
            model, ensemble,
            smooth_scale=2.0 if smooth_scale is None else smooth_scale,
            beta=hybrid_beta)
    else:
        transform = (control_smoother(model, smooth_scale)
                     if smooth_scale is not None else None)
        penalty = None
        if transform is not None and first_guess is not None:
            raise ValueError(
                "smooth_scale optimises a CONTROL vector; a physical "
                "first_guess cannot seed it (the transform is not "
                "inverted here) — drop first_guess or smooth_scale")
    cost, pack, unpack = make_cost_fn(
        model, observations, obs_weight=obs_weight, background=background,
        background_weight=background_weight, remat_chunk=remat_chunk,
        control_transform=transform, control_penalty=penalty,
        obs_state_index=obs_state_index)
    d = model.grid.decomp
    if ensemble is not None:
        x = zero_control()
    else:
        x = pack(np.zeros((d.global_ny, d.global_nx))
                 if first_guess is None else first_guess)

    if optimizer == "adam":
        # uniform update() signature with lbfgs (extra args ignored)
        opt = optax.with_extra_args_support(optax.adam(learning_rate))
    elif optimizer == "lbfgs":
        opt = optax.lbfgs()
    else:
        raise ValueError(f"optimizer must be 'adam' or 'lbfgs', "
                         f"got {optimizer!r}")
    opt_state = opt.init(x)

    # ONE compiled program: the adjoint is expensive to compile
    # (~20-60 s per program on the chip) and the final gradient is
    # reported from the last iterate instead of an extra full
    # forward+adjoint pass
    @jax.jit
    def step(x, opt_state):
        c, g = jax.value_and_grad(cost)(x)
        updates, opt_state = opt.update(
            g, opt_state, x, value=c, grad=g, value_fn=cost)
        gmax = jax.tree.reduce(
            jnp.maximum, jax.tree.map(lambda t: jnp.abs(t).max(), g))
        return optax.apply_updates(x, updates), opt_state, c, gmax

    history = []
    gmax = float("nan")
    for _ in range(iters):
        x, opt_state, c, gm = step(x, opt_state)
        history.append(float(c))
        gmax = gm
    out = {"eta0": unpack(x), "cost_history": history,
           "grad_norm": float(gmax)}
    if ensemble is not None:
        out["ensemble_weights"] = np.asarray(x["a"])
    return out
