"""One-way grid nesting: a refined child grid driven by its parent.

The AGRIF capability class (NEMO's nesting layer): a child
:class:`~.gravity_wave.GravityWaveModel` covers a rectangular window of
its parent's domain at ``ratio`` x finer resolution (``dx/r``, ``dt/r``)
and receives its open-boundary values from the parent — space-bilinear
plus time-linear interpolation — while the parent never sees the child
(one-way).  The reference library has no nesting layer; its clients
hand-write this over MPI gather/scatter.  Here the WHOLE nest step —
one parent step, ``r`` child substeps, and the boundary glue between
them — is ONE jitted program over sharded global arrays: the glue is
O(perimeter) static gathers/scatters at the jit level, so XLA inserts
whatever resharding collectives the mesh layout needs (there is no
hand-written pack/unpack or rank bookkeeping anywhere).

Discrete design (what makes the seam exact rather than merely plausible):

* The child grid keeps the standard one-cell land ring (tmask=0); the
  next ring in — the *boundary ring* — is wet but its ``t_upd`` update
  mask is zeroed (on every stacked copy, halo twins included), so the
  child step never evolves it.  Before each child substep the ring's
  eta is overwritten with parent values at the substep's START time
  ``alpha = k/r``; u/v faces adjacent to the ring are updated by the
  child's own stencil from those prescribed etas, which reproduces the
  parent's forward-backward staggering exactly.
* Consequence (pinned by ``tests/test_nesting.py``): at ``ratio=1`` the
  bilinear weights and the time blend both degenerate to the identity
  and the child interior equals the parent window to the last bit —
  the nesting analogue of the decomposition-invariance invariant.

Scope: the linear :class:`GravityWaveModel` on the one-step path
(the glue must run every parent step, so K-step sweeps are
rejected — enable them on the parent AFTER
`step_program` if you accept per-K-step coupling).  Land inside the
child window is supported (the parent tmask is refined
piecewise-constant); the boundary ring itself must be wet.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

import dl_esm_inf_tpu as dl
from ..core import layout
from .gravity_wave import GravityWaveModel


# ----------------------------------------------------------------------
# Interpolation index plans (host-side, static)
# ----------------------------------------------------------------------
def _t_point_plan(cy, cx, pj0, pi0, ratio, pny, pnx):
    """Bilinear gather plan from parent T points to child T points.

    Child T cell (cy, cx) sits at parent T-index coordinates
    ``pj0 + (cy + 0.5)/r - 0.5`` (exactly integer when r == 1, so the
    weights degenerate to the identity — the bitwise r=1 invariant).
    """
    py = pj0 + (np.asarray(cy, np.float64) + 0.5) / ratio - 0.5
    px = pi0 + (np.asarray(cx, np.float64) + 0.5) / ratio - 0.5
    y0 = np.clip(np.floor(py).astype(np.int64), 0, pny - 2)
    x0 = np.clip(np.floor(px).astype(np.int64), 0, pnx - 2)
    wy = np.clip(py - y0, 0.0, 1.0)
    wx = np.clip(px - x0, 0.0, 1.0)
    return y0, x0, wy, wx


def _bilinear(pg, plan, dtype):
    """Gather a plan's values from a (gny, gnx) global parent array."""
    y0, x0, wy, wx = plan
    wy = jnp.asarray(wy, dtype)
    wx = jnp.asarray(wx, dtype)
    v00 = pg[y0, x0]
    v01 = pg[y0, x0 + 1]
    v10 = pg[y0 + 1, x0]
    v11 = pg[y0 + 1, x0 + 1]
    return ((1 - wy) * ((1 - wx) * v00 + wx * v01)
            + wy * ((1 - wx) * v10 + wx * v11))


def _stacked_indices(decomp, gy, gx):
    """Stacked-layout coordinates of the INTERNAL copy of global cells.

    Shard-halo twins are deliberately not touched: the child step opens
    with a halo exchange, which refreshes them from these."""
    h = decomp.halo
    sy = (gy // decomp.tile_ny) * decomp.local_ny + h + gy % decomp.tile_ny
    sx = (gx // decomp.tile_nx) * decomp.local_nx + h + gx % decomp.tile_nx
    return sy, sx


# ----------------------------------------------------------------------
class OneWayNest:
    """A parent model + a one-way refined child over a window of it.

    Parameters
    ----------
    parent : GravityWaveModel
        One-step path (no steps_per_sweep).
    origin : (pj0, pi0)
        Parent T-cell of the child window's south-west corner.
    shape : (ph, pw)
        Window extent in parent cells; the child grid is
        ``(ph*ratio, pw*ratio)`` and covers exactly that window.
    ratio : int
        Refinement ratio r >= 1: child dx = parent dx / r and the child
        takes r substeps (dt/r) per parent step.
    two_way : bool
        After the r substeps, restrict the child's eta (conservative
        r x r mean) back onto the parent's window interior — the
        AGRIF "update" phase.  The feedback region is inset two parent
        cells from the window edge (clear of the land + boundary
        rings), covers wet parent cells only, and is the identity at
        ratio=1, so the bitwise r=1 invariant survives feedback.
        eta-only (the linear model's velocities follow from it).
    """

    def __init__(self, parent: GravityWaveModel, *, origin, shape,
                 ratio: int, two_way: bool = False, child_ndomains=None,
                 child_ndomainx=None, child_ndomainy=None):
        if parent._sweep_K > 1:
            raise ValueError(
                "one-way nesting needs the parent on the one-step path "
                "(the boundary glue runs every parent step); build the "
                "parent without steps_per_sweep")
        self.parent = parent
        self.ratio = r = int(ratio)
        if r < 1:
            raise ValueError(f"ratio must be >= 1, got {ratio}")
        pj0, pi0 = (int(v) for v in origin)
        ph, pw = (int(v) for v in shape)
        pdec = parent.grid.decomp
        pny, pnx = pdec.global_ny, pdec.global_nx
        if not (0 <= pi0 and pi0 + pw <= pnx and 0 <= pj0
                and pj0 + ph <= pny):
            raise ValueError(
                f"child window [{pj0}:{pj0 + ph}) x [{pi0}:{pi0 + pw}) "
                f"outside the parent domain {pny}x{pnx}")
        if ph < 4 or pw < 4:
            raise ValueError("child window needs >= 4 parent cells per "
                             "axis (land ring + boundary ring + interior)")
        self.two_way = bool(two_way)
        if self.two_way and (ph < 5 or pw < 5):
            raise ValueError("two-way feedback needs a window of >= 5 "
                             "parent cells per axis (2-cell inset)")
        self.origin = (pj0, pi0)
        self.shape = (ph, pw)
        cny, cnx = ph * r, pw * r

        # Child tmask: the parent window refined piecewise-constant,
        # with the standard one-cell land ring forced on the outside.
        ptm = layout.unstack_internal(pdec, parent.grid._tmask_np)
        tm_c = np.kron(ptm[pj0:pj0 + ph, pi0:pi0 + pw],
                       np.ones((r, r), np.int32)).astype(np.int32)
        tm_c[0, :] = tm_c[-1, :] = 0
        tm_c[:, 0] = tm_c[:, -1] = 0
        ring = np.zeros((cny, cnx), np.int32)
        ring[1, 1:-1] = ring[-2, 1:-1] = 1
        ring[1:-1, 1] = ring[1:-1, -2] = 1
        if not np.all(tm_c[ring == 1] == 1):
            raise ValueError(
                "the child's boundary ring must be wet: move the window "
                "so its edge cells are ocean in the parent tmask")

        pgrid = parent.grid
        cgrid = dl.Grid(pgrid.name, pgrid.boundary_conditions,
                        pgrid.offset, dtype=pgrid.dtype)
        cgrid.decompose(cnx, cny, ndomains=child_ndomains,
                        ndomainx=child_ndomainx, ndomainy=child_ndomainy,
                        halo_width=pdec.halo)
        dl.grid_init(cgrid, pgrid.dx / r, pgrid.dy / r, tm_c)
        self.child = GravityWaveModel(cgrid, dt=parent.dt / r,
                                      g=parent.g, depth=parent.depth)

        # Freeze the boundary ring: zero t_upd on EVERY stacked copy
        # (halo twins included) so no path ever evolves it.
        cdec = cgrid.decomp
        dtype = self.child.eta.dtype
        ring_stacked = layout.stack_global(cdec, ring, mode="edge")
        t_upd = np.asarray(self.child._t_upd) * (1 - ring_stacked)
        self.child._t_upd = jax.device_put(jnp.asarray(t_upd, dtype),
                                           cgrid.sharding)

        # Static plans: ring scatter targets + parent gather weights.
        ry, rx = np.nonzero(ring)
        self._ring_scatter = _stacked_indices(cdec, ry, rx)
        self._ring_plan = _t_point_plan(ry, rx, pj0, pi0, r, pny, pnx)

        if self.two_way:
            # Feedback plan: wet parent cells in the window interior
            # (inset 2 parent cells), each fed the r x r mean of its
            # child cells.
            fj, fi = np.mgrid[pj0 + 2:pj0 + ph - 2, pi0 + 2:pi0 + pw - 2]
            wet = ptm[fj, fi] == 1
            self._fb_wet = wet.ravel()
            self._fb_scatter = _stacked_indices(pdec, fj[wet], fi[wet])
        self._subnests = ()      # filled by NestSet for telescoping
        self._prog_cache = {}

    # ------------------------------------------------------------------
    def sync_from_parent(self) -> None:
        """Initialise the child's eta from the parent's (bilinear).

        u/v start at rest; for a fine-structure initial condition set
        the child's eta directly instead (``child.set_initial_eta``)."""
        pj0, pi0 = self.origin
        pdec = self.parent.grid.decomp
        cdec = self.child.grid.decomp
        cny, cnx = cdec.global_ny, cdec.global_nx
        cy, cx = np.mgrid[0:cny, 0:cnx]
        plan = _t_point_plan(cy.ravel(), cx.ravel(), pj0, pi0,
                             self.ratio, pdec.global_ny, pdec.global_nx)
        pg = self.parent.eta.gather_inner_data()
        y0, x0, wy, wx = plan
        vals = ((1 - wy) * ((1 - wx) * pg[y0, x0] + wx * pg[y0, x0 + 1])
                + wy * ((1 - wx) * pg[y0 + 1, x0]
                        + wx * pg[y0 + 1, x0 + 1]))
        eta_c = vals.reshape(cny, cnx)
        tm_c = layout.unstack_internal(cdec, self.child.grid._tmask_np)
        eta_c[np.asarray(tm_c) != 1] = 0.0
        self.child.set_initial_eta(eta_c)

    # ------------------------------------------------------------------
    def step_program(self, nsteps: int = 1):
        """One jitted program: nsteps x (parent step + r child substeps).

        State pytree: ``((p_eta, p_u, p_v), tree)`` in the stacked
        sharded layout (see :func:`_make_nest_program`).  Before child
        substep k the boundary ring's eta is set to the parent field at
        blend time ``alpha = k/r`` (start-of-substep: with the
        forward-backward stagger the child's own u/v updates then
        reproduce the parent's sequencing, which is what makes r=1
        bitwise)."""
        if nsteps not in self._prog_cache:
            self._prog_cache[nsteps] = _make_nest_program(
                self.parent, (self,), nsteps)
        return self._prog_cache[nsteps]

    def run(self, nsteps: int) -> None:
        p = self.parent
        out = self.step_program(nsteps)(
            ((p.eta.data, p.u.data, p.v.data), _read_tree((self,))))
        p.eta.data, p.u.data, p.v.data = out[0]
        _write_tree((self,), out[1])

    # -- pieces shared with NestSet ------------------------------------
    def _feedback(self, p_eta, c_eta):
        """Restrict the child's eta onto the parent window (traced)."""
        r = self.ratio
        ph, pw = self.shape
        cg = layout.unstack_internal(self.child.grid.decomp, c_eta)
        blk = cg[2 * r:(ph - 2) * r, 2 * r:(pw - 2) * r]
        avg = blk.reshape(ph - 4, r, pw - 4, r).mean((1, 3))
        fsy, fsx = self._fb_scatter
        return p_eta.at[fsy, fsx].set(avg.ravel()[self._fb_wet])


def _read_tree(nests):
    """Device state of a nest forest as a pytree (telescoping order)."""
    return tuple(((n.child.eta.data, n.child.u.data, n.child.v.data),
                  _read_tree(n._subnests)) for n in nests)


def _write_tree(nests, tree) -> None:
    for n, (c_state, sub) in zip(nests, tree):
        n.child.eta.data, n.child.u.data, n.child.v.data = c_state
        _write_tree(n._subnests, sub)


def _make_nest_program(parent, nests, nsteps: int):
    """Jitted program advancing a parent and a FOREST of nests.

    State pytree: ``((p_eta, p_u, p_v), trees)`` with one
    ``((c_eta, c_u, c_v), subtrees)`` entry per nest — nests telescope:
    a nest whose parent model is another nest's child advances inside
    that child's substeps, with its ring times interpolated at the
    child's (finer) cadence.  Per level: one model step, then each
    nest's ring-prescribed substeps (recursing into ITS nests), then
    each two-way nest's feedback (window disjointness at every level
    makes the order immaterial)."""
    dtype = jnp.dtype(parent.eta.dtype)
    res = {}

    def prep(model, ns):
        res[id(model)] = (model.step_program(1),
                          (model._t_upd, model._u_wet, model._v_wet))
        for n in ns:
            prep(n.child, n._subnests)

    prep(parent, nests)

    def advance(model, ns, m_state, trees):
        """One step of ``model`` + all descendant nests (traced)."""
        prog, masks = res[id(model)]
        mdec = model.grid.decomp
        pg_old = layout.unstack_internal(mdec, m_state[0])
        rings_old = [_bilinear(pg_old, n._ring_plan, dtype) for n in ns]
        m_eta, m_u, m_v = prog(*m_state, *masks)
        pg_new = layout.unstack_internal(mdec, m_eta)
        new_trees = []
        for i, n in enumerate(ns):
            ring_new = _bilinear(pg_new, n._ring_plan, dtype)
            c_state, sub = trees[i]
            r = n.ratio
            sy, sx = n._ring_scatter
            for k in range(r):
                if k == 0:
                    vals = rings_old[i]   # exact, no 0-weight blend
                else:
                    a = dtype.type(k / r)
                    vals = (1 - a) * rings_old[i] + a * ring_new
                c_state = (c_state[0].at[sy, sx].set(vals),
                           c_state[1], c_state[2])
                c_state, sub = advance(n.child, n._subnests,
                                       c_state, sub)
            if n.two_way:
                m_eta = n._feedback(m_eta, c_state[0])
            new_trees.append((c_state, sub))
        return (m_eta, m_u, m_v), tuple(new_trees)

    def body(_, s):
        return advance(parent, nests, s[0], s[1])

    @jax.jit
    def prog(state):
        return lax.fori_loop(0, nsteps, body, state)

    return prog


class NestSet:
    """A forest of nests — siblings AND telescopes — advanced together.

    Takes :class:`OneWayNest` instances and assembles the hierarchy by
    identity: a nest whose ``parent`` is another nest's ``child``
    telescopes inside it (its substeps run within the mid-level child's
    substeps, ring times at the finer cadence); the remaining roots
    must share one parent model.  The whole family advances as one
    jitted program per ``run``.  One-way children are provably
    independent: each child's trajectory (and the parent's) is bitwise
    identical to running its nest alone (`tests/test_nesting.py`).
    Two-way nests under the same parent model must have disjoint
    windows so their feedbacks commute."""

    def __init__(self, nests):
        nests = tuple(nests)
        if not nests:
            raise ValueError("NestSet needs at least one nest")
        child_models = {id(n.child) for n in nests}
        for n in nests:
            n._subnests = tuple(m for m in nests if m.parent is n.child)
            n._prog_cache.clear()    # hierarchy may have changed
        roots = tuple(n for n in nests
                      if id(n.parent) not in child_models)
        if len({id(n.parent) for n in roots}) != 1:
            raise ValueError(
                "all nests must share the same parent model at the root "
                "(or telescope from another nest's child)")
        by_parent = {}
        for n in nests:
            if n.two_way:
                by_parent.setdefault(id(n.parent), []).append(n)
        for group in by_parent.values():
            fb = [(n.origin, n.shape) for n in group]
            for a in range(len(fb)):
                for b in range(a + 1, len(fb)):
                    (ja, ia), (ha, wa) = fb[a]
                    (jb, ib), (hb, wb) = fb[b]
                    if (ja < jb + hb and jb < ja + ha
                            and ia < ib + wb and ib < ia + wa):
                        raise ValueError(
                            "two-way nests must have disjoint windows "
                            f"(feedback overlaps: {fb[a]} vs {fb[b]})")
        self.parent = roots[0].parent
        self.nests = roots           # root nests; telescopes hang below
        self.all_nests = nests
        self._prog_cache = {}

    def step_program(self, nsteps: int = 1):
        if nsteps not in self._prog_cache:
            self._prog_cache[nsteps] = _make_nest_program(
                self.parent, self.nests, nsteps)
        return self._prog_cache[nsteps]

    def run(self, nsteps: int) -> None:
        p = self.parent
        out = self.step_program(nsteps)(
            ((p.eta.data, p.u.data, p.v.data), _read_tree(self.nests)))
        p.eta.data, p.u.data, p.v.data = out[0]
        _write_tree(self.nests, out[1])
