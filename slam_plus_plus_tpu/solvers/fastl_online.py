"""Online FastL: a streaming incremental solver with NO final pattern.

Reference analogue: the reference FastL consumes a stream — its block
ordering is extended incrementally as vertices arrive
(p_ExtendBlockOrdering_with_SubOrdering, reference
include/slam/OrderingMagic.h:291) and R grows without knowing the future.
The replay FastLSolver (solvers/fastl.py) instead builds its symbolic plan
from the final pattern — benchmark-grade but not usable live.

Accelerator-first streaming design (static shapes + low-rank fringe + amortized
growth; SURVEY §7 "incremental updates without recompilation"):

  * VERTEX CAPACITY DOUBLING: the engine is built over a PREDICTED padded
    system — all edges seen so far plus placeholder odometry-chain edges
    (v, v+1) up to the capacity.  Chain arrivals just overwrite the
    placeholder measurement row in edge_data (a device scatter, zero
    recompilation) and run the standard omega/activation step.
  * LOOP-CLOSURE FRINGE (Woodbury): a closure's lambda pairs are not in
    the predicted pattern.  Its PSD contribution G G^T (G = J^T chol(info),
    two blocks) is carried as a low-rank correction: maintained
    X = lambda0^-1 G columns through the existing factor, solves corrected
    by  dx = base - X (I + G^T X)^-1 G^T base.  Exact, no pattern change.
  * AMORTIZED REBUILD: when the vertex capacity or the fringe capacity
    overflows, the engine is rebuilt over the grown graph (closures merge
    into the pattern, fringe clears).  Rebuilds — the only recompilation
    events — are O(log n) from doubling plus O(closures / fringe_cap);
    the count is logged in stats["rebuilds"].

FastL semantics (frozen linearization, omega updates, push on large |dx|)
are inherited from the wrapped replay engine's components.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from slam_plus_plus_tpu.config import SolverConfig
from slam_plus_plus_tpu.graph.system import GraphSystem
from slam_plus_plus_tpu.models.types import EDGE_TYPES, VERTEX_TYPES
from slam_plus_plus_tpu.solvers.fastl import FastLSolver


class OnlineFastLSolver:
    """Streaming pose-graph FastL.

    Usage:
        s = OnlineFastLSolver()
        for (i, j, z, info) in stream:
            s.add_edge(i, j, z, info)
        chi2 = s.finish()
    """

    def __init__(self, edge_type: str = "edge_pose2d",
                 initial_capacity: int = 256, fringe_cap: int = 64,
                 every_n: int = 1, max_iterations: int = 10,
                 dx_threshold: float = 20.0,
                 config: Optional[SolverConfig] = None):
        self.edge_type = edge_type
        self.et = EDGE_TYPES[edge_type]
        self.capacity = initial_capacity
        self.fringe_cap = fringe_cap
        self.every_n = every_n
        self.max_iterations = max_iterations
        self.dx_threshold = dx_threshold
        self.config = config or SolverConfig()

        self.seen: List[tuple] = []      # (i, j, z, info) in arrival order
        self.n_vertices = 0
        self.stats: Dict[str, float] = dict(rebuilds=0, solves=0, pushes=0,
                                            closures=0, steps=0)
        self.fs: Optional[FastLSolver] = None
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------------
    # engine lifecycle
    # ------------------------------------------------------------------

    def _build_engine(self) -> None:
        """(Re)build the padded engine over all seen edges + the predicted
        odometry chain up to capacity.  The only recompilation event."""
        self.stats["rebuilds"] += 1
        system = GraphSystem()
        for (i, j, z, info) in self.seen:
            system.add_edge(self.edge_type, [i, j], z, info)
        # predicted chain placeholders (identity measurement, unit info —
        # overwritten on arrival; inactive edges are masked to zero anyway)
        z0 = np.zeros(len(self.seen[0][2]))
        info0 = np.eye(len(self.seen[0][2]))
        self._chain_li = {}
        n_now = self.n_vertices
        for v in range(n_now - 1, self.capacity - 1):
            system.add_edge(self.edge_type, [v, v + 1], z0, info0)
            self._chain_li[v + 1] = system.edge_stores[self.edge_type].n - 1

        # the online engine drives the jax-side internals (_apply_pending,
        # inc.step) directly — opt out of the native whole-replay path
        fs = FastLSolver(system, every_n=self.every_n,
                         max_iterations=self.max_iterations,
                         dx_threshold=self.dx_threshold, config=self.config,
                         use_native=False)
        self.fs = fs
        # carry the optimized states over from the previous engine
        if hasattr(self, "_host_states"):
            for t, arr in self._host_states.items():
                n = min(len(arr), system.vertex_stores[t].n)
                system.vertex_stores[t].states[:n] = arr[:n]
        self._states = fs.asm.snapshot_states(system)

        self._counts = {n: 0 for n in fs.asm.edge_data}
        self._counts[self.edge_type] = len(self.seen)
        self._n_active = self.n_vertices
        self._stores, self._eta0 = fs._init_stores(
            self._states, dict(self._counts), self._n_active)
        self._pending: List[tuple] = []
        self._outstanding = False
        self._lin_dirty = True
        self._last_nap = self.n_vertices

        # fringe state
        self._fringe: List[dict] = []    # {'i','j','G' [2,Bp,m] host}
        self._X = None                   # host [F, Np, Bp]
        self._gram = np.zeros((0, 0))    # G^T X  (host)

        # edge-row insert map: next real arrival of a chain edge (v, v+1)
        # writes into edge_data row _chain_li[v+1]

        # per-edge fringe kernels (tiny, compiled once per engine)
        asm = fs.asm
        et = self.et
        kernel = asm._kernels[self.edge_type]

        def fringe_terms(states, z, info, li, lj):
            g = (states[et.vertex_types[0]][li][None],
                 states[et.vertex_types[1]][lj][None])
            chi2_e, _h, gs, Hpp, _Hll, _Hpl = kernel(
                g, z[None], info[None])
            return chi2_e[0], gs[0][0], gs[1][0], [h[0] for h in Hpp]

        self._fringe_terms = jax.jit(fringe_terms)

        def jac_cols(states, z, info, li, lj):
            # G columns: per slot, J_k^T chol(info)  -> [Bp, m]
            s0 = states[et.vertex_types[0]][li]
            s1 = states[et.vertex_types[1]][lj]
            L = jnp.linalg.cholesky(info)
            outs = []
            for k, vt in enumerate([VERTEX_TYPES[t]
                                    for t in et.vertex_types]):
                def f(delta, k=k):
                    st = [s0, s1]
                    st[k] = vt.boxplus(st[k], delta)
                    return et.residual(tuple(st), z)
                J = jax.jacfwd(f)(jnp.zeros(vt.tangent_dim, dtype=z.dtype))
                Jt = J.T
                if Jt.shape[0] < asm.Bp:
                    Jt = jnp.pad(Jt, ((0, asm.Bp - Jt.shape[0]), (0, 0)))
                outs.append(Jt @ L)
            return outs[0], outs[1]

        self._jac_cols = jax.jit(jac_cols)

    # ------------------------------------------------------------------
    # streaming
    # ------------------------------------------------------------------

    BOOTSTRAP_VERTICES = 8

    def add_edge(self, i: int, j: int, z, info) -> None:
        z = np.asarray(z, dtype=np.float64)
        info = np.asarray(info, dtype=np.float64)
        self.stats["steps"] += 1
        self.seen.append((i, j, z, info))
        new_vertex = max(i, j) >= self.n_vertices
        if new_vertex:
            # the very first edge introduces both endpoints; afterwards ids
            # must grow one at a time (reference FlatSystem semantics)
            assert max(i, j) == self.n_vertices or len(self.seen) == 1, \
                "online mode requires incremental vertex ids"
            self.n_vertices = max(i, j) + 1

        if self.fs is None:
            # buffer a short bootstrap prefix, then build the first engine
            # (all buffered edges land in its pattern directly)
            if self.n_vertices >= self.BOOTSTRAP_VERTICES:
                self._ensure_engine()
            return

        chain_arrival = (new_vertex and j == i + 1 and
                         j in self._chain_li and
                         max(i, j) == self._n_active)
        if ((new_vertex and not chain_arrival) or
                self.n_vertices > self.capacity or
                len(self._fringe) >= self.fringe_cap):
            # growth or fringe overflow: rebuild over everything seen
            while self.capacity < self.n_vertices:
                self.capacity *= 2
            self._snapshot_states()
            self._build_engine()
            if not new_vertex:
                # the triggering closure deserves its solve
                self._outstanding = False
                self._solve_point()
            return
        self._ingest_last()

    def _ensure_engine(self) -> None:
        if self.fs is None:
            while self.capacity < self.n_vertices:
                self.capacity *= 2
            self._build_engine()

    def _ingest_last(self) -> None:
        (i, j, z, info) = self.seen[-1]
        fs = self.fs
        asm = fs.asm
        new_vertex = (max(i, j) == self._n_active)
        if new_vertex and j == max(i, j) and j in self._chain_li:
            li = self._chain_li[j]
            # overwrite the placeholder measurement (device row update)
            data = asm.edge_data[self.edge_type]
            data["z"] = data["z"].at[li].set(jnp.asarray(z, dtype=asm.dtype))
            data["info"] = data["info"].at[li].set(
                jnp.asarray(info, dtype=asm.dtype))
            # activate the new vertex from the edge initializer
            self._states = fs._activate(self._states, self.edge_type,
                                        1, li)
            self._counts[self.edge_type] += 1
            self._n_active += 1
            nm = np.zeros(self.et.arity)
            nm[1] = 1.0
            self._pending.append((self.edge_type, li, nm))
        else:
            # loop closure -> fringe
            self.stats["closures"] += 1
            self._outstanding = True
            self._add_fringe(i, j, z, info)

        if (self._n_active - self._last_nap) < self.every_n:
            return
        self._last_nap = self._n_active
        if not self._outstanding:
            return
        self._outstanding = False
        self._solve_point()

    # ------------------------------------------------------------------
    # fringe (Woodbury) machinery
    # ------------------------------------------------------------------

    def _local_ids(self, i, j):
        fs = self.fs
        sysd = fs.system.vertex_directory
        return sysd[i][1], sysd[j][1]

    def _add_fringe(self, i, j, z, info) -> None:
        fs = self.fs
        asm = fs.asm
        li, lj = self._local_ids(i, j)
        zi = jnp.asarray(z, dtype=asm.dtype)
        ii = jnp.asarray(info, dtype=asm.dtype)
        Gi, Gj = self._jac_cols(self._states, zi, ii, li, lj)
        chi2_e, g0, g1, _ = self._fringe_terms(self._states, zi, ii, li, lj)
        # eta is dense — fringe gradients scatter straight in
        ci = int(asm.type_cslot[self.et.vertex_types[0]][li])
        cj = int(asm.type_cslot[self.et.vertex_types[1]][lj])
        self._eta0 = self._eta0.at[jnp.asarray([ci, cj])].add(
            jnp.stack([g0, g1]))
        G = np.zeros((2, asm.Bp, Gi.shape[1]))
        G[0], G[1] = np.asarray(Gi), np.asarray(Gj)
        entry = dict(i=ci, j=cj, z=z, info=info, li=li, lj=lj, G=G)
        self._fringe.append(entry)
        self._extend_X([entry])

    def _col_rhs(self, entry):
        """Dense rhs columns for one fringe edge's G: [m, Np, Bp]."""
        asm = self.fs.asm
        m = entry["G"].shape[2]
        rhs = np.zeros((m, asm.Np, asm.Bp))
        for c in range(m):
            rhs[c, entry["i"]] = entry["G"][0, :, c]
            rhs[c, entry["j"]] = entry["G"][1, :, c]
        return rhs

    def _extend_X(self, entries) -> None:
        """Solve lambda0^-1 G for the new columns and extend the Gram."""
        fs = self.fs
        cols = []
        for e in entries:
            for rhs in self._col_rhs(e):
                x = np.asarray(fs._solve(self._stores,
                                         jnp.asarray(rhs,
                                                     dtype=fs.asm.dtype))[0])
                cols.append(x)
        Xnew = np.stack(cols) if cols else np.zeros((0, 1, 1))
        self._X = (Xnew if self._X is None
                   else np.concatenate([self._X, Xnew]))
        self._rebuild_gram()

    def _rebuild_gram(self) -> None:
        F = self._X.shape[0] if self._X is not None else 0
        cols_meta = []
        for e in self._fringe:
            m = e["G"].shape[2]
            for c in range(m):
                cols_meta.append((e, c))
        gram = np.zeros((F, F))
        for a, (ea, ca) in enumerate(cols_meta):
            for b in range(F):
                eb, cb = cols_meta[b]
                gram[a, b] = (ea["G"][0, :, ca] @ self._X[b, ea["i"]] +
                              ea["G"][1, :, ca] @ self._X[b, ea["j"]])
        self._gram = gram
        self._cols_meta = cols_meta

    def _woodbury(self, base: np.ndarray) -> np.ndarray:
        """dx = base - X (I + G^T X)^-1 (G^T base)  (all host numpy)."""
        F = self._X.shape[0] if self._X is not None else 0
        if not F:
            return base
        y = np.array([e["G"][0, :, c] @ base[e["i"]] +
                      e["G"][1, :, c] @ base[e["j"]]
                      for (e, c) in self._cols_meta])
        M = np.eye(F) + self._gram
        w = np.linalg.solve(M, y)
        return base - np.tensordot(w, self._X, axes=(0, 0))

    def _refresh_fringe(self) -> None:
        """Relinearize every fringe edge at the current states (after a
        push) and rebuild X/eta contributions."""
        fs = self.fs
        asm = fs.asm
        for e in self._fringe:
            zi = jnp.asarray(e["z"], dtype=asm.dtype)
            ii = jnp.asarray(e["info"], dtype=asm.dtype)
            Gi, Gj = self._jac_cols(self._states, zi, ii, e["li"], e["lj"])
            e["G"][0], e["G"][1] = np.asarray(Gi), np.asarray(Gj)
            _c2, g0, g1, _ = self._fringe_terms(self._states, zi, ii,
                                                e["li"], e["lj"])
            self._eta0 = self._eta0.at[jnp.asarray([e["i"], e["j"]])].add(
                jnp.stack([g0, g1]))
        self._resolve_X()

    # ------------------------------------------------------------------
    # solve / push
    # ------------------------------------------------------------------

    def _solve_point(self) -> None:
        fs = self.fs
        asm = fs.asm
        self.stats["solves"] += 1
        if self._pending:
            self._eta0, dirty_pos, dirty_vals = fs._apply_pending(
                self._stores, self._eta0, self._states, self._pending)
            self._pending.clear()
            if fs.inc is not None:
                ok = fs.inc.refactor_dirty(self._stores, dirty_pos,
                                           dirty_vals)
            else:
                ok = False
            if not ok:
                self._stores = fs._refactor(self._stores)
            # factor changed -> X columns are stale
            if self._fringe:
                self._resolve_X()
        for _ in range(self.max_iterations):
            base = np.asarray(fs._solve(self._stores, self._eta0)[0])
            dx = self._woodbury(base)
            norm = float(np.linalg.norm(dx))
            if not np.isfinite(norm) or norm > 1e5 or \
                    norm <= self.dx_threshold:
                self._lin_dirty = True
                break
            # push
            self.stats["pushes"] += 1
            self._lin_dirty = False
            self._states = asm._update_jit(
                self._states, jnp.asarray(dx, dtype=asm.dtype),
                jnp.zeros((1, asm.Bl), dtype=asm.dtype))
            self._stores, self._eta0 = fs._init_stores(
                self._states, dict(self._counts), self._n_active)
            self._refresh_fringe()

    def _resolve_X(self) -> None:
        """Recompute X for the current factor (same linearization)."""
        fs = self.fs
        cols = []
        for e in self._fringe:
            for rhs in self._col_rhs(e):
                cols.append(np.asarray(fs._solve(
                    self._stores, jnp.asarray(rhs, dtype=fs.asm.dtype))[0]))
        self._X = np.stack(cols) if cols else None
        if self._X is not None:
            self._rebuild_gram()

    def _snapshot_states(self) -> None:
        if self.fs is None:
            return
        self.fs.asm.writeback_states(self.fs.system, self._states)
        self._host_states = {
            t: np.array(self.fs.system.vertex_stores[t].states
                        [:self.fs.system.vertex_stores[t].n])
            for t in self.fs.asm.type_names}

    # ------------------------------------------------------------------

    def chi2(self) -> float:
        fs = self.fs
        asm = fs.asm
        total = float(asm.chi2_active(self._states, self._counts))
        for e in self._fringe:
            c2, _g0, _g1, _ = self._fringe_terms(
                self._states, jnp.asarray(e["z"], dtype=asm.dtype),
                jnp.asarray(e["info"], dtype=asm.dtype), e["li"], e["lj"])
            total += float(c2)
        return total

    def finish(self):
        """Final one-time dx (reference CalculateOneTimeDx reporting
        semantics) and chi2.  Returns (chi2, stats)."""
        self._ensure_engine()
        fs = self.fs
        if self._pending:
            self._eta0, dirty_pos, dirty_vals = fs._apply_pending(
                self._stores, self._eta0, self._states, self._pending)
            self._pending.clear()
            self._stores = fs._refactor(self._stores)
            if self._fringe:
                self._resolve_X()
            self._lin_dirty = True
        if self._lin_dirty:
            base = np.asarray(fs._solve(self._stores, self._eta0)[0])
            dx = self._woodbury(base)
            if np.all(np.isfinite(dx)):
                self._states = fs.asm._update_jit(
                    self._states, jnp.asarray(dx, dtype=fs.asm.dtype),
                    jnp.zeros((1, fs.asm.Bl), dtype=fs.asm.dtype))
        self.stats["elapsed"] = time.perf_counter() - self._t0
        chi2 = float(fs.asm.chi2_active(self._states, self._counts))
        for e in self._fringe:
            c2, _g0, _g1, _ = self._fringe_terms(
                self._states, jnp.asarray(e["z"], dtype=fs.asm.dtype),
                jnp.asarray(e["info"], dtype=fs.asm.dtype),
                e["li"], e["lj"])
            chi2 += float(c2)
        return chi2, self.stats
