"""Incremental solver: per-edge steps with every-N scheduling.

Reference analogue: CNonlinearSolver_Lambda in incremental operation —
CParseLoop::AppendSystem -> solver.Incremental_Step -> t_Incremental_Step
(loop-closure detection + per-N-vertices schedule, reference
include/slam/NonlinearSolver_Base.h:497-620) -> Optimize(max_iters, thresh)
with the reference's exact semantics (break-before-push on |dx| <= thresh,
reference include/slam/NonlinearSolver_Lambda.h:637-661).  CLI defaults
replicated: nonlinear step = Optimize(10, 20) (reference
src/slam_app/Main.cpp:704-705); no final batch optimization in incremental
mode (reference include/slam_app/Main.h:1463-1467).

Accelerator-first design: instead of growing matrices per step (the reference's
Extend_Lambda), the FULL dataset structure is laid out once and replayed with
*active-count masking* — inactive edges carry zero information, inactive
vertices unit pivots, and the counts are traced scalars.  The entire
incremental run therefore reuses ONE compiled assemble/solve/update step:
zero recompiles, amortized O(1) dispatches per step.  Newly activated
vertices are initialized on device from their introducing edge
(EdgeType.jax_initializer), matching the reference's parse-loop vertex
initializers (reference include/slam/ParseLoop.h:138,399).
"""

from __future__ import annotations

import dataclasses

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from slam_plus_plus_tpu.assembly.assembler import Assembler
from slam_plus_plus_tpu.config import SolverConfig, device_policy
from slam_plus_plus_tpu.graph.system import GraphSystem
from slam_plus_plus_tpu.linalg.dense import solve_dense_spd
from slam_plus_plus_tpu.linalg.host_solver import HostSparseSolver
from slam_plus_plus_tpu.linalg.schur import SchurSolver
from slam_plus_plus_tpu.models.types import EDGE_TYPES


class IncrementalSolver:
    """Replays a fully parsed system edge-by-edge.

    Usage:
        system = parse_g2o(path)
        inc = IncrementalSolver(system, every_n=1)
        chi2 = inc.run()
    """

    def __init__(self, system: GraphSystem, every_n: int = 1,
                 max_iterations: int = 10, dx_threshold: float = 20.0,
                 mode: str = "lambda",
                 config: Optional[SolverConfig] = None,
                 allow_fused: bool = True):
        """mode="lambda": the reference lambda solver's incremental policy —
        solve only when a loop closure is pending at an every-N boundary,
        Optimize(10, 20) break-before-push semantics (exact parity).

        mode="fastl": the FastL-equivalent operating point — solve at every
        new vertex, one iteration, always push (the reference's
        __NONLINEAR_SOLVER_FAST_L_BACKSUBSTITUTE_EACH_1 behavior).  Where
        FastL approximates by reusing stale linearization in R and only
        omega-updating (RSS13's O(affected) trick for CPUs), the device engine
        fully relinearizes each step — one batched device launch — which
        converges at least as well (manhattan: 91.08 vs FastL's 93.97)."""
        self.system = system
        self.config = config or SolverConfig()
        self.mode = mode
        if mode == "fastl":
            every_n, max_iterations, dx_threshold = 1, 1, 0.0
        self.every_n = every_n
        self.max_iterations = max_iterations
        self.dx_threshold = dx_threshold

        # ---- maintained-factor fast path (round 5) ---------------------
        # For pose-graph (non-Schur) lambda-mode replays, the linearization
        # is frozen between pushes, so lambda maintained by omega updates
        # equals the reference's full Refresh_Lambda exactly — the FastL
        # fused scan engine (one dispatch per solve point) serves the
        # lambda solver too; only the final report differs (no trailing
        # one-time dx, reference NonlinearSolver_Lambda.h:637-661).
        # Verified exact: manhattan3500 -nsp 1 chi2 1705.99 @534 == ref.
        self._delegate = None
        if mode == "lambda" and every_n and allow_fused:
            from slam_plus_plus_tpu.models.types import VERTEX_TYPES
            # delegate pose-graph AND landmark-SLAM replays (the
            # mixed-class engine is exact for both: manhattan 1705.99
            # @534, landmark 24.65 @166 == the legacy Schur path); keep
            # the legacy path for BA-class systems, where padding cameras
            # into the mixed class wastes Bp^2
            small_blocks = all(
                VERTEX_TYPES[t].tangent_dim <= 6 or st.n == 0
                for t, st in system.vertex_stores.items())
            if small_blocks:
                from slam_plus_plus_tpu.solvers.fastl import FastLSolver
                self._delegate = FastLSolver(
                    system, every_n=every_n, max_iterations=max_iterations,
                    dx_threshold=dx_threshold, config=config,
                    onetime_dx=False)
                self.asm = self._delegate.asm
                self.steps = self._delegate.steps
                return
        self.asm = Assembler(system, dataclasses.replace(
            self.config, edge_layout="flat"))
        asm = self.asm

        # ---- linear backend (mirrors GaussNewtonSolver) ----------------
        use_schur = asm.Nl > 0 and asm.Kpl > 0
        self._schur = SchurSolver(asm) if use_schur else None
        self._host = HostSparseSolver() if not use_schur else None
        self._dense_direct = (not use_schur and
                              asm.Np * asm.Bp <= device_policy().dense_limit)
        self._sparse_chol = None
        self._fused_lambda = None
        if not use_schur and not self._dense_direct:
            from slam_plus_plus_tpu.linalg.block_cholesky import (
                BlockCholeskySolver)
            self._sparse_chol = BlockCholeskySolver(
                asm.pp_rows, asm.pp_cols, asm.Np, asm.Bp)

            # one dispatch per lambda-mode solve iteration: active-prefix
            # assembly + full MIS-Schur factor+solve + |dx| in a single
            # program (the reference's Extend/Refresh_Lambda + Cholesky
            # solve per incremental step, NonlinearSolver_Lambda.h:516-625)
            chol = self._sparse_chol

            def fused_lambda(states, edge_data, counts, nap, nal):
                bs = asm._assemble_active_impl(states, edge_data, counts,
                                               nap, nal)
                dx_p = chol._factor_solve_impl(bs.pp_blocks, bs.eta_p)
                norm = jnp.linalg.norm(dx_p)
                return dx_p, norm, bs.max_hdiag

            self._fused_lambda = jax.jit(fused_lambda)
        if self._dense_direct:
            self._dense_solve_jit = jax.jit(
                lambda bs: solve_dense_spd(asm.pp_rows, asm.pp_cols,
                                           bs.pp_blocks, bs.eta_p,
                                           asm.Np, asm.Bp))

        self._build_replay_plan()
        self._activate_fns: Dict[Tuple[str, int], callable] = {}

        # fastl mode: ONE fused jitted step (assemble+solve+update), no host
        # synchronization — steps stream asynchronously to the device
        self._fused_step = None
        schur_fusable = (self._schur is not None and
                         not getattr(self._schur, "sparse_reduced", False))
        if self.mode == "fastl" and (schur_fusable or self._dense_direct):
            def fused(states, edge_data, counts, nap, nal):
                bs = self.asm._assemble_active_impl(states, edge_data,
                                                    counts, nap, nal)
                if self._schur is not None:
                    dx_p, dx_l = self._schur._solve_dense_impl(bs)
                else:
                    dx_p = solve_dense_spd(asm.pp_rows, asm.pp_cols,
                                           bs.pp_blocks, bs.eta_p,
                                           asm.Np, asm.Bp)
                    dx_l = jnp.zeros((max(asm.Nl, 1), asm.Bl),
                                     dtype=bs.eta_p.dtype)
                # guard non-finite steps without host sync
                ok = jnp.isfinite(jnp.sum(dx_p)) & jnp.isfinite(jnp.sum(dx_l))
                okf = ok.astype(dx_p.dtype)
                return self.asm._update_impl(states, dx_p * okf, dx_l * okf)

            self._fused_step = jax.jit(fused)

    # ------------------------------------------------------------------

    def _build_replay_plan(self) -> None:
        """Host precompute: per-step edge, new-vertex activations, counts,
        loop-closure flags."""
        system = self.system
        order_of = {g: i for i, g in enumerate(system.vertex_order)}

        seen = set()
        self.steps: List[dict] = []
        counts = {name: 0 for name in system.edge_stores}
        n_active_vertices = 0
        # per-type active vertex count in class order: vertices activate in
        # insertion order, so a single count per class suffices
        for (ename, li) in system._edge_insert_log:
            store = system.edge_stores[ename]
            et = store.etype
            vids = store.vertex_ids[li]
            new_vs = []
            for slot, gid in enumerate(vids):
                if gid not in seen:
                    seen.add(gid)
                    new_vs.append((slot, int(gid)))
                    n_active_vertices += 1
            counts[ename] += 1

            # reference loop-closure test (NonlinearSolver_Base.h:505-539)
            n = len(vids)
            first = min(order_of[g] for g in vids)
            closure = (first + n < n_active_vertices) if n > 1 else False

            # class-wise active counts = how many of the first
            # n_active_vertices insertion-ordered vertices are p/l
            self.steps.append(dict(
                ename=ename, li=li, new_vs=new_vs, closure=closure,
                counts=dict(counts), n_active=n_active_vertices))

        # prefix: number of p-class among first k inserted vertices
        p_flags = np.array(
            [1 if self.asm.type_class[system.vertex_directory[g][0]] == "p"
             else 0 for g in system.vertex_order], dtype=np.int64)
        self._p_prefix = np.concatenate([[0], np.cumsum(p_flags)])
        self._l_prefix = np.concatenate(
            [[0], np.cumsum(1 - p_flags)])

    def _activate(self, states, ename: str, slot: int, eidx: int):
        et = EDGE_TYPES[ename]
        if et.jax_initializer is None:
            return states  # file-initialized (BA): snapshot already holds it
        key = (ename, slot)
        if key not in self._activate_fns:
            asm = self.asm

            def act(states, edge_data, eidx, ename=ename, slot=slot, et=et):
                data = edge_data[ename]
                gathered = tuple(states[t][data["slot_local"][k][eidx]]
                                 for k, t in enumerate(et.vertex_types))
                new = et.jax_initializer(gathered, data["z"][eidx], slot)
                tname = et.vertex_types[slot]
                li = data["slot_local"][slot][eidx]
                out = dict(states)
                out[tname] = states[tname].at[li].set(
                    new.astype(states[tname].dtype))
                return out

            self._activate_fns[key] = jax.jit(act)
        return self._activate_fns[key](states, self.asm.edge_data, eidx)

    def _solve(self, bs):
        asm = self.asm
        if self._schur is not None:
            return self._schur.solve(bs)
        zeros_l = jnp.zeros((max(asm.Nl, 1), asm.Bl), dtype=bs.eta_p.dtype)
        if self._dense_direct:
            return self._dense_solve_jit(bs), zeros_l
        if self._sparse_chol is not None:
            return self._sparse_chol.solve(bs.pp_blocks, bs.eta_p), zeros_l
        dx_p = self._host.solve_blocks(asm.pp_rows, asm.pp_cols,
                                       np.asarray(bs.pp_blocks),
                                       np.asarray(bs.eta_p), asm.Np, asm.Bp)
        return jnp.asarray(dx_p, dtype=bs.eta_p.dtype), zeros_l

    def _optimize(self, states, counts, nap, nal, max_iters, thresh):
        """Reference Optimize(): solve, break-before-push on small |dx|.

        Gauge-deficient systems (incremental BA) get an escalating damped
        retry when the plain GN solve is non-finite — the analogue of the
        reference's LM/dogleg fallback for BA problem types."""
        from slam_plus_plus_tpu.solvers.lm import damp_system
        n_iters = 0
        for _ in range(max_iters):
            n_iters += 1
            if self._fused_lambda is not None:
                dx_p, norm_dev, _hd = self._fused_lambda(
                    states, self.asm.edge_data, counts, nap, nal)
                norm = float(norm_dev)
                if np.isfinite(norm):
                    if norm <= thresh:
                        break
                    states = self.asm.update(
                        states, dx_p,
                        jnp.zeros((max(self.asm.Nl, 1), self.asm.Bl),
                                  dtype=dx_p.dtype))
                    continue
                # non-finite: fall through to the damped retry path
            bs = self.asm.assemble_active(states, counts, nap, nal)
            dx_p, dx_l = self._solve(bs)
            norm = float(jnp.sqrt(jnp.sum(dx_p * dx_p) + jnp.sum(dx_l * dx_l)))
            if not np.isfinite(norm):
                alpha = float(bs.max_hdiag) * 1e-6
                for _try in range(6):
                    dx_p, dx_l = self._solve(
                        damp_system(bs, alpha, self.asm.pp_diag_ids_dev))
                    norm = float(jnp.sqrt(jnp.sum(dx_p * dx_p) +
                                          jnp.sum(dx_l * dx_l)))
                    if np.isfinite(norm):
                        break
                    alpha *= 100.0
            if not np.isfinite(norm) or norm <= thresh:
                break
            states = self.asm.update(states, dx_p, dx_l)
        return states, n_iters

    # ------------------------------------------------------------------

    def run(self, verbose: bool = False, on_step=None):
        """Replay all edges; returns (final_chi2, n_total_iterations)."""
        if self._delegate is not None:
            if on_step is not None:
                raise ValueError("per-step callbacks need "
                                 "IncrementalSolver(allow_fused=False)")
            out = self._delegate.run(verbose=verbose)
            self.elapsed = self._delegate.elapsed
            self.n_solves = self._delegate.stats.get("steps", 0)
            return out
        t0 = time.perf_counter()
        asm = self.asm
        states = asm.snapshot_states(self.system)

        last_optimized = 0
        had_closure = False
        total_iters = 0
        n_solves = 0

        for si, step in enumerate(self.steps):
            # activate new vertices on device (edge initializer semantics)
            for (slot, gid) in step["new_vs"]:
                states = self._activate(states, step["ename"], slot, step["li"])

            had_closure = had_closure or step["closure"] or self.mode == "fastl"
            n_active = step["n_active"]
            if self.every_n and (n_active - last_optimized) >= self.every_n:
                last_optimized = n_active
                if had_closure:
                    had_closure = False
                    counts = {n: step["counts"].get(n, 0)
                              for n in asm.edge_data}
                    nap = int(self._p_prefix[n_active])
                    nal = int(self._l_prefix[n_active])
                    if self._fused_step is not None:
                        # async streaming: no host sync inside the loop
                        states = self._fused_step(states, asm.edge_data,
                                                  counts, nap, nal)
                        it = 1
                    else:
                        states, it = self._optimize(
                            states, counts, nap, nal,
                            self.max_iterations, self.dx_threshold)
                    total_iters += it
                    n_solves += 1
                    if verbose and n_solves % 200 == 0:
                        print(f"step {si}: solves={n_solves} "
                              f"iters={total_iters}")
            if on_step is not None:
                on_step(self, si, states)

        full_counts = {n: self.steps[-1]["counts"].get(n, 0)
                       for n in asm.edge_data}
        chi2 = float(asm.chi2_active(states, full_counts))
        asm.writeback_states(self.system, states)
        self.elapsed = time.perf_counter() - t0
        self.n_solves = n_solves
        if verbose:
            print(f"incremental done: {len(self.steps)} steps, "
                  f"{n_solves} solves, {total_iters} iterations, "
                  f"{self.elapsed:.2f}s")
        return chi2, total_iters
