"""Batch Gauss-Newton over the rectangular Jacobian A (the "A solver").

Reference analogue: CNonlinearSolver_A (reference
include/slam/NonlinearSolver_A.h:314) — the solver that MATERIALIZES the
weighted block Jacobian A (one block row per edge, chi2 = ||A dx - b||^2
after sqrt-information weighting) plus the unary gauge factor, and solves
the least-squares system each iteration.  Unlike the lambda family it has
no robust-weighting hook (robust weights route through the lambda reduction
plans only) — replicated here.

Device/host split: the per-edge Jacobian/residual batches come from the same
jax kernels as the lambda path (vmap + jacfwd through the ⊞ retraction);
the rectangular assembly and the least-squares solve are host-side
(scipy LSQR) — this solver exists for verification and pedagogy, exactly as
in the reference, and the A it builds is exposed for inspection.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from slam_plus_plus_tpu.config import SolverConfig
from slam_plus_plus_tpu.graph.system import GraphSystem
from slam_plus_plus_tpu.models.types import EDGE_TYPES, VERTEX_TYPES
from slam_plus_plus_tpu.solvers.gauss_newton import GaussNewtonSolver


class ASolver(GaussNewtonSolver):
    def __init__(self, system: GraphSystem, config: Optional[SolverConfig] = None):
        config = config or SolverConfig()
        # robust off (reference A solver has no robust hook); flat edge
        # order keeps block rows in parse order like the reference's A
        config = dataclasses.replace(config, solver="a", edge_layout="flat")
        super().__init__(system, config)
        self._jac_kernels = {
            plan.name: self._make_jac_kernel(plan.name)
            for plan in self.asm.plans}

    def _make_jac_kernel(self, ename):
        """Batched (weighted residual, weighted jacobians) for one edge
        type: b_e = -L^T r, A_e = L^T J with info = L L^T."""
        et = EDGE_TYPES[ename]
        vts = [VERTEX_TYPES[t] for t in et.vertex_types]

        def single(states, z, info):
            r = et.residual(states, z)
            jacs = []
            for k, vt in enumerate(vts):
                def f(delta, k=k, vt=vt):
                    st = list(states)
                    st[k] = vt.boxplus(st[k], delta)
                    return et.residual(tuple(st), z)
                jacs.append(jax.jacfwd(f)(
                    jnp.zeros(vt.tangent_dim, dtype=z.dtype)))
            L = jnp.linalg.cholesky(info)
            return -(L.T @ r), tuple(L.T @ J for J in jacs)

        return jax.jit(jax.vmap(single))

    # ---- the rectangular system ----------------------------------------

    def _col_layout(self):
        """Scalar column offset per (class, cslot) with EXACT tangent dims
        (no padding — A's columns are the true unknowns)."""
        asm = self.asm
        offs_p, off = [], 0
        for (t, _li) in asm.p_order:
            offs_p.append(off)
            off += VERTEX_TYPES[t].tangent_dim
        offs_l = []
        for (t, _li) in asm.l_order:
            offs_l.append(off)
            off += VERTEX_TYPES[t].tangent_dim
        return offs_p, offs_l, off

    def materialize_A(self, states=None) -> Tuple[sp.csr_matrix, np.ndarray]:
        """(A, b): weighted block Jacobian + rhs at the current (or given)
        linearization point, including the unary gauge row block
        (reference CBasicUnaryFactorFactory's identity factor)."""
        asm = self.asm
        if states is None:
            states = asm.snapshot_states(self.system)
        offs_p, offs_l, n_cols = self._col_layout()
        rows, cols, vals = [], [], []
        bs = []
        row_off = 0
        for plan in asm.plans:
            data = asm.edge_data[plan.name]
            et = EDGE_TYPES[plan.name]
            gathered = tuple(states[t][data["slot_local"][k]]
                             for k, t in enumerate(et.vertex_types))
            wb, wjs = self._jac_kernels[plan.name](gathered, data["z"],
                                                   data["info"])
            m = et.residual_dim
            E = plan.E
            bs.append(np.asarray(wb).ravel())
            for k, t in enumerate(et.vertex_types):
                J = np.asarray(wjs[k])                      # [E, m, tdim]
                td = VERTEX_TYPES[t].tangent_dim
                cslot = np.asarray(plan.slot_cslot[k])
                col0 = (np.asarray(offs_p)[cslot]
                        if plan.slot_class[k] == "p"
                        else np.asarray(offs_l)[cslot])
                r = (row_off + np.arange(E)[:, None, None] * m +
                     np.arange(m)[None, :, None])
                c = col0[:, None, None] + np.arange(td)[None, None, :]
                rows.append(np.broadcast_to(r, J.shape).ravel())
                cols.append(np.broadcast_to(c, J.shape).ravel())
                vals.append(J.ravel())
            row_off += E * m
        # unary gauge factor on the anchor vertex
        if asm.anchor_cslot is not None:
            t, _ = asm.p_order[asm.anchor_cslot]
            td = VERTEX_TYPES[t].tangent_dim
            c0 = offs_p[asm.anchor_cslot]
            rows.append(row_off + np.arange(td))
            cols.append(c0 + np.arange(td))
            vals.append(np.ones(td))
            bs.append(np.zeros(td))
            row_off += td
        A = sp.coo_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(row_off, n_cols)).tocsr()
        return A, np.concatenate(bs)

    def _solve_via_A(self, states):
        """One GN step through the rectangular system: min ||A dx - b||."""
        asm = self.asm
        A, b = self.materialize_A(states)
        dx = sp.linalg.lsqr(A, b, atol=1e-12, btol=1e-12, iter_lim=8000)[0]
        offs_p, offs_l, _ = self._col_layout()
        dx_p = np.zeros((max(asm.Np, 1), asm.Bp))
        for s, (t, _li) in enumerate(asm.p_order):
            td = VERTEX_TYPES[t].tangent_dim
            dx_p[s, :td] = dx[offs_p[s]:offs_p[s] + td]
        dx_l = np.zeros((max(asm.Nl, 1), asm.Bl))
        for s, (t, _li) in enumerate(asm.l_order):
            td = VERTEX_TYPES[t].tangent_dim
            dx_l[s, :td] = dx[offs_l[s]:offs_l[s] + td]
        return (jnp.asarray(dx_p, dtype=asm.dtype),
                jnp.asarray(dx_l, dtype=asm.dtype))

    def optimize(self, max_iterations: Optional[int] = None,
                 dx_threshold: Optional[float] = None, verbose: bool = False):
        """CNonlinearSolver_A::Optimize semantics (shared CSolverOps_Base
        schedule: refresh A, solve, threshold-break before push)."""
        cfg = self.config.incremental
        max_iterations = (max_iterations if max_iterations is not None
                          else cfg.final_max_iterations)
        dx_threshold = (dx_threshold if dx_threshold is not None
                        else cfg.final_dx_threshold)
        asm = self.asm
        states = asm.snapshot_states(self.system)
        n_iters = 0
        for _ in range(max_iterations):
            n_iters += 1
            dx_p, dx_l = self._solve_via_A(states)
            dx_norm = float(jnp.sqrt(jnp.sum(dx_p * dx_p) +
                                     jnp.sum(dx_l * dx_l)))
            if not np.isfinite(dx_norm):
                break
            if dx_norm <= dx_threshold:
                break
            states = asm.update(states, dx_p, dx_l)
        chi2 = float(asm.chi2(states))
        asm.writeback_states(self.system, states)
        return chi2, n_iters
