"""Preconditioned conjugate-gradient solver ("SPCG").

Reference analogue: CNonlinearSolver_SPCG (reference
include/slam/NonlinearSolver_SPCG.h:19,61) — research solver running
conjugate gradients over the normal equations with a SUBGRAPH
preconditioner.  Device formulation: matrix-free CG over the planar block SpMV
(one batched GEMM sweep per iteration), preconditioned by

  * "subgraph" (default for pose graphs, the reference's design): a
    maximum-weight spanning tree of the pose graph (weight = information
    trace), assembled into its own lambda and factored by the MIS-Schur
    engine.  A TREE eliminates with zero fill and ~half its vertices per
    level, so the preconditioner solve is O(log n) batched levels — the
    sequential sparse triangular solve that made spanning trees look
    hardware-hostile becomes exactly the engine's best case;
  * "jacobi": inverted diagonal blocks (kept for landmark systems, where
    the Schur path is preferred anyway).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from slam_plus_plus_tpu.config import SolverConfig
from slam_plus_plus_tpu.graph.system import GraphSystem
from slam_plus_plus_tpu.linalg.spmv import lambda_spmv
from slam_plus_plus_tpu.ops import planar
from slam_plus_plus_tpu.solvers.gauss_newton import GaussNewtonSolver


class SPCGSolver(GaussNewtonSolver):
    """GN outer loop with a CG linear solver (no factorization)."""

    def __init__(self, system: GraphSystem, config: Optional[SolverConfig] = None,
                 cg_iters: int = 200, cg_tol: float = 1e-8,
                 preconditioner: str = "auto"):
        super().__init__(system, config)
        self.cg_iters = cg_iters
        self.cg_tol = cg_tol
        asm = self.asm
        self._diag_pos = jnp.asarray(asm.pp_diag_ids)
        if preconditioner == "auto":
            preconditioner = "subgraph" if asm.Nl == 0 else "jacobi"
        self.preconditioner = preconditioner
        if preconditioner == "subgraph":
            self._build_subgraph()
        self._cg_jit = jax.jit(self._cg_impl)

    # -- spanning-tree subgraph preconditioner ---------------------------

    def _build_subgraph(self) -> None:
        """Host: maximum-weight spanning tree (Kruskal over information
        trace), per-edge-type keep masks, and the tree-pattern factorization
        plan (reference NonlinearSolver_SPCG.h:19 subgraph role)."""
        from slam_plus_plus_tpu.models.types import EDGE_TYPES
        from slam_plus_plus_tpu.linalg.block_cholesky import (
            BlockCholeskySolver)
        asm = self.asm
        system = self.system
        Np = asm.Np

        cand = []     # (weight, ename, local_idx, ci, cj)
        for ename, store in system.edge_stores.items():
            et = EDGE_TYPES[ename]
            if et.arity != 2:
                continue
            for li in range(store.n):
                gi, gj = store.vertex_ids[li]
                ci = asm.type_cslot[system.vertex_directory[gi][0]][
                    system.vertex_directory[gi][1]]
                cj = asm.type_cslot[system.vertex_directory[gj][0]][
                    system.vertex_directory[gj][1]]
                w = float(np.trace(np.asarray(store.informations[li])))
                cand.append((w, ename, li, int(ci), int(cj)))
        cand.sort(key=lambda t: -t[0])
        parent = np.arange(Np)

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        tree_pairs = []
        for (w, ename, li, ci, cj) in cand:
            ra, rb = find(ci), find(cj)
            if ra == rb:
                continue
            parent[ra] = rb
            tree_pairs.append((min(ci, cj), max(ci, cj)))

        # tree-pattern positions inside the full pp pattern.  The
        # preconditioner is the FULL lambda restricted to tree + diagonal
        # pairs: restricted = (tree lambda) + (full diag - tree diag), a
        # PSD shift of the tree's SPD lambda — so it is SPD, strictly
        # stronger than the tree alone, and needs no re-assembly (one
        # gather from the BlockSystem the solver already has).
        keys_full = asm.pp_rows * Np + asm.pp_cols
        tp = np.array(sorted({r * Np + c for (r, c) in tree_pairs} |
                             {v * Np + v for v in range(Np)}),
                      dtype=np.int64)
        self._tree_sel = jnp.asarray(np.searchsorted(keys_full, tp))
        self._tree_chol = BlockCholeskySolver(tp // Np, tp % Np, Np, asm.Bp)

    def _cg_impl(self, bs):
        asm = self.asm
        Bp, Bl = asm.Bp, asm.Bl

        if self.preconditioner == "subgraph":
            f_tree = self._tree_chol._factor_impl(
                bs.pp_blocks[self._tree_sel])

            def precond(r_p, r_l):
                return (self._tree_chol._solve_with_factor_impl(f_tree,
                                                                r_p), r_l)
        else:
            # block-Jacobi preconditioner: inverted diagonal blocks
            diag_p = bs.pp_blocks[self._diag_pos]        # [Np, Bp*Bp]
            m_p = planar.binv(diag_p, Bp)
            m_l = planar.binv(bs.ll_blocks, Bl) if asm.Nl else None

            def precond(r_p, r_l):
                z_p = planar.bmv(m_p, r_p, Bp, Bp)
                z_l = planar.bmv(m_l, r_l, Bl, Bl) if asm.Nl else r_l
                return z_p, z_l

        def matvec(v_p, v_l):
            return lambda_spmv(asm, bs, v_p, v_l)

        b_p, b_l = bs.eta_p, bs.eta_l
        x_p = jnp.zeros_like(b_p)
        x_l = jnp.zeros_like(b_l)
        r_p, r_l = b_p, b_l
        z_p, z_l = precond(r_p, r_l)
        p_p, p_l = z_p, z_l
        rz = jnp.sum(r_p * z_p) + jnp.sum(r_l * z_l)
        b_norm = jnp.sqrt(jnp.sum(b_p * b_p) + jnp.sum(b_l * b_l))

        def body(carry, _):
            x_p, x_l, r_p, r_l, p_p, p_l, rz, done = carry
            Ap_p, Ap_l = matvec(p_p, p_l)
            pAp = jnp.sum(p_p * Ap_p) + jnp.sum(p_l * Ap_l)
            alpha = jnp.where(pAp > 0, rz / pAp, 0.0)
            x_p2 = x_p + alpha * p_p
            x_l2 = x_l + alpha * p_l
            r_p2 = r_p - alpha * Ap_p
            r_l2 = r_l - alpha * Ap_l
            z_p2, z_l2 = precond(r_p2, r_l2)
            rz2 = jnp.sum(r_p2 * z_p2) + jnp.sum(r_l2 * z_l2)
            beta = jnp.where(rz > 0, rz2 / rz, 0.0)
            p_p2 = z_p2 + beta * p_p
            p_l2 = z_l2 + beta * p_l
            r_norm = jnp.sqrt(jnp.sum(r_p2 * r_p2) + jnp.sum(r_l2 * r_l2))
            done2 = done | (r_norm <= self.cg_tol * b_norm)
            # freeze updates once converged
            keep = 1.0 - done.astype(x_p.dtype)
            out = (x_p + keep * (x_p2 - x_p), x_l + keep * (x_l2 - x_l),
                   jnp.where(done, r_p, r_p2), jnp.where(done, r_l, r_l2),
                   jnp.where(done, p_p, p_p2), jnp.where(done, p_l, p_l2),
                   jnp.where(done, rz, rz2), done2)
            return out, None

        init = (x_p, x_l, r_p, r_l, p_p, p_l, rz,
                jnp.asarray(False))
        (x_p, x_l, *_), _ = jax.lax.scan(body, init, None,
                                         length=self.cg_iters)
        return x_p, x_l

    def _solve(self, block_system):
        return self._cg_jit(block_system)
