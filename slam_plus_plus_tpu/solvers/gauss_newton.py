"""Batch Gauss-Newton ("Lambda") solver.

Reference analogue: CNonlinearSolver_Lambda::Optimize
(reference include/slam/NonlinearSolver_Lambda.h:476-668).  Iteration
semantics replicated exactly for golden-value parity:

    for iter in range(max_iters):
        refresh lambda at current linearization point
        eta = rhs
        dx = solve(lambda, eta)            # Cholesky or Schur
        if ||dx||_2 <= dx_threshold: break # break BEFORE pushing
        x <- x ⊞ dx

The linear backend is chosen per structure: Schur elimination whenever an
eliminated (landmark) class exists, a dense Cholesky for small primary
systems, and the nested MIS-Schur sparse block Cholesky
(linalg/block_cholesky.py) for large pose graphs; linear_solver="scipy"
forces the host oracle.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from slam_plus_plus_tpu.assembly.assembler import Assembler
from slam_plus_plus_tpu.config import SolverConfig, device_policy
from slam_plus_plus_tpu.graph.system import GraphSystem
from slam_plus_plus_tpu.linalg.dense import solve_dense_spd
from slam_plus_plus_tpu.linalg.host_solver import HostSparseSolver
from slam_plus_plus_tpu.linalg.schur import SchurSolver


class GaussNewtonSolver:
    def __init__(self, system: GraphSystem, config: Optional[SolverConfig] = None):
        if not system.edge_stores:
            raise ValueError("cannot build a solver over an empty system "
                             "(no edges); add edges first")
        self.system = system
        self.config = config or SolverConfig()
        self.asm = Assembler(system, self.config)
        self.timing = {}

        asm = self.asm
        use_schur = asm.Nl > 0 and asm.Kpl > 0
        if self.config.linear_solver == "schur":
            use_schur = True
        if self.config.linear_solver in ("dense", "scipy"):
            use_schur = False

        self._schur = SchurSolver(asm) if use_schur else None
        self._host = HostSparseSolver() if not use_schur else None
        n_scalar = asm.Np * asm.Bp
        # f32 never auto-picks the raw dense factor: an unequilibrated
        # pose-graph lambda has kappa ~1e8, so a single-precision direct
        # Cholesky loses every digit (kappa*eps = O(10); observed on chip:
        # NaN first step at intel/manhattan scale while the Jacobi-
        # equilibrated + CG-refined sparse path converges at ratio <=1.01).
        f32 = self.asm.dtype == jnp.float32
        self._dense_direct = (not use_schur and
                              (self.config.linear_solver == "dense" or
                               (self.config.linear_solver == "auto" and
                                not f32 and
                                n_scalar <= device_policy().dense_limit)))
        if self._dense_direct:
            # rows/cols stay host-side numpy: static scatter structure.
            # full-f32 precision: a reduced-precision blocked Cholesky/TRSM
            # makes a 10k-dim dense factor produce a divergent step
            # (observed: manhattan3500 batch chi2 exploding after one
            # iteration, while the sparse path with pinned precision
            # converges).
            def dense_solve(sys_):
                with jax.default_matmul_precision("highest"):
                    return solve_dense_spd(asm.pp_rows, asm.pp_cols,
                                           sys_.pp_blocks, sys_.eta_p,
                                           asm.Np, asm.Bp)

            self._dense_solve_jit = jax.jit(dense_solve)
        # large pose-graph path: nested MIS-Schur sparse block Cholesky on
        # device (replaces the reference's CLinearSolver_UberBlock role)
        self._sparse_chol = None
        if (not use_schur and not self._dense_direct and
                self.config.linear_solver in ("auto", "block_cholesky")):
            from slam_plus_plus_tpu.linalg.block_cholesky import (
                BlockCholeskySolver)
            from slam_plus_plus_tpu.linalg.spmv import lambda_spmv
            f32 = self.asm.dtype == jnp.float32
            # f32 depth cap: error through the MIS-Schur elimination grows
            # with the level count — at 17 levels (w100K scale) the f32
            # factor left O(1) error in a subspace and plain refinement
            # diverged.  Capping at 8 levels raises the dense bottom only
            # modestly (w100K: 1470 -> 2966 blocks = one ~9k-dim dense
            # Cholesky, ~10 ms class) while removing 40% of the scatter
            # products and halving the error depth; f64 keeps full depth
            # (deep elimination is cheaper than a large host/dense bottom
            # there).
            self._sparse_chol = BlockCholeskySolver(
                asm.pp_rows, asm.pp_cols, asm.Np, asm.Bp,
                **(dict(max_levels=8) if f32 else {}))
            chol = self._sparse_chol
            pcg_iters = (self.config.refine_iterations + 10) if f32 else 0

            def sparse_solve(bs):
                f = chol._factor_impl(bs.pp_blocks)
                b = bs.eta_p
                dx = chol._solve_with_factor_impl(f, b)
                if not pcg_iters:
                    return dx
                # f32: wrap the factor as a PCG preconditioner.  Unlike
                # stationary refinement (round 3: diverged whenever the f32
                # factor stopped being a contraction), CG converges for ANY
                # SPD preconditioner quality — the Krylov step optimally
                # damps the modes the factor got wrong.  Bounded iteration
                # count + true-residual exit, all on device.
                zl = jnp.zeros((max(asm.Nl, 1), asm.Bl), dtype=dx.dtype)

                def mv(x):
                    hv, _ = lambda_spmv(asm, bs, x, zl)
                    return hv

                def dot(a, c):
                    return jnp.vdot(a.reshape(-1), c.reshape(-1))

                bn2 = dot(b, b)
                tol2 = jnp.asarray(1e-8, dx.dtype) * bn2   # rel 1e-4
                r0 = b - mv(dx)
                z0 = chol._solve_with_factor_impl(f, r0)
                state = (dx, r0, z0, z0, dot(r0, z0), jnp.asarray(0))

                def cond(s):
                    x, r, z, p, rz, k = s
                    return (k < pcg_iters) & (dot(r, r) > tol2) & \
                        jnp.isfinite(rz)

                def body(s):
                    x, r, z, p, rz, k = s
                    Ap = mv(p)
                    alpha = rz / dot(p, Ap)
                    x = x + alpha * p
                    r = r - alpha * Ap
                    z = chol._solve_with_factor_impl(f, r)
                    rz_new = dot(r, z)
                    p = z + (rz_new / rz) * p
                    return (x, r, z, p, rz_new, k + 1)

                dx_new, r, *_ = jax.lax.while_loop(cond, body, state)
                # solve-quality gate: keep whichever of (direct, PCG) has
                # the smaller TRUE residual, and NaN the step if even that
                # is garbage — the GN loop aborts cleanly instead of
                # corrupting the state (the reference's Cholesky-failure
                # abort analogue, NonlinearSolver_Lambda.h:666-668).
                rel2 = dot(r, r) / jnp.maximum(bn2, 1e-30)
                r_direct = b - mv(dx)
                rel2_direct = dot(r_direct, r_direct) / jnp.maximum(bn2,
                                                                    1e-30)
                better = (rel2 < rel2_direct) & jnp.all(jnp.isfinite(dx_new))
                dx = jnp.where(better, dx_new, dx)
                rel2 = jnp.minimum(rel2, rel2_direct)
                return jnp.where(rel2 < 1.0, dx, jnp.nan)

            self._sparse_solve_jit = jax.jit(sparse_solve)

    def _solve(self, block_system):
        asm = self.asm
        if self._schur is not None:
            return self._schur.solve(block_system)
        zeros_l = jnp.zeros((max(asm.Nl, 1), asm.Bl), dtype=block_system.eta_p.dtype)
        if self._dense_direct:
            return self._dense_solve_jit(block_system), zeros_l
        if self._sparse_chol is not None:
            return self._sparse_solve_jit(block_system), zeros_l
        if asm.Nl:
            dx_p, dx_l = self._host.solve_partitioned(asm, block_system)
            return (jnp.asarray(dx_p, dtype=block_system.eta_p.dtype),
                    jnp.asarray(dx_l, dtype=block_system.eta_p.dtype))
        dx_p = self._host.solve_blocks(asm.pp_rows, asm.pp_cols,
                                       np.asarray(block_system.pp_blocks),
                                       np.asarray(block_system.eta_p),
                                       asm.Np, asm.Bp)
        return jnp.asarray(dx_p, dtype=block_system.eta_p.dtype), zeros_l

    def optimize(self, max_iterations: Optional[int] = None,
                 dx_threshold: Optional[float] = None, verbose: bool = False):
        """Run GN to convergence; writes optimized states back to the system.

        Returns (final_chi2, iterations_run).
        """
        cfg = self.config.incremental
        max_iterations = (max_iterations if max_iterations is not None
                          else cfg.final_max_iterations)
        dx_threshold = (dx_threshold if dx_threshold is not None
                        else cfg.final_dx_threshold)

        t0 = time.perf_counter()
        states = self.asm.snapshot_states(self.system)
        n_iters = 0
        for it in range(max_iterations):
            n_iters += 1
            block_system = self.asm.assemble(states)
            dx_p, dx_l = self._solve(block_system)
            dx_norm = float(jnp.sqrt(jnp.sum(dx_p * dx_p) + jnp.sum(dx_l * dx_l)))
            if verbose:
                print(f"iter {it}: chi2={float(block_system.chi2):.2f} "
                      f"|dx|={dx_norm:.6f}")
            if not np.isfinite(dx_norm):
                break  # Cholesky failure analogue: abort iteration
            if dx_norm <= dx_threshold:
                break  # reference: break before pushing (Lambda.h:648)
            states = self.asm.update(states, dx_p, dx_l)
        chi2 = float(self.asm.chi2(states))
        self.asm.writeback_states(self.system, states)
        self.timing["optimize"] = time.perf_counter() - t0
        return chi2, n_iters

    def chi2(self) -> float:
        states = self.asm.snapshot_states(self.system)
        return float(self.asm.chi2(states))


def optimize(system: GraphSystem, config: Optional[SolverConfig] = None,
             max_iterations: int = 5, dx_threshold: float = 0.01,
             verbose: bool = False):
    solver = GaussNewtonSolver(system, config)
    return solver.optimize(max_iterations, dx_threshold, verbose=verbose)
