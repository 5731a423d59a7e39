"""Levenberg-Marquardt ("Lambda-LM") solver — the reference default for BA.

Reference analogue: CNonlinearSolver_Lambda_LM
(reference include/slam/NonlinearSolver_Lambda_LM.h:97-226,796-1140).
Semantics replicated exactly for golden parity:

    alpha = 1e-3 * max per-edge vertex-Hessian diagonal; nu = 2; fail = 10
    last_error = chi2(x)
    for iteration < max_iters:                 # max_iters grows on failures
        lambda  <- refresh at linpoint; diag += alpha
        dx      <- solve(lambda, eta)
        if |dx| <= threshold: break            # break BEFORE pushing
        x_saved <- x; x <- x ⊞ dx; error <- chi2(x)
        rho = (last_error - error) / (dx . (alpha*dx + eta))
        good: alpha *= max(1/3, 1-(2 rho-1)^3); nu = 2; last_error = error
        bad:  alpha *= nu; nu *= 2; x <- x_saved;
              if fail: fail -= 1; max_iters += 1
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from slam_plus_plus_tpu.assembly.assembler import BlockSystem
from slam_plus_plus_tpu.config import SolverConfig
from slam_plus_plus_tpu.graph.system import GraphSystem
from slam_plus_plus_tpu.solvers.gauss_newton import GaussNewtonSolver


def damp_system(system: BlockSystem, alpha, pp_diag_ids) -> BlockSystem:
    """lambda.diag += alpha (reference ApplyDamping,
    NonlinearSolver_Lambda_LM.h:228-243).  Blocks are planar [K, B*B]."""
    Bp = int(round(system.pp_blocks.shape[-1] ** 0.5))
    Bl = int(round(system.ll_blocks.shape[-1] ** 0.5))
    p_diag_cols = [i * Bp + i for i in range(Bp)]
    l_diag_cols = [i * Bl + i for i in range(Bl)]
    pp = system.pp_blocks.at[pp_diag_ids[:, None], p_diag_cols].add(alpha)
    ll = system.ll_blocks.at[:, l_diag_cols].add(alpha)
    return system._replace(pp_blocks=pp, ll_blocks=ll)


def make_damped_gn_step(asm, schur, damping=1e-3):
    """One damped Gauss-Newton/Schur step as a pure function
    ``(states, edge_data) -> (new_states, chi2 at states)``: assembly,
    diagonal damping ``damping * max_hdiag``, dense reduced-camera solve,
    vertex update.  The benchmarked BA iteration."""

    def step(states, edge_data):
        bs = asm._finalize(*asm._edge_sums(states, edge_data))
        bs = damp_system(bs, bs.max_hdiag * jnp.asarray(damping,
                                                        dtype=asm.dtype),
                         asm.pp_diag_ids_dev)
        dx_p, dx_l = schur._solve_dense_impl(bs)
        return asm._update_impl(states, dx_p, dx_l), bs.chi2

    return step


class LevenbergMarquardtSolver(GaussNewtonSolver):
    TAU = 1e-3  # reference f_InitialDamping tau (Lambda_LM.h:155)

    def optimize(self, max_iterations: Optional[int] = None,
                 dx_threshold: Optional[float] = None, verbose: bool = False):
        cfg = self.config.incremental
        max_iterations = (max_iterations if max_iterations is not None
                          else cfg.final_max_iterations)
        dx_threshold = (dx_threshold if dx_threshold is not None
                        else cfg.final_dx_threshold)

        t0 = time.perf_counter()
        asm = self.asm
        states = asm.snapshot_states(self.system)
        base = asm.assemble(states)

        alpha = float(base.max_hdiag) * self.TAU
        if self.config.damping_init:
            alpha = self.config.damping_init
        nu = 2.0
        fail = 10
        last_error = float(base.chi2)
        if verbose:
            print(f"alpha: {alpha:f}\ninitial chi2: {last_error:f}")

        # fused LM trial (BA/Schur problems): damp + solve + push + trial
        # re-assembly + the rho scalars in ONE dispatch with ONE host sync
        # (the unfused loop pays 3-4 syncs per iteration)
        fused_trial = getattr(self, "_lm_trial_jit", None)
        if fused_trial is None and self._schur is not None:
            def _trial(states, base, alpha):
                damped = damp_system(base, alpha, asm.pp_diag_ids_dev)
                dx_p, dx_l = self._schur.solve_impl(damped)
                dx_norm = jnp.sqrt(jnp.sum(dx_p * dx_p) +
                                   jnp.sum(dx_l * dx_l))
                new_states = asm._update_impl(states, dx_p, dx_l)
                new_sys = asm._finalize(*asm._edge_sums(new_states,
                                                        asm.edge_data))
                denom = (jnp.sum(dx_p * (alpha * dx_p + base.eta_p)) +
                         jnp.sum(dx_l * (alpha * dx_l + base.eta_l)))
                return new_states, new_sys, dx_norm, new_sys.chi2, denom

            fused_trial = self._lm_trial_jit = jax.jit(_trial)

        n_iters = 0
        it = 0
        while it < max_iterations:
            it += 1
            n_iters += 1
            if base is None:
                base = asm.assemble(states)
            alpha_dev = jnp.asarray(alpha, dtype=asm.dtype)
            if fused_trial is not None:
                new_states, new_sys, norm_d, err_d, den_d = fused_trial(
                    states, base, alpha_dev)
                # ONE host sync for all three scalars (each separate
                # float() is a device round trip)
                dx_norm, error, denom = map(float, jax.device_get(
                    (norm_d, err_d, den_d)))
                if not np.isfinite(dx_norm):
                    break
                if dx_norm <= dx_threshold:
                    break  # reference: break before pushing (Lambda_LM.h:1054)
                saved_states = states
                states = new_states
            else:
                damped = damp_system(base, alpha_dev, asm.pp_diag_ids_dev)
                dx_p, dx_l = self._solve(damped)
                dx_norm = float(jnp.sqrt(jnp.sum(dx_p * dx_p) +
                                         jnp.sum(dx_l * dx_l)))
                if not np.isfinite(dx_norm):
                    break
                if dx_norm <= dx_threshold:
                    break  # reference: break before pushing (Lambda_LM.h:1054)

                saved_states = states
                states = asm.update(states, dx_p, dx_l)
                new_sys = asm.assemble(states)
                error = float(new_sys.chi2)
                # rho denominator: dx . (alpha dx + eta)  (Lambda_LM.h:207)
                denom = float(
                    jnp.sum(dx_p * (alpha * dx_p + base.eta_p)) +
                    jnp.sum(dx_l * (alpha * dx_l + base.eta_l)))
            if verbose:
                print(f"iter {it - 1}: chi2: {error:f} |dx|={dx_norm:.6f} "
                      f"alpha={alpha:g}")
            rho = (last_error - error) / denom if denom != 0.0 else -1.0
            if rho > 0:
                alpha *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                nu = 2.0
                last_error = error
                base = new_sys
            else:
                alpha *= nu
                nu *= 2.0
                states = saved_states
                if fail > 0:
                    fail -= 1
                    max_iterations += 1

        chi2 = float(asm.chi2(states))
        asm.writeback_states(self.system, states)
        self.timing["optimize"] = time.perf_counter() - t0
        return chi2, n_iters


def optimize_lm(system: GraphSystem, config: Optional[SolverConfig] = None,
                max_iterations: int = 5, dx_threshold: float = 0.01,
                verbose: bool = False):
    solver = LevenbergMarquardtSolver(system, config)
    return solver.optimize(max_iterations, dx_threshold, verbose=verbose)
