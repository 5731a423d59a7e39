"""Truncated symmetric eigensolver over the block system.

Reference analogue: CSymEigsSolver / CSymEigsShiftSolver (reference
include/slam/Eigenvalues.h:179,378 — Lanczos with implicit restarts,
Spectra-style, used for gauge/conditioning analysis and the
slam_schur_orderings research tool).  Device formulation: LOBPCG over the
planar block SpMV (linalg/spmv.lambda_spmv) — blocked matrix-free iteration
that maps to batched GEMMs — with a dense fallback
for small systems.

API mirrors the reference's use cases: largest/smallest magnitude
eigenvalues of lambda (or of the reduced camera system).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from slam_plus_plus_tpu.linalg.spmv import lambda_spmv

_DENSE_LIMIT = 2000


def _dense_lambda(asm, bs) -> np.ndarray:
    from slam_plus_plus_tpu.linalg.bsr import partitioned_to_scipy
    A = partitioned_to_scipy(
        asm.pp_rows, asm.pp_cols, np.asarray(bs.pp_blocks), asm.Np, asm.Bp,
        asm.pl_rows if asm.Nl else None, asm.pl_cols if asm.Nl else None,
        np.asarray(bs.pl_blocks) if asm.Nl else None,
        np.asarray(bs.ll_blocks) if asm.Nl else None, asm.Nl, asm.Bl)
    return A.toarray()


def sym_eigs(asm, bs, k: int = 6, which: str = "LM",
             max_iters: int = 200) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k eigenvalues/eigenvectors of the (symmetric) lambda.

    which: "LM" largest magnitude | "SM" smallest magnitude (via dense or
    shifted iteration).  Returns (eigenvalues [k], eigenvectors [n, k])."""
    n = asm.Np * asm.Bp + asm.Nl * asm.Bl

    if n <= _DENSE_LIMIT or which == "SM":
        # smallest-magnitude needs an inverse operator; for the problem sizes
        # where conditioning analysis is run (research tool), dense is exact
        # and still GEMM-shaped
        A = _dense_lambda(asm, bs)
        w, V = np.linalg.eigh(A)
        order = np.argsort(np.abs(w))
        idx = order[::-1][:k] if which == "LM" else order[:k]
        return w[idx], V[:, idx]

    # matrix-free LOBPCG on the planar block spmv
    Np, Bp, Nl, Bl = asm.Np, asm.Bp, asm.Nl, asm.Bl
    n_p = Np * Bp

    def matvec_cols(X):  # X: [n, m]
        def one(col):
            v_p = col[:n_p].reshape(Np, Bp)
            v_l = (col[n_p:].reshape(Nl, Bl) if Nl
                   else jnp.zeros((1, Bl), dtype=col.dtype))
            o_p, o_l = lambda_spmv(asm, bs, v_p, v_l)
            parts = [o_p.reshape(-1)]
            if Nl:
                parts.append(o_l.reshape(-1))
            return jnp.concatenate(parts)
        return jax.vmap(one, in_axes=1, out_axes=1)(X)

    from jax.experimental.sparse.linalg import lobpcg_standard
    rng = np.random.default_rng(0)
    X0 = jnp.asarray(rng.normal(0, 1, (n, k)), dtype=bs.eta_p.dtype)
    w, V, _ = lobpcg_standard(matvec_cols, X0, m=max_iters)
    order = jnp.argsort(-jnp.abs(w))
    return np.asarray(w[order]), np.asarray(V[:, order])


def condition_estimate(asm, bs) -> float:
    """max|eig| / min|eig| — the reference's gauge/conditioning analysis.

    Large systems stay matrix-free: LOBPCG gives the largest eigenvalue
    w_hi directly; the smallest comes from shift-invert — LOBPCG on
    A^-1 with the inner solves done by matrix-free CG over the planar
    block SpMV.  This is the device formulation of the reference's
    shift-invert mode (CSymEigsShiftSolver, Eigenvalues.h:378)."""
    n = asm.Np * asm.Bp + asm.Nl * asm.Bl
    if n <= _DENSE_LIMIT:
        w = np.linalg.eigvalsh(_dense_lambda(asm, bs))
        return float(np.abs(w).max() / max(np.abs(w).min(), 1e-300))
    w_hi, _ = sym_eigs(asm, bs, k=1, which="LM")
    hi = float(np.abs(w_hi[0]))

    Np, Bp, Nl, Bl = asm.Np, asm.Bp, asm.Nl, asm.Bl
    n_p = Np * Bp

    def matvec(col):
        v_p = col[:n_p].reshape(Np, Bp)
        v_l = (col[n_p:].reshape(Nl, Bl) if Nl
               else jnp.zeros((1, Bl), dtype=col.dtype))
        o_p, o_l = lambda_spmv(asm, bs, v_p, v_l)
        parts = [o_p.reshape(-1)]
        if Nl:
            parts.append(o_l.reshape(-1))
        return jnp.concatenate(parts)

    # block-Jacobi preconditioner: inverse diagonal blocks of lambda (the
    # SPCG solver's preconditioner, reused here so the inner CG converges
    # in O(sqrt(kappa_precond)) iterations instead of wandering for 4n)
    from slam_plus_plus_tpu.ops import planar
    pp_diag = bs.pp_blocks[asm.pp_diag_ids_dev]
    pd_inv = planar.binv(pp_diag, Bp)
    ll_inv = planar.binv(bs.ll_blocks, Bl) if Nl else None

    def precond(col):
        v_p = col[:n_p].reshape(Np, Bp)
        parts = [planar.bmv(pd_inv, v_p, Bp, Bp).reshape(-1)]
        if Nl:
            parts.append(planar.bmv(ll_inv, col[n_p:].reshape(Nl, Bl),
                                    Bl, Bl).reshape(-1))
        return jnp.concatenate(parts)

    if Nl == 0:
        # pose-only: apply A^-1 through ONE cached MIS-Schur factorization
        # instead of per-iteration CG — O(fill) once + O(levels) per solve,
        # which removes the former O(n*k)-matvecs-per-outer-iteration cost
        # at the 100k scale this exists for
        from slam_plus_plus_tpu.linalg.block_cholesky import (
            BlockCholeskySolver)
        chol = BlockCholeskySolver(asm.pp_rows, asm.pp_cols, Np, Bp)
        f = chol.factor(bs.pp_blocks)

        def inv_matvec(X):
            def one(col):
                return chol._solve_with_factor_impl(
                    f, col.reshape(Np, Bp)).reshape(-1)
            return jax.vmap(one, in_axes=1, out_axes=1)(X)
    else:
        def inv_matvec(X):  # A^-1 X via preconditioned CG, columnwise
            def one(col):
                x, _ = jax.scipy.sparse.linalg.cg(matvec, col, tol=1e-9,
                                                  maxiter=min(4 * n, 20000),
                                                  M=precond)
                return x
            return jax.vmap(one, in_axes=1, out_axes=1)(X)

    from jax.experimental.sparse.linalg import lobpcg_standard
    rng = np.random.default_rng(1)
    X0 = jnp.asarray(rng.normal(0, 1, (n, 1)), dtype=bs.eta_p.dtype)
    w_inv, _, _ = lobpcg_standard(jax.jit(inv_matvec), X0, m=25)
    lo = 1.0 / float(w_inv[0])
    return float(hi / max(abs(lo), 1e-300))
