"""Device dense solve of a uniform block-sparse SPD system (planar blocks).

Fills the role of the reference's CLinearSolver_DenseEigen / CLinearSolver_DenseGPU
(reference include/slam/LinearSolver_Schur.h:1046,1219): the reduced camera
system after Schur elimination is small and dense — exactly the regime where
a single dense Cholesky wins.  XLA's `cholesky`/`triangular_solve` are
already blocked (cuSOLVER on the GPU); we add the planar-block densification
(flat-index scatter — see ops/planar.py for the layout rationale).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from slam_plus_plus_tpu.ops import planar


def dense_scatter_indices(rows, cols, N: int, B: int):
    """Host-side: (upper_idx, mirror_idx, offdiag_mask) for planar scatter."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    idx = planar.scatter_flat_indices(rows, cols, B, B, row_stride=N * B)
    idx_t = planar.scatter_flat_indices(cols, rows, B, B, row_stride=N * B)
    off = (rows != cols).astype(np.float64)
    return idx, idx_t, off


def scatter_dense(rows, cols, blocks_planar, N, B):
    """Planar upper-pair block list [K, B*B] -> dense symmetric [N*B, N*B].

    rows/cols are host numpy arrays (static structure)."""
    idx, idx_t, off = dense_scatter_indices(np.asarray(rows),
                                            np.asarray(cols), N, B)
    dt = blocks_planar.dtype
    tperm = [i * B + j for j in range(B) for i in range(B)]
    dense = jnp.zeros((N * B * N * B,), dtype=dt)
    dense = dense.at[jnp.asarray(idx).reshape(-1)].add(
        blocks_planar.reshape(-1))
    mirrored = blocks_planar[:, tperm] * jnp.asarray(off, dtype=dt)[:, None]
    dense = dense.at[jnp.asarray(idx_t).reshape(-1)].add(mirrored.reshape(-1))
    return dense.reshape(N * B, N * B)


def solve_dense_spd(rows, cols, blocks_planar, rhs, N, B):
    """Solve the block system densely with Cholesky.  rhs: [N, B]."""
    A = scatter_dense(rows, cols, blocks_planar, N, B)
    b = rhs.reshape(N * B)
    L = jnp.linalg.cholesky(A)
    y = jax.scipy.linalg.solve_triangular(L, b, lower=True)
    x = jax.scipy.linalg.solve_triangular(L.T, y, lower=False)
    return x.reshape(N, B)
