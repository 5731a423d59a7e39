"""Planar (flattened) small-block linear algebra.

The accelerator analogue of the reference's FBS compile-time block-size
specialization (reference include/slam/BlockMatrixFBS.h:40-1853).  Blocks
are stored *planar* — [K, Br*Bc], block id leading, flattened block on the
minor axis — so every op is a fused elementwise chain on [K]-column vectors
with the tiny block loops unrolled at trace time, instead of batches of
tiny [Br, Bc] matmuls.

All functions take/return planar arrays and unroll the tiny block loops in
Python (static Br/Bm/Bc), exactly as the reference's typelist machinery
unrolls them at C++ compile time.
"""

from __future__ import annotations

import jax.numpy as jnp


def bmm(a, b, Br: int, Bm: int, Bc: int):
    """Per-block matmul: a [K, Br*Bm] @ b [K, Bm*Bc] -> [K, Br*Bc]."""
    cols = []
    for i in range(Br):
        for j in range(Bc):
            acc = a[:, i * Bm] * b[:, j]
            for n in range(1, Bm):
                acc = acc + a[:, i * Bm + n] * b[:, n * Bc + j]
            cols.append(acc)
    return jnp.stack(cols, axis=1)


def bmm_At_B(a, b, Br: int, Bm: int, Bc: int):
    """Per-block a^T @ b: a [K, Bm*Br], b [K, Bm*Bc] -> [K, Br*Bc]."""
    cols = []
    for i in range(Br):
        for j in range(Bc):
            acc = a[:, i] * b[:, j]
            for n in range(1, Bm):
                acc = acc + a[:, n * Br + i] * b[:, n * Bc + j]
            cols.append(acc)
    return jnp.stack(cols, axis=1)


def bmm_A_Bt(a, b, Br: int, Bm: int, Bc: int):
    """Per-block a @ b^T: a [K, Br*Bm], b [K, Bc*Bm] -> [K, Br*Bc]."""
    cols = []
    for i in range(Br):
        for j in range(Bc):
            acc = a[:, i * Bm] * b[:, j * Bm]
            for n in range(1, Bm):
                acc = acc + a[:, i * Bm + n] * b[:, j * Bm + n]
            cols.append(acc)
    return jnp.stack(cols, axis=1)


def bmv(a, v, Br: int, Bc: int):
    """Per-block matvec: a [K, Br*Bc] @ v [K, Bc] -> [K, Br]."""
    cols = []
    for i in range(Br):
        acc = a[:, i * Bc] * v[:, 0]
        for j in range(1, Bc):
            acc = acc + a[:, i * Bc + j] * v[:, j]
        cols.append(acc)
    return jnp.stack(cols, axis=1)


def bmv_At(a, v, Br: int, Bc: int):
    """Per-block a^T @ v: a [K, Br*Bc], v [K, Br] -> [K, Bc]."""
    cols = []
    for j in range(Bc):
        acc = a[:, j] * v[:, 0]
        for i in range(1, Br):
            acc = acc + a[:, i * Bc + j] * v[:, i]
        cols.append(acc)
    return jnp.stack(cols, axis=1)


def btranspose(a, Br: int, Bc: int):
    """Per-block transpose: [K, Br*Bc] -> [K, Bc*Br] (column permutation)."""
    perm = [i * Bc + j for j in range(Bc) for i in range(Br)]
    return a[:, perm]


def bdiag(a, B: int):
    """Per-block diagonal: [K, B*B] -> [K, B]."""
    idx = [i * B + i for i in range(B)]
    return a[:, idx]


def badd_diag(a, alpha, B: int):
    """Per-block a + alpha*I on the diagonal: [K, B*B] -> [K, B*B]."""
    out = a
    for i in range(B):
        out = out.at[:, i * B + i].add(alpha)
    return out


def binv(a, B: int):
    """Per-block inverse for B in {1, 2, 3} via adjugate (unrolled).

    a: [K, B*B] planar.  Larger B falls back to reshaping through
    jnp.linalg.inv (callers should keep B small for the eliminated class —
    landmarks are 1-3 dof in every reference problem type).
    """
    if B == 1:
        return 1.0 / a
    if B == 2:
        a11, a12, a21, a22 = a[:, 0], a[:, 1], a[:, 2], a[:, 3]
        det = a11 * a22 - a12 * a21
        inv_det = 1.0 / det
        return jnp.stack([a22 * inv_det, -a12 * inv_det,
                          -a21 * inv_det, a11 * inv_det], axis=1)
    if B == 3:
        m = [a[:, k] for k in range(9)]
        (a11, a12, a13,
         a21, a22, a23,
         a31, a32, a33) = m
        c11 = a22 * a33 - a23 * a32
        c12 = a13 * a32 - a12 * a33
        c13 = a12 * a23 - a13 * a22
        c21 = a23 * a31 - a21 * a33
        c22 = a11 * a33 - a13 * a31
        c23 = a13 * a21 - a11 * a23
        c31 = a21 * a32 - a22 * a31
        c32 = a12 * a31 - a11 * a32
        c33 = a11 * a22 - a12 * a21
        det = a11 * c11 + a12 * c21 + a13 * c31
        inv_det = 1.0 / det
        return jnp.stack([c11, c12, c13, c21, c22, c23, c31, c32, c33],
                         axis=1) * inv_det[:, None]
    # larger (even) blocks: recursive 2x2 block inversion via the Schur
    # complement — planar all the way, no [K, B, B] intermediates.
    # Requires SPD blocks (guaranteed for lambda
    # pivots: sums of J^T J plus unit pivots).
    B1 = B // 2
    B2 = B - B1

    def sub(i0, j0, Br, Bc):
        idx = [(i0 + i) * B + (j0 + j) for i in range(Br) for j in range(Bc)]
        return a[:, idx]

    A11 = sub(0, 0, B1, B1)
    A12 = sub(0, B1, B1, B2)
    A21 = sub(B1, 0, B2, B1)
    A22 = sub(B1, B1, B2, B2)
    A11i = binv(A11, B1)
    # S = A22 - A21 A11^-1 A12
    T = bmm(A21, A11i, B2, B1, B1)                 # [K, B2*B1]
    S = A22 - bmm(T, A12, B2, B1, B2)
    Si = binv(S, B2)
    # blocks of the inverse
    I12 = -bmm(bmm(A11i, A12, B1, B1, B2), Si, B1, B2, B2)   # [K, B1*B2]
    I21 = -bmm(Si, T, B2, B2, B1)                             # [K, B2*B1]
    I11 = A11i - bmm(I12, T, B1, B2, B1)
    I22 = Si
    cols = []
    for i in range(B):
        for j in range(B):
            if i < B1 and j < B1:
                cols.append(I11[:, i * B1 + j])
            elif i < B1:
                cols.append(I12[:, i * B2 + (j - B1)])
            elif j < B1:
                cols.append(I21[:, (i - B1) * B1 + j])
            else:
                cols.append(I22[:, (i - B1) * B2 + (j - B1)])
    return jnp.stack(cols, axis=1)


def scatter_flat_indices(rows, cols, Br: int, Bc: int, row_stride: int):
    """Host-side: flat scatter indices for planar blocks into a flat dense
    target.  Target layout: row-major [n_rows, row_stride] flattened.

    rows/cols: [K] block coordinates (numpy).  Returns [K, Br*Bc] int32.
    """
    import numpy as np
    base = (rows.astype(np.int64) * Br)[:, None] * row_stride + \
        (cols.astype(np.int64) * Bc)[:, None]
    off = np.array([i * row_stride + j for i in range(Br) for j in range(Bc)],
                   dtype=np.int64)
    return (base + off[None, :]).astype(np.int32)
