"""Device-scalable sparse block Cholesky: nested MIS-Schur elimination.

Fills the role of the reference's native block Cholesky linear solver —
CLinearSolver_UberBlock's elimination-tree factorization with a fill-reducing
block ordering and symbolic reuse across calls (reference
include/slam/LinearSolver_UberBlock.h:45,216,272;
include/slam/BlockMatrix.h:3663-3707; AMD ordering
include/slam/OrderingMagic.h:319) — redesigned for the accelerator instead of
being ported:

  * The *ordering* and the *parallel schedule* are the same object: each
    level eliminates a maximal independent set (MIS) of low-degree block
    vertices.  By independence their pivot submatrix is exactly block
    diagonal, so the whole level's elimination is one batched planar inverse
    plus batched planar block products — no elimination tree traversal, no
    per-column sequencing.  (The reference itself computes MIS orderings for
    its Schur research, CSchurOrdering::t_MIS*, LinearSolver_Schur.h:378;
    here the *nested* MIS Schur complement IS the factorization.)
  * Degree-capped greedy-by-degree MIS selection approximates the fill
    behavior of minimum degree while exposing maximal batch parallelism.
  * After O(log n) levels the reduced system is small; it is scattered dense
    and factored by one dense Cholesky (the reference's own dense-Schur default
    for reduced systems, __SCHUR_USE_DENSE_SOLVER, LinearSolver_Schur.h:49).
  * The symbolic plan (per-level index arrays) is built once per sparsity
    pattern on host and reused across iterations/steps — the analogue of
    SymbolicDecomposition_Blocky symbolic reuse.

The factorization artifacts per level — the block-diagonal pivot inverses
C^-1 and the coupling products W = U C^-1 — double as the data needed for
repeated solves and for recurrent marginal recovery (the Takahashi recurrence
closes over exactly the fill pattern the plan already enumerates).

All block storage is PLANAR [K, B*B] (see ops/planar.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from slam_plus_plus_tpu.ops import planar


# ----------------------------------------------------------------------
# symbolic phase (host)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class _Level:
    """Host index arrays for one elimination level (all numpy)."""
    n: int                    # vertices entering this level
    n_next: int               # vertices remaining after elimination
    n_elim: int
    K: int                    # pairs entering this level
    K_next: int               # pairs remaining (carry + fill)
    elim_orig: np.ndarray     # [nE] level ids of eliminated vertices
    rest_orig: np.ndarray     # [n_next] level ids of surviving vertices
    elim_diag_idx: np.ndarray  # [nE] pair index of (e,e) in this level
    u_src: np.ndarray         # [Ku] pair index of each coupling block
    u_flip: np.ndarray        # [Ku] bool: stored as (elim,rest) -> transpose
    u_elim: np.ndarray        # [Ku] compact elim id
    u_rest_next: np.ndarray   # [Ku] compact next-level id of the rest vertex
    pa: np.ndarray            # [T] index into W for fill products
    pb: np.ndarray            # [T] index into U for fill products
    p_flip: np.ndarray        # [T] bool: transpose product before scatter
    p_dst: np.ndarray         # [T] destination pair index in next level
    carry_src: np.ndarray     # [Kc] pair index in this level
    carry_dst: np.ndarray     # [Kc] pair index in next level


class SymbolicPlan:
    """MIS-Schur elimination plan for a fixed block sparsity pattern.

    Built once per pattern (reference: SymbolicDecomposition_Blocky,
    LinearSolver_UberBlock.h:272); `factor`/`solve` reuse it every call.
    """

    def __init__(self, rows: np.ndarray, cols: np.ndarray, N: int, B: int,
                 bottom: int = 512, max_degree: int = 16,
                 max_levels: int = 64, dense_cap: int = 32000,
                 pin_last=None):
        """pin_last: optional vertex ids EXCLUDED from every elimination
        level — they survive to the dense bottom, the analogue of the
        reference's constrained orderings that force chosen blocks to the
        end of the factor (CLastElementOrderingConstraint /
        CFirstLastElementOrderingConstraint / n-last,
        reference include/slam/OrderingMagic.h:138-180; used there to keep
        marginals-relevant columns last).  Here "last" = the bottom dense
        factor, where the pinned blocks' rows/columns are directly
        addressable."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if np.any(rows > cols):
            raise ValueError("pattern must be upper pairs (row <= col)")
        self.N, self.B = int(N), int(B)
        self.levels: List[_Level] = []
        self._pin_mask0 = np.zeros(N, dtype=bool)
        if pin_last is not None:
            self._pin_mask0[np.asarray(pin_last, dtype=np.int64)] = True

        # current level pattern: sorted unique keys r*n + c (r <= c) and the
        # mapping from original pair order (level 0 = caller's order)
        n = int(N)
        keys = rows * n + cols
        order = np.argsort(keys)
        keys = keys[order]
        if np.any(keys[1:] == keys[:-1]):
            raise ValueError("duplicate pairs in pattern")
        self.input_perm = order  # caller blocks -> level-0 storage order

        dense_cap_blocks = max(bottom, dense_cap // B)
        pin = self._pin_mask0.copy()
        while n > bottom and len(self.levels) < max_levels:
            # stop when elimination stops paying: the remaining system is
            # dense-ish (fill) or progress is marginal — the dense bottom
            # is cheaper than more scatter levels (the reference's own
            # dense-solver default for reduced systems).  On grid-like pose
            # graphs MIS clears ~90% of the vertices in 10-20 levels; the
            # remaining separator core is exactly the part that WANTS the
            # device as one dense factorization.
            density = len(keys) / (n * (n + 1) / 2)
            if density > 0.25 and n <= dense_cap_blocks:
                break
            lvl, keys, n_next = self._build_level(keys, n, max_degree, pin)
            if lvl is None:
                break  # no progress possible (degree cap)
            self.levels.append(lvl)
            stalled = lvl.n_elim < max(16, 0.05 * n)
            pin = pin[lvl.rest_orig]
            n = n_next
            if stalled and n <= dense_cap_blocks:
                break
        if n * B > max(dense_cap, 40000):
            raise ValueError(
                f"elimination stalled with a {n * B}-dim reduced system; "
                f"graph too dense for the MIS-Schur engine (raise max_degree "
                f"or use the Schur/landmark path)")

        # level-0 row/col per (sorted) pair — for the Jacobi scaling of the
        # input blocks (and of incremental deltas)
        keys0 = np.sort(rows * N + cols)
        self.rows0 = (keys0 // N).astype(np.int64)
        self.cols0 = (keys0 % N).astype(np.int64)
        self.diag_pos0 = np.flatnonzero(self.rows0 == self.cols0)
        assert len(self.diag_pos0) == N, "every vertex needs a diagonal pair"

        # original vertex id of each bottom slot (consumers of pin_last
        # address the pinned blocks inside the dense bottom through this)
        orig = np.arange(N, dtype=np.int64)
        for lv in self.levels:
            orig = orig[lv.rest_orig]
        self.bottom_orig = orig

        # bottom: dense scatter plan for the remaining pattern
        self.n_bottom = n
        r = keys // n
        c = keys % n
        self._bottom_idx = planar.scatter_flat_indices(
            r, c, B, B, row_stride=n * B)
        off = r != c
        self._bottom_idx_t = planar.scatter_flat_indices(
            c, r, B, B, row_stride=n * B)
        self._bottom_off = off.astype(np.float64)
        self._tperm = [i * B + j for j in range(B) for i in range(B)]

    # -- host helpers ---------------------------------------------------

    @staticmethod
    def _build_level(keys: np.ndarray, n: int, max_degree: int,
                     pin: Optional[np.ndarray] = None):
        r = keys // n
        c = keys % n
        offd = r != c
        orr, occ = r[offd], c[offd]

        # adjacency (CSR) over off-diagonal pairs
        deg = np.bincount(orr, minlength=n) + np.bincount(occ, minlength=n)
        heads = np.concatenate([orr, occ])
        tails = np.concatenate([occ, orr])
        adj_order = np.argsort(heads, kind="stable")
        adj = tails[adj_order]
        adj_start = np.concatenate([[0], np.cumsum(np.bincount(heads,
                                                               minlength=n))])

        # greedy MIS by ascending degree.  The cap adapts to the current
        # degree distribution (fill raises degrees level by level — a fixed
        # cap stalls): eliminating the below-median-degree independent set
        # approximates minimum-degree fill behavior while keeping ~35-45%
        # of vertices per level in the batch.
        cap = max(max_degree, int(1.5 * np.median(deg)) + 1)
        elim_mask = np.zeros(n, dtype=bool)
        blocked = np.zeros(n, dtype=bool)
        if pin is not None:
            blocked |= pin    # pinned vertices are never MIS candidates
        for _ in range(8):
            vorder = np.argsort(deg, kind="stable")
            for v in vorder:
                if blocked[v] or deg[v] > cap:
                    continue
                elim_mask[v] = True
                blocked[v] = True
                blocked[adj[adj_start[v]:adj_start[v + 1]]] = True
            if elim_mask.any():
                break
            cap *= 2  # all degrees above cap: relax (guarantees progress)
        if not elim_mask.any():
            return None, keys, n

        elim_orig = np.flatnonzero(elim_mask)
        rest_orig = np.flatnonzero(~elim_mask)
        n_elim, n_next = len(elim_orig), len(rest_orig)
        rest_map = np.full(n, -1, dtype=np.int64)
        rest_map[rest_orig] = np.arange(n_next)
        elim_map = np.full(n, -1, dtype=np.int64)
        elim_map[elim_orig] = np.arange(n_elim)

        # diagonal pair index per eliminated vertex
        diag_keys = elim_orig * n + elim_orig
        elim_diag_idx = np.searchsorted(keys, diag_keys)
        assert np.array_equal(keys[elim_diag_idx], diag_keys), \
            "missing diagonal pair for eliminated vertex"

        # coupling (U) pairs: exactly one endpoint eliminated (both is
        # impossible by independence)
        er, ec = elim_mask[r], elim_mask[c]
        is_u = (er ^ ec) & offd
        u_src = np.flatnonzero(is_u)
        u_flip = er[u_src]  # stored (elim, rest): need B_{rest,elim} = ^T
        u_elim_v = np.where(u_flip, r[u_src], c[u_src])
        u_rest_v = np.where(u_flip, c[u_src], r[u_src])
        # group U by eliminated vertex for fill-pair generation
        gorder = np.argsort(u_elim_v, kind="stable")
        u_src = u_src[gorder]
        u_flip = u_flip[gorder]
        u_elim_v = u_elim_v[gorder]
        u_rest_v = u_rest_v[gorder]
        u_elim = elim_map[u_elim_v]
        u_rest_next = rest_map[u_rest_v]

        # carry pairs: both endpoints survive
        is_carry = ~er & ~ec
        carry_src = np.flatnonzero(is_carry)
        carry_keys = rest_map[r[carry_src]] * n_next + rest_map[c[carry_src]]

        # fill products: per eliminated vertex, all (i<=j) pairs of its
        # incident U blocks; vectorized by grouping on the (small, capped)
        # group size d
        counts = np.bincount(u_elim, minlength=n_elim)
        starts = np.concatenate([[0], np.cumsum(counts)])
        pa_l, pb_l = [], []
        for d in np.unique(counts):
            if d == 0:
                continue
            gsel = np.flatnonzero(counts == d)
            ii, jj = np.triu_indices(d)
            base = starts[gsel][:, None]
            pa_l.append((base + ii[None, :]).ravel())
            pb_l.append((base + jj[None, :]).ravel())
        if pa_l:
            pa = np.concatenate(pa_l)
            pb = np.concatenate(pb_l)
        else:
            pa = np.zeros(0, dtype=np.int64)
            pb = np.zeros(0, dtype=np.int64)
        ra = u_rest_next[pa]
        rb = u_rest_next[pb]
        p_flip = ra > rb
        fill_keys = np.where(p_flip, rb * n_next + ra, ra * n_next + rb)

        next_keys = np.unique(np.concatenate([carry_keys, fill_keys]))
        carry_dst = np.searchsorted(next_keys, carry_keys)
        p_dst = np.searchsorted(next_keys, fill_keys)

        lvl = _Level(
            n=n, n_next=n_next, n_elim=n_elim, K=len(keys),
            K_next=len(next_keys),
            elim_orig=elim_orig, rest_orig=rest_orig,
            elim_diag_idx=elim_diag_idx,
            u_src=u_src, u_flip=u_flip, u_elim=u_elim,
            u_rest_next=u_rest_next,
            pa=pa, pb=pb, p_flip=p_flip, p_dst=p_dst,
            carry_src=carry_src, carry_dst=carry_dst)
        return lvl, next_keys, n_next


# ----------------------------------------------------------------------
# numeric phase (device, jit-able with the plan closed over)
# ----------------------------------------------------------------------

class BlockCholeskyFactor(NamedTuple):
    """Factorization artifacts: per-level (c_inv, W) + dense bottom factor.

    The whole elimination runs on the Jacobi-equilibrated system
    S lambda S with S = diag(lambda)^-1/2 (s_vert): SLAM lambdas mix
    rotation/translation information scales and grow ~8 decimal orders
    through a deep elimination — beyond f32 without scaling (observed:
    negative bottom pivots / NaN Cholesky in f32 at w100K scale).  With a
    unit input diagonal the level growth stays bounded and f32 survives;
    solves scale the rhs in and the solution out.  The bottom additionally
    re-equilibrates its own dense diagonal (scale)."""
    c_invs: Tuple[jnp.ndarray, ...]   # [nE_k, B*B] each
    Ws: Tuple[jnp.ndarray, ...]       # [Ku_k, B*B] each
    L_bottom: jnp.ndarray             # [nb*B, nb*B] lower Cholesky (scaled)
    scale: jnp.ndarray                # [nb*B] bottom equilibration diag
    s_vert: jnp.ndarray               # [N, B] level-0 Jacobi scaling


def _full_f32(fn):
    """Trace-time full-f32 matmul precision for the factorization path.

    A reduced-precision f32 matmul (bf16 passes, or TF32 on the GPU)
    inside the blocked cholesky / solve_triangular lowerings is fatal for
    deep eliminations (observed: non-finite first dx on the 100k-pose
    17-level factorization, while full f32 is finite).  No-op on CPU."""
    import functools

    @functools.wraps(fn)
    def wrapper(*a, **k):
        with jax.default_matmul_precision("highest"):
            return fn(*a, **k)
    return wrapper


def _equilibrated_cholesky(dense):
    d = jnp.diagonal(dense)
    if dense.dtype != jnp.float32:
        s = jax.lax.rsqrt(jnp.maximum(d, 1e-10))
        return jnp.linalg.cholesky(dense * s[:, None] * s[None, :]), s
    # f32: a deep elimination can push bottom diagonal entries NEGATIVE
    # under round-off (observed at w100K: 17 levels, 1470-block bottom,
    # with reduced-precision matmuls).  Scale
    # by |d| so negative pivots don't explode the scaling, then take the
    # smallest ridge from an escalating ladder that yields a finite
    # factor; the solve is corrected by iterative refinement against the
    # TRUE residual, so the ridge only weakens the preconditioner.
    s = jax.lax.rsqrt(jnp.maximum(jnp.abs(d), 1e-10))
    A = dense * s[:, None] * s[None, :]
    eye = jnp.eye(A.shape[0], dtype=dense.dtype)
    L = jnp.linalg.cholesky(A + 1e-5 * eye)
    for ridge in (1e-3, 1e-1, 10.0):
        bad = ~jnp.all(jnp.isfinite(L))
        L = jax.lax.cond(bad,
                         lambda r=ridge: jnp.linalg.cholesky(A + r * eye),
                         lambda: L)
    return L, s


def _bottom_solve(L, s, rhs):
    y = jax.scipy.linalg.solve_triangular(L, rhs * s, lower=True)
    return s * jax.scipy.linalg.solve_triangular(L.T, y, lower=False)


class BlockCholeskySolver:
    """Sparse block SPD solver with cached symbolic plan.

    Usage:
        solver = BlockCholeskySolver(rows, cols, N, B)
        dx = solver.solve(blocks_planar, eta)          # factor + solve
        f = solver.factor(blocks_planar)               # reuse across rhs
        dx = solver.solve_with_factor(f, eta)
    """

    def __init__(self, rows, cols, N: int, B: int, bottom: int = 512,
                 max_degree: int = 16, dense_cap: int = 32000,
                 max_levels: int = 64, pin_last=None):
        self.plan = SymbolicPlan(rows, cols, N, B, bottom=bottom,
                                 max_degree=max_degree, dense_cap=dense_cap,
                                 max_levels=max_levels, pin_last=pin_last)
        self.N, self.B = int(N), int(B)
        self._solve_jit = jax.jit(self._factor_solve_impl)
        self._factor_jit = jax.jit(self._factor_impl)
        self._solve_with_factor_jit = jax.jit(self._solve_with_factor_impl)

    # -- numeric kernels -------------------------------------------------

    def _jacobi_scale(self, H):
        """s_vert [N, B] = diag(H)^-1/2 and the per-pair planar scale array
        (outer product of the pair's row/col scales)."""
        plan, B = self.plan, self.B
        d = planar.bdiag(H[jnp.asarray(plan.diag_pos0)], B)
        s = jax.lax.rsqrt(jnp.maximum(d, 1e-30))
        sr = s[jnp.asarray(plan.rows0)]        # [K, B]
        sc = s[jnp.asarray(plan.cols0)]        # [K, B]
        outer = (sr[:, :, None] * sc[:, None, :]).reshape(H.shape[0], B * B)
        return s, outer

    def _descend(self, H, eta, collect):
        """Run the elimination levels; returns bottom (H, eta) and artifacts."""
        B = self.B
        c_invs, Ws, etas = [], [], []
        f32 = H.dtype == jnp.float32
        for lv in self.plan.levels:
            C = H[lv.elim_diag_idx]
            if f32:
                # f32 depth guard: a pivot block drifting near-singular
                # under round-off makes binv's adjugate explode (finite but
                # huge c_inv -> the factor stops being a contraction and
                # iterative refinement diverges; observed at w100K).
                # A relative ridge bounds kappa(C) per level; the solve
                # refines against the true residual so only preconditioner
                # quality is affected.
                dmean = jnp.mean(jnp.abs(planar.bdiag(C, B)), axis=1)
                C = planar.badd_diag(C, 1e-5 * jnp.maximum(dmean, 1e-30), B)
            c_inv = planar.binv(C, B)
            U0 = H[lv.u_src]
            U = jnp.where(jnp.asarray(lv.u_flip)[:, None],
                          planar.btranspose(U0, B, B), U0)
            W = planar.bmm(U, c_inv[lv.u_elim], B, B, B)

            eta_E = eta[lv.elim_orig]
            corr = planar.bmv(W, eta_E[lv.u_elim], B, B)
            eta = eta[lv.rest_orig] - jax.ops.segment_sum(
                corr, jnp.asarray(lv.u_rest_next), num_segments=lv.n_next)

            if len(lv.pa):
                prod = planar.bmm_A_Bt(W[lv.pa], U[lv.pb], B, B, B)
                prod = jnp.where(jnp.asarray(lv.p_flip)[:, None],
                                 planar.btranspose(prod, B, B), prod)
            Hn = jnp.zeros((lv.K_next, B * B), dtype=H.dtype)
            Hn = Hn.at[jnp.asarray(lv.carry_dst)].set(H[lv.carry_src])
            if len(lv.pa):
                Hn = Hn - jax.ops.segment_sum(
                    prod, jnp.asarray(lv.p_dst), num_segments=lv.K_next)
            H = Hn
            if collect:
                c_invs.append(c_inv)
                Ws.append(W)
                etas.append(eta_E)
        return H, eta, c_invs, Ws, etas

    def _bottom_dense(self, H):
        plan = self.plan
        nb = plan.n_bottom * self.B
        dt = H.dtype
        dense = jnp.zeros((nb * nb,), dtype=dt)
        dense = dense.at[jnp.asarray(plan._bottom_idx).reshape(-1)].add(
            H.reshape(-1))
        mirrored = (H[:, plan._tperm] *
                    jnp.asarray(plan._bottom_off, dtype=dt)[:, None])
        dense = dense.at[jnp.asarray(plan._bottom_idx_t).reshape(-1)].add(
            mirrored.reshape(-1))
        return dense.reshape(nb, nb)

    def _ascend(self, x_bottom, c_invs, Ws, etas):
        """Back-substitute up through the levels."""
        B = self.B
        x = x_bottom  # [n_bottom, B]
        for li in range(len(self.plan.levels) - 1, -1, -1):
            lv = self.plan.levels[li]
            c_inv, W, eta_E = c_invs[li], Ws[li], etas[li]
            # x_e = C^-1 eta_e - sum_u W_u^T x_rest(u)
            corr = planar.bmv_At(W, x[lv.u_rest_next], B, B)
            x_e = planar.bmv(c_inv, eta_E, B, B) - jax.ops.segment_sum(
                corr, jnp.asarray(lv.u_elim), num_segments=lv.n_elim)
            xk = jnp.zeros((lv.n, B), dtype=x.dtype)
            xk = xk.at[jnp.asarray(lv.rest_orig)].set(x)
            xk = xk.at[jnp.asarray(lv.elim_orig)].set(x_e)
            x = xk
        return x

    @_full_f32
    def _factor_solve_impl(self, blocks, eta):
        # reduced-precision f32 matmuls are fatal inside a deep elimination
        # + Cholesky chain; force full-precision accumulation for the
        # solve-critical dense ops
        with jax.default_matmul_precision("highest"):
            H = blocks[self.plan.input_perm]
            sv, outer = self._jacobi_scale(H)
            Hb, eta_b, c_invs, Ws, etas = self._descend(H * outer, eta * sv,
                                                        collect=True)
            dense = self._bottom_dense(Hb)
            L, s = _equilibrated_cholesky(dense)
            nb = self.plan.n_bottom * self.B
            xb = _bottom_solve(L, s, eta_b.reshape(nb))
            dx = self._ascend(xb.reshape(self.plan.n_bottom, self.B),
                              c_invs, Ws, etas)
            return dx * sv

    @_full_f32
    def _factor_impl(self, blocks):
        with jax.default_matmul_precision("highest"):
            H = blocks[self.plan.input_perm]
            sv, outer = self._jacobi_scale(H)
            eta0 = jnp.zeros((self.N, self.B), dtype=blocks.dtype)
            Hb, _eta, c_invs, Ws, _etas = self._descend(H * outer, eta0,
                                                        collect=True)
            L, s = _equilibrated_cholesky(self._bottom_dense(Hb))
            return BlockCholeskyFactor(tuple(c_invs), tuple(Ws), L, s, sv)

    @_full_f32
    def _solve_with_factor_impl(self, f: BlockCholeskyFactor, eta):
        B = self.B
        etas = []
        with jax.default_matmul_precision("highest"):
            eta = eta * f.s_vert
            for li, lv in enumerate(self.plan.levels):
                W = f.Ws[li]
                eta_E = eta[lv.elim_orig]
                etas.append(eta_E)
                corr = planar.bmv(W, eta_E[lv.u_elim], B, B)
                eta = eta[lv.rest_orig] - jax.ops.segment_sum(
                    corr, jnp.asarray(lv.u_rest_next), num_segments=lv.n_next)
            nb = self.plan.n_bottom * B
            xb = _bottom_solve(f.L_bottom, f.scale, eta.reshape(nb))
            dx = self._ascend(xb.reshape(self.plan.n_bottom, B),
                              list(f.c_invs), list(f.Ws), etas)
            return dx * f.s_vert

    # -- public ----------------------------------------------------------

    def solve(self, blocks, eta):
        """Factor + solve: blocks [K, B*B] planar (caller's pair order),
        eta [N, B].  Returns dx [N, B]."""
        return self._solve_jit(blocks, eta)

    def factor(self, blocks) -> BlockCholeskyFactor:
        return self._factor_jit(blocks)

    def solve_with_factor(self, f: BlockCholeskyFactor, eta):
        return self._solve_with_factor_jit(f, eta)

    # -- recurrent sparse marginals ---------------------------------------

    @_full_f32
    def _marginals_impl(self, f: BlockCholeskyFactor):
        """Takahashi-style backward recurrence over the elimination levels:
        recover Sigma = lambda^-1 restricted to the fill pattern, never
        materializing a dense n x n matrix.

        Reference analogue: the ICRA-2015 recurrent formula
        (reference include/slam/Marginals.h:1694,2694) — there a backward
        recurrence over sparse R columns; here the same recurrence batched
        per elimination level, reusing the factorization's own index plans:

          Sigma_bot   = dense inverse of the bottom factor (small, dense)
          Sigma_ER[u] = -sum_i W_i^T Sigma_{rho_i, rho_u}   (fill-pair plan)
          Sigma_EE[e] = C_e^-1 - sum_u Sigma_ER[u] W_u
          Sigma_RR    = carry copy from the level below

        Every needed Sigma_{rho_i, rho_j} lies on the NEXT level's pattern
        (fill closure) — the recurrence closes exactly like the reference's.
        Returns Sigma blocks on the level-0 pattern in PLAN order."""
        with jax.default_matmul_precision("highest"):
            return self._marginals_body(f)

    def _marginals_body(self, f: BlockCholeskyFactor):
        plan, B = self.plan, self.B
        nb = plan.n_bottom * B
        eye = jnp.eye(nb, dtype=f.L_bottom.dtype)
        Linv = jax.scipy.linalg.solve_triangular(f.L_bottom, eye, lower=True)
        # undo the Jacobi equilibration: Sigma = S (S A S)^-1 S
        Sig_dense = (Linv.T @ Linv) * f.scale[:, None] * f.scale[None, :]
        # scatter the dense bottom inverse back onto the bottom pattern
        bidx = jnp.asarray(plan._bottom_idx)
        Sig = Sig_dense.reshape(-1)[bidx.reshape(-1)].reshape(bidx.shape)

        for li in range(len(plan.levels) - 1, -1, -1):
            lv = plan.levels[li]
            c_inv, W = f.c_invs[li], f.Ws[li]
            Ku = len(lv.u_src)
            dt = Sig.dtype

            if len(lv.pa):
                G = Sig[lv.p_dst]                    # [T, B*B] stored blocks
                Gt = planar.btranspose(G, B, B)
                pflip = jnp.asarray(lv.p_flip)[:, None]
                S_ab = jnp.where(pflip, Gt, G)       # Sigma_{rho_a', rho_b'}
                S_ba = jnp.where(pflip, G, Gt)
                term_b = planar.bmm_At_B(W[lv.pa], S_ab, B, B, B)
                term_a = planar.bmm_At_B(W[lv.pb], S_ba, B, B, B)
                offd = (lv.pa != lv.pb)
                Sig_ER = -(jax.ops.segment_sum(
                    term_b, jnp.asarray(lv.pb), num_segments=Ku) +
                    jax.ops.segment_sum(
                        term_a * jnp.asarray(offd, dtype=dt)[:, None],
                        jnp.asarray(lv.pa), num_segments=Ku))
            else:
                Sig_ER = jnp.zeros((max(Ku, 1), B * B), dtype=dt)

            # Sigma_EE = C^-1 - sum_u Sigma_ER[u] W_u
            corr = planar.bmm(Sig_ER[:Ku], W, B, B, B) if Ku else None
            Sig_EE = c_inv
            if Ku:
                Sig_EE = c_inv - jax.ops.segment_sum(
                    corr, jnp.asarray(lv.u_elim), num_segments=lv.n_elim)

            # assemble the level-k Sigma on its own pattern
            Sig_k = jnp.zeros((lv.K, B * B), dtype=dt)
            Sig_k = Sig_k.at[jnp.asarray(lv.carry_src)].set(
                Sig[jnp.asarray(lv.carry_dst)])
            Sig_k = Sig_k.at[jnp.asarray(lv.elim_diag_idx)].set(Sig_EE)
            if Ku:
                # stored pair (r, c): u_flip means stored as (e, rho) =
                # Sigma_ER directly; otherwise (rho, e) = Sigma_ER^T
                uval = jnp.where(jnp.asarray(lv.u_flip)[:, None],
                                 Sig_ER[:Ku],
                                 planar.btranspose(Sig_ER[:Ku], B, B))
                Sig_k = Sig_k.at[jnp.asarray(lv.u_src)].set(uval)
            Sig = Sig_k
        # undo the level-0 Jacobi scaling: Sigma = S Sigma' S
        sv = f.s_vert
        sr = sv[jnp.asarray(plan.rows0)]
        sc = sv[jnp.asarray(plan.cols0)]
        outer = (sr[:, :, None] * sc[:, None, :]).reshape(Sig.shape[0], B * B)
        return Sig * outer

    def marginals(self, f: BlockCholeskyFactor):
        """Sigma on the level-0 pattern (PLAN order), from a cached factor."""
        if not hasattr(self, "_marginals_jit"):
            self._marginals_jit = jax.jit(self._marginals_impl)
        return self._marginals_jit(f)

    def marginals_from_stores(self, stores, inc):
        """Marginals from the incremental engine's maintained flat stores
        (inc: the IncrementalCholesky owning the store layout)."""
        return self.marginals(inc.to_factor(stores))

    @property
    def n_levels(self) -> int:
        return len(self.plan.levels)

    def stats(self) -> dict:
        """Fill/level diagnostics (host)."""
        return {
            "levels": [(lv.n, lv.n_elim, lv.K, len(lv.pa))
                       for lv in self.plan.levels],
            "n_bottom": self.plan.n_bottom,
        }
