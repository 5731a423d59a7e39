"""Marginal covariance recovery.

Reference analogue: CMarginals (reference include/slam/Marginals.h:70-5224,
the ICRA-2015 fast covariance recovery) and CSchurComplement_Marginals
(reference include/slam/BAMarginals.h:388, the 3DV-2017 Schur-domain BA
marginals).  The reference recovers requested parts of Sigma = lambda^-1 by a
backward recurrence over the sparse Cholesky factor R; the device formulation
goes through the same two-level structure the solvers already use:

  * primary (pose/camera) covariance: Sigma_pp = SC^-1 where SC is the
    reduced system after eliminating the landmark class — computed via one
    dense Cholesky + triangular solves against identity (the reduced
    system is small by construction, the same reasoning as the reference's
    __SCHUR_USE_DENSE_SOLVER default);
  * landmark block-diagonal: Sigma_l = C_l^-1 + W_l^T Sigma_pp W_l with
    W = U C^-1 — the reference's sc_margs_detail::CUTTSolve_Bases_Impl
    recovers the same quantity with per-landmark basis solves
    (BAMarginals.h:238); here it is one dense GEMM Sigma_pp @ W_panel plus a
    batched per-landmark contraction, chunked over landmarks like the Schur
    solver's panels;
  * problems with no eliminated class invert the dense lambda directly.

Marginals are computed on the UNDAMPED lambda, as the reference refreshes
lambda with null damping before marginals (reference
include/slam/NonlinearSolver_Lambda_LM.h:1138-1142).

Covariance of the gauge: like the reference, the unary-factor block
(+identity on the anchor vertex) is part of lambda, which keeps it
invertible and matches the reference's numbers exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

from slam_plus_plus_tpu.ops import planar


class MarginalsResult(NamedTuple):
    p_diag: jnp.ndarray           # [Np, Bp*Bp] planar block-diagonal of Sigma_pp
    l_diag: jnp.ndarray           # [Nl, Bl*Bl] planar (empty-dim if no landmarks)
    sigma_pp: Optional[jnp.ndarray] = None  # [Np*Bp, Np*Bp] dense (if requested)


class Marginals:
    """Covariance recovery bound to an Assembler's structure.

    part: "diagonal" (default — the reference's mpart_Diagonal) or "full"
    (additionally returns the dense primary covariance).
    """

    def __init__(self, asm, part: str = "diagonal",
                 gauge_jitter: float = 0.0, mode: str = "auto"):
        """gauge_jitter: relative diagonal damping (scaled by max_hdiag)
        applied before inversion — gauge-deficient systems (mono BA scale
        freedom) are singular and would produce NaN; the reference's own
        factorization merely loses precision there, producing huge finite
        values.  Set 0 to disable.

        mode: "dense" inverts the (reduced) system densely; "sparse" uses
        the recurrent recovery over the MIS-Schur factor
        (BlockCholeskySolver.marginals — the ICRA-2015 recurrent formula
        analogue, O(fill) compute, no dense n x n); "auto" picks sparse for
        large pose-only systems."""
        self.asm = asm
        self.part = part
        self.gauge_jitter = gauge_jitter
        self._schur_mode = asm.Nl > 0 and asm.Kpl > 0
        self._schur_sparse = False
        if self._schur_mode:
            from slam_plus_plus_tpu.linalg.schur import SchurSolver
            nred = asm.Np * asm.Bp
            # many-pose landmark systems (victoria-park/cityTrees class):
            # densifying SC is O(nred^2) memory — route through the
            # sparse-reduced SC + the recurrent recovery over its MIS-Schur
            # factor instead (reference role: the recurrent formula,
            # Marginals.h:1694, applied to the reduced camera system)
            self._schur_sparse = (nred > 20000 or mode == "sparse_schur")
            if self._schur_sparse:
                self._schur = SchurSolver(
                    asm, sparse_reduced_limit=min(20000, max(nred - 1, 1)))
                sch = self._schur
                assert sch.sparse_reduced
                rc = sch._reduced_chol
                inv_perm = np.empty(sch.Ksc, dtype=np.int64)
                inv_perm[rc.plan.input_perm] = np.arange(sch.Ksc)
                keys = np.asarray(sch._sc_rows) * asm.Np + \
                    np.asarray(sch._sc_cols)
                diag_keys = np.arange(asm.Np) * asm.Np + np.arange(asm.Np)
                self._sc_diag_plan = jnp.asarray(
                    inv_perm[np.searchsorted(keys, diag_keys)])
                fill_dst = np.asarray(sch._fill_dst)
                self._fill_dst_plan = jnp.asarray(inv_perm[fill_dst])
                fill_pa = np.asarray(sch._fill_pa)
                fill_pb = np.asarray(sch._fill_pb)
                self._lm_seg = jnp.asarray(asm.pl_cols[fill_pa])
                self._pair_offd = jnp.asarray(
                    (fill_pa != fill_pb).astype(np.float64))
            else:
                self._schur = SchurSolver(asm, dense_reduced=True)
        else:
            self._schur = None
        self._sparse = None
        # auto picks the recurrent sparse path early: it is O(fill) compute
        # and O(fill) memory vs the dense path's O(n^3)/O(n^2), and it is
        # the better-tested engine (oracle-exact at 7800 dims); the dense
        # path remains for small systems and part="full"
        if (not self._schur_mode and part != "full" and
                (mode == "sparse" or
                 (mode == "auto" and asm.Np * asm.Bp > 1500))):
            from slam_plus_plus_tpu.linalg.block_cholesky import (
                BlockCholeskySolver)
            self._sparse = BlockCholeskySolver(asm.pp_rows, asm.pp_cols,
                                               asm.Np, asm.Bp)
            inv_perm = np.empty(len(asm.pp_rows), dtype=np.int64)
            inv_perm[self._sparse.plan.input_perm] = np.arange(
                len(asm.pp_rows))
            self._diag_pos = jnp.asarray(inv_perm[asm.pp_diag_ids])
            self._inv_perm = inv_perm
        self._compute_jit = jax.jit(self._compute_impl)

    def _dense_lambda_pp(self, bs):
        from slam_plus_plus_tpu.linalg.dense import scatter_dense
        asm = self.asm
        return scatter_dense(asm.pp_rows, asm.pp_cols, bs.pp_blocks,
                             asm.Np, asm.Bp)

    def _compute_impl(self, bs) -> MarginalsResult:
        asm = self.asm
        if self.gauge_jitter:
            from slam_plus_plus_tpu.solvers.lm import damp_system
            bs = damp_system(bs, bs.max_hdiag * self.gauge_jitter,
                             asm.pp_diag_ids_dev)
        Np, Bp, Nl, Bl = asm.Np, asm.Bp, asm.Nl, asm.Bl
        nred = Np * Bp
        dt = bs.pp_blocks.dtype

        if self._sparse is not None:
            f = self._sparse._factor_impl(bs.pp_blocks)
            sig = self._sparse._marginals_impl(f)
            p_diag = sig[self._diag_pos]
            l_diag = jnp.zeros((max(Nl, 1), Bl * Bl), dtype=dt)
            return MarginalsResult(p_diag, l_diag, None)

        if not self._schur_mode:
            A = self._dense_lambda_pp(bs)
            L = jnp.linalg.cholesky(A)
            inv_l = jax.scipy.linalg.solve_triangular(
                L, jnp.eye(nred, dtype=dt), lower=True)
            sigma = inv_l.T @ inv_l
            p_diag = self._extract_pdiag(sigma)
            l_diag = jnp.zeros((max(Nl, 1), Bl * Bl), dtype=dt)
            return MarginalsResult(
                p_diag, l_diag, sigma if self.part == "full" else None)

        sch = self._schur
        if self._schur_sparse:
            # sparse-reduced SC + recurrent recovery over its factor: the
            # >20k-dim landmark-marginals path.  Sigma_pp blocks needed for
            # the landmark correction all lie on the SC pattern (pose pairs
            # co-observing a landmark are exactly the SC fill pairs), so
            # the recurrent recovery provides every block without
            # densifying anything.
            c_inv = planar.binv(bs.ll_blocks, Bl)
            u = bs.pl_blocks
            w = planar.bmm(u, c_inv[sch._pl_cols_dev], Bp, Bl, Bl)
            sc = jnp.zeros((sch.Ksc, Bp * Bp), dtype=dt)
            sc = sc.at[sch._pp_to_sc].set(bs.pp_blocks)
            prod = planar.bmm_A_Bt(w[sch._fill_pa], u[sch._fill_pb],
                                   Bp, Bl, Bp)
            prod = jnp.where(sch._fill_flip[:, None],
                             planar.btranspose(prod, Bp, Bp), prod)
            sc = sc - jax.ops.segment_sum(prod, sch._fill_dst,
                                          num_segments=sch.Ksc)
            rc = sch._reduced_chol
            f = rc._factor_impl(sc)
            Sig = rc._marginals_impl(f)             # SC fill pattern, PLAN order
            p_diag = Sig[self._sc_diag_plan]
            # Sigma_l = C^-1 + sum over obs pairs  w_a^T Sigma_ab w_b
            Sg = Sig[self._fill_dst_plan]           # stored (min,max) blocks
            Sg = jnp.where(sch._fill_flip[:, None],
                           planar.btranspose(Sg, Bp, Bp), Sg)
            t1 = planar.bmm_At_B(w[sch._fill_pa], Sg, Bl, Bp, Bp)
            t2 = planar.bmm(t1, w[sch._fill_pb], Bl, Bp, Bl)
            t2 = t2 + (planar.btranspose(t2, Bl, Bl) *
                       self._pair_offd[:, None].astype(dt))
            corr = jax.ops.segment_sum(t2, self._lm_seg, num_segments=Nl)
            l_diag = c_inv + corr
            return MarginalsResult(p_diag, l_diag, None)
        if sch.panel_mode == "uniform":
            # gather-free panels (see SchurSolver._uniform_panels)
            c_inv, Ut, Wt = sch._uniform_panels(bs)
            sc = sch._dense_pp(bs.pp_blocks) - Wt.T @ Ut
            L = jnp.linalg.cholesky(sc)
            inv_l = jax.scipy.linalg.solve_triangular(
                L, jnp.eye(nred, dtype=dt), lower=True)
            sigma_pp = inv_l.T @ inv_l
            p_diag = self._extract_pdiag(sigma_pp)
            # Sigma_l = C^-1 + W_l^T SC^-1 W_l  per landmark, from the
            # row-partitioned W panel
            P = Wt @ sigma_pp                                   # [Nl*Bl, nred]
            corr = jnp.einsum("cir,cjr->cij", Wt.reshape(Nl, Bl, nred),
                              P.reshape(Nl, Bl, nred)).reshape(Nl, Bl * Bl)
            l_diag = c_inv + corr
            return MarginalsResult(
                p_diag, l_diag, sigma_pp if self.part == "full" else None)

        c_inv = planar.binv(bs.ll_blocks, Bl)                  # [Nl, Bl*Bl]
        u = bs.pl_blocks
        w = planar.bmm(u, c_inv[sch._pl_cols_dev], Bp, Bl, Bl)  # [Kpl, Bp*Bl]

        # SC and its inverse (dense)
        sc0 = sch._dense_pp(bs.pp_blocks)
        u_sorted = u[sch._order_dev]
        w_sorted = w[sch._order_dev]
        C = sch.chunk

        def build_panel(vals, idx):
            panel = jnp.zeros((nred * C * Bl,), dtype=dt)
            return panel.at[idx.reshape(-1)].add(
                vals.reshape(-1)).reshape(nred, C * Bl)

        # single-chunk fast path mirrors SchurSolver
        if sch.n_chunks == 1:
            idx = sch._panel_base + (sch._sorted_cols_dev * Bl)[:, None]
            up = build_panel(u_sorted, idx)
            wp = build_panel(w_sorted, idx)
            sc = sc0 - wp @ up.T
        else:
            M = sch.max_chunk_blocks

            def body(sc, ci):
                lo = sch._chunk_starts[ci]
                n_in = sch._chunk_starts[ci + 1] - lo
                sl = jnp.minimum(jnp.arange(M, dtype=lo.dtype) + lo,
                                 u_sorted.shape[0] - 1)
                valid = jnp.arange(M) < n_in
                mask = valid.astype(dt)[:, None]
                rel = sch._sorted_cols_dev[sl] - ci * C
                idx = jnp.where(valid[:, None],
                                sch._panel_base[sl] + (rel * Bl)[:, None], 0)
                up = build_panel(u_sorted[sl] * mask, idx)
                wp = build_panel(w_sorted[sl] * mask, idx)
                return sc - wp @ up.T, None

            sc, _ = jax.lax.scan(body, sc0, jnp.arange(sch.n_chunks))

        L = jnp.linalg.cholesky(sc)
        inv_l = jax.scipy.linalg.solve_triangular(
            L, jnp.eye(nred, dtype=dt), lower=True)
        sigma_pp = inv_l.T @ inv_l                              # SC^-1
        p_diag = self._extract_pdiag(sigma_pp)

        # landmark block diagonal: Sigma_l = C^-1 + W_l^T Sigma_pp W_l,
        # chunked: P = Sigma_pp @ W_panel; Sigma_l = C_l^-1 + W_l^T P_l
        l_diag = c_inv

        if sch.n_chunks == 1:
            idx = sch._panel_base + (sch._sorted_cols_dev * Bl)[:, None]
            wp = build_panel(w_sorted, idx)
            P = sigma_pp @ wp                                  # [nred, C*Bl]
            wr = wp.reshape(nred, C, Bl)
            pr = P.reshape(nred, C, Bl)
            corr = jnp.einsum("rci,rcj->cij", wr, pr).reshape(C, Bl * Bl)
            l_diag = l_diag + corr[:Nl]
        else:
            M = sch.max_chunk_blocks

            def lbody(carry, ci):
                ld = carry
                lo = sch._chunk_starts[ci]
                n_in = sch._chunk_starts[ci + 1] - lo
                sl = jnp.minimum(jnp.arange(M, dtype=lo.dtype) + lo,
                                 w_sorted.shape[0] - 1)
                valid = jnp.arange(M) < n_in
                mask = valid.astype(dt)[:, None]
                rel = sch._sorted_cols_dev[sl] - ci * C
                idx = jnp.where(valid[:, None],
                                sch._panel_base[sl] + (rel * Bl)[:, None], 0)
                wp = build_panel(w_sorted[sl] * mask, idx)
                P = sigma_pp @ wp
                wr = wp.reshape(nred, C, Bl)
                pr = P.reshape(nred, C, Bl)
                corr = jnp.einsum("rci,rcj->cij", wr, pr).reshape(C, Bl * Bl)
                # scatter chunk correction into the landmark diag
                lm_ids = jnp.minimum(ci * C + jnp.arange(C), ld.shape[0] - 1)
                in_range = (ci * C + jnp.arange(C)) < ld.shape[0]
                ld = ld.at[lm_ids].add(corr * in_range[:, None].astype(dt))
                return ld, None

            l_diag, _ = jax.lax.scan(lbody, l_diag, jnp.arange(sch.n_chunks))

        return MarginalsResult(
            p_diag, l_diag, sigma_pp if self.part == "full" else None)

    def _extract_pdiag(self, sigma):
        asm = self.asm
        Np, Bp = asm.Np, asm.Bp
        s4 = sigma.reshape(Np, Bp, Np, Bp)
        ids = jnp.arange(Np)
        return s4[ids, :, ids, :].reshape(Np, Bp * Bp)

    # public ------------------------------------------------------------

    def compute(self, block_system) -> MarginalsResult:
        return self._compute_jit(block_system)

    def sigma_blocks(self, block_system):
        """Sigma restricted to the lambda pattern, in ASSEMBLER pair order
        ([Kpp, Bp*Bp] planar) — the sparse recurrent recovery.  Off-diagonal
        neighbor covariances feed the compact-pose distance tests
        (reference include/slam/Distances.h:79)."""
        if self._sparse is None:
            raise ValueError("sigma_blocks requires mode='sparse'")
        f = self._sparse.factor(block_system.pp_blocks)
        sig = self._sparse.marginals(f)
        return sig[jnp.asarray(self._inv_perm)]


class IncrementalMarginals:
    """Incrementally updated block-diagonal covariance.

    Reference analogue: CMarginals::Update_BlockDiagonalMarginals_FBS_ExOmega
    (reference include/slam/Marginals.h:5224) with the update-vs-recalculate
    policy of the solver base: after new edges add omega = G G^T to lambda,
    the cached Sigma diagonal updates by Woodbury

        Sigma' = Sigma - X (I + G^T X)^-1 X^T,     X = Sigma G

    where X solves through the cached Cholesky factor — O(n k) per update
    instead of a fresh O(n^3/3) factorization.  Falls back to a full
    recompute when the update rank exceeds ``max_update_rank`` (the
    b_CanUpdate() policy).

    Round-1 scope: the primary (non-Schur) system; Schur-domain incremental
    updates fall back to recompute.
    """

    def __init__(self, asm, max_update_rank: int = 64):
        self.asm = asm
        self.max_update_rank = max_update_rank
        self._L = None            # cached dense Cholesky factor of lambda_pp
        self._sparse_factor = None  # cached MIS-Schur factor (large systems)
        self._sigma_diag = None   # [Np, Bp*Bp] planar
        # accumulated Woodbury corrections [(X [n,k], K [k,k]), ...]:
        # Sigma_now = Sigma_0 - sum_i X_i K_i X_i^T, so repeated updates
        # solve against the CACHED factor and replay the corrections
        self._corrections = []
        self._rank_used = 0
        self._marg = Marginals(asm)

    def compute(self, bs):
        """Full recompute; caches the factor for subsequent updates."""
        import jax.numpy as jnp
        from slam_plus_plus_tpu.linalg.dense import scatter_dense
        asm = self.asm
        res = self._marg.compute(bs)
        self._corrections = []
        self._rank_used = 0
        if not self._marg._schur_mode:
            if self._marg._sparse is not None:
                self._sparse_factor = self._marg._sparse.factor(bs.pp_blocks)
                self._L = None
            else:
                A = scatter_dense(asm.pp_rows, asm.pp_cols, bs.pp_blocks,
                                  asm.Np, asm.Bp)
                self._L = jnp.linalg.cholesky(A)
                self._sparse_factor = None
        self._sigma_diag = res.p_diag
        return res

    def b_can_update(self, k: int) -> bool:
        have_factor = self._L is not None or self._sparse_factor is not None
        return (have_factor and not self._marg._schur_mode
                and self._rank_used + k <= self.max_update_rank)

    def _sigma_mul(self, G):
        """Sigma_now @ G through the cached factor + replayed corrections."""
        import jax
        import jax.numpy as jnp
        if self._L is not None:
            Y = jax.scipy.linalg.solve_triangular(self._L, G, lower=True)
            X = jax.scipy.linalg.solve_triangular(self._L.T, Y, lower=False)
        else:
            asm = self.asm
            chol = self._marg._sparse

            def one(col):
                return chol._solve_with_factor_impl(
                    self._sparse_factor,
                    col.reshape(asm.Np, asm.Bp)).reshape(-1)
            X = jax.vmap(one, in_axes=1, out_axes=1)(G)
        for (Xi, Ki) in self._corrections:
            X = X - Xi @ (Ki @ (Xi.T @ G))
        return X

    def update(self, G):
        """Rank-k update after lambda grew by G @ G.T  (G: [n, k] dense,
        columns = square-root factors of the new edges' omega).  Repeatable:
        corrections accumulate against the cached factor until the total
        rank exceeds max_update_rank (the reference's b_CanUpdate policy,
        Marginals.h:5224); then raises ValueError (caller recomputes)."""
        import jax.numpy as jnp
        G = jnp.asarray(G)
        k = G.shape[1]
        if not self.b_can_update(k):
            raise ValueError("update not possible; recompute required")
        asm = self.asm
        X = self._sigma_mul(G)
        K = jnp.linalg.inv(jnp.eye(k, dtype=G.dtype) + G.T @ X)
        Np, Bp = asm.Np, asm.Bp
        Xb = X.reshape(Np, Bp, k)
        corr = jnp.einsum("nik,kl,njl->nij", Xb, K, Xb).reshape(Np, Bp * Bp)
        self._sigma_diag = self._sigma_diag - corr
        self._corrections.append((X, K))
        self._rank_used += k
        return self._sigma_diag

    @staticmethod
    def omega_sqrt_for_edges(asm, states, ename: str, eidxs):
        """G columns for a batch of edges of one type: sqrt-information-
        weighted jacobians scattered to the global index space ([n, m*E]).
        Fully batched on device (vmap over edges + one scatter)."""
        import jax
        import jax.numpy as jnp
        import numpy as np
        from slam_plus_plus_tpu.models.types import EDGE_TYPES, VERTEX_TYPES
        et = EDGE_TYPES[ename]
        data = asm.edge_data[ename]
        eidxs = jnp.asarray(np.atleast_1d(np.asarray(eidxs, dtype=np.int64)))
        m = et.residual_dim
        Bp = asm.Bp
        vts = [VERTEX_TYPES[t] for t in et.vertex_types]

        def one(eidx):
            gathered = tuple(states[t][data["slot_local"][kk][eidx]]
                             for kk, t in enumerate(et.vertex_types))
            info = data["info"][eidx]
            w, V = jnp.linalg.eigh(info)
            sqrtW = (V * jnp.sqrt(jnp.maximum(w, 0.0))[None, :]) @ V.T
            rows = []
            for kk, vt in enumerate(vts):
                def f(delta, kk=kk, vt=vt):
                    st = list(gathered)
                    st[kk] = vt.boxplus(st[kk], delta)
                    if et.expectation is not None:
                        return et.error(data["z"][eidx],
                                        et.expectation(tuple(st)))
                    return et.residual(tuple(st), data["z"][eidx])
                J = jax.jacfwd(f)(jnp.zeros(vt.tangent_dim,
                                            dtype=info.dtype))
                Jw = (sqrtW @ J).T                      # [d, m]
                if vt.tangent_dim < Bp:
                    Jw = jnp.pad(Jw, ((0, Bp - vt.tangent_dim), (0, 0)))
                rows.append(Jw)
            cslots = jnp.stack([data["slot_cslot"][kk][eidx]
                                for kk in range(et.arity)])
            return jnp.stack(rows), cslots               # [arity, Bp, m]

        Jw_all, cs_all = jax.vmap(one)(eidxs)            # [E, arity, Bp, m]
        E = len(eidxs)
        n = asm.Np * Bp
        G = jnp.zeros((asm.Np, Bp, m * E), dtype=Jw_all.dtype)
        for kk in range(et.arity):
            # edge e's columns live at [m*e : m*(e+1)]
            col_onehot = (jnp.arange(E)[:, None] ==
                          jnp.arange(E)[None, :]).astype(Jw_all.dtype)
            block = jnp.einsum("ebm,ef->ebfm", Jw_all[:, kk],
                               col_onehot).reshape(E, Bp, m * E)
            G = G.at[cs_all[:, kk]].add(block)
        return G.reshape(n, m * E)

    # backward-compatible single-edge wrapper
    @staticmethod
    def omega_sqrt_for_edge(asm, states, ename: str, eidx: int):
        return IncrementalMarginals.omega_sqrt_for_edges(
            asm, states, ename, [eidx])
