"""Distributed pose-graph factorization: MIS-Schur levels over a mesh.

Reference role: the sparse block Cholesky products of
CLinearSolver_UberBlock / the Schur products (reference
include/slam/LinearSolver_Schur.h:1744-1767) — single-node there; here the
per-level batched work of linalg/block_cholesky.py is sharded over the
mesh:

  * H (pattern blocks) and the pivot inverses stay REPLICATED — at B=3 a
    w100K-class level-0 is ~35 MB, far below per-device HBM, and the pivot
    inverse is a cheap elementwise pass;
  * the coupling products W = U C^-1 are computed on a 1/n slice of the
    U axis per device and `all_gather`ed (every shard needs arbitrary W
    rows for its fill products);
  * the FILL PRODUCTS — the dominant per-level compute, the analogue of the
    reference's two Schur SpDGEMMs — run on a 1/n slice of the product
    axis per device; the partial `segment_sum` into the next level's
    pattern is completed by one `psum` over the mesh (the reduction-plan
    pattern of SURVEY §2.3 P3, distributed);
  * the (small) dense bottom factorization and the triangular solves run
    replicated, exactly like the reference's dense-Schur default for
    reduced systems (LinearSolver_Schur.h:49).

Per-level collective volume: one W all-gather ([Ku, B*B]) + one next-H
psum ([K_next, B*B]) — a few MB per level at w100K scale, over NVLink.
The produced factor is replicated, so `solve_with_factor` (and the
recurrent marginals) run unchanged from the single-device engine.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from slam_plus_plus_tpu.ops import planar
from slam_plus_plus_tpu.linalg.block_cholesky import (
    BlockCholeskySolver, BlockCholeskyFactor, _equilibrated_cholesky)


class DistributedBlockCholeskySolver(BlockCholeskySolver):
    """BlockCholeskySolver whose elimination levels shard W/product work
    over a mesh axis.  Factor artifacts come back replicated; solves reuse
    the base-class path."""

    def __init__(self, rows, cols, N: int, B: int, mesh, axis: str = "edges",
                 **kw):
        super().__init__(rows, cols, N, B, **kw)
        self.mesh = mesh
        self.axis = axis
        n = int(mesh.devices.size)
        self.n_shards = n

        # per-level [n, width] sharded index tables (pad lanes masked)
        self._shards = []
        for lv in self.plan.levels:
            Ku, T = len(lv.u_src), len(lv.pa)

            def split(a, fill):
                m = ((max(len(a), 1) + n - 1) // n) * n
                out = np.full(m, fill, dtype=np.int64)
                out[:len(a)] = a
                return jnp.asarray(out.reshape(n, -1))

            def splitmask(k):
                m = ((max(k, 1) + n - 1) // n) * n
                out = np.zeros(m)
                out[:k] = 1.0
                return jnp.asarray(out.reshape(n, -1))

            self._shards.append(dict(
                u_idx=split(np.arange(Ku), 0), u_mask=splitmask(Ku),
                pa=split(lv.pa, 0), pb=split(lv.pb, 0),
                p_flip=split(lv.p_flip.astype(np.int64), 0),
                # pad products scatter into a dropped segment
                p_dst=split(lv.p_dst, lv.K_next), p_mask=splitmask(T),
            ))
        self._factor_dist_jit = jax.jit(
            jax.shard_map(self._factor_body, mesh=mesh, in_specs=(P(),),
                          out_specs=P(), check_vma=False))

    # -- sharded numeric phase ------------------------------------------

    def _factor_body(self, blocks):
        plan, B = self.plan, self.B
        with jax.default_matmul_precision("highest"):
            H = blocks[plan.input_perm]
            sv, outer = self._jacobi_scale(H)
            H = H * outer
            c_invs, Ws = [], []
            for li, lv in enumerate(plan.levels):
                sh = self._shards[li]
                me = jax.lax.axis_index(self.axis)
                dt = H.dtype
                C = H[lv.elim_diag_idx]
                if dt == jnp.float32:
                    dmean = jnp.mean(jnp.abs(planar.bdiag(C, B)), axis=1)
                    C = planar.badd_diag(C, 1e-5 * jnp.maximum(dmean, 1e-30),
                                         B)
                c_inv = planar.binv(C, B)                    # replicated
                if len(lv.u_src):
                    U0 = H[lv.u_src]
                    U = jnp.where(jnp.asarray(lv.u_flip)[:, None],
                                  planar.btranspose(U0, B, B), U0)
                    # W on my U slice, all_gathered to full
                    ui = sh["u_idx"][me]
                    W_loc = planar.bmm(
                        U[ui], c_inv[jnp.asarray(lv.u_elim)[ui]],
                        B, B, B) * sh["u_mask"][me][:, None].astype(dt)
                    W = jax.lax.all_gather(
                        W_loc, self.axis, tiled=True)[:len(lv.u_src)]
                else:
                    U = jnp.zeros((0, B * B), dtype=dt)
                    W = jnp.zeros((0, B * B), dtype=dt)
                # eta-free factor path (solves reuse the replicated factor)
                # fill products on my product slice; psum completes the
                # distributed reduction plan
                Hn = jnp.zeros((lv.K_next, B * B), dtype=dt)
                Hn = Hn.at[jnp.asarray(lv.carry_dst)].set(H[lv.carry_src])
                if len(lv.pa):
                    pa, pb = sh["pa"][me], sh["pb"][me]
                    prod = planar.bmm_A_Bt(W[pa], U[pb], B, B, B)
                    prod = jnp.where(sh["p_flip"][me][:, None] > 0,
                                     planar.btranspose(prod, B, B), prod)
                    prod = prod * sh["p_mask"][me][:, None].astype(dt)
                    part = jax.ops.segment_sum(
                        prod, sh["p_dst"][me],
                        num_segments=lv.K_next + 1)[:lv.K_next]
                    Hn = Hn - jax.lax.psum(part, self.axis)
                H = Hn
                c_invs.append(c_inv)
                Ws.append(W)
            dense = self._bottom_dense(H)
            L, s = _equilibrated_cholesky(dense)
            return BlockCholeskyFactor(tuple(c_invs), tuple(Ws), L, s, sv)

    def factor(self, blocks) -> BlockCholeskyFactor:
        return self._factor_dist_jit(blocks)

    def solve(self, blocks, eta):
        f = self.factor(blocks)
        return self.solve_with_factor(f, eta)
