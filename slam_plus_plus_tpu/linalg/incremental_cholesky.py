"""Incremental (dirty-set) refactorization of the nested MIS-Schur factor,
fused into a single scanned device program per step.

The O(affected)-per-step analogue of the reference FastL's trailing-submatrix
R11 refactorization (reference include/slam/NonlinearSolver_FastL.h:2104-2263
Refresh_R_IncR11/Refresh_d_IncR11): when new-edge Hessian contributions
(omega) land on a few lambda pairs, only the factorization blocks REACHABLE
from those pairs change.  Reachability follows the elimination levels of
linalg/block_cholesky.py.

Accelerator-shaped redesign (round 4): the previous engine unrolled a Python
loop over the L elimination levels into one XLA graph of ~15 ops/level —
hundreds of tiny sequential ops, the wrong shape for an accelerator (~11 ms
per step on CPU) and a multi-second compile.  This version:

  * stores the whole factorization FLAT: one [sum K_l, B*B] array per kind
    (H pattern blocks incl. the bottom, pivot inverses C, couplings W, fill
    products P), each with two trailing rows — DUMMY (always zero, the
    target of padded *gathers*) and SINK (scratch, the target of padded
    *scatters*).  With that convention no mask vectors are needed anywhere:
    a padded lane reads zeros, computes zeros, and writes them where nobody
    looks.
  * gives every level the SAME dirty-set capacities, so the per-level update
    is one `lax.scan` body (~15 ops TOTAL in the compiled program, L trips)
    instead of 15*L unrolled ops.  The host walk packs global flat indices
    into one [L, SLOTS] int32 buffer — a single host->device transfer.
  * fuses the dirty refactorization, the dense-bottom re-Cholesky, AND the
    solve (descend + bottom + ascend, also scans) into ONE jitted program
    returning (stores', dx, |dx|): one dispatch per incremental step.

Per-level capacities are fixed at plan time; a step whose dirty set
overflows falls back to the full (still batched) redescent — the analogue
of the reference's Refresh_R_FullR fallback (NonlinearSolver_FastL.h:2367).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from slam_plus_plus_tpu.ops import planar
from slam_plus_plus_tpu.linalg.block_cholesky import (
    BlockCholeskySolver, _equilibrated_cholesky, _full_f32)


class IncrementalCholesky:
    _NOT_PREPARED = object()   # sentinel: "compute prepare_host inline"

    def __init__(self, chol: BlockCholeskySolver,
                 caps: Optional[dict] = None, omega_cap: int = 768,
                 aot_salt: Optional[str] = None):
        self.chol = chol
        self.plan = chol.plan
        self.B = chol.B
        # static capacity of the per-step omega delta batch: the fused step
        # compiles exactly once; larger batches overflow to the full
        # redescent (amortized — they only arise from long quiet stretches)
        self.omega_cap = omega_cap
        self._build_offsets()
        self._set_caps(caps)
        self._build_host_maps()
        self._build_solve_consts()
        self._build_full_consts()
        # stores are donated: the step updates tens of MB of factor state in
        # place instead of copying it every step
        if aot_salt is not None:
            from slam_plus_plus_tpu.utils.aot_cache import aot_jit
            salt = f"{aot_salt}|{self.cap_d},{self.cap_e},{self.cap_w}," \
                   f"{self.cap_p},{self.omega_cap}"
            self.aot_salt = salt
            self._step_jit = aot_jit(self._step_impl, "inc_step", salt,
                                     donate_argnums=(0,))
            self._full_jit = aot_jit(self._full_impl, "inc_full", salt)
            self._solve_jit = aot_jit(self._solve_only_impl, "inc_solve",
                                      salt)
        else:
            self.aot_salt = None
            self._step_jit = jax.jit(self._step_impl, donate_argnums=(0,))
            self._full_jit = jax.jit(self._full_impl)
            self._solve_jit = jax.jit(self._solve_only_impl)
        self.n_overflows = 0

    # ------------------------------------------------------------------
    # flat store layout
    # ------------------------------------------------------------------

    def _build_offsets(self) -> None:
        plan = self.plan
        levels = plan.levels
        # H: level patterns 0..L-1, then the bottom pattern, then dummy+sink
        self.off_H = np.concatenate(
            [[0], np.cumsum([lv.K for lv in levels])]).astype(np.int64)
        self.KB = len(plan._bottom_idx)          # bottom pattern pairs
        self.KH = int(self.off_H[-1]) + self.KB  # data rows
        self.H_dummy, self.H_sink = self.KH, self.KH + 1
        self.off_H_bottom = int(self.off_H[-1])

        self.off_C = np.concatenate(
            [[0], np.cumsum([lv.n_elim for lv in levels])]).astype(np.int64)
        self.NC = int(self.off_C[-1])
        self.C_dummy, self.C_sink = self.NC, self.NC + 1

        self.off_W = np.concatenate(
            [[0], np.cumsum([len(lv.u_src) for lv in levels])]).astype(
                np.int64)
        self.NW = int(self.off_W[-1])
        self.W_dummy, self.W_sink = self.NW, self.NW + 1

        self.off_P = np.concatenate(
            [[0], np.cumsum([len(lv.pa) for lv in levels])]).astype(np.int64)
        self.NP = int(self.off_P[-1])
        self.P_dummy = self.NP          # P pad is both gather and scatter:
        #                                 padded lanes write the zeros they
        #                                 read, so one row serves both roles

        nbB = plan.n_bottom * self.B
        self.nbB = nbB
        self.dense_sink = nbB * nbB     # dense stored flat with 1 sink slot

        # device-constant extended bottom scatter plans (row KB = sink)
        sink_row = np.full((1, self.B * self.B), self.dense_sink)
        self._bot_idx_ext = jnp.asarray(np.concatenate(
            [plan._bottom_idx, sink_row]).astype(np.int32))
        self._bot_idx_t_ext = jnp.asarray(np.concatenate(
            [plan._bottom_idx_t, sink_row]).astype(np.int32))
        self._bot_off_ext = jnp.asarray(
            np.concatenate([plan._bottom_off, [0.0]]))
        self._tperm = np.asarray(plan._tperm)

        # level-0 pattern (== the full lambda pattern) for the f32
        # iterative-refinement SpMV
        self._rows0 = jnp.asarray(plan.rows0.astype(np.int32))
        self._cols0 = jnp.asarray(plan.cols0.astype(np.int32))
        self._offdiag0 = jnp.asarray(
            (plan.rows0 != plan.cols0).astype(np.float32))

    def _set_caps(self, caps) -> None:
        # uniform per-level capacities (the scan body is one program).
        # Dirty sets stay small and nearly scale-free (a few dozen pairs
        # even at the deepest level on 10k-pose replays — measured); the
        # full redescent is the (rare) overflow fallback.
        if caps is None:
            caps = {}
        levels = self.plan.levels
        self.cap_d = int(caps.get("d", 384))
        self.cap_e = int(caps.get("e", 192))
        self.cap_w = int(caps.get("w", 384))
        self.cap_p = int(caps.get("p", 768))
        if levels:
            self.cap_e = min(self.cap_e, max(lv.n_elim for lv in levels) + 1)
            self.cap_w = min(self.cap_w,
                             max(len(lv.u_src) for lv in levels) + 1)
            self.cap_p = min(self.cap_p,
                             max(len(lv.pa) for lv in levels) + 1)
        self.cap_d = min(self.cap_d,
                         max(max((lv.K for lv in levels), default=1),
                             self.KB) + 1)
        # flat per-level slot layout (int32): all global indices.  The
        # *_dpos/_epos/_wapos slots localize each read to this step's dirty
        # lists so the scan body never touches the big stores — old values
        # are gathered once OUTSIDE the scan (see _step_impl), and the scan
        # carries only the [cap_d, B*B] running pair deltas.  (Carrying the
        # full H/C/W/P through the scan forced XLA to copy them every
        # level: 3.8 ms/step at 3500 poses; the small-carry form is ~1 ms.)
        slots = [("d_pos", self.cap_d), ("e_diag", self.cap_e),
                 ("e_pos", self.cap_e), ("e_dpos", self.cap_e),
                 ("w_usrc", self.cap_w), ("w_celim", self.cap_w),
                 ("w_pos", self.cap_w), ("w_dpos", self.cap_w),
                 ("w_epos", self.cap_w),
                 ("p_wa", self.cap_p), ("p_wapos", self.cap_p),
                 ("p_ubsrc", self.cap_p), ("p_ub_dpos", self.cap_p),
                 ("p_pos", self.cap_p), ("p_seg", self.cap_p),
                 ("c_pos", self.cap_d), ("c_seg", self.cap_d)]
        off = 0
        self._slots = {}
        for name, size in slots:
            self._slots[name] = (off, off + size)
            off += size
        self._row_len = off

    # ------------------------------------------------------------------
    # host symbolic maps (reachability walk)
    # ------------------------------------------------------------------

    def _build_host_maps(self) -> None:
        self.maps = []
        for lv in self.plan.levels:
            elim_of_pair = np.full(lv.K, -1, dtype=np.int64)
            elim_of_pair[lv.elim_diag_idx] = np.arange(lv.n_elim)
            u_of_pair = np.full(lv.K, -1, dtype=np.int64)
            u_of_pair[lv.u_src] = np.arange(len(lv.u_src))
            carry_dst_of_pair = np.full(lv.K, -1, dtype=np.int64)
            carry_dst_of_pair[lv.carry_src] = lv.carry_dst

            # u grouped by elim (u arrays are already sorted by u_elim)
            cnt = np.bincount(lv.u_elim, minlength=lv.n_elim)
            u_start = np.concatenate([[0], np.cumsum(cnt)])

            # prods grouped by pa and by pb
            order_a = np.argsort(lv.pa, kind="stable")
            a_start = np.concatenate(
                [[0], np.cumsum(np.bincount(lv.pa[order_a],
                                            minlength=len(lv.u_src)))]) \
                if len(lv.pa) else np.zeros(len(lv.u_src) + 1, dtype=np.int64)
            order_b = np.argsort(lv.pb, kind="stable")
            b_start = np.concatenate(
                [[0], np.cumsum(np.bincount(lv.pb[order_b],
                                            minlength=len(lv.u_src)))]) \
                if len(lv.pb) else np.zeros(len(lv.u_src) + 1, dtype=np.int64)

            self.maps.append(dict(
                elim_of_pair=elim_of_pair, u_of_pair=u_of_pair,
                carry_dst_of_pair=carry_dst_of_pair,
                u_start=u_start,
                prods_by_pa=order_a, pa_start=a_start,
                prods_by_pb=order_b, pb_start=b_start))

    def _host_walk(self, dirty_pos: List[np.ndarray]):
        """Walk reachability level by level; returns per-level bundles
        (host numpy, level-local indices) or (None, None) on capacity
        overflow.  dirty_pos: per-edge level-0 pair position arrays."""
        plan = self.plan
        levels = plan.levels
        bundles = []
        all_pos = (np.concatenate(dirty_pos) if dirty_pos
                   else np.zeros(0, dtype=np.int64))
        D, _ = np.unique(all_pos, return_inverse=True)

        for li, lv in enumerate(levels):
            m = self.maps[li]
            if len(D) > self.cap_d:
                return None, None
            e_ids = m["elim_of_pair"][D]
            E_d = e_ids[e_ids >= 0]
            u_val = m["u_of_pair"][D]
            U_val_d = u_val[u_val >= 0]
            # W dirty: U value changed, or pivot inverse changed
            if len(E_d):
                us, ue = m["u_start"][E_d], m["u_start"][E_d + 1]
                tot = (ue - us).sum()
                w_from_e = np.repeat(us, ue - us) + (
                    np.arange(tot) - np.repeat(np.cumsum(ue - us) - (ue - us),
                                               ue - us))
            else:
                w_from_e = np.zeros(0, dtype=np.int64)
            W_d = np.unique(np.concatenate([U_val_d, w_from_e]))

            def _ranges(ids, order, start):
                if not len(ids):
                    return np.zeros(0, dtype=np.int64)
                s, e = start[ids], start[ids + 1]
                tot = (e - s).sum()
                flat = np.repeat(s, e - s) + (
                    np.arange(tot) - np.repeat(np.cumsum(e - s) - (e - s),
                                               e - s))
                return order[flat]
            P_d = np.unique(np.concatenate([
                _ranges(W_d, m["prods_by_pa"], m["pa_start"]),
                _ranges(U_val_d, m["prods_by_pb"], m["pb_start"])]))
            if (len(E_d) > self.cap_e or len(W_d) > self.cap_w or
                    len(P_d) > self.cap_p):
                return None, None

            # next-level dirty pairs: carry copies + product destinations
            carry_dst = m["carry_dst_of_pair"][D]
            carry_sel = np.flatnonzero(carry_dst >= 0)   # positions in D
            p_dst = lv.p_dst[P_d] if len(P_d) else np.zeros(0, dtype=np.int64)
            D_next = np.unique(np.concatenate([carry_dst[carry_sel], p_dst]))
            carry_seg = np.searchsorted(D_next, carry_dst[carry_sel])
            p_seg = np.searchsorted(D_next, p_dst)

            bundles.append(dict(
                D=D, E=E_d, W=W_d, P=P_d,
                carry_sel=carry_sel, carry_seg=carry_seg, p_seg=p_seg))
            D = D_next

        if len(D) > self.cap_d:
            return None, None
        return bundles, D

    def _pack(self, bundles, D_bot):
        """Pack the walk into the [L, ROW] int32 buffer (global indices,
        pads per the dummy/sink convention) + the bottom selection."""
        plan, B = self.plan, self.B
        L = len(plan.levels)
        buf = np.empty((max(L, 1), self._row_len), dtype=np.int32)
        s = self._slots

        def put(row, name, a, fill):
            lo, hi = s[name]
            n = len(a)
            row[lo:lo + n] = a
            row[lo + n:hi] = fill

        def locate(sorted_list, values, miss):
            """Position of each value in sorted_list, or `miss`."""
            if not len(values) or not len(sorted_list):
                return np.full(len(values), miss, dtype=np.int64)
            pos = np.searchsorted(sorted_list, values)
            pos_c = np.minimum(pos, len(sorted_list) - 1)
            hit = np.asarray(sorted_list)[pos_c] == values
            return np.where(hit, pos_c, miss)

        for li, lv in enumerate(plan.levels):
            b = bundles[li]
            row = buf[li]
            oh, oc, ow, op = (self.off_H[li], self.off_C[li],
                              self.off_W[li], self.off_P[li])
            D, E, Wd, P = b["D"], b["E"], b["W"], b["P"]
            if li == 0:
                # level-0 H values were already updated by the omega scatter;
                # the add becomes a no-op into the sink (d_val still carries
                # the deltas for propagation)
                put(row, "d_pos", np.full(len(D), self.H_sink), self.H_sink)
            else:
                put(row, "d_pos", oh + D, self.H_sink)
            # delta localization: position of each read pair in this level's
            # dirty list D, or cap_d (zero row).  At level 0 the omega
            # kernel has ALREADY scattered the deltas into H, so the
            # pre-gathered old values are current — localize to the zero
            # row to avoid double-counting.
            def dloc(pairs):
                if li == 0:
                    return np.full(len(pairs), self.cap_d, dtype=np.int64)
                return locate(D, pairs, self.cap_d)

            put(row, "e_diag", oh + lv.elim_diag_idx[E], self.H_dummy)
            put(row, "e_pos", oc + E, self.C_sink)
            # every dirty pivot's diag pair is in D by construction
            put(row, "e_dpos", dloc(lv.elim_diag_idx[E]), self.cap_d)
            # W inputs: U source pair (flip encoded in sign: ~idx = flip)
            usrc = oh + lv.u_src[Wd]
            usrc = np.where(lv.u_flip[Wd], -usrc - 1, usrc)
            put(row, "w_usrc", usrc, self.H_dummy)
            put(row, "w_celim", oc + lv.u_elim[Wd], self.C_dummy)
            put(row, "w_pos", ow + Wd, self.W_sink)
            put(row, "w_dpos", dloc(lv.u_src[Wd]), self.cap_d)
            put(row, "w_epos", locate(E, lv.u_elim[Wd], self.cap_e),
                self.cap_e)
            # fill products
            put(row, "p_wa", ow + lv.pa[P], self.W_dummy)
            put(row, "p_wapos", locate(Wd, lv.pa[P], self.cap_w), self.cap_w)
            ub = oh + lv.u_src[lv.pb[P]]
            ub = np.where(lv.u_flip[lv.pb[P]], -ub - 1, ub)
            put(row, "p_ubsrc", ub, self.H_dummy)
            put(row, "p_ub_dpos", dloc(lv.u_src[lv.pb[P]]), self.cap_d)
            ppos = op + P
            ppos = np.where(lv.p_flip[P], -ppos - 1, ppos)
            put(row, "p_pos", ppos, self.P_dummy)
            put(row, "p_seg", b["p_seg"], self.cap_d)
            put(row, "c_pos", b["carry_sel"], self.cap_d)
            put(row, "c_seg", b["carry_seg"], self.cap_d)

        bot_sel = np.full(self.cap_d, self.KB, dtype=np.int32)
        bot_sel[:len(D_bot)] = D_bot
        bot_h = np.full(self.cap_d, self.H_sink, dtype=np.int32)
        bot_h[:len(D_bot)] = self.off_H_bottom + D_bot
        return buf, bot_sel, bot_h

    # ------------------------------------------------------------------
    # full redescent -> flat stores
    # ------------------------------------------------------------------

    def _build_full_consts(self) -> None:
        """Stacked per-level device constants for the SCANNED full
        redescent — the analogue of _build_solve_consts for the descend
        direction.  The round-4 _full_impl unrolled a python loop over the
        L levels into one XLA graph (~1.5 s of jax tracing per process and
        a deep sequential program); bucketing levels of similar pair-count
        into shared lax.scan bodies cuts the trace to ~4 bodies.

        Carry layout per bucket of width W: rows [0..W) hold the level's
        pair blocks, row W is the zero/sink row (padded gathers read zero,
        padded scatters land there), row W+1 is an IDENTITY block (padded
        pivot gathers invert to identity harmlessly)."""
        plan, B = self.plan, self.B
        levels = plan.levels
        L = len(levels)
        self._full_buckets = []
        b_start = 0
        while b_start < L:
            w0 = max(levels[b_start].K, levels[b_start].K_next)
            b_end = b_start + 1
            while (b_end < L and
                   max(levels[b_end].K, levels[b_end].K_next) > 0.55 * w0):
                w0 = max(w0, levels[b_end].K, levels[b_end].K_next)
                b_end = b_end + 1
            lvls = levels[b_start:b_end]
            Lb = len(lvls)
            W = int(max(max(lv.K, lv.K_next) for lv in lvls))
            nE = max(lv.n_elim for lv in lvls)
            Ku = max(max(len(lv.u_src) for lv in lvls), 1)
            T = max(max(len(lv.pa) for lv in lvls), 1)
            Kc = max(max(len(lv.carry_src) for lv in lvls), 1)

            def stack(get, width, fill):
                out = np.full((Lb, width), fill, dtype=np.int64)
                for li, lv in enumerate(lvls):
                    a = np.asarray(get(b_start + li, lv))
                    out[li, :len(a)] = a
                return jnp.asarray(out)

            def stackb(get, width):
                out = np.zeros((Lb, width), dtype=bool)
                for li, lv in enumerate(lvls):
                    a = np.asarray(get(lv))
                    out[li, :len(a)] = a
                return jnp.asarray(out)

            xs = dict(
                h_out=stack(lambda gi, lv: self.off_H[gi] +
                            np.arange(lv.K), W, self.H_sink),
                elim=stack(lambda gi, lv: lv.elim_diag_idx, nE, W + 1),
                c_out=stack(lambda gi, lv: self.off_C[gi] +
                            np.arange(lv.n_elim), nE, self.C_sink),
                u_src=stack(lambda gi, lv: lv.u_src, Ku, W),
                u_flip=stackb(lambda lv: lv.u_flip, Ku),
                u_elim=stack(lambda gi, lv: lv.u_elim, Ku, nE),
                w_out=stack(lambda gi, lv: self.off_W[gi] +
                            np.arange(len(lv.u_src)), Ku, self.W_sink),
                pa=stack(lambda gi, lv: lv.pa, T, Ku),
                pb=stack(lambda gi, lv: lv.pb, T, Ku),
                p_flip=stackb(lambda lv: lv.p_flip, T),
                p_out=stack(lambda gi, lv: self.off_P[gi] +
                            np.arange(len(lv.pa)), T, self.NP),
                p_dst=stack(lambda gi, lv: lv.p_dst, T, W),
                c_src=stack(lambda gi, lv: lv.carry_src, Kc, W),
                c_dst=stack(lambda gi, lv: lv.carry_dst, Kc, W),
            )
            self._full_buckets.append(dict(xs=xs, W=W, nE=nE, Ku=Ku, T=T))
            b_start = b_end

    @_full_f32
    def _full_impl(self, H0):
        """Full redescent from level-0 blocks (PLAN order, [K0, B*B]) via
        the bucketed level scans, producing the flat stores the fused step
        updates in place.  Replaces the round-4 unrolled python loop (same
        math, per-lane bit-equal; ~4 scan bodies instead of ~15*L ops)."""
        with jax.default_matmul_precision("highest"):
            plan, B = self.plan, self.B
            BB = B * B
            sv, outer0 = self.chol._jacobi_scale(H0)
            H0s = H0 * outer0
            dt = H0s.dtype
            eye = jnp.eye(B, dtype=dt).reshape(1, BB)
            zero1 = jnp.zeros((1, BB), dtype=dt)

            H_flat = jnp.zeros((self.KH + 2, BB), dtype=dt)
            C_flat = jnp.zeros((self.NC + 2, BB), dtype=dt)
            W_flat = jnp.zeros((self.NW + 2, BB), dtype=dt)
            P_flat = jnp.zeros((self.NP + 1, BB), dtype=dt)

            H_cur = H0s
            for bk in self._full_buckets:
                W, nE, Ku, T, xs = (bk["W"], bk["nE"], bk["Ku"], bk["T"],
                                    bk["xs"])
                pad = W - H_cur.shape[0]
                Hc = (jnp.concatenate(
                    [H_cur, jnp.zeros((pad, BB), dtype=dt)])
                    if pad > 0 else H_cur[:W])

                def body(Hd, x, W=W, nE=nE):
                    H_ext = jnp.concatenate([Hd, zero1, eye])
                    Cp = H_ext[x["elim"]]
                    if dt == jnp.float32:
                        dmean = jnp.mean(jnp.abs(planar.bdiag(Cp, B)),
                                         axis=1)
                        Cp = planar.badd_diag(
                            Cp, 1e-5 * jnp.maximum(dmean, 1e-30), B)
                    c_inv = planar.binv(Cp, B)
                    U0 = H_ext[x["u_src"]]
                    U = jnp.where(x["u_flip"][:, None],
                                  planar.btranspose(U0, B, B), U0)
                    c_ext = jnp.concatenate([c_inv, zero1])
                    Wn = planar.bmm(U, c_ext[x["u_elim"]], B, B, B)
                    W_ext = jnp.concatenate([Wn, zero1])
                    U_ext = jnp.concatenate([U, zero1])
                    prod = planar.bmm_A_Bt(W_ext[x["pa"]], U_ext[x["pb"]],
                                           B, B, B)
                    prod = jnp.where(x["p_flip"][:, None],
                                     planar.btranspose(prod, B, B), prod)
                    Hn = jnp.zeros((W + 1, BB), dtype=dt)
                    Hn = Hn.at[x["c_dst"]].set(H_ext[x["c_src"]])
                    Hn = Hn - jax.ops.segment_sum(prod, x["p_dst"],
                                                  num_segments=W + 1)
                    return Hn[:W], (Hd, c_inv, Wn, prod)

                Hc, (Hs, Cs, Ws, Ps) = jax.lax.scan(body, Hc, xs)
                H_flat = H_flat.at[xs["h_out"].reshape(-1)].set(
                    Hs.reshape(-1, BB))
                C_flat = C_flat.at[xs["c_out"].reshape(-1)].set(
                    Cs.reshape(-1, BB))
                W_flat = W_flat.at[xs["w_out"].reshape(-1)].set(
                    Ws.reshape(-1, BB))
                P_flat = P_flat.at[xs["p_out"].reshape(-1)].set(
                    Ps.reshape(-1, BB))
                H_cur = Hc

            Hb = H_cur[:self.KB] if len(plan.levels) else H0s
            H_flat = H_flat.at[self.off_H_bottom +
                               jnp.arange(self.KB)].set(Hb)
            dense = self.chol._bottom_dense(Hb)
            L, s = _equilibrated_cholesky(dense)
            return dict(
                H=H_flat, C=C_flat, W=W_flat, P=P_flat,
                dense=jnp.concatenate([dense.reshape(-1),
                                       jnp.zeros((1,), dtype=dt)]),
                L=L, s=s, sv=sv,
                outer0=jnp.concatenate(
                    [outer0, jnp.ones((1, BB), dtype=dt)]))

    @_full_f32
    def _full_impl_unrolled(self, H0):
        """Round-4 unrolled redescent (kept as the parity oracle for
        tests/test_fastl.py::test_full_scan_matches_unrolled)."""
        with jax.default_matmul_precision("highest"):
            plan, B = self.plan, self.B
            sv, outer0 = self.chol._jacobi_scale(H0)
            H_parts, C_parts, W_parts, P_parts = [], [], [], []
            H = H0 * outer0
            for li, lv in enumerate(plan.levels):
                dt = H.dtype
                H_parts.append(H)
                C = H[lv.elim_diag_idx]
                if dt == jnp.float32:
                    # f32 pivot ridge (see block_cholesky._descend): bounds
                    # kappa of eliminated pivots so c_inv stays a contraction
                    dmean = jnp.mean(jnp.abs(planar.bdiag(C, B)), axis=1)
                    C = planar.badd_diag(C, 1e-5 * jnp.maximum(dmean, 1e-30),
                                         B)
                c_inv = planar.binv(C, B)
                U0 = H[lv.u_src]
                U = jnp.where(jnp.asarray(lv.u_flip)[:, None],
                              planar.btranspose(U0, B, B), U0)
                W = planar.bmm(U, c_inv[lv.u_elim], B, B, B)
                if len(lv.pa):
                    prod = planar.bmm_A_Bt(W[lv.pa], U[lv.pb], B, B, B)
                    prod = jnp.where(jnp.asarray(lv.p_flip)[:, None],
                                     planar.btranspose(prod, B, B), prod)
                else:
                    prod = jnp.zeros((0, B * B), dtype=dt)
                Hn = jnp.zeros((lv.K_next, B * B), dtype=dt)
                Hn = Hn.at[jnp.asarray(lv.carry_dst)].set(H[lv.carry_src])
                if len(lv.pa):
                    Hn = Hn - jax.ops.segment_sum(
                        prod, jnp.asarray(lv.p_dst), num_segments=lv.K_next)
                C_parts.append(c_inv)
                W_parts.append(W)
                P_parts.append(prod)
                H = Hn
            H_parts.append(H)    # bottom pattern blocks
            dense = self.chol._bottom_dense(H)
            L, s = _equilibrated_cholesky(dense)
            dt = H.dtype
            pad2 = jnp.zeros((2, B * B), dtype=dt)
            pad1 = jnp.zeros((1, B * B), dtype=dt)
            return dict(
                H=jnp.concatenate(H_parts + [pad2]),
                C=jnp.concatenate(C_parts + [pad2]),
                W=jnp.concatenate(W_parts + [pad2]),
                P=jnp.concatenate(P_parts + [pad1]),
                dense=jnp.concatenate([dense.reshape(-1),
                                       jnp.zeros((1,), dtype=dt)]),
                L=L, s=s, sv=sv,
                outer0=jnp.concatenate(
                    [outer0, jnp.ones((1, B * B), dtype=dt)]))

    def init_stores(self, H0) -> Dict:
        """H0: level-0 blocks in PLAN order, no dummy row.

        The returned stores expose 'H0' as an ALIAS of the flat H — level-0
        positions are < K0, so omega scatters land in the right segment."""
        out = dict(self._full_jit(H0))
        out["H0"] = out["H"]
        return out

    def refactor_full(self, stores) -> Dict:
        K0 = int(self.off_H[1]) if len(self.plan.levels) else self.KH
        raw = stores["H"][:K0] / stores["outer0"][:K0]
        out = dict(self._full_jit(raw))
        out["H0"] = out["H"]
        return out

    # ------------------------------------------------------------------
    # fused step: dirty refactorization + bottom + solve, one dispatch
    # ------------------------------------------------------------------

    def _dirty_scan(self, stores, omega_vals, omega_seg, buf, bot_sel,
                    bot_h):
        plan, B = self.plan, self.B
        H, C, W, P = stores["H"], stores["C"], stores["W"], stores["P"]
        dt = H.dtype

        # level-0 dirty values from the omega deltas (padded rows: dropped
        # segment cap_d sums to the sliced-off row)
        d_val = jax.ops.segment_sum(omega_vals, omega_seg,
                                    num_segments=self.cap_d + 1)[:self.cap_d]

        s = self._slots

        def col(name):
            lo, hi = s[name]
            return buf[:, lo:hi]                       # [L, cap]

        # ---- pre-gather every OLD value the scan reads (batched over all
        # levels; the big stores never enter the scan carry) --------------
        usrc = col("w_usrc")
        uflip = usrc < 0
        usrc = jnp.where(uflip, -usrc - 1, usrc)
        ub = col("p_ubsrc")
        ubflip = ub < 0
        ub = jnp.where(ubflip, -ub - 1, ub)
        ppos = col("p_pos")
        pflip = ppos < 0
        ppos = jnp.where(pflip, -ppos - 1, ppos)
        pre = dict(
            Hd_old=H[col("e_diag")], Uw_old=H[usrc], uflip=uflip,
            C_old_w=C[col("w_celim")], W_old_pa=W[col("p_wa")],
            Upb_old=H[ub], ubflip=ubflip, P_old=P[ppos], pflip=pflip,
            e_dpos=col("e_dpos"), w_dpos=col("w_dpos"),
            w_epos=col("w_epos"), p_wapos=col("p_wapos"),
            p_ub_dpos=col("p_ub_dpos"), p_seg=col("p_seg"),
            c_pos=col("c_pos"), c_seg=col("c_seg"))

        zero1 = jnp.zeros((1, B * B), dtype=dt)

        def body(d_val, x):
            d_ext = jnp.concatenate([d_val, zero1])
            Hd = x["Hd_old"] + d_ext[x["e_dpos"]]
            if dt == jnp.float32:
                dmean = jnp.mean(jnp.abs(planar.bdiag(Hd, B)), axis=1)
                Hd = planar.badd_diag(Hd, 1e-5 * jnp.maximum(dmean, 1e-30),
                                      B)
            c_new = planar.binv(Hd, B)                 # [cap_e, B*B]

            Uw = x["Uw_old"] + d_ext[x["w_dpos"]]
            Uw = jnp.where(x["uflip"][:, None],
                           planar.btranspose(Uw, B, B), Uw)
            c_ext = jnp.concatenate([c_new, zero1])
            c_eff = jnp.where((x["w_epos"] < self.cap_e)[:, None],
                              c_ext[x["w_epos"]], x["C_old_w"])
            W_new = planar.bmm(Uw, c_eff, B, B, B)     # [cap_w, B*B]

            W_ext = jnp.concatenate([W_new, zero1])
            W_eff = jnp.where((x["p_wapos"] < self.cap_w)[:, None],
                              W_ext[x["p_wapos"]], x["W_old_pa"])
            Upb = x["Upb_old"] + d_ext[x["p_ub_dpos"]]
            Upb = jnp.where(x["ubflip"][:, None],
                            planar.btranspose(Upb, B, B), Upb)
            newp = planar.bmm_A_Bt(W_eff, Upb, B, B, B)
            newp = jnp.where(x["pflip"][:, None],
                             planar.btranspose(newp, B, B), newp)
            delta = newp - x["P_old"]

            carry_vals = d_ext[x["c_pos"]]
            vals = jnp.concatenate([carry_vals, -delta])
            segs = jnp.concatenate([x["c_seg"], x["p_seg"]])
            d_next = jax.ops.segment_sum(
                vals, segs, num_segments=self.cap_d + 1)[:self.cap_d]
            return d_next, (d_val, c_new, W_new, newp)

        if len(plan.levels):
            d_val, (d_all, c_all, W_all, newp_all) = jax.lax.scan(
                body, d_val, pre)
            # ---- apply all updates to the flat stores in one batched
            # scatter per array (entries belong to exactly one level, so
            # there are no cross-level duplicates)
            BB = B * B
            H = H.at[col("d_pos").reshape(-1)].add(d_all.reshape(-1, BB))
            C = C.at[col("e_pos").reshape(-1)].set(c_all.reshape(-1, BB))
            W = W.at[col("w_pos").reshape(-1)].set(W_all.reshape(-1, BB))
            P = P.at[ppos.reshape(-1)].set(newp_all.reshape(-1, BB))

        # bottom: apply deltas to the stored blocks + dense, refactor
        H = H.at[bot_h].add(d_val)
        dense = stores["dense"]
        dense = dense.at[self._bot_idx_ext[bot_sel].reshape(-1)].add(
            d_val.reshape(-1))
        mirr = (d_val[:, self._tperm] *
                self._bot_off_ext[bot_sel][:, None].astype(dt))
        dense = dense.at[self._bot_idx_t_ext[bot_sel].reshape(-1)].add(
            mirr.reshape(-1))
        L, sc = _equilibrated_cholesky(
            dense[:-1].reshape(self.nbB, self.nbB))
        return dict(H=H, C=C, W=W, P=P, dense=dense, L=L, s=sc,
                    sv=stores["sv"], outer0=stores["outer0"])

    @_full_f32
    def _step_impl(self, stores, omega_vals, omega_seg, buf, bot_sel, bot_h,
                   eta0):
        with jax.default_matmul_precision("highest"):
            out = self._dirty_scan(stores, omega_vals, omega_seg, buf,
                                   bot_sel, bot_h)
            dx = self.solve_scan_refined(out, eta0)
            return out, dx, jnp.linalg.norm(dx)

    def step(self, stores, eta0, dirty_pos: List[np.ndarray], dirty_vals,
             host_packed=_NOT_PREPARED):
        """Fused dirty refactorization + solve; returns
        (stores', dx, norm) or None on capacity overflow (caller falls back
        to refactor_full + solve).  stores['H'] must already include the
        omega deltas at level 0 (the omega kernel scatters them).
        host_packed: optional precomputed prepare_host result (pipelining)."""
        packed = self._prepare(dirty_pos, dirty_vals, host_packed)
        if packed is None:
            return None
        omega_vals, seg, buf, bot_sel, bot_h = packed
        out, dx, norm = self._step_jit(
            {k: stores[k] for k in ("H", "C", "W", "P", "dense", "L", "s",
                                    "sv", "outer0")},
            omega_vals, seg, buf, bot_sel, bot_h, eta0)
        stores.update(out)
        stores["H0"] = out["H"]
        return stores, dx, norm

    def prepare_host(self, dirty_pos: List[np.ndarray]):
        """Host half of a step: reachability walk + index packing.  Pure
        numpy (no device work) so callers can run it for solve point k+1
        WHILE the device executes step k.  Returns (seg, buf, bot_sel,
        bot_h) or None on capacity overflow."""
        all_pos = np.concatenate(dirty_pos)
        if len(all_pos) > self.omega_cap:
            self.n_overflows += 1
            return None
        bundles, D_bot = self._host_walk(dirty_pos)
        if bundles is None:
            self.n_overflows += 1
            return None
        buf, bot_sel, bot_h = self._pack(bundles, D_bot)
        # segment map: each omega contribution -> its position in the
        # level-0 dirty list (duplicates sum); unpadded — callers pad as
        # their omega-value layout requires
        D0 = bundles[0]["D"] if self.plan.levels else D_bot
        seg = np.searchsorted(D0, all_pos)
        return (seg, buf, bot_sel, bot_h)

    # ------------------------------------------------------------------
    # batched host walks: the WHOLE replay's solve schedule is host-static
    # (it depends only on the plan + which edges are pending at each solve
    # point, never on runtime values), so all reachability walks can be
    # done in ONE vectorized numpy pass at construction instead of ~2 ms
    # of small-array numpy per solve point (the reference's analogue work
    # is Refresh_R_IncR11's per-step submatrix selection,
    # NonlinearSolver_FastL.h:2145; there is no analogue of batching it
    # because the reference's schedule is not precomputed)
    # ------------------------------------------------------------------

    _SHIFT = np.int64(1) << np.int64(42)   # (sid, val) -> combined sort key

    def prepare_host_batch(self, dirty_pos_lists):
        """Vectorized prepare_host for many solve points at once.

        dirty_pos_lists: list over solve points of dirty_pos (each a list of
        level-0 position arrays).  Returns a list of prepare_host-equivalent
        results ((seg, buf, bot_sel, bot_h) or None on overflow), bit-equal
        to calling prepare_host per point.
        """
        S = len(dirty_pos_lists)
        self.last_batch_sizes = dict(d=0, e=0, w=0, p=0, omega=0)
        self.last_batch_per_solve = {k: np.zeros(S, dtype=np.int64)
                                     for k in ("d", "e", "w", "p")}
        if S == 0:
            return []
        plan = self.plan
        L = len(plan.levels)
        SH = self._SHIFT

        all_pos_l = [np.concatenate(dp) if dp else np.zeros(0, np.int64)
                     for dp in dirty_pos_lists]
        lens = np.array([len(a) for a in all_pos_l])
        over = lens > self.omega_cap
        pos_flat = (np.concatenate(all_pos_l) if all_pos_l
                    else np.zeros(0, np.int64))
        sid_flat = np.repeat(np.arange(S), lens)

        def dedup(sid, val):
            key = np.sort(sid * SH + val, kind="stable")
            if len(key):
                keep = np.empty(len(key), dtype=bool)
                keep[0] = True
                np.not_equal(key[1:], key[:-1], out=keep[1:])
                key = key[keep]
            return key // SH, key % SH

        def starts_of(sid):
            return np.searchsorted(sid, np.arange(S + 1))

        def expand(sid, ids, start_arr, order=None):
            if not len(ids):
                return (np.zeros(0, np.int64),) * 2
            s, e = start_arr[ids], start_arr[ids + 1]
            ln = e - s
            tot = int(ln.sum())
            flat = np.repeat(s, ln) + (np.arange(tot) -
                                       np.repeat(np.cumsum(ln) - ln, ln))
            out_sid = np.repeat(sid, ln)
            return out_sid, (order[flat] if order is not None else flat)

        def locate(h_sid, h_val, h_starts, q_sid, q_val, miss):
            if not len(q_val):
                return np.zeros(0, np.int64)
            if not len(h_val):
                return np.full(len(q_val), miss, dtype=np.int64)
            hk = h_sid * SH + h_val
            qk = q_sid * SH + q_val
            pos = np.searchsorted(hk, qk)
            pc = np.minimum(pos, len(hk) - 1)
            hit = hk[pc] == qk
            return np.where(hit, pc - h_starts[q_sid], miss)

        d_sid, d_val = dedup(sid_flat, pos_flat)
        d0_sid, d0_val = d_sid, d_val
        d0_starts = starts_of(d0_sid)

        # observed per-solve maxima (for replay-sized capacity tightening):
        # both the global max and the per-solve-point max over levels, so
        # the caller can cap at a high percentile and let the rare huge
        # solve point fall back to the full redescent
        sizes = dict(d=0, e=0, w=0, p=0, omega=int(lens.max()) if S else 0)
        per_solve = {k: np.zeros(S, dtype=np.int64)
                     for k in ("d", "e", "w", "p")}

        def _upd(name, starts):
            c = starts[1:] - starts[:-1]
            if len(c):
                sizes[name] = max(sizes[name], int(c.max()))
                np.maximum(per_solve[name], c, out=per_solve[name])

        levels_flat = []        # per level: dict of flat arrays
        for li, lv in enumerate(plan.levels):
            m = self.maps[li]
            d_starts = starts_of(d_sid)
            _upd("d", d_starts)
            over |= (d_starts[1:] - d_starts[:-1]) > self.cap_d

            e_all = m["elim_of_pair"][d_val] if len(d_val) else d_val
            em = e_all >= 0
            e_sid, e_val = d_sid[em], e_all[em]
            e_starts = starts_of(e_sid)

            u_all = m["u_of_pair"][d_val] if len(d_val) else d_val
            um = u_all >= 0
            uv_sid, uv_val = d_sid[um], u_all[um]

            wf_sid, wf_val = expand(e_sid, e_val, m["u_start"])
            w_sid, w_val = dedup(np.concatenate([uv_sid, wf_sid]),
                                 np.concatenate([uv_val, wf_val]))
            w_starts = starts_of(w_sid)

            pa_sid, pa_val = expand(w_sid, w_val, m["pa_start"],
                                    m["prods_by_pa"])
            pb_sid, pb_val = expand(uv_sid, uv_val, m["pb_start"],
                                    m["prods_by_pb"])
            p_sid, p_val = dedup(np.concatenate([pa_sid, pb_sid]),
                                 np.concatenate([pa_val, pb_val]))
            p_starts = starts_of(p_sid)

            _upd("e", e_starts)
            _upd("w", w_starts)
            _upd("p", p_starts)
            over |= (e_starts[1:] - e_starts[:-1]) > self.cap_e
            over |= (w_starts[1:] - w_starts[:-1]) > self.cap_w
            over |= (p_starts[1:] - p_starts[:-1]) > self.cap_p

            cd_all = m["carry_dst_of_pair"][d_val] if len(d_val) else d_val
            cm = cd_all >= 0
            c_sid = d_sid[cm]
            c_dst = cd_all[cm]
            c_pos_local = np.flatnonzero(cm) - d_starts[d_sid[cm]]

            pd_val = (lv.p_dst[p_val] if len(p_val)
                      else np.zeros(0, np.int64))
            dn_sid, dn_val = dedup(np.concatenate([c_sid, p_sid]),
                                   np.concatenate([c_dst, pd_val]))
            dn_starts = starts_of(dn_sid)
            c_seg = locate(dn_sid, dn_val, dn_starts, c_sid, c_dst,
                           self.cap_d)
            p_seg = locate(dn_sid, dn_val, dn_starts, p_sid, pd_val,
                           self.cap_d)

            levels_flat.append(dict(
                d=(d_sid, d_val, d_starts), e=(e_sid, e_val, e_starts),
                w=(w_sid, w_val, w_starts), p=(p_sid, p_val, p_starts),
                c=(c_sid, c_pos_local, c_seg), p_seg=p_seg))
            d_sid, d_val = dn_sid, dn_val

        d_starts = starts_of(d_sid)
        _upd("d", d_starts)
        over |= (d_starts[1:] - d_starts[:-1]) > self.cap_d
        bot_flat = (d_sid, d_val, d_starts)
        self.last_batch_sizes = sizes
        self.last_batch_per_solve = per_solve

        # ---- pack into [S, L, ROW] with flat scatters -------------------
        s = self._slots
        tmpl = np.empty(self._row_len, dtype=np.int32)
        fills = dict(d_pos=self.H_sink, e_diag=self.H_dummy,
                     e_pos=self.C_sink, e_dpos=self.cap_d,
                     w_usrc=self.H_dummy, w_celim=self.C_dummy,
                     w_pos=self.W_sink, w_dpos=self.cap_d,
                     w_epos=self.cap_e, p_wa=self.W_dummy,
                     p_wapos=self.cap_w, p_ubsrc=self.H_dummy,
                     p_ub_dpos=self.cap_d, p_pos=self.P_dummy,
                     p_seg=self.cap_d, c_pos=self.cap_d, c_seg=self.cap_d)
        for name, fill in fills.items():
            lo, hi = s[name]
            tmpl[lo:hi] = fill
        buf_all = np.tile(tmpl, (S, max(L, 1), 1))

        ROW = self._row_len
        flat_view = buf_all.reshape(-1)

        def put(li, name, sid, starts, vals):
            if not len(vals):
                return
            lo, hi = s[name]
            rank = np.arange(len(sid)) - starts[sid]
            # overflowed solve points exceed the slot width — they return
            # None anyway, but their scatter must not spill into the NEXT
            # solve's buffer (observed corrupting a neighboring replay)
            keep = rank < (hi - lo)
            if not keep.all():
                sid, rank, vals = sid[keep], rank[keep],                     np.asarray(vals)[keep]
            idx = (sid * max(L, 1) + li) * ROW + lo + rank
            flat_view[idx] = vals

        for li, lv in enumerate(plan.levels):
            f = levels_flat[li]
            oh, oc, ow, op = (self.off_H[li], self.off_C[li],
                              self.off_W[li], self.off_P[li])
            d_sid_l, d_val_l, d_starts_l = f["d"]
            e_sid_l, e_val_l, e_starts_l = f["e"]
            w_sid_l, w_val_l, w_starts_l = f["w"]
            p_sid_l, p_val_l, p_starts_l = f["p"]

            if li > 0:
                put(li, "d_pos", d_sid_l, d_starts_l, oh + d_val_l)

            def dloc(q_sid, pairs):
                if li == 0:
                    return np.full(len(pairs), self.cap_d, dtype=np.int64)
                return locate(d_sid_l, d_val_l, d_starts_l, q_sid, pairs,
                              self.cap_d)

            put(li, "e_diag", e_sid_l, e_starts_l,
                oh + lv.elim_diag_idx[e_val_l])
            put(li, "e_pos", e_sid_l, e_starts_l, oc + e_val_l)
            put(li, "e_dpos", e_sid_l, e_starts_l,
                dloc(e_sid_l, lv.elim_diag_idx[e_val_l]))
            usrc = oh + lv.u_src[w_val_l]
            usrc = np.where(lv.u_flip[w_val_l], -usrc - 1, usrc)
            put(li, "w_usrc", w_sid_l, w_starts_l, usrc)
            put(li, "w_celim", w_sid_l, w_starts_l, oc + lv.u_elim[w_val_l])
            put(li, "w_pos", w_sid_l, w_starts_l, ow + w_val_l)
            put(li, "w_dpos", w_sid_l, w_starts_l,
                dloc(w_sid_l, lv.u_src[w_val_l]))
            put(li, "w_epos", w_sid_l, w_starts_l,
                locate(e_sid_l, e_val_l, e_starts_l, w_sid_l,
                       lv.u_elim[w_val_l], self.cap_e))
            put(li, "p_wa", p_sid_l, p_starts_l, ow + lv.pa[p_val_l])
            put(li, "p_wapos", p_sid_l, p_starts_l,
                locate(w_sid_l, w_val_l, w_starts_l, p_sid_l,
                       lv.pa[p_val_l], self.cap_w))
            ub = oh + lv.u_src[lv.pb[p_val_l]]
            ub = np.where(lv.u_flip[lv.pb[p_val_l]], -ub - 1, ub)
            put(li, "p_ubsrc", p_sid_l, p_starts_l, ub)
            put(li, "p_ub_dpos", p_sid_l, p_starts_l,
                dloc(p_sid_l, lv.u_src[lv.pb[p_val_l]]))
            ppos = op + p_val_l
            ppos = np.where(lv.p_flip[p_val_l], -ppos - 1, ppos)
            put(li, "p_pos", p_sid_l, p_starts_l, ppos)
            put(li, "p_seg", p_sid_l, p_starts_l, f["p_seg"])
            c_sid_l, c_pos_l, c_seg_l = f["c"]
            c_starts_l = starts_of(c_sid_l)
            put(li, "c_pos", c_sid_l, c_starts_l, c_pos_l)
            put(li, "c_seg", c_sid_l, c_starts_l, c_seg_l)

        b_sid, b_val, b_starts = bot_flat
        bot_sel_all = np.full((S, self.cap_d), self.KB, dtype=np.int32)
        bot_h_all = np.full((S, self.cap_d), self.H_sink, dtype=np.int32)
        if len(b_sid):
            rank = np.arange(len(b_sid)) - b_starts[b_sid]
            keep = rank < self.cap_d   # overflow spill guard (see put)
            bot_sel_all[b_sid[keep], rank[keep]] = b_val[keep]
            bot_h_all[b_sid[keep], rank[keep]] = \
                self.off_H_bottom + b_val[keep]

        # per-point seg into the level-0 dirty list (duplicates sum)
        seg_flat = locate(d0_sid, d0_val, d0_starts, sid_flat, pos_flat, -1)

        out = []
        off = 0
        n_over = int(np.count_nonzero(over))
        self.n_overflows += n_over
        for si in range(S):
            n = lens[si]
            if over[si]:
                out.append(None)
                off += n
                continue
            out.append((seg_flat[off:off + n], buf_all[si],
                        bot_sel_all[si], bot_h_all[si]))
            off += n
        return out

    def _prepare(self, dirty_pos, dirty_vals, host_packed=_NOT_PREPARED):
        if host_packed is IncrementalCholesky._NOT_PREPARED:
            host_packed = self.prepare_host(dirty_pos)
        if host_packed is None:
            return None
        seg, buf, bot_sel, bot_h = host_packed
        # pad segments to the STATIC omega_cap (dropped dummy segment) so
        # the standalone step kernel never recompiles
        seg_pad = np.full(self.omega_cap, self.cap_d, dtype=np.int64)
        seg_pad[:len(seg)] = seg
        omega_vals = (jnp.concatenate(dirty_vals)
                      if len(dirty_vals) > 1 else dirty_vals[0])
        npad = self.omega_cap - omega_vals.shape[0]
        if npad:
            omega_vals = jnp.concatenate(
                [omega_vals,
                 jnp.zeros((npad, self.B * self.B), dtype=omega_vals.dtype)])
        return (omega_vals, jnp.asarray(seg_pad), jnp.asarray(buf),
                jnp.asarray(bot_sel), jnp.asarray(bot_h))

    def refactor_dirty(self, stores, dirty_pos: List[np.ndarray],
                       dirty_vals) -> bool:
        """Dirty update without the fused solve (kept for callers that only
        maintain the factor); False on overflow."""
        packed = self._prepare(dirty_pos, dirty_vals)
        if packed is None:
            return False
        omega_vals, seg, buf, bot_sel, bot_h = packed
        if not hasattr(self, "_dirty_only_jit"):
            @_full_f32
            def dirty_only(stores, omega_vals, seg, buf, bot_sel, bot_h):
                with jax.default_matmul_precision("highest"):
                    return self._dirty_scan(stores, omega_vals, seg, buf,
                                            bot_sel, bot_h)
            self._dirty_only_jit = jax.jit(dirty_only, donate_argnums=(0,))
        out = self._dirty_only_jit(
            {k: stores[k] for k in ("H", "C", "W", "P", "dense", "L", "s",
                                    "sv", "outer0")},
            omega_vals, seg, buf, bot_sel, bot_h)
        stores.update(out)
        stores["H0"] = out["H"]
        return True

    # ------------------------------------------------------------------
    # scanned solve (descend + dense bottom + ascend)
    # ------------------------------------------------------------------

    def _build_solve_consts(self) -> None:
        """Stacked per-level device constants for the scanned solve,
        BUCKETED by level size: levels shrink ~0.6x each, so padding every
        level to the level-0 width wastes ~9x the work — contiguous levels
        within a <2x size range share one scan instead.  All index arrays
        pad per the dummy convention (row Nb of the bucket's eta/x carry is
        always zero)."""
        plan = self.plan
        levels = plan.levels
        L = len(levels)
        self.Nmax = int(plan.N)
        self._solve_buckets = []
        b_start = 0
        while b_start < L:
            n0 = levels[b_start].n
            b_end = b_start + 1
            while b_end < L and levels[b_end].n > 0.55 * n0:
                b_end += 1
            lvls = levels[b_start:b_end]
            Lb = len(lvls)
            Nb = int(n0)
            nE_max = max(lv.n_elim for lv in lvls)
            Ku_max = max(max(len(lv.u_src) for lv in lvls), 1)

            def stack(get, width, fill):
                out = np.full((Lb, width), fill, dtype=np.int32)
                for li, lv in enumerate(lvls):
                    a = get(b_start + li, lv)
                    out[li, :len(a)] = a
                return jnp.asarray(out)

            xs = dict(
                elim=stack(lambda gi, lv: lv.elim_orig, nE_max, Nb),
                rest_full=stack(lambda gi, lv: lv.rest_orig, Nb, Nb),
                u_w=stack(lambda gi, lv: self.off_W[gi] + np.arange(
                    len(lv.u_src)), Ku_max, self.W_dummy),
                u_elim=stack(lambda gi, lv: lv.u_elim, Ku_max, nE_max),
                u_rest=stack(lambda gi, lv: lv.u_rest_next, Ku_max, Nb),
                c_g=stack(lambda gi, lv: self.off_C[gi] +
                          np.arange(lv.n_elim), nE_max, self.C_dummy),
                elim_full=stack(lambda gi, lv: lv.elim_orig, Nb, Nb),
            )
            self._solve_buckets.append(dict(
                xs=xs, Nb=Nb, nE_max=nE_max,
                n_exit=int(lvls[-1].n_next)))
            b_start = b_end

    def _solve_scan(self, stores, eta0):
        """Solve lambda dx = eta0 with the current flat factor stores."""
        plan, B = self.plan, self.B
        C, W = stores["C"], stores["W"]
        dt = C.dtype
        eta = eta0 * stores["sv"]
        eta = jnp.concatenate([eta, jnp.zeros((1, B), dtype=dt)])

        eta_Es_l = []
        for bk in self._solve_buckets:
            Nb, nE_max, xs = bk["Nb"], bk["nE_max"], bk["xs"]
            eta = eta[:Nb + 1]     # rows >= entering size are zero

            def down(eta, x, Nb=Nb):
                eta_E = eta[x["elim"]]                       # [nE_max, B]
                eta_E_ext = jnp.concatenate(
                    [eta_E, jnp.zeros((1, B), dtype=dt)])
                corr = planar.bmv(W[x["u_w"]], eta_E_ext[x["u_elim"]], B, B)
                seg = jax.ops.segment_sum(corr, x["u_rest"],
                                          num_segments=Nb + 1)[:Nb]
                eta_next = eta[x["rest_full"]] - seg
                eta_next = jnp.concatenate(
                    [eta_next, jnp.zeros((1, B), dtype=dt)])
                return eta_next, eta_E

            eta, eta_Es = jax.lax.scan(down, eta, xs)
            eta_Es_l.append(eta_Es)

        nb = plan.n_bottom
        eta_b = eta[:nb].reshape(nb * B)
        y = jax.scipy.linalg.solve_triangular(
            stores["L"], eta_b * stores["s"], lower=True)
        xb = stores["s"] * jax.scipy.linalg.solve_triangular(
            stores["L"].T, y, lower=False)
        x = jnp.zeros((nb + 1, B), dtype=dt)
        x = x.at[:nb].set(xb.reshape(nb, B))

        for bi in range(len(self._solve_buckets) - 1, -1, -1):
            bk = self._solve_buckets[bi]
            Nb, nE_max, xs = bk["Nb"], bk["nE_max"], bk["xs"]
            # widen the carry from the deeper bucket's numbering to this one
            pad_rows = Nb + 1 - x.shape[0]
            if pad_rows > 0:
                x = jnp.concatenate(
                    [x, jnp.zeros((pad_rows, B), dtype=dt)])

            def up(x, inp, Nb=Nb, nE_max=nE_max):
                xcon, eta_E = inp
                corr = planar.bmv_At(W[xcon["u_w"]], x[xcon["u_rest"]], B, B)
                x_e = planar.bmv(C[xcon["c_g"]], eta_E, B, B) - \
                    jax.ops.segment_sum(corr, xcon["u_elim"],
                                        num_segments=nE_max + 1)[:nE_max]
                xk = jnp.zeros((Nb + 1, B), dtype=dt)
                xk = xk.at[xcon["rest_full"]].set(x[:Nb])
                xk = xk.at[xcon["elim_full"]].set(
                    jnp.concatenate(
                        [x_e, jnp.zeros((Nb - nE_max, B), dtype=dt)]))
                return xk, None

            x, _ = jax.lax.scan(up, x, (xs, eta_Es_l[bi]), reverse=True)

        return x[:self.Nmax] * stores["sv"]

    def _spmv0(self, stores, x):
        """y = lambda x via the level-0 (raw, unscaled) pattern blocks."""
        plan, B = self.plan, self.B
        K0 = int(self.off_H[1]) if len(plan.levels) else self.KH
        lam = stores["H"][:K0] / stores["outer0"][:K0]
        yv = planar.bmv(lam, x[self._cols0], B, B)
        y = jax.ops.segment_sum(yv, self._rows0, num_segments=plan.N)
        ytv = planar.bmv_At(lam, x[self._rows0], B, B) * \
            self._offdiag0[:, None].astype(x.dtype)
        return y + jax.ops.segment_sum(ytv, self._cols0,
                                       num_segments=plan.N)

    def solve_scan_refined(self, stores, eta0):
        """One Richardson refinement pass in f32: dx error drops from the
        factor's rounding level (~1e-3 relative on long replays) to the
        SpMV's (~1e-6), which keeps the REPLAY TRAJECTORY stable — the f32
        push decisions (|dx| vs threshold) stop flipping against the f64
        oracle.  Diagnosed on trees10k incr fastL (ratio 1.0947 from
        decision flips over 4342 solve points in f32);
        periodic redescents did NOT fix it because the factor was never
        the problem.  f64 paths skip the extra work."""
        dx = self._solve_scan(stores, eta0)
        if dx.dtype != jnp.float32:
            return dx
        r = eta0 - self._spmv0(stores, dx)
        return dx + self._solve_scan(stores, r)

    @_full_f32
    def _solve_only_impl(self, stores, eta0):
        with jax.default_matmul_precision("highest"):
            dx = self.solve_scan_refined(stores, eta0)
            return dx, jnp.linalg.norm(dx)

    def solve(self, stores, eta0):
        dx, _ = self.solve_with_norm(stores, eta0)
        return dx

    def solve_with_norm(self, stores, eta0):
        keys = ("C", "W", "L", "s", "sv", "H", "outer0")
        return self._solve_jit({k: stores[k] for k in keys}, eta0)

    # ------------------------------------------------------------------

    def to_factor(self, stores):
        """Slice the flat stores back into a BlockCholeskyFactor — the
        bridge from the maintained incremental state to the recurrent
        marginals recovery (BlockCholeskySolver.marginals)."""
        from slam_plus_plus_tpu.linalg.block_cholesky import (
            BlockCholeskyFactor)
        L = len(self.plan.levels)
        c_invs = tuple(stores["C"][self.off_C[i]:self.off_C[i + 1]]
                       for i in range(L))
        Ws = tuple(stores["W"][self.off_W[i]:self.off_W[i + 1]]
                   for i in range(L))
        return BlockCholeskyFactor(c_invs, Ws, stores["L"], stores["s"],
                                   stores["sv"])
