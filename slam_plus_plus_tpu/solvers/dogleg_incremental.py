"""Incremental Lambda-DL: dogleg with fluid relinearization and an
incrementally maintained Schur complement.

Reference analogue: CNonlinearSolver_Lambda_DL (reference
include/slam/NonlinearSolver_Lambda_DL.h:242-1560, 3DV 2017), whose
incremental machinery is:

  * per-vertex update threshold: PushValuesInGraphSystem applies a vertex's
    dx only when its norm reaches m_f_update_thresh (1e-5, :399,1417,1990);
    vertices that moved enter m_relin_vertex_list;
  * fluid relinearization: only lambda blocks incident to moved vertices are
    refreshed (m_relin_vertex_list, :308-318) — since unmoved vertices did
    not change state, this refresh is EXACT, not an approximation;
  * incrementally maintained Schur complement m_SchurCompl / m_minus_D_inv
    (:313-316): only the landmark columns touched by refreshed blocks are
    re-eliminated into SC;
  * dogleg trust region control identical to the batch solver.

Accelerator-first redesign (not a port): the maintained state is a set of device
arrays — planar lambda pieces (pp [Kpp], u [Kpl], ll [Nl], eta_p, eta_l),
the DENSE reduced camera system SC [Np*Bp]^2, and per-edge linearization
snapshots (the endpoint states at each edge's last refresh).  One batched
dispatch per (edge type, size bucket) refreshes all dirty edges: it
evaluates the edge kernel at BOTH the snapshot and the current states and
scatters the difference into the maintained arrays (the snapshot makes the
delta exact with no per-edge contribution cache).  Dirty landmarks are
re-eliminated by building old/new U,W panels (scatter + two GEMMs) and
adding the panel-product difference to SC.  The dense SC refactors on the
device every iteration — at reduced-camera sizes this is microseconds, so
unlike the reference we never maintain a FACTOR incrementally, only the SC
matrix (the expensive object).  Compiled programs: one refresh per
(edge type, bucket), one panel-delta per bucket, one solve, one update —
all reused across every marker of the replay.
"""

from __future__ import annotations

import dataclasses

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from slam_plus_plus_tpu.assembly.assembler import Assembler, BlockSystem
from slam_plus_plus_tpu.config import SolverConfig
from slam_plus_plus_tpu.graph.system import GraphSystem
from slam_plus_plus_tpu.models.types import EDGE_TYPES
from slam_plus_plus_tpu.ops import planar


def _buckets(n: int, base: int = 256) -> List[int]:
    """Power-of-4 size ladder: [256, 1024, 4096, ...] capped at n."""
    out = []
    b = base
    while b < n:
        out.append(b)
        b *= 4
    out.append(n)
    return out


def _pick_bucket(ladder: List[int], n: int) -> int:
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]


class IncrementalDoglegSolver:
    """Marker-driven incremental BA with fluid relinearization.

    Usage (the incremental_ba_3dv pattern):
        solver = IncrementalDoglegSolver(system)
        for marker_step in markers:
            solver.advance_to(marker_step)       # activate new edges
            chi2 = solver.optimize()             # dogleg at this marker
    or simply solver.run(markers) for the whole replay.
    """

    def __init__(self, system: GraphSystem,
                 config: Optional[SolverConfig] = None,
                 max_iterations: int = 5, dx_threshold: float = 0.01,
                 trust_radius: float = 2.0,
                 update_thresh: float = 1e-5):
        self.system = system
        self.config = config or SolverConfig()
        self.max_iterations = max_iterations
        self.dx_threshold = dx_threshold
        self.initial_delta = trust_radius
        # the trust radius is SOLVER state in the reference (m_f_delta,
        # NonlinearSolver_Lambda_DL.h:319): it persists across markers
        self.delta = trust_radius
        self.update_thresh = update_thresh
        self.asm = Assembler(system, dataclasses.replace(
            self.config, edge_layout="flat"))
        asm = self.asm
        if asm.Nl == 0 or asm.Kpl == 0:
            raise ValueError("IncrementalDoglegSolver targets Schur-split "
                             "BA problems; use DoglegSolver for pose graphs")
        self.nred = asm.Np * asm.Bp

        self._build_host_structure()
        self._build_kernels()
        self.stats: Dict[str, float] = dict(
            solves=0, iters=0, refreshed_edges=0, refreshed_lms=0,
            total_edge_slots=0)
        self._state = None   # set by _init_at

    # ------------------------------------------------------------------
    # host symbolic structure
    # ------------------------------------------------------------------

    def _build_host_structure(self) -> None:
        asm = self.asm
        system = self.system

        # replay plan: per inserted edge, which vertices activate
        seen = set()
        self.steps: List[dict] = []
        nap = nal = 0
        for (ename, li) in system._edge_insert_log:
            store = system.edge_stores[ename]
            vids = store.vertex_ids[li]
            new_vs = []
            for slot, gid in enumerate(vids):
                if gid not in seen:
                    seen.add(gid)
                    tname = system.vertex_directory[gid][0]
                    if asm.type_class[tname] == "p":
                        nap += 1
                    else:
                        nal += 1
                    new_vs.append(slot)
            self.steps.append(dict(ename=ename, li=li, new_vs=new_vs,
                                   nap=nap, nal=nal))

        # vertex -> incident (edge type, edge index) CSR per class
        p_heads: List[np.ndarray] = []
        p_edges: List[np.ndarray] = []
        l_heads: List[np.ndarray] = []
        l_edges: List[np.ndarray] = []
        self._etype_ids = {p.name: i for i, p in enumerate(asm.plans)}
        for plan in asm.plans:
            eid = (np.int64(self._etype_ids[plan.name]) << 32) + \
                np.arange(plan.E, dtype=np.int64)
            for k in range(len(plan.slot_types)):
                cs = np.asarray(plan.slot_cslot[k])
                if plan.slot_class[k] == "p":
                    p_heads.append(cs)
                    p_edges.append(eid)
                else:
                    l_heads.append(cs)
                    l_edges.append(eid)

        def csr(heads, items, n):
            if not heads:
                return (np.zeros(n + 1, dtype=np.int64),
                        np.zeros(0, dtype=np.int64))
            h = np.concatenate(heads)
            it = np.concatenate(items)
            order = np.argsort(h, kind="stable")
            start = np.concatenate(
                [[0], np.cumsum(np.bincount(h, minlength=n))])
            return start, it[order]

        self._p_inc = csr(p_heads, p_edges, asm.Np)
        self._l_inc = csr(l_heads, l_edges, asm.Nl)

        # per-landmark observation table (for the SC panel delta)
        counts = np.bincount(asm.pl_cols, minlength=asm.Nl)
        self.max_obs = int(counts.max()) if asm.Nl else 0
        order = np.argsort(asm.pl_cols, kind="stable")
        tbl = np.zeros((asm.Nl, self.max_obs), dtype=np.int64)
        tbl_rows = np.zeros((asm.Nl, self.max_obs), dtype=np.int64)
        ovalid = np.zeros((asm.Nl, self.max_obs), dtype=np.float64)
        fill = np.zeros(asm.Nl, dtype=np.int64)
        for k in order:
            c = asm.pl_cols[k]
            tbl[c, fill[c]] = k
            tbl_rows[c, fill[c]] = asm.pl_rows[k]
            ovalid[c, fill[c]] = 1.0
            fill[c] += 1
        self._obs_tbl = jnp.asarray(tbl)
        self._obs_rows = jnp.asarray(tbl_rows)
        self._obs_valid = jnp.asarray(ovalid, dtype=asm.dtype)

        # dense SC flat scatter indices for pp pairs (upper + mirror)
        self._pp_idx = planar.scatter_flat_indices(
            asm.pp_rows, asm.pp_cols, asm.Bp, asm.Bp, row_stride=self.nred)
        off = asm.pp_rows != asm.pp_cols
        self._pp_idx_t = planar.scatter_flat_indices(
            asm.pp_cols, asm.pp_rows, asm.Bp, asm.Bp, row_stride=self.nred)
        self._pp_off = off.astype(np.float64)
        self._pp_idx_dev = jnp.asarray(self._pp_idx)
        self._pp_idx_t_dev = jnp.asarray(self._pp_idx_t)
        self._pp_off_dev = jnp.asarray(self._pp_off, dtype=asm.dtype)
        self._tperm = np.array([i * asm.Bp + j for j in range(asm.Bp)
                                for i in range(asm.Bp)])

        # bucket ladders
        self._edge_ladder = {p.name: _buckets(p.E) for p in asm.plans}
        self._lm_ladder = _buckets(asm.Nl)

        # per-edge "has been added" flag (old contribution exists)
        self._edge_added = {p.name: np.zeros(p.E, dtype=bool)
                            for p in asm.plans}
        # per-vertex activation flag (unit pivot still present when False)
        self._p_active = np.zeros(asm.Np, dtype=bool)
        self._l_active = np.zeros(asm.Nl, dtype=bool)

    # ------------------------------------------------------------------
    # device kernels
    # ------------------------------------------------------------------

    def _build_kernels(self) -> None:
        asm = self.asm
        Bp, Bl = asm.Bp, asm.Bl
        nred = self.nred
        dt = asm.dtype
        swap_perm = np.array([i * Bp + j for j in range(Bp)
                              for i in range(Bp)])

        # ---- per-edge-type refresh: delta = contrib(now) - contrib(snap)
        self._refresh_fns: Dict[str, callable] = {}
        for plan in asm.plans:
            et = EDGE_TYPES[plan.name]
            kernel = asm._kernels[plan.name]

            def refresh(states, snap, edge_data, M, eidx, valid, old_mask,
                        new_mask,
                        plan=plan, et=et, kernel=kernel):
                """eidx [cap]; valid/old_mask [cap]; new_mask [cap, arity].
                M: dict of maintained arrays (donated).  Returns M."""
                data = edge_data[plan.name]
                z = data["z"][eidx]
                info = data["info"][eidx]
                g_new = tuple(states[t][data["slot_local"][k][eidx]]
                              for k, t in enumerate(et.vertex_types))
                g_old = tuple(snap[plan.name][k][eidx]
                              for k in range(et.arity))
                _c2n, _hn, gs_n, Hpp_n, Hll_n, Hpl_n = kernel(g_new, z, info)
                _c2o, _ho, gs_o, Hpp_o, Hll_o, Hpl_o = kernel(g_old, z, info)

                vmask = valid[:, None]
                omask = (valid * old_mask)[:, None]
                sc = M["sc"].reshape(-1)
                pp, u, ll = M["pp"], M["u"], M["ll"]
                eta_p, eta_l = M["eta_p"], M["eta_l"]

                p_diag_cols = np.array([i * Bp + i for i in range(Bp)])
                l_diag_cols = np.array([i * Bl + i for i in range(Bl)])
                diag_contrib = {a: ci for ci, (a, b, _s, _w)
                                in enumerate(plan.pp_contribs) if a == b}

                for ci, (a, b, seg, swp) in enumerate(plan.pp_contribs):
                    d = Hpp_n[ci] * vmask - Hpp_o[ci] * omask
                    if a in diag_contrib and diag_contrib[a] == ci:
                        # activation removes the inactive unit pivot
                        cs = data["slot_cslot"][a][eidx]
                        d = d.at[:, p_diag_cols].add(
                            -new_mask[:, a:a + 1] * asm.p_mask_dev[cs])
                    swap = jnp.asarray(swp)[eidx]
                    d = jnp.where(swap[:, None], d[:, swap_perm], d)
                    pos = data["pp_seg"][ci][eidx]
                    pp = pp.at[pos].add(d)
                    # dense SC mirror of the pp delta
                    sc = sc.at[self._pp_idx_dev[pos].reshape(-1)].add(
                        d.reshape(-1))
                    mirr = (d[:, self._tperm] *
                            self._pp_off_dev[pos][:, None])
                    sc = sc.at[self._pp_idx_t_dev[pos].reshape(-1)].add(
                        mirr.reshape(-1))

                li = 0
                for k in range(et.arity):
                    cs = data["slot_cslot"][k][eidx]
                    if plan.slot_class[k] == "p":
                        eta_p = eta_p.at[cs].add(
                            gs_n[k] * vmask - gs_o[k] * omask)
                    else:
                        eta_l = eta_l.at[cs].add(
                            gs_n[k] * vmask - gs_o[k] * omask)
                        d = Hll_n[li] * vmask - Hll_o[li] * omask
                        d = d.at[:, l_diag_cols].add(
                            -new_mask[:, k:k + 1] * asm.l_mask_dev[cs])
                        ll = ll.at[cs].add(d)
                        li += 1

                for ci, (pa, lb, _s) in enumerate(plan.pl_contribs):
                    pos = data["pl_seg"][ci][eidx]
                    u = u.at[pos].add(Hpl_n[ci] * vmask - Hpl_o[ci] * omask)

                # snapshot <- current states for the refreshed edges.
                # Padded lanes DUPLICATE a valid edge index; a .set with
                # duplicate indices is order-undefined, so route invalid
                # lanes out of bounds (dropped) instead of masking values.
                sidx = jnp.where(valid > 0, eidx, plan.E)
                snap_out = dict(snap)
                sl = list(snap[plan.name])
                for k in range(et.arity):
                    sl[k] = sl[k].at[sidx].set(g_new[k], mode="drop")
                snap_out[plan.name] = tuple(sl)
                return dict(sc=sc.reshape(nred, nred), pp=pp, u=u, ll=ll,
                            eta_p=eta_p, eta_l=eta_l), snap_out

            self._refresh_fns[plan.name] = jax.jit(
                refresh, donate_argnums=(1, 3))

        l_diag_cols = np.array([i * Bl + i for i in range(Bl)])

        # ---- dirty-landmark panel pair: U,W panels for a padded lm list
        def lm_panels(u, ll, lm_ids, lvalid, alpha):
            """[capL] dirty landmark ids -> (U_panel, W_panel)
            [nred, capL*Bl] with each landmark's obs blocks in its slice.

            alpha: relative damping added to the landmark diagonal before
            inversion — a landmark observed by a single camera so far has a
            rank-2 Hll (2x3 jacobian), so the raw inverse is singular; the
            fixed relative damping keeps every C^-1 finite (the role of the
            batch solvers' damped-retry, made unconditional and CONSTANT so
            incremental panel deltas stay consistent across steps)."""
            capL = lm_ids.shape[0]
            blocks = u[self._obs_tbl[lm_ids]]         # [capL, M, Bp*Bl]
            ov = self._obs_valid[lm_ids] * lvalid[:, None]
            blocks = blocks * ov[:, :, None]
            ll_d = ll[lm_ids].at[:, l_diag_cols].add(alpha)
            c_inv = planar.binv(ll_d, Bl)             # [capL, Bl*Bl]
            M_ = self.max_obs
            w = planar.bmm(blocks.reshape(-1, Bp * Bl),
                           jnp.repeat(c_inv, M_, axis=0),
                           Bp, Bl, Bl).reshape(capL, M_, Bp * Bl)
            rows = self._obs_rows[lm_ids]             # [capL, M]
            # flat panel indices: block (r, j-th lm) -> rows r*Bp.., cols j*Bl
            rr = (rows[..., None, None] * Bp +
                  jnp.arange(Bp)[None, None, :, None])   # [capL,M,Bp,1]
            cc = (jnp.arange(capL)[:, None, None, None] * Bl +
                  jnp.arange(Bl)[None, None, None, :])
            flat = (rr * (capL * Bl) + cc).reshape(capL, M_, Bp * Bl)
            flat = jnp.where(ov[:, :, None] > 0, flat, 0)
            up = jnp.zeros((nred * capL * Bl,), dtype=u.dtype)
            up = up.at[flat.reshape(-1)].add(
                (blocks * ov[:, :, None]).reshape(-1))
            wp = jnp.zeros((nred * capL * Bl,), dtype=u.dtype)
            wp = wp.at[flat.reshape(-1)].add((w * ov[:, :, None]).reshape(-1))
            return (up.reshape(nred, capL * Bl), wp.reshape(nred, capL * Bl))

        def sc_lm_delta(sc, up_old, wp_old, u, ll, lm_ids, lvalid, alpha):
            up_new, wp_new = lm_panels(u, ll, lm_ids, lvalid, alpha)
            return sc - (wp_new @ up_new.T - wp_old @ up_old.T)

        self._lm_panels_impl = lm_panels
        self._lm_panels_jit = jax.jit(lm_panels)
        self._sc_lm_delta_jit = jax.jit(sc_lm_delta, donate_argnums=(0,))

        # ---- solve path: rhs reduction + dense SC cholesky + backsub
        pl_rows_dev = jnp.asarray(asm.pl_rows)
        pl_cols_dev = jnp.asarray(asm.pl_cols)

        def solve(M, alpha):
            sc, u, ll = M["sc"], M["u"], M["ll"]
            eta_p, eta_l = M["eta_p"], M["eta_l"]
            ll_d = ll.at[:, l_diag_cols].add(alpha)
            c_inv = planar.binv(ll_d, Bl)
            w = planar.bmm(u, c_inv[pl_cols_dev], Bp, Bl, Bl)
            w_eta = planar.bmv(w, eta_l[pl_cols_dev], Bp, Bl)
            rhs = eta_p - jax.ops.segment_sum(w_eta, pl_rows_dev,
                                              num_segments=asm.Np)
            # relative gauge regularization: the BA gauge leaves SC with a
            # near-null direction along which the raw GN step explodes and
            # the trust region then crawls; 1e-9-relative damping caps it
            # without disturbing the well-posed directions (the batch
            # solvers' damped-retry fallback, made unconditional here so
            # the solve stays ONE compiled program)
            sc = sc + (jnp.max(jnp.diagonal(sc)) * 1e-9) * \
                jnp.eye(nred, dtype=sc.dtype)
            L = jnp.linalg.cholesky(sc)
            y = jax.scipy.linalg.solve_triangular(L, rhs.reshape(nred),
                                                  lower=True)
            dx_p = jax.scipy.linalg.solve_triangular(
                L.T, y, lower=False).reshape(asm.Np, Bp)
            ut_dx = planar.bmv_At(u, dx_p[pl_rows_dev], Bp, Bl)
            rhs_l = eta_l - jax.ops.segment_sum(ut_dx, pl_cols_dev,
                                                num_segments=asm.Nl)
            dx_l = planar.bmv(c_inv, rhs_l, Bl, Bl)
            return dx_p, dx_l

        self._solve_jit = jax.jit(solve)

        # ---- thresholded vertex update (the reference's conditional
        # PushValuesInGraphSystem, NonlinearSolver_Lambda_DL.h:1417,1990):
        # vertices below the update threshold do not move at all, which is
        # what makes the fluid refresh exact
        def masked_update(states, dx_p, dx_l, thresh):
            np_ = jnp.sqrt(jnp.sum(dx_p * dx_p, axis=1))
            nl_ = jnp.sqrt(jnp.sum(dx_l * dx_l, axis=1))
            mp = (np_ >= thresh).astype(dx_p.dtype)
            ml = (nl_ >= thresh).astype(dx_l.dtype)
            out = asm._update_impl(states, dx_p * mp[:, None],
                                   dx_l * ml[:, None])
            return out, mp, ml

        self._masked_update_jit = jax.jit(masked_update)

        # lambda . v for the dogleg alpha/gain (maintained arrays)
        from slam_plus_plus_tpu.linalg.spmv import lambda_spmv

        def spmv(M, vp, vl):
            bs = BlockSystem(M["pp"], M["u"], M["ll"], M["eta_p"],
                             M["eta_l"], jnp.zeros((), dtype=dt),
                             jnp.zeros((), dtype=dt))
            return lambda_spmv(asm, bs, vp, vl)

        self._spmv_jit = jax.jit(spmv)

    # ------------------------------------------------------------------
    # maintained-state lifecycle
    # ------------------------------------------------------------------

    def _init_at(self, step_idx: int) -> None:
        """Full assembly at replay position step_idx (first marker)."""
        asm = self.asm
        st = self.steps[step_idx]
        counts = {n: 0 for n in asm.edge_data}
        for s in self.steps[:step_idx + 1]:
            counts[s["ename"]] += 1
        self._counts = counts
        self._nap, self._nal = st["nap"], st["nal"]
        states = asm.snapshot_states(self.system)
        bs = asm.assemble_active(states, counts, st["nap"], st["nal"])

        # FIXED relative landmark damping (see lm_panels): chosen once at
        # init so incremental panel deltas stay consistent across the run
        if not hasattr(self, "_alpha_l"):
            self._alpha_l = float(bs.max_hdiag) * 1e-8

        # dense SC from the assembled system (one batched build; the full
        # landmark elimination reuses the panel kernel at capL = Nl)
        def build_sc(bs, alpha):
            sc = jnp.zeros((self.nred * self.nred,), dtype=asm.dtype)
            sc = sc.at[self._pp_idx_dev.reshape(-1)].add(
                bs.pp_blocks.reshape(-1))
            mirr = (bs.pp_blocks[:, self._tperm] *
                    self._pp_off_dev[:, None])
            sc = sc.at[self._pp_idx_t_dev.reshape(-1)].add(mirr.reshape(-1))
            sc = sc.reshape(self.nred, self.nred)
            up, wp = self._lm_panels_impl(
                bs.pl_blocks, bs.ll_blocks, jnp.arange(asm.Nl),
                jnp.ones((asm.Nl,), dtype=asm.dtype), alpha)
            return sc - wp @ up.T

        if not hasattr(self, "_build_sc_jit"):
            self._build_sc_jit = jax.jit(build_sc)
        sc = self._build_sc_jit(bs, jnp.asarray(self._alpha_l,
                                                dtype=asm.dtype))

        snap = {}
        for plan in asm.plans:
            data = asm.edge_data[plan.name]
            et = EDGE_TYPES[plan.name]
            snap[plan.name] = tuple(
                states[t][data["slot_local"][k]]
                for k, t in enumerate(et.vertex_types))
        self._snap = snap
        self._M = dict(sc=sc, pp=bs.pp_blocks, u=bs.pl_blocks,
                       ll=bs.ll_blocks, eta_p=bs.eta_p, eta_l=bs.eta_l)
        self._states = states
        self._max_hdiag = float(bs.max_hdiag)
        for s in self.steps[:step_idx + 1]:
            self._edge_added[s["ename"]][s["li"]] = True
        self._p_active[:st["nap"]] = True
        self._l_active[:st["nal"]] = True
        self._pos = step_idx

    # ------------------------------------------------------------------

    def advance_to(self, step_idx: int) -> None:
        """Activate edges (self._pos, step_idx]; refresh them as add-only
        deltas (old_mask = 0) into the maintained arrays."""
        if self._state is None:
            self._init_at(step_idx)
            self._state = "ready"
            return
        pend: Dict[str, List[int]] = {}
        for s in self.steps[self._pos + 1:step_idx + 1]:
            pend.setdefault(s["ename"], []).append(s["li"])
            self._counts[s["ename"]] += 1
        st = self.steps[step_idx]
        self._nap, self._nal = st["nap"], st["nal"]
        # landmarks touched by the new edges must be re-eliminated into SC
        # (a brand-new landmark's OLD panel is exactly zero: u = 0 and the
        # unit pivot make W U^T vanish, so the same bracket covers both)
        asm = self.asm
        lms = []
        for en, els in pend.items():
            plan = next(p for p in asm.plans if p.name == en)
            for k in range(len(plan.slot_types)):
                if plan.slot_class[k] == "l":
                    lms.append(np.asarray(plan.slot_cslot[k])[np.asarray(els)])
        lms = (np.unique(np.concatenate(lms)) if lms
               else np.zeros(0, dtype=np.int64))

        def do_refresh():
            for en, els in pend.items():
                self._dispatch_refresh(en, np.asarray(els, dtype=np.int64))

        self._bracketed_reeliminate(lms, do_refresh)
        self._pos = step_idx

    def _bracketed_reeliminate(self, lms: np.ndarray, do_refresh) -> None:
        """Snapshot the dirty landmarks' SC panels, run the refresh (which
        mutates u/ll/pp/sc), then apply the panel-product difference to SC
        — the incrementally maintained Schur complement update (reference
        m_SchurCompl, NonlinearSolver_Lambda_DL.h:313-316)."""
        asm = self.asm
        self.stats["refreshed_lms"] += len(lms)
        old_panels = []
        for lo in range(0, len(lms), self._lm_ladder[-1]):
            chunk = lms[lo:lo + self._lm_ladder[-1]]
            cap = _pick_bucket(self._lm_ladder, len(chunk))
            npad = cap - len(chunk)
            lvalid = np.ones(cap)
            if npad:
                chunk = np.concatenate(
                    [chunk, np.full(npad, chunk[0], dtype=np.int64)])
                lvalid[cap - npad:] = 0.0
            up, wp = self._lm_panels_jit(
                self._M["u"], self._M["ll"], jnp.asarray(chunk),
                jnp.asarray(lvalid, dtype=asm.dtype),
                jnp.asarray(self._alpha_l, dtype=asm.dtype))
            old_panels.append((chunk, lvalid, up, wp))

        do_refresh()

        for (chunk, lvalid, up, wp) in old_panels:
            self._M["sc"] = self._sc_lm_delta_jit(
                self._M["sc"], up, wp, self._M["u"], self._M["ll"],
                jnp.asarray(chunk), jnp.asarray(lvalid, dtype=asm.dtype),
                jnp.asarray(self._alpha_l, dtype=asm.dtype))

    def _dispatch_refresh(self, ename: str, els: np.ndarray) -> None:
        """Refresh the given edges of one type (bucketed padded batches)."""
        asm = self.asm
        plan = next(p for p in asm.plans if p.name == ename)
        et = EDGE_TYPES[ename]
        added = self._edge_added[ename]
        ladder = self._edge_ladder[ename]
        self.stats["refreshed_edges"] += len(els)
        for lo in range(0, len(els), ladder[-1]):
            chunk = els[lo:lo + ladder[-1]]
            cap = _pick_bucket(ladder, len(chunk))
            npad = cap - len(chunk)
            valid = np.ones(cap)
            if npad:
                chunk = np.concatenate(
                    [chunk, np.full(npad, chunk[0], dtype=np.int64)])
                valid[cap - npad:] = 0.0
            old_mask = added[chunk].astype(np.float64)
            # activation: vertex becomes active the first time an added
            # edge touches it
            new_mask = np.zeros((cap, et.arity))
            for k in range(et.arity):
                cs = np.asarray(plan.slot_cslot[k])[chunk]
                act = self._p_active if plan.slot_class[k] == "p" \
                    else self._l_active
                fresh = ~act[cs] & (valid > 0)
                # dedupe: only the FIRST occurrence of a vertex in this
                # batch removes its pivot
                seen_local = set()
                for j in np.flatnonzero(fresh):
                    if cs[j] not in seen_local:
                        seen_local.add(cs[j])
                        new_mask[j, k] = 1.0
                act[cs[fresh]] = True
            self._M, self._snap = self._refresh_fns[ename](
                self._states, self._snap, asm.edge_data, self._M,
                jnp.asarray(chunk), jnp.asarray(valid, dtype=asm.dtype),
                jnp.asarray(old_mask, dtype=asm.dtype),
                jnp.asarray(new_mask, dtype=asm.dtype))
            added[chunk] = True

    def _refresh_dirty(self, mp: np.ndarray, ml: np.ndarray) -> None:
        """Fluid relinearization: refresh edges incident to moved vertices
        and re-eliminate the landmarks they touch."""
        asm = self.asm
        p_start, p_items = self._p_inc
        l_start, l_items = self._l_inc
        segs = []
        for v in np.flatnonzero(mp):
            segs.append(p_items[p_start[v]:p_start[v + 1]])
        for v in np.flatnonzero(ml):
            segs.append(l_items[l_start[v]:l_start[v + 1]])
        if not segs:
            return
        dirty = np.unique(np.concatenate(segs))
        # keep only already-added edges (pending ones are refreshed by
        # advance_to)
        etid = (dirty >> 32).astype(np.int64)
        eli = (dirty & 0xFFFFFFFF).astype(np.int64)

        # dirty landmarks: l-endpoints of dirty edges + moved landmarks
        dirty_lms = [np.flatnonzero(ml)]
        for ti, plan in enumerate(asm.plans):
            sel = eli[etid == ti]
            sel = sel[self._edge_added[plan.name][sel]]
            if not len(sel):
                continue
            for k in range(len(plan.slot_types)):
                if plan.slot_class[k] == "l":
                    dirty_lms.append(np.asarray(plan.slot_cslot[k])[sel])

        lms = np.unique(np.concatenate(dirty_lms)) if dirty_lms else \
            np.zeros(0, dtype=np.int64)
        lms = lms[self._l_active[lms]]

        def do_refresh():
            for ti, plan in enumerate(asm.plans):
                sel = eli[etid == ti]
                sel = sel[self._edge_added[plan.name][sel]]
                if len(sel):
                    self._dispatch_refresh(plan.name, sel)

        self._bracketed_reeliminate(lms, do_refresh)

    # ------------------------------------------------------------------
    # dogleg optimization at the current replay position
    # ------------------------------------------------------------------

    def _chi2(self, states) -> float:
        return float(self.asm.chi2_active(states, self._counts))

    def optimize(self, max_iterations: Optional[int] = None,
                 dx_threshold: Optional[float] = None,
                 verbose: bool = False) -> Tuple[float, int]:
        asm = self.asm
        max_iterations = max_iterations or self.max_iterations
        dx_threshold = dx_threshold or self.dx_threshold
        delta = self.delta
        M = self._M
        states = self._states
        last_error = self._chi2(states)
        n_iters = 0
        it = 0
        while it < max_iterations:
            it += 1
            n_iters += 1
            eta_p, eta_l = M["eta_p"], M["eta_l"]
            gn_p, gn_l = self._solve_jit(
                M, jnp.asarray(self._alpha_l, dtype=asm.dtype))
            gn_ok = bool(np.isfinite(float(jnp.sum(gn_p) + jnp.sum(gn_l))))
            gn_norm = (float(jnp.sqrt(jnp.sum(gn_p ** 2) +
                                      jnp.sum(gn_l ** 2)))
                       if gn_ok else np.inf)
            if gn_ok and gn_norm <= dx_threshold:
                break

            eta_norm = float(jnp.sqrt(jnp.sum(eta_p ** 2) +
                                      jnp.sum(eta_l ** 2)))
            if eta_norm < 1e-14:
                break
            le_p, le_l = self._spmv_jit(M, eta_p, eta_l)
            denom = float(jnp.sum(eta_p * le_p) + jnp.sum(eta_l * le_l))
            alpha = eta_norm ** 2 / denom if denom > 0 else 0.0

            if gn_ok and gn_norm <= delta:
                dl_p, dl_l = gn_p, gn_l
            elif (not gn_ok) or alpha * eta_norm >= delta:
                scale = delta / eta_norm
                if not gn_ok:
                    scale = min(alpha, scale)
                dl_p, dl_l = eta_p * scale, eta_l * scale
            else:
                a_p, a_l = eta_p * alpha, eta_l * alpha
                b_p, b_l = gn_p - a_p, gn_l - a_l
                bb = float(jnp.sum(b_p ** 2) + jnp.sum(b_l ** 2))
                c = float(jnp.sum(a_p * b_p) + jnp.sum(a_l * b_l))
                a2 = (alpha * eta_norm) ** 2
                disc = np.sqrt(c * c + bb * (delta * delta - a2))
                beta = ((-c + disc) / bb if c <= 0
                        else (delta * delta - a2) / (c + disc))
                dl_p = a_p + beta * b_p
                dl_l = a_l + beta * b_l

            trial, mp, ml = self._masked_update_jit(
                states, dl_p, dl_l,
                jnp.asarray(self.update_thresh, dtype=asm.dtype))
            error = self._chi2(trial)
            ld_p, ld_l = self._spmv_jit(M, dl_p, dl_l)
            pred = float(jnp.sum(dl_p * (2.0 * eta_p - ld_p)) +
                         jnp.sum(dl_l * (2.0 * eta_l - ld_l)))
            gain = (last_error - error) / pred if pred != 0 else -1.0
            if verbose:
                print(f"  dl it {it - 1}: chi2 {error:.3f} delta={delta:.3g} "
                      f"gain={gain:.3f} moved="
                      f"{int(np.sum(np.asarray(mp)) + np.sum(np.asarray(ml)))}")

            prev_delta = delta
            delta = delta / max(1.0 / 3.0, 1.0 - (2.0 * gain - 1.0) ** 3)
            if gain > 0:
                states = trial
                self._states = states
                last_error = error
                # fluid relinearization of exactly the moved vertices
                self._refresh_dirty(np.asarray(mp) > 0, np.asarray(ml) > 0)
                M = self._M
            if delta < dx_threshold:
                break

        self.delta = delta
        self.stats["solves"] += 1
        self.stats["iters"] += n_iters
        return last_error, n_iters

    # ------------------------------------------------------------------

    def run(self, marker_steps: List[int], verbose: bool = False):
        """Replay: optimize at each marker (0-based step indices)."""
        t0 = time.perf_counter()
        trace = []
        for ms in marker_steps:
            self.advance_to(ms)
            chi2, _ = self.optimize(verbose=verbose)
            trace.append(chi2)
            if verbose:
                print(f"marker @{ms + 1}: chi2 {chi2:.3f}")
        self.asm.writeback_states(self.system, self._states)
        self.elapsed = time.perf_counter() - t0
        return trace[-1] if trace else None, trace

    # ------------------------------------------------------------------
    # Schur-domain marginals from the MAINTAINED system (no refactor)
    # ------------------------------------------------------------------

    def marginals(self, alpha: Optional[float] = None):
        """(camera block-diag [Np, Bp*Bp], landmark block-diag [Nl, Bl*Bl])
        computed from the maintained SC/u/ll — the reference's incremental
        BA marginals hook (BAMarginals.h:388 driven from the DL loop).

        alpha: gauge damping added to the lambda diagonal (pp AND ll),
        matching the batch Marginals' damp_system semantics exactly; the
        maintained (undamped) SC is corrected in-flight:
            SC_d = SC + alpha I + (W - W_d) U^T
        with W_d the coupling products under the damped C."""
        asm = self.asm
        if alpha is None:
            alpha = self._max_hdiag * 1e-10
        if not hasattr(self, "_marg_jit"):
            Bp, Bl = asm.Bp, asm.Bl

            def marg(M, alpha, alpha_eng):
                sc, u, ll = M["sc"], M["u"], M["ll"]
                l_diag_cols = np.array([i * Bl + i for i in range(Bl)])
                ll_d = ll.at[:, l_diag_cols].add(alpha)
                ones = jnp.ones((asm.Nl,), dtype=sc.dtype)
                ids = jnp.arange(asm.Nl)
                # wp is the engine-consistent panel (what the maintained SC
                # holds); wp_d the marginals-damped one — the difference
                # converts the maintained SC to the marginals damping
                up, wp = self._lm_panels_impl(u, ll, ids, ones, alpha_eng)
                _up2, wp_d = self._lm_panels_impl(u, ll, ids, ones, alpha)
                sc_d = (sc + alpha * jnp.eye(self.nred, dtype=sc.dtype) +
                        (wp - wp_d) @ up.T)
                L = jnp.linalg.cholesky(sc_d)
                inv_l = jax.scipy.linalg.solve_triangular(
                    L, jnp.eye(self.nred, dtype=sc.dtype), lower=True)
                sigma_pp = inv_l.T @ inv_l
                s4 = sigma_pp.reshape(asm.Np, Bp, asm.Np, Bp)
                cids = jnp.arange(asm.Np)
                p_diag = s4[cids, :, cids, :].reshape(asm.Np, Bp * Bp)
                # Sigma_l = C_d^-1 + W_d^T Sigma_pp W_d (the batch BA
                # marginals panel recurrence, covariance.py)
                P = sigma_pp @ wp_d                     # [nred, Nl*Bl]
                wr = wp_d.reshape(self.nred, asm.Nl, Bl)
                pr = P.reshape(self.nred, asm.Nl, Bl)
                corr = jnp.einsum("rli,rlj->lij", wr, pr)
                c_inv = planar.binv(ll_d, Bl)
                l_diag = c_inv + corr.reshape(asm.Nl, Bl * Bl)
                return p_diag, l_diag

            self._marg_jit = jax.jit(marg)
        return self._marg_jit(self._M, jnp.asarray(alpha, dtype=asm.dtype),
                              jnp.asarray(self._alpha_l, dtype=asm.dtype))
