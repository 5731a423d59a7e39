"""Batched lambda/eta assembly — the accelerator replacement for the
reference's reduction plans.

Reference analogue: CLambdaOps::{Extend_Lambda, Refresh_Lambda,
Collect_RightHandSide_Vector} with CMatrixReductionPlan / CVectorReductionPlan
(reference include/slam/NonlinearSolver_Lambda_Base.h:113,524 and
NonlinearSolver_Lambda.h:66-67,516-560).  Where the reference scatters
per-edge Hessian contributions to scratch pages and reduces them with OpenMP,
we compute *all* per-edge blocks batched on device (vmap of the residual +
``jacfwd`` through each vertex's ⊞ retraction) and reduce with
``jax.ops.segment_sum`` over host-precomputed segment ids — deterministic and
batched.

Two-class block layout (the "guided ordering", reference
CSchurOrdering::n_Calculate_GuidedOrdering, include/slam/LinearSolver_Schur.h:292):
vertex types are split into a *primary* class (poses/cameras, padded block
size Bp) and an *eliminated* class (landmarks, padded Bl).  Lambda is stored
partitioned:

    [ H_pp  H_pl ]     H_pp : block-sparse [Kpp, Bp, Bp], upper pairs
    [  .    H_ll ]     H_pl : block-sparse [Kpl, Bp, Bl]
                       H_ll : block-diagonal [Nl, Bl, Bl]

Mixed tangent dims inside a class are padded to the class block size; padded
diagonal entries get a unit pivot so factorizations stay SPD, and padded dx
components are exactly zero.  This is the accelerator answer to the
reference's FBS typelist specialization: one batched kernel per edge *type*, uniform shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from slam_plus_plus_tpu.config import (SolverConfig, apply_matmul_precision,
                                       device_policy)
from slam_plus_plus_tpu.graph.system import GraphSystem
from slam_plus_plus_tpu.models.types import EDGE_TYPES, VERTEX_TYPES



class BlockSystem(NamedTuple):
    """Partitioned block lambda + rhs + chi2 (device pytree).

    Block collections are PLANAR — [K, Br*Bc] with the flattened block on the
    minor axis — so every op on them is a fused elementwise chain over
    [K]-column vectors.  See ops/planar.py.
    """

    pp_blocks: jnp.ndarray  # [Kpp, Bp*Bp] upper pairs, planar
    pl_blocks: jnp.ndarray  # [Kpl, Bp*Bl] planar (Kpl may be 0)
    ll_blocks: jnp.ndarray  # [Nl, Bl*Bl] block diagonal, planar
    eta_p: jnp.ndarray      # [Np, Bp]
    eta_l: jnp.ndarray      # [Nl, Bl]
    chi2: jnp.ndarray       # scalar
    # max diagonal entry over per-edge vertex Hessian blocks; the reference's
    # LM initial-damping source f_Max_VertexHessianDiagValue
    # (reference include/slam/NonlinearSolver_Lambda_LM.h:151-198)
    max_hdiag: jnp.ndarray  # scalar


@dataclasses.dataclass
class _EdgePlan:
    name: str
    E: int
    slot_types: Tuple[str, ...]
    slot_local: List[np.ndarray]      # [arity] x [E] local index into type store
    slot_cslot: List[np.ndarray]      # [arity] x [E] class-slot index
    slot_class: Tuple[str, ...]       # 'p' | 'l'
    # pp contributions: list of (slot_a, slot_b, seg_ids[E], swap[E])
    pp_contribs: List[Tuple[int, int, np.ndarray, np.ndarray]]
    # pl contributions: list of (p_slot, l_slot, seg_ids[E])
    pl_contribs: List[Tuple[int, int, np.ndarray]]
    robust: bool


class Assembler:
    """Per-graph-structure assembly pipeline.

    Build once per graph structure (vertex/edge sets); call :meth:`assemble`
    with updated states each iteration.  The jitted numeric phase is cached on
    the instance — re-linearization costs one device launch, no retracing.
    """

    def __init__(self, system: GraphSystem, config: Optional[SolverConfig] = None,
                 dtype=None):
        self.config = config or SolverConfig()
        self.dtype = dtype if dtype is not None else self.config.resolved_dtype()
        apply_matmul_precision()
        self._build_structure(system)
        self._build_device_plan(system)
        self._assemble_jit = jax.jit(self._assemble_impl)
        self._chi2_jit = jax.jit(self._chi2_impl)
        self._update_jit = jax.jit(self._update_impl)

    # ------------------------------------------------------------------
    # host symbolic phase
    # ------------------------------------------------------------------

    def _build_structure(self, system: GraphSystem) -> None:
        self.type_names = sorted(system.vertex_stores.keys())
        self.type_class: Dict[str, str] = {}
        any_landmark = any(
            VERTEX_TYPES[t].schur_class == "landmark" for t in self.type_names)
        if any_landmark and self.config.schur_split == "off":
            any_landmark = False  # single mixed class: MIS interleaves
        elif any_landmark and self.config.schur_split == "auto":
            # split only when the reduced system stays dense-solvable;
            # otherwise the mixed MIS elimination (landmarks are ideal
            # low-degree candidates) avoids the all-landmarks-first fill
            pose_dims = sum(
                VERTEX_TYPES[t].tangent_dim * system.vertex_stores[t].n
                for t in self.type_names
                if VERTEX_TYPES[t].schur_class != "landmark")
            if pose_dims > 20000:
                any_landmark = False
        for t in self.type_names:
            vt = VERTEX_TYPES[t]
            self.type_class[t] = "l" if (any_landmark and vt.schur_class == "landmark") else "p"

        # class slots in global insertion order (matches the reference's
        # block ordering within each class)
        self.type_cslot: Dict[str, np.ndarray] = {
            t: np.full(system.vertex_stores[t].n, -1, dtype=np.int64)
            for t in self.type_names}
        p_order: List[Tuple[str, int]] = []
        l_order: List[Tuple[str, int]] = []
        for g in system.vertex_order:
            tname, li = system.vertex_directory[g]
            order = p_order if self.type_class[tname] == "p" else l_order
            self.type_cslot[tname][li] = len(order)
            order.append((tname, li))
        self.p_order, self.l_order = p_order, l_order
        self.Np, self.Nl = len(p_order), len(l_order)

        p_dims = [VERTEX_TYPES[t].tangent_dim for t in self.type_names
                  if self.type_class[t] == "p"]
        l_dims = [VERTEX_TYPES[t].tangent_dim for t in self.type_names
                  if self.type_class[t] == "l"]
        self.Bp = max(p_dims) if p_dims else 1
        self.Bl = max(l_dims) if l_dims else 1

        self.p_mask = np.zeros((max(self.Np, 1), self.Bp))
        for s, (t, _) in enumerate(p_order):
            self.p_mask[s, :VERTEX_TYPES[t].tangent_dim] = 1.0
        self.l_mask = np.zeros((max(self.Nl, 1), self.Bl))
        for s, (t, _) in enumerate(l_order):
            self.l_mask[s, :VERTEX_TYPES[t].tangent_dim] = 1.0

        # ---- per-edge-type plans + global pp/pl pattern -----------------
        pp_keys: List[Tuple[int, int]] = []
        pl_keys: List[Tuple[int, int]] = []
        raw_plans = []
        for ename in sorted(system.edge_stores.keys()):
            store = system.edge_stores[ename]
            et = store.etype
            E = store.n
            vids = store.vertex_ids[:E]
            slot_local, slot_cslot, slot_class = [], [], []
            for k in range(et.arity):
                tname = et.vertex_types[k]
                locs = np.array([system.vertex_directory[v][1] for v in vids[:, k]],
                                dtype=np.int64)
                slot_local.append(locs)
                slot_cslot.append(self.type_cslot[tname][locs])
                slot_class.append(self.type_class[tname])
            raw_plans.append([ename, et, E, slot_local, slot_cslot, tuple(slot_class)])

        # ---- uniform per-landmark edge layout (BA fast path) -----------
        #
        # Sort + pad each landmark-observing plan's edges into [Nl, M] groups
        # (dummy edges carry zero information) so that every landmark-side
        # reduction and the Schur panel build become pure reshapes instead
        # of gathers/scatters of O(E) rows.  The analogue of the
        # reference's cache-blocked matrix reduction plans
        # (CMatrixReductionPlan, include/slam/NonlinearSolver_Lambda_Base.h).
        self.pl_uniform = None
        self._pad_maps: Dict[str, np.ndarray] = {}
        lay = getattr(self.config, "edge_layout", "auto")
        l_plan_ids = [i for i, rp in enumerate(raw_plans)
                      if any(c == "l" for c in rp[5])]
        ok_shape = all(sum(1 for c in raw_plans[i][5] if c == "l") == 1
                       for i in l_plan_ids)
        if lay in ("auto", "uniform") and l_plan_ids and ok_shape and self.Nl:
            total_old = sum(rp[2] for rp in raw_plans)
            Ms = {}
            for i in l_plan_ids:
                lslot = raw_plans[i][5].index("l")
                counts = np.bincount(raw_plans[i][4][lslot],
                                     minlength=self.Nl)
                Ms[i] = int(counts.max())
            total_new = (sum(rp[2] for i, rp in enumerate(raw_plans)
                             if i not in l_plan_ids) +
                         sum(self.Nl * Ms[i] for i in l_plan_ids))
            if lay == "uniform" or total_new <= 1.5 * total_old + 8192:
                self.pl_uniform = []
                for i in l_plan_ids:
                    ename, et, E, slot_local, slot_cslot, slot_class = \
                        raw_plans[i]
                    lslot = slot_class.index("l")
                    M = max(Ms[i], 1)
                    lc = slot_cslot[lslot]
                    counts = np.bincount(lc, minlength=self.Nl)
                    if not hasattr(self, "_uniform_counts"):
                        self._uniform_counts = {}
                    self._uniform_counts[ename] = counts
                    starts = np.concatenate([[0], np.cumsum(counts)])
                    order = np.argsort(lc, kind="stable")
                    ranks = np.arange(E) - starts[lc[order]]
                    pad_idx = np.full(self.Nl * M, E, dtype=np.int64)
                    pad_idx[lc[order] * M + ranks] = order
                    self._pad_maps[ename] = pad_idx
                    raw_plans[i][2] = self.Nl * M
                    raw_plans[i][3] = [
                        np.concatenate([a, a[:1]])[pad_idx]
                        for a in slot_local]
                    raw_plans[i][4] = [
                        np.concatenate([a, a[:1]])[pad_idx]
                        for a in slot_cslot]
                    # positional landmark ids override the dummies' cslots so
                    # the [Nl, M] reshape semantics hold for every slot
                    raw_plans[i][4][lslot] = np.repeat(
                        np.arange(self.Nl, dtype=np.int64), M)

        # global key collection (order defines contribution concatenation)
        pp_contrib_keys: List[np.ndarray] = []
        pl_contrib_keys: List[np.ndarray] = []
        pl_contrib_enames: List[str] = []
        plan_meta = []
        for ename, et, E, slot_local, slot_cslot, slot_class in raw_plans:
            pp_list, pl_list = [], []
            for a in range(et.arity):
                for b in range(a, et.arity):
                    ca, cb = slot_class[a], slot_class[b]
                    ia, ib = slot_cslot[a], slot_cslot[b]
                    if ca == "p" and cb == "p":
                        swap = ia > ib
                        keys = np.where(swap, ib * self.Np + ia, ia * self.Np + ib)
                        pp_list.append((a, b, keys, swap))
                        pp_contrib_keys.append(keys)
                    elif ca == "l" and cb == "l":
                        if a != b:
                            raise NotImplementedError(
                                f"edge {ename}: landmark-landmark coupling unsupported")
                        pl_list.append(None)  # placeholder, ll handled separately
                    else:
                        # orient primary x landmark
                        if ca == "p":
                            keys = ia * max(self.Nl, 1) + ib
                            pl_list.append((a, b, keys))
                        else:
                            keys = ib * max(self.Nl, 1) + ia
                            pl_list.append((b, a, keys))
                        pl_contrib_keys.append(pl_list[-1][2])
                        pl_contrib_enames.append(ename)
            plan_meta.append((ename, et, E, slot_local, slot_cslot, slot_class,
                              pp_list, pl_list))

        all_pp = (np.concatenate(pp_contrib_keys) if pp_contrib_keys
                  else np.zeros(0, dtype=np.int64))
        uniq_pp, inv_pp = np.unique(all_pp, return_inverse=True)
        self.pp_rows = (uniq_pp // self.Np).astype(np.int64)
        self.pp_cols = (uniq_pp % self.Np).astype(np.int64)
        self.Kpp = len(uniq_pp)

        if self.pl_uniform is not None:
            # uniform layout: padded slots ARE the pl blocks, in contribution
            # order — no dedup, identity "reduction", zero blocks for dummies
            rows_l, cols_l, off = [], [], 0
            for ci, keys in enumerate(pl_contrib_keys):
                n = len(keys)
                rows_l.append((keys // max(self.Nl, 1)).astype(np.int64))
                cols_l.append((keys % max(self.Nl, 1)).astype(np.int64))
                M = n // self.Nl
                self.pl_uniform.append(
                    dict(offset=off, M=M, rows=rows_l[-1],
                         counts=self._uniform_counts[
                             pl_contrib_enames[ci]]))
                off += n
            self.pl_rows = (np.concatenate(rows_l) if rows_l
                            else np.zeros(0, dtype=np.int64))
            self.pl_cols = (np.concatenate(cols_l) if cols_l
                            else np.zeros(0, dtype=np.int64))
            self.Kpl = off
            inv_pl = np.arange(max(off, 1), dtype=np.int64)
        else:
            all_pl = (np.concatenate(pl_contrib_keys) if pl_contrib_keys
                      else np.zeros(0, dtype=np.int64))
            uniq_pl, inv_pl = np.unique(all_pl, return_inverse=True)
            self.pl_rows = (uniq_pl // max(self.Nl, 1)).astype(np.int64)
            self.pl_cols = (uniq_pl % max(self.Nl, 1)).astype(np.int64)
            self.Kpl = len(uniq_pl)

        # diagonal (p,p) pair ids — every primary vertex has a diagonal block
        # (edge contributions or the pad/anchor fix ensure presence); map via
        # searchsorted into the unique key list
        diag_keys = np.arange(self.Np, dtype=np.int64) * self.Np + np.arange(self.Np)
        pos = np.searchsorted(uniq_pp, diag_keys)
        ok = (pos < len(uniq_pp)) & (uniq_pp[np.minimum(pos, len(uniq_pp) - 1)] == diag_keys)
        if not ok.all() and self.Np:
            # vertices with no primary-primary contribution (e.g. cameras in
            # pure BA get diagonal from P2C camera-slot pair) — extend pattern
            missing = diag_keys[~ok]
            uniq_pp = np.sort(np.concatenate([uniq_pp, missing]))
            inv_pp = np.searchsorted(uniq_pp, all_pp)
            self.pp_rows = (uniq_pp // self.Np).astype(np.int64)
            self.pp_cols = (uniq_pp % self.Np).astype(np.int64)
            self.Kpp = len(uniq_pp)
            pos = np.searchsorted(uniq_pp, diag_keys)
        self.pp_diag_ids = pos.astype(np.int64)

        # distribute inverse-mapped segment ids back to plans
        self.plans: List[_EdgePlan] = []
        off_pp = off_pl = 0
        for ename, et, E, slot_local, slot_cslot, slot_class, pp_list, pl_list in plan_meta:
            pp_contribs = []
            for (a, b, keys, swap) in pp_list:
                seg = inv_pp[off_pp:off_pp + E]
                off_pp += E
                pp_contribs.append((a, b, seg.astype(np.int64), swap))
            pl_contribs = []
            for item in pl_list:
                if item is None:
                    continue
                (pa, lb, keys) = item
                seg = inv_pl[off_pl:off_pl + E]
                off_pl += E
                pl_contribs.append((pa, lb, seg.astype(np.int64)))
            robust = bool(et.robust)
            self.plans.append(_EdgePlan(ename, E, et.vertex_types, slot_local,
                                        slot_cslot, tuple(slot_class),
                                        pp_contribs, pl_contribs, robust))

        # unary gauge anchor: identity on the first vertex of the first edge
        # (reference CBasicUnaryFactorFactory, include/slam/FlatSystem.h:432-470)
        self.anchor_cslot = None
        if system._edge_insert_log:
            first_et, first_li = system._edge_insert_log[0]
            first_vid = int(system.edge_stores[first_et].vertex_ids[first_li][0])
            tname, li = system.vertex_directory[first_vid]
            if self.type_class[tname] == "p":
                self.anchor_cslot = int(self.type_cslot[tname][li])

    # ------------------------------------------------------------------
    # device plan
    # ------------------------------------------------------------------

    def _build_device_plan(self, system: GraphSystem) -> None:
        dt = self.dtype
        # pure-array pytree (static slot indices stay in self.plans) so the
        # numeric phase can take it as a jit/shard_map argument
        self.edge_data = {}
        for plan in self.plans:
            store = system.edge_stores[plan.name]
            z_np = np.asarray(store.measurements[:store.n], dtype=np.float64)
            info_np = np.asarray(store.informations[:store.n],
                                 dtype=np.float64)
            pad_idx = self._pad_maps.get(plan.name)
            if pad_idx is not None:
                # dummy edges: zero information (contribute exactly nothing)
                z_np = np.concatenate([z_np, np.zeros_like(z_np[:1])])[pad_idx]
                info_np = np.concatenate(
                    [info_np, np.zeros_like(info_np[:1])])[pad_idx]
            self.edge_data[plan.name] = dict(
                z=jnp.asarray(z_np, dtype=dt),
                info=jnp.asarray(info_np, dtype=dt),
                slot_local=tuple(jnp.asarray(x) for x in plan.slot_local),
                slot_cslot=tuple(jnp.asarray(x) for x in plan.slot_cslot),
                pp_seg=tuple(jnp.asarray(s) for (a, b, s, w) in plan.pp_contribs),
                pp_swap=tuple(jnp.asarray(w) for (a, b, s, w) in plan.pp_contribs),
                pl_seg=tuple(jnp.asarray(s) for (a, b, s) in plan.pl_contribs),
            )
        # positional landmark -> type-local row maps for the uniform-layout
        # broadcast gather (see _edge_sums)
        self._l_local_maps = {}
        if self.pl_uniform is not None:
            for plan in self.plans:
                if self._pad_maps.get(plan.name) is None:
                    continue
                lslot = plan.slot_class.index("l")
                tname = plan.slot_types[lslot]
                lmap = np.zeros(max(self.Nl, 1), dtype=np.int64)
                for c, (tn, li) in enumerate(self.l_order):
                    if tn == tname:
                        lmap[c] = li
                self._l_local_maps[plan.name] = jnp.asarray(lmap)

        self.p_mask_dev = jnp.asarray(self.p_mask, dtype=dt)
        self.l_mask_dev = jnp.asarray(self.l_mask, dtype=dt)
        self.pp_diag_ids_dev = jnp.asarray(self.pp_diag_ids)

        # per-type update metadata: class + cslot array
        self.state_meta = {
            t: (self.type_class[t], jnp.asarray(self.type_cslot[t]))
            for t in self.type_names}

        # batched residual+jacobian kernels per edge type
        self._kernels: Dict[str, Callable] = {}
        for plan in self.plans:
            self._kernels[plan.name] = self._make_kernel(plan)

        # fused Pallas kernel for the hot edge type (P2C — the BA
        # flagship); auto-enabled on the GPU in f32.  It compiles only for
        # the GPU: "on" elsewhere fails at the first assembly.
        self._pallas_plans = ()
        use_pallas = self.config.use_pallas
        pallas_ok = (use_pallas == "on" or
                     (use_pallas == "auto" and
                      device_policy().platform == "gpu" and
                      self.dtype == jnp.float32))
        if pallas_ok:
            self._pallas_plans = tuple(
                p.name for p in self.plans
                if p.name == "edge_p2c" and self.Bp == 6 and self.Bl == 3)

        # permutation-gather tables for single-contributor reductions
        self._pp_gather = self._build_gather(
            [s for plan in self.plans for (_a, _b, s, _w) in plan.pp_contribs],
            self.Kpp)
        self._pl_gather = self._build_gather(
            [s for plan in self.plans for (_a, _b, s) in plan.pl_contribs],
            self.Kpl)

    @staticmethod
    def _build_gather(seg_arrays, K):
        if not seg_arrays or K == 0:
            return False
        seg_all = np.concatenate([np.asarray(s) for s in seg_arrays])
        if len(seg_all) != K:
            return False
        if np.array_equal(seg_all, np.arange(K)):
            return "identity"   # concatenation IS the reduction — no gather
        if len(np.unique(seg_all)) != K:
            return False
        order = np.empty(K, dtype=np.int32)
        order[seg_all] = np.arange(K, dtype=np.int32)
        return jnp.asarray(order)

    def _make_kernel(self, plan: _EdgePlan):
        """Batched per-edge kernel producing PLANAR (flattened) contributions.

        Everything block-shaped leaves the kernel flattened to its last axis
        ([E, B], [E, Br*Bc]).  See ops/planar.py.
        """
        et = EDGE_TYPES[plan.name]
        vts = [VERTEX_TYPES[t] for t in et.vertex_types]
        Bp, Bl = self.Bp, self.Bl
        robust = bool(et.robust) and self.config.solver != "a"
        loss_name, loss_scale = et.robust_loss, et.robust_scale
        overrides = self.config.robust_overrides or {}
        if plan.name in overrides:
            loss_name, loss_scale = overrides[plan.name]
        elif "*" in overrides:
            loss_name, loss_scale = overrides["*"]
        from slam_plus_plus_tpu.robust.losses import LOSSES
        loss_fn = LOSSES[loss_name]

        if et.expectation is not None:
            # reference parity mode: jacobian of the expectation h (negated
            # to keep the dr/ddelta sign convention used downstream); the
            # reference differentiates h, not r (SE3_Types.h:265-290)
            def r_and_jacs(states, z):
                h = et.expectation(states)
                r = et.error(z, h)
                jacs = []
                for k, vt in enumerate(vts):
                    def f(delta, k=k, vt=vt):
                        st = list(states)
                        st[k] = vt.boxplus(st[k], delta)
                        return et.expectation(tuple(st))
                    jacs.append(-jax.jacfwd(f)(
                        jnp.zeros(vt.tangent_dim, dtype=z.dtype)))
                return r, jacs
        else:
            def r_and_jacs(states, z):
                r = et.residual(states, z)
                jacs = []
                for k, vt in enumerate(vts):
                    def f(delta, k=k, vt=vt):
                        st = list(states)
                        st[k] = vt.boxplus(st[k], delta)
                        return et.residual(tuple(st), z)
                    jacs.append(jax.jacfwd(f)(
                        jnp.zeros(vt.tangent_dim, dtype=z.dtype)))
                return r, jacs

        def single(states, z, info):
            r, jacs = r_and_jacs(states, z)
            chi2_e = r @ (info @ r)

            info_w = info
            if robust:
                # reference: w = loss(|e| / scale) scales the information
                # (SE3_Types.h:128, RobustUtils.h:368-440); the weight is
                # re-evaluated at every (re)linearization — IRLS
                # (Notify_LinearizationChange, NonlinearSolver_Lambda.h:455)
                info_w = info * loss_fn(jnp.linalg.norm(r) / loss_scale)

            padded = []
            for k in range(len(vts)):
                J = jacs[k]
                Bc = Bp if plan.slot_class[k] == "p" else Bl
                if J.shape[-1] < Bc:
                    J = jnp.pad(J, ((0, 0), (0, Bc - J.shape[-1])))
                padded.append(J)

            lam_r = info_w @ r
            hdiag_e = jnp.asarray(0.0, dtype=z.dtype)
            gs = []
            for k in range(len(vts)):
                JtI = padded[k].T @ info_w           # [Bc, m]
                hdiag_e = jnp.maximum(
                    hdiag_e, jnp.max(jnp.sum(JtI * padded[k].T, axis=1)))
                gs.append(-(padded[k].T @ lam_r))    # [Bc]

            Hpp = [(padded[a].T @ info_w @ padded[b]).reshape(-1)
                   for (a, b, _s, _w) in plan.pp_contribs]
            Hll = [(padded[k].T @ info_w @ padded[k]).reshape(-1)
                   for k in range(len(vts)) if plan.slot_class[k] == "l"]
            Hpl = [(padded[pa].T @ info_w @ padded[lb]).reshape(-1)
                   for (pa, lb, _s) in plan.pl_contribs]
            return (chi2_e, hdiag_e, tuple(gs), tuple(Hpp), tuple(Hll),
                    tuple(Hpl))

        return jax.vmap(single)

    def snapshot_states(self, system: GraphSystem) -> Dict[str, jnp.ndarray]:
        return {t: jnp.asarray(system.vertex_stores[t].data, dtype=self.dtype)
                for t in self.type_names}

    def writeback_states(self, system: GraphSystem, states: Dict[str, jnp.ndarray]) -> None:
        for t in self.type_names:
            system.vertex_stores[t].states[:system.vertex_stores[t].n] = np.asarray(
                states[t], dtype=np.float64)

    # ------------------------------------------------------------------
    # device numeric phase
    # ------------------------------------------------------------------

    def _edge_sums(self, states, edge_data):
        """Raw per-edge contribution sums — the part that is data-parallel
        over edges and distributes with shard_map + psum (parallel/dist.py).

        All block collections are PLANAR: pp [Kpp, Bp*Bp], pl [Kpl, Bp*Bl],
        ll [Nl, Bl*Bl] (see ops/planar.py).  Matmul precision follows the
        device policy (config.apply_matmul_precision).
        """
        dt = self.dtype
        Bp, Bl = self.Bp, self.Bl
        Np, Nl = max(self.Np, 1), max(self.Nl, 1)

        pp_chunks, pp_segids = [], []
        pl_chunks, pl_segids = [], []
        etap_chunks, etap_segids = [], []
        ll = jnp.zeros((Nl, Bl * Bl), dtype=dt)
        eta_l = jnp.zeros((Nl, Bl), dtype=dt)
        chi2 = jnp.zeros((), dtype=dt)
        max_hdiag = jnp.zeros((), dtype=dt)

        # planar transpose permutation for swapped (upper->lower) pp pairs
        swap_perm = [i * Bp + j for j in range(Bp) for i in range(Bp)]

        for plan in self.plans:
            data = edge_data[plan.name]
            et = EDGE_TYPES[plan.name]
            uniform_M = (self._pad_maps.get(plan.name) is not None and
                         plan.E == Nl * (plan.E // max(Nl, 1)) and
                         plan.E // max(Nl, 1) or None)
            lmap = getattr(self, "_l_local_maps", {}).get(plan.name)
            gathered = []
            for k, t in enumerate(et.vertex_types):
                sl = data["slot_local"][k]
                st = states[t]
                if (uniform_M and lmap is not None and
                        plan.slot_class[k] == "l"):
                    # uniform layout: the l slot is positional — one tiny
                    # [Nl] gather + broadcast replaces the O(E)-row gather
                    base = st[lmap]                            # [Nl, d]
                    gathered.append(jnp.broadcast_to(
                        base[:, None, :],
                        (Nl, uniform_M, st.shape[1])).reshape(
                            plan.E, st.shape[1]))
                elif self._onehot_ok(plan.E, st.shape[0]):
                    # one-hot GEMM gather for small vertex tables.
                    # HIGHEST precision: selection must reproduce the f32
                    # state bits exactly
                    oh = (sl[:, None] ==
                          jnp.arange(st.shape[0], dtype=sl.dtype)).astype(dt)
                    gathered.append(jnp.matmul(
                        oh, st, precision=jax.lax.Precision.HIGHEST))
                else:
                    gathered.append(st[sl])
            gathered = tuple(gathered)
            if plan.name in getattr(self, "_pallas_plans", ()):
                chi2_e, hdiag_e, gs, Hpp, Hll, Hpl = self._pallas_edge_terms(
                    plan, gathered, data)
            else:
                chi2_e, hdiag_e, gs, Hpp, Hll, Hpl = self._kernels[plan.name](
                    gathered, data["z"], data["info"])

            chi2 = chi2 + jnp.sum(chi2_e)
            max_hdiag = jnp.maximum(max_hdiag, jnp.max(hdiag_e))
            li = 0
            for k in range(len(plan.slot_types)):
                cs = data["slot_cslot"][k]
                if plan.slot_class[k] == "p":
                    etap_chunks.append(gs[k])
                    etap_segids.append(cs)
                elif uniform_M:
                    # uniform [Nl, M] layout: the landmark reduction is a
                    # pure reshape-sum — no gather, no sort (see
                    # _build_structure's uniform-layout block)
                    M = uniform_M
                    eta_l = eta_l + gs[k].reshape(Nl, M, Bl).sum(axis=1)
                    ll = ll + Hll[li].reshape(Nl, M, Bl * Bl).sum(axis=1)
                    li += 1
                else:
                    # flat layout: segment-sum by landmark
                    eta_l = eta_l + jax.ops.segment_sum(
                        gs[k], cs, num_segments=Nl)
                    ll = ll + jax.ops.segment_sum(
                        Hll[li], cs, num_segments=Nl)
                    li += 1

            for ci, (a, b, _s, _w) in enumerate(plan.pp_contribs):
                H = Hpp[ci]
                if a != b:
                    swap = data["pp_swap"][ci]
                    H = jnp.where(swap[:, None], H[:, swap_perm], H)
                pp_chunks.append(H)
                pp_segids.append(data["pp_seg"][ci])

            for ci in range(len(plan.pl_contribs)):
                pl_chunks.append(Hpl[ci])
                pl_segids.append(data["pl_seg"][ci])

        eta_p = self._reduce_segments(etap_chunks, etap_segids, Np, dt)
        pp = self._reduce_contribs(pp_chunks, pp_segids, self.Kpp,
                                   Bp * Bp, dt, "_pp_gather")
        pl = self._reduce_contribs(pl_chunks, pl_segids, max(self.Kpl, 1),
                                   Bp * Bl, dt, "_pl_gather")
        return pp, pl, ll, eta_p, eta_l, chi2, max_hdiag

    @staticmethod
    def _onehot_ok(total, K, itemsize=4):
        """One-hot GEMM reduction beats segment_sum when the target count is
        small (the [total, K] one-hot operand is a bounded GEMM) and the
        operand fits."""
        return (K <= 1024 and total >= 4 * K and
                total * K * itemsize <= (512 << 20))

    def _reduce_segments(self, chunks, segids, K, dt):
        """Sum [Ei, d] chunks into K segments: one-hot GEMM when
        profitable, else segment_sum."""
        if not chunks:
            return jnp.zeros((max(K, 1), self.Bp), dtype=dt)
        vals = jnp.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        ids = (jnp.concatenate(segids) if len(segids) > 1 else segids[0])
        if self._onehot_ok(vals.shape[0], K):
            onehot = (ids[:, None] ==
                      jnp.arange(K, dtype=ids.dtype)).astype(dt)
            return onehot.T @ vals
        return jax.ops.segment_sum(vals, ids, num_segments=K)

    def _pallas_edge_terms(self, plan, gathered, data):
        """Fused Pallas path for P2C, in the generic kernel's contribution
        signature."""
        from slam_plus_plus_tpu.ops import pallas_p2c
        E = plan.E
        chi2_e, hdiag_e, gc, gp, hcc, hcp, hpp = pallas_p2c.p2c_edge_terms(
            gathered[0].reshape(E, 11), gathered[1].reshape(E, 3),
            data["z"].reshape(E, 2), data["info"].reshape(E, 4))
        return chi2_e, hdiag_e, (gc, gp), (hcc,), (hpp,), (hcp,)

    def _reduce_contribs(self, chunks, segids, K, d, dt, gather_attr):
        """Sum contribution chunks into K planar blocks.

        When every block has exactly one contributor (BA: each cam-landmark
        pair appears once), the segment reduction is a pure permutation and
        a host-precomputed GATHER replaces it.  The gather tables are built
        host-side in _build_device_plan; DistributedAssembler disables them (shard-local
        chunks are partial)."""
        if not chunks:
            return jnp.zeros((max(K, 1), d), dtype=dt)
        vals = jnp.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        gather = getattr(self, gather_attr, False)
        if isinstance(gather, str):   # "identity": concat IS the reduction
            return vals
        if gather is not False:
            return vals[gather]
        ids = (jnp.concatenate(segids) if len(segids) > 1 else segids[0])
        if self._onehot_ok(vals.shape[0], K):
            onehot = (ids[:, None] ==
                      jnp.arange(K, dtype=ids.dtype)).astype(dt)
            return onehot.T @ vals
        return jax.ops.segment_sum(vals, ids, num_segments=K)

    def _assemble_impl(self, states, edge_data) -> BlockSystem:
        pp, pl, ll, eta_p, eta_l, chi2, max_hdiag = self._edge_sums(
            states, edge_data)
        return self._finalize(pp, pl, ll, eta_p, eta_l, chi2, max_hdiag)

    # ---- active-prefix (incremental) variants -------------------------
    #
    # The incremental engine replays a growing graph against the FULL
    # symbolic structure with *active-count masking*: edges beyond the
    # active prefix get zero information (contributing exactly nothing),
    # inactive vertices get unit diagonal pivots (dx = 0).  The counts are
    # traced scalars, so the entire incremental run reuses ONE compiled
    # step — the accelerator answer to the reference's incremental allocation
    # (Extend_Lambda, reference include/slam/NonlinearSolver_Lambda_Base.h).

    def _mask_edge_data(self, edge_data, counts):
        masked = {}
        for plan in self.plans:
            d = dict(edge_data[plan.name])
            mask = (jnp.arange(plan.E) < counts[plan.name]).astype(self.dtype)
            d["info"] = d["info"] * mask[:, None, None]
            masked[plan.name] = d
        return masked

    def _assemble_active_impl(self, states, edge_data, counts,
                              n_active_p, n_active_l) -> BlockSystem:
        sums = self._edge_sums(states, self._mask_edge_data(edge_data, counts))
        bs = self._finalize(*sums)
        Bp, Bl = self.Bp, self.Bl
        p_diag_cols = [i * Bp + i for i in range(Bp)]
        inactive_p = (jnp.arange(self.Np if self.Np else 1) >=
                      n_active_p).astype(self.dtype)
        pp = bs.pp_blocks.at[self.pp_diag_ids_dev[:, None], p_diag_cols].add(
            inactive_p[:, None] * self.p_mask_dev)
        ll = bs.ll_blocks
        if self.Nl:
            l_diag_cols = [i * Bl + i for i in range(Bl)]
            inactive_l = (jnp.arange(self.Nl) >= n_active_l).astype(self.dtype)
            ll = ll.at[:, l_diag_cols].add(inactive_l[:, None] * self.l_mask_dev)
        return bs._replace(pp_blocks=pp, ll_blocks=ll)

    def _chi2_active_impl(self, states, edge_data, counts):
        return self._chi2_impl(states, self._mask_edge_data(edge_data, counts))

    def set_aot_salt(self, salt: str) -> None:
        """Opt this assembler's jitted programs into the persistent AOT
        export cache (utils/aot_cache) — warm runs skip tracing.  The salt
        must fingerprint everything baked into the traces (the pattern /
        contribution segment arrays); FastLSolver computes it."""
        from slam_plus_plus_tpu.utils.aot_cache import (aot_jit,
                                                        register_namedtuples)
        register_namedtuples(BlockSystem)
        self.aot_salt = salt
        self._update_jit = aot_jit(self._update_impl, "asm_update", salt)
        for attr in ("_assemble_active_jit", "_chi2_active_jit"):
            if hasattr(self, attr):
                delattr(self, attr)

    def _make_jit(self, fn, name):
        if getattr(self, "aot_salt", None) is not None:
            from slam_plus_plus_tpu.utils.aot_cache import aot_jit
            return aot_jit(fn, name, self.aot_salt)
        return jax.jit(fn)

    def assemble_active(self, states, counts, n_active_p, n_active_l):
        if self.pl_uniform is not None:
            raise RuntimeError(
                "active-prefix masking needs parse order; construct the "
                "Assembler with config.edge_layout='flat'")
        if not hasattr(self, "_assemble_active_jit"):
            self._assemble_active_jit = self._make_jit(
                self._assemble_active_impl, "asm_active")
        return self._assemble_active_jit(states, self.edge_data, counts,
                                         n_active_p, n_active_l)

    def chi2_active(self, states, counts):
        if not hasattr(self, "_chi2_active_jit"):
            self._chi2_active_jit = self._make_jit(self._chi2_active_impl,
                                                   "asm_chi2_active")
        return self._chi2_active_jit(states, self.edge_data, counts)

    def _finalize(self, pp, pl, ll, eta_p, eta_l, chi2, max_hdiag) -> BlockSystem:
        Bp, Bl = self.Bp, self.Bl
        p_diag_cols = [i * Bp + i for i in range(Bp)]
        l_diag_cols = [i * Bl + i for i in range(Bl)]

        # pad fix: unit pivots on padded tangent dims (keeps SPD, dx_pad = 0)
        pp = pp.at[self.pp_diag_ids_dev[:, None], p_diag_cols].add(
            1.0 - self.p_mask_dev)
        if self.Nl:
            ll = ll.at[:, l_diag_cols].add(1.0 - self.l_mask_dev)

        # unary gauge anchor (identity * 1 on the first edge's first vertex,
        # masked to its real dims)
        if self.anchor_cslot is not None:
            aid = self.pp_diag_ids_dev[self.anchor_cslot]
            pp = pp.at[aid, p_diag_cols].add(self.p_mask_dev[self.anchor_cslot])

        return BlockSystem(pp, pl, ll, eta_p, eta_l, chi2, max_hdiag)

    def _chi2_impl(self, states, edge_data):
        chi2 = jnp.zeros((), dtype=self.dtype)
        for plan in self.plans:
            data = edge_data[plan.name]
            et = EDGE_TYPES[plan.name]
            gathered = tuple(states[t][data["slot_local"][k]]
                             for k, t in enumerate(et.vertex_types))
            chi2_e = self._kernels[plan.name](gathered, data["z"],
                                              data["info"])[0]
            chi2 = chi2 + jnp.sum(chi2_e)
        return chi2

    def _update_impl(self, states, dx_p, dx_l):
        new_states = {}
        for t in self.type_names:
            vt = VERTEX_TYPES[t]
            cls, cslot = self.state_meta[t]
            dx = dx_p if cls == "p" else dx_l
            delta = dx[cslot][:, :vt.tangent_dim]
            new_states[t] = jax.vmap(vt.boxplus)(states[t], delta)
        return new_states

    # public API --------------------------------------------------------

    def assemble(self, states) -> BlockSystem:
        return self._assemble_jit(states, self.edge_data)

    def chi2(self, states):
        return self._chi2_jit(states, self.edge_data)

    def update(self, states, dx_p, dx_l=None):
        if dx_l is None:
            dx_l = jnp.zeros((max(self.Nl, 1), self.Bl), dtype=self.dtype)
        return self._update_jit(states, dx_p, dx_l)
