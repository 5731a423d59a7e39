"""FastL: incremental solver with a maintained factorization (omega updates).

Reference analogue: CNonlinearSolver_FastL (reference
include/slam/NonlinearSolver_FastL.h) — the RSS-2013 incremental solver.
Its semantics, replicated here exactly:

  * Linearization points are FROZEN between optimization pushes; lambda and
    the factor R are *updated* with the new edges' Hessian contributions
    (omega, fL_util::Calculate_Omega, NonlinearSolver_FastL.h:698,743)
    rather than rebuilt.
  * Every new vertex triggers an update of (R, d); dx is back-substituted
    only when loop closures are outstanding (TryOptimize,
    NonlinearSolver_FastL.h:1451-1566).
  * If ||dx|| exceeds the threshold, the step is PUSHED: all vertices move,
    the system becomes dirty, and the next factorization is a full
    relinearization + refactorization (Refresh_R_FullR,
    NonlinearSolver_FastL.h:2367); otherwise dx is discarded and the frozen
    linearization survives (break-before-push).

Accelerator-first redesign of the mechanism (not a port of R11 refactorization):
lambda lives as the level-0 block array of the nested MIS-Schur plan
(linalg/block_cholesky.py) over the final replay pattern; an omega step is a
scatter of the new edges' Hessian blocks into lambda followed by a
refactorization.  The refactorization is batched per level — `refresh="full"`
redescends all levels in one fused dispatch (already O(fill) with no
reassembly of old edges, the dominant cost in a full replay);
`refresh="dirty"` (linalg/incremental_cholesky.py) recomputes only the
blocks reachable from the changed pairs — the O(affected) analogue of the
reference's trailing-submatrix R11 update.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from slam_plus_plus_tpu.assembly.assembler import Assembler
from slam_plus_plus_tpu.config import SolverConfig
from slam_plus_plus_tpu.graph.system import GraphSystem
from slam_plus_plus_tpu.models.types import EDGE_TYPES, VERTEX_TYPES
from slam_plus_plus_tpu.linalg.block_cholesky import BlockCholeskySolver


class FastLSolver:
    """Incremental FastL replay over a parsed system.

    Usage:
        inc = FastLSolver(system, every_n=1)
        chi2, iters = inc.run()
    """

    def __init__(self, system: GraphSystem, every_n: int = 1,
                 max_iterations: int = 10, dx_threshold: float = 20.0,
                 config: Optional[SolverConfig] = None,
                 refresh: str = "dirty",
                 full_refresh_interval: int = 0,
                 bottom: int = 32,
                 onetime_dx: bool = True,
                 use_native: bool = True):
        """onetime_dx=False selects the reference LAMBDA solver's incremental
        reporting semantics: chi2/solution are evaluated at the last pushed
        linearization with no trailing one-time dx (the lambda solver's
        Optimize discards a below-threshold dx, reference
        include/slam/NonlinearSolver_Lambda.h:637-661, and reports at the
        linearization point).  Between pushes the linearization is frozen, so
        lambda maintained by omega updates equals the lambda solver's full
        Refresh_Lambda bit-for-near-bit — the maintained-factor engine serves
        both solvers; only the final report differs."""
        self.system = system
        self.onetime_dx = onetime_dx
        self.config = config or SolverConfig()
        self.every_n = every_n
        self.max_iterations = max_iterations
        self.dx_threshold = dx_threshold
        self.refresh = refresh
        self.full_refresh_interval = full_refresh_interval
        # landmark problems: run the MIS-Schur engine over the MIXED class
        # (landmarks padded to Bp) — landmarks are low-degree independent-set
        # candidates the elimination picks up in its first levels, which is
        # exactly the reference FastL's uniform treatment of landmark blocks
        # in R (its fastL regression rows include cityTrees10k/victoria-park,
        # reference scripts/tests/unit_tests.sh:216-222,248-254)
        import dataclasses as _dc
        self.config = _dc.replace(self.config, schur_split="off")
        self.asm = Assembler(system, _dc.replace(
            self.config, edge_layout="flat"))
        asm = self.asm
        assert asm.Nl == 0, "mixed-class assembler still split a class"

        # f32 note (measured, trees10k incr in f32): periodic full factor
        # redescents do NOT tighten the final chi2 — the 1.09x gap vs the
        # f64 trajectory comes from push decisions flipping under f32
        # rounding (trajectory variance), not from accumulated factor
        # error (a refresh-every-64 run landed WORSE at 1.21x).  Long f32
        # landmark replays therefore deploy on CPU/f64; the engine itself
        # is correct on chip (manhattan f32 ratio 1.0024).

        # factorization plan over the full replay pattern; SMALL dense
        # bottom — the dirty step refactors the bottom Cholesky every step,
        # so its size sets the per-step floor (bottom^3/3 flops); elimination
        # levels above it only pay O(affected)
        self.chol = BlockCholeskySolver(asm.pp_rows, asm.pp_cols, asm.Np,
                                        asm.Bp, bottom=min(asm.Np, bottom))
        self._inv_input_perm = np.empty(len(asm.pp_rows), dtype=np.int64)
        self._inv_input_perm[self.chol.plan.input_perm] = np.arange(
            len(asm.pp_rows))
        # pp pair index (assembler order) -> H0 position (plan order)

        # program fingerprint for the persistent AOT export cache: must
        # cover every constant baked into the traces — the lambda pattern,
        # each edge type's contribution segments (connectivity), and dtype
        from slam_plus_plus_tpu.utils.aot_cache import salt_arrays
        self._aot_salt = salt_arrays(
            asm.pp_rows, asm.pp_cols,
            np.array([asm.Np, asm.Bp, min(asm.Np, bottom)]),
            *[s for plan in asm.plans for (_a, _b, s, _w) in
              plan.pp_contribs]) + f"|{np.dtype(asm.dtype)}"
        asm.set_aot_salt(self._aot_salt)

        self._build_replay_plan()

        # native CPU replay (native/inc_engine.cpp): SE(2)/2D-landmark f64
        # replays run as ONE C++ call over the same symbolic plan — the
        # entire jax-side engine below is skipped (no tracing, no
        # dispatches).  Unsupported configurations fall through to jax.
        self._native = None
        if refresh == "dirty" and use_native:
            from slam_plus_plus_tpu.solvers.native_engine import NativeReplay
            self._native = NativeReplay.try_build(self)
        if self._native is not None:
            self.inc = None
            self.stats = {}
            self.marginals_trace = []
            self._sigma_diag = None
            self._sigma_pending = []
            return

        self._build_omega_kernels()
        if refresh == "dirty":
            from slam_plus_plus_tpu.linalg.incremental_cholesky import (
                IncrementalCholesky)
            self.inc = IncrementalCholesky(self.chol,
                                           aot_salt=self._aot_salt)
            # the ENTIRE replay's reachability walks in one vectorized
            # numpy pass (the solve schedule is host-static); run() then
            # never walks on the critical path
            keys = sorted(self._sched)
            packed = self.inc.prepare_host_batch(
                [self._sched[si] for si in keys])
            # replay-sized capacities: the default caps pad every scan
            # level to worst-case widths; the batch walk just measured the
            # ACTUAL per-solve sizes over this replay, so rebuild + repack
            # at the 97th percentile (rounded up) — the rare huge solve
            # point overflows to the full redescent, which at ~6 ms is
            # cheaper than paying its padding on every one of the other
            # ~500 solve points
            psz = self.inc.last_batch_per_solve
            tight = {k: int(np.ceil((np.percentile(psz[k], 97) + 1) / 16)
                            * 16)
                     for k in ("d", "e", "w", "p")} if keys else {}
            if keys and any(tight[k] < getattr(self.inc, f"cap_{k}") - 16
                            for k in tight):
                self.inc = IncrementalCholesky(self.chol, caps=tight,
                                               aot_salt=self._aot_salt)
                packed = self.inc.prepare_host_batch(
                    [self._sched[si] for si in keys])
            self._prepared_all = dict(zip(keys, packed))
            self._build_fused1()
        else:
            self.inc = None
            # unscaled stores: omega kernel still wants an outer array
            self._ones_outer = jnp.ones((len(asm.pp_rows), asm.Bp * asm.Bp),
                                        dtype=asm.dtype)
        self.stats: Dict[str, float] = {}
        # in-loop marginals maintenance (MarginalsPolicy-driven)
        self.marginals_trace: List[str] = []
        self._sigma_diag = None
        self._sigma_pending: List[tuple] = []

    # ------------------------------------------------------------------

    def _build_replay_plan(self) -> None:
        """Host precompute: per-step new edges/vertices/closure flags.

        Mirrors IncrementalSolver._build_replay_plan; additionally records,
        per edge, its level-0 pair positions and eta slots for the omega
        scatter."""
        system = self.system
        asm = self.asm
        order_of = {g: i for i, g in enumerate(system.vertex_order)}

        seen = set()
        self.steps: List[dict] = []
        n_active = 0
        for (ename, li) in system._edge_insert_log:
            store = system.edge_stores[ename]
            vids = store.vertex_ids[li]
            new_vs = []
            for slot, gid in enumerate(vids):
                if gid not in seen:
                    seen.add(gid)
                    new_vs.append((slot, int(gid)))
                    n_active += 1
            n = len(vids)
            first = min(order_of[g] for g in vids)
            closure = (first + n < n_active) if n > 1 else False
            self.steps.append(dict(ename=ename, li=li, new_vs=new_vs,
                                   closure=closure, n_active=n_active))

        # per-plan omega scatter metadata: H0 positions of each pp contrib
        # and the transpose-on-store orientation (the plan's level-0 storage
        # is the sorted pattern; assembler order maps through input_perm)
        self._omega_meta = {}
        for plan in asm.plans:
            pos = [self._inv_input_perm[np.asarray(s)]
                   for (_a, _b, s, _w) in plan.pp_contribs]
            swaps = [np.asarray(w) for (_a, _b, _s, w) in plan.pp_contribs]
            self._omega_meta[plan.name] = (pos, swaps)

        # diag H0 position per class slot (for activation pivot removal)
        self._diag_pos = self._inv_input_perm[asm.pp_diag_ids]

        # deterministic solve schedule (mirrors run()'s scheduling exactly):
        # per solve point, the pending batch's level-0 dirty positions.
        # run() uses it to compute the NEXT step's reachability walk while
        # the device executes the current step (host/device pipelining).
        self._sched: Dict[int, list] = {}
        pending_meta: List[tuple] = []
        outstanding = False
        last_nap = 0
        started = False
        for si, step in enumerate(self.steps):
            nm = np.zeros(EDGE_TYPES[step["ename"]].arity)
            pending_meta.append((step["ename"], step["li"], nm))
            outstanding = outstanding or step["closure"]
            if step["n_active"] - last_nap < self.every_n:
                continue
            last_nap = step["n_active"]
            if not started:
                started = True
                pending_meta = []
            if not outstanding:
                continue
            outstanding = False
            if pending_meta:
                self._sched[si] = self._pending_pos(pending_meta)
                pending_meta = []
        order = sorted(self._sched)
        self._next_solve = {si: order[i + 1] if i + 1 < len(order) else None
                            for i, si in enumerate(order)}

    # edges of one type processed per omega dispatch; pending batches larger
    # than this are chunked (still the SAME compiled program)
    OMEGA_EDGE_CAP = 16

    def _build_omega_kernels(self) -> None:
        """One jitted kernel per edge type: compute a PADDED BATCH of edges'
        Hessian/eta contribution deltas at the CURRENT states and scatter
        them into (H0, eta0) in one fused dispatch.

        This is Calculate_Omega (reference NonlinearSolver_FastL.h:698-743)
        as a batched device op; also handles new-vertex activation (removes
        the inactive unit pivot).  The batch is padded to OMEGA_EDGE_CAP so
        the program compiles exactly ONCE per edge type; invalid lanes have
        their values masked to zero (their scatter adds nothing).  Returns
        the updated (H0, eta0) plus the scaled delta blocks [C*cap, Bp*Bp]
        in contribution-major order for the dirty engine."""
        asm = self.asm
        Bp = asm.Bp
        self._omega_fns = {}
        for plan in asm.plans:
            et = EDGE_TYPES[plan.name]
            kernel = asm._kernels[plan.name]
            pos_meta, swap_meta = self._omega_meta[plan.name]
            swap_perm = np.array([i * Bp + j for j in range(Bp)
                                  for i in range(Bp)])
            # contrib index of each slot's diagonal (a == b == slot)
            diag_contrib = {a: ci for ci, (a, b, _s, _w)
                            in enumerate(plan.pp_contribs) if a == b}
            diag_cols = np.array([i * Bp + i for i in range(Bp)])

            def omega(states, edge_data, H0, eta0, outer0, eidx, new_mask,
                      valid,
                      plan=plan, et=et, kernel=kernel, pos_meta=pos_meta,
                      swap_meta=swap_meta, swap_perm=swap_perm,
                      diag_contrib=diag_contrib, diag_cols=diag_cols):
                # eidx [cap] int; new_mask [cap, arity]; valid [cap] float
                data = edge_data[plan.name]
                gathered = tuple(
                    states[t][data["slot_local"][k][eidx]]
                    for k, t in enumerate(et.vertex_types))
                z = data["z"][eidx]
                info = data["info"][eidx]
                chi2_e, _hd, gs, Hpp, _Hll, _Hpl = kernel(gathered, z, info)

                pos, vals = [], []
                for ci, (a, b, _s, _w) in enumerate(plan.pp_contribs):
                    Hblk = Hpp[ci]                        # [cap, Bp*Bp]
                    if a in diag_contrib and diag_contrib[a] == ci:
                        # activation: remove the slot's inactive unit pivot
                        cs = data["slot_cslot"][a][eidx]
                        Hblk = Hblk.at[:, diag_cols].add(
                            -new_mask[:, a:a + 1] * asm.p_mask_dev[cs])
                    swap = jnp.asarray(swap_meta[ci])[eidx]
                    Hblk = jnp.where(swap[:, None], Hblk[:, swap_perm], Hblk)
                    pos.append(jnp.asarray(pos_meta[ci])[eidx])
                    vals.append(Hblk)
                posf = jnp.stack(pos).reshape(-1)         # [C*cap] C-major
                valsf = jnp.stack(vals) * valid[None, :, None]
                valsf = valsf.reshape(posf.shape[0], Bp * Bp)
                scaled = valsf * outer0[posf]
                H0 = H0.at[posf].add(scaled)
                eta_slots = jnp.stack(
                    [data["slot_cslot"][k][eidx]
                     for k in range(et.arity)]).reshape(-1)
                eta_vals = (jnp.stack([gs[k] for k in range(et.arity)]) *
                            valid[None, :, None]).reshape(-1, Bp)
                eta0 = eta0.at[eta_slots].add(eta_vals)
                return H0, eta0, scaled

            def omega_pinned(*args, omega=omega):
                # full-f32 pin: reduced-precision f32 matmuls corrupt the
                # jacfwd products; on the STANDALONE omega path (multi-chunk
                # pendings — loop-heavy graphs) the corrupted contributions
                # accumulated into lambda and diverged a city10k replay to
                # 1e16 chi2.  The fused1 path is pinned too.
                with jax.default_matmul_precision("highest"):
                    return omega(*args)

            from slam_plus_plus_tpu.utils.aot_cache import aot_jit
            self._omega_fns[plan.name] = aot_jit(
                omega_pinned, f"omega_{plan.name}", self._aot_salt,
                donate_argnums=(2, 3))
            self._omega_bodies = getattr(self, "_omega_bodies", {})
            self._omega_bodies[plan.name] = omega

    def _build_fused1(self) -> None:
        """Single-dispatch solve point (the dominant every_n=1 case: ONE
        omega chunk of ONE edge type): omega + dirty refactorization +
        bottom re-Cholesky + solve traced as one program.  The legacy
        omega-then-step pair remains the fallback for multi-chunk /
        multi-type pending batches."""
        inc = self.inc
        self._fused1_fns = {}
        for plan in self.asm.plans:
            body = self._omega_bodies[plan.name]

            def fused1(stores, eta0, states, edge_data, eidx, new_mask,
                       valid, omega_seg, buf, bot_sel, bot_h, body=body):
                with jax.default_matmul_precision("highest"):
                    H, eta0, scaled = body(
                        states, edge_data, stores["H"], eta0,
                        stores["outer0"], eidx, new_mask, valid)
                    inner = dict(stores)
                    inner["H"] = H
                    out = inc._dirty_scan(inner, scaled, omega_seg, buf,
                                          bot_sel, bot_h)
                    dx = inc.solve_scan_refined(out, eta0)
                    return out, eta0, dx, jnp.linalg.norm(dx)

            from slam_plus_plus_tpu.utils.aot_cache import aot_jit
            self._fused1_fns[plan.name] = aot_jit(
                fused1, f"fused1_{plan.name}", self._aot_salt,
                donate_argnums=(0, 1))

    # ------------------------------------------------------------------

    def _activate(self, states, ename, slot, eidx):
        et = EDGE_TYPES[ename]
        if et.jax_initializer is None:
            return states
        key = (ename, slot)
        if not hasattr(self, "_act_fns"):
            self._act_fns = {}
        if key not in self._act_fns:
            def act(states, edge_data, eidx, ename=ename, slot=slot, et=et):
                data = edge_data[ename]
                gathered = tuple(states[t][data["slot_local"][k][eidx]]
                                 for k, t in enumerate(et.vertex_types))
                new = et.jax_initializer(gathered, data["z"][eidx], slot)
                tname = et.vertex_types[slot]
                li = data["slot_local"][slot][eidx]
                out = dict(states)
                out[tname] = states[tname].at[li].set(
                    new.astype(states[tname].dtype))
                return out
            # donation: activation runs once per NEW VERTEX (thousands per
            # replay); without it XLA copies every state array per call
            from slam_plus_plus_tpu.utils.aot_cache import aot_jit
            self._act_fns[key] = aot_jit(act, f"act_{ename}_{slot}",
                                         self._aot_salt,
                                         donate_argnums=(0,))
        return self._act_fns[key](states, self.asm.edge_data, eidx)

    # --- batched activation: between solve points nothing reads the new
    # vertices' states, so arrivals are QUEUED and materialized right
    # before the next dispatch as one lax.scan per same-(type,slot) run —
    # the chain dependence (vertex k+1 initialized from vertex k's fresh
    # state) is exactly the scan carry.  Replaces one jit dispatch per new
    # vertex (~0.44 ms x thousands) with ~one per solve point.
    _ACT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

    def _queue_activation(self, ename, slot, eidx) -> bool:
        et = EDGE_TYPES[ename]
        if et.jax_initializer is None:
            return False
        if not hasattr(self, "_act_queue"):
            self._act_queue = []
        self._act_queue.append((ename, slot, eidx))
        return True

    def _flush_activations(self, states):
        q = getattr(self, "_act_queue", None)
        if not q:
            return states
        if not hasattr(self, "_act_scan_fns"):
            self._act_scan_fns = {}
        i = 0
        while i < len(q):
            j = i + 1
            while j < len(q) and q[j][:2] == q[i][:2]:
                j += 1
            ename, slot = q[i][:2]
            idxs = np.array([e for (_en, _sl, e) in q[i:j]], dtype=np.int64)
            while len(idxs):
                cap = next(b for b in self._ACT_BUCKETS
                           if b >= min(len(idxs), self._ACT_BUCKETS[-1]))
                take = min(cap, len(idxs))
                chunk = idxs[:take]
                idxs = idxs[take:]
                pad = np.concatenate(
                    [chunk, np.full(cap - take, chunk[-1])])
                valid = np.zeros(cap)
                valid[:take] = 1.0
                states = self._act_scan(ename, slot, cap)(
                    states, self.asm.edge_data, pad, valid)
            i = j
        q.clear()
        return states

    def _act_scan(self, ename, slot, cap):
        key = (ename, slot, cap)
        if key not in self._act_scan_fns:
            et = EDGE_TYPES[ename]

            def act_run(states, edge_data, eidxs, valid,
                        ename=ename, slot=slot, et=et):
                data = edge_data[ename]
                tname = et.vertex_types[slot]

                def body(states, inp):
                    eidx, v = inp
                    gathered = tuple(
                        states[t][data["slot_local"][k][eidx]]
                        for k, t in enumerate(et.vertex_types))
                    new = et.jax_initializer(gathered, data["z"][eidx],
                                             slot)
                    li = data["slot_local"][slot][eidx]
                    old = states[tname][li]
                    new = jnp.where(v > 0, new.astype(old.dtype), old)
                    out = dict(states)
                    out[tname] = states[tname].at[li].set(new)
                    return out, None

                states, _ = jax.lax.scan(
                    body, states,
                    (jnp.asarray(eidxs),
                     jnp.asarray(valid, dtype=self.asm.dtype)))
                return states

            from slam_plus_plus_tpu.utils.aot_cache import aot_jit
            self._act_scan_fns[key] = aot_jit(
                act_run, f"actrun_{ename}_{slot}_{cap}", self._aot_salt,
                donate_argnums=(0,))
        return self._act_scan_fns[key]

    def _init_stores(self, states, counts, n_active):
        """(Re)build lambda at the current linearization and factor fully.

        The push/full-relinearization path (reference Refresh_R_FullR after
        a dirty system, NonlinearSolver_FastL.h:2367)."""
        bs = self.asm.assemble_active(states, counts, n_active, 0)
        H0 = bs.pp_blocks[self.chol.plan.input_perm]
        eta0 = bs.eta_p
        if self.inc is not None:
            stores = self.inc.init_stores(H0)
        else:
            stores = {"H0": H0,
                      "factor": self.chol._factor_jit(bs.pp_blocks)}
        return stores, eta0

    def _pending_chunks(self, pending):
        """Deterministic per-type padded chunking of a pending batch
        (shared by the omega dispatch and the pipelined walk scheduler)."""
        cap = self.OMEGA_EDGE_CAP
        by_type: Dict[str, list] = {}
        for (en, el, nm) in pending:
            by_type.setdefault(en, []).append((el, nm))
        out = []
        for en, items in by_type.items():
            els = np.array([el for el, _ in items], dtype=np.int64)
            nms = np.array([nm for _, nm in items], dtype=np.float64)
            for lo in range(0, len(els), cap):
                chunk = els[lo:lo + cap]
                nmc = nms[lo:lo + cap]
                npad = cap - len(chunk)
                valid = np.ones(cap)
                if npad:
                    # pad with a VALID edge of this chunk: its positions are
                    # already dirty, so the padding adds nothing to the walk
                    chunk = np.concatenate(
                        [chunk, np.full(npad, chunk[0], dtype=np.int64)])
                    nmc = np.concatenate(
                        [nmc, np.zeros((npad,) + nms.shape[1:])])
                    valid[len(els) - lo:] = 0.0
                out.append((en, chunk, nmc, valid))
        return out

    def _pending_pos(self, pending):
        """Level-0 dirty pair positions for a pending batch (host only)."""
        pos_l = []
        for (en, chunk, _nmc, _valid) in self._pending_chunks(pending):
            pos_meta, _sw = self._omega_meta[en]
            pos_l.append(np.stack([p[chunk] for p in pos_meta]).reshape(-1))
        return pos_l

    def _apply_pending(self, stores, eta0, states, pending):
        """Compute + apply omega deltas for the pending edges in per-type
        padded batches (one dispatch per OMEGA_EDGE_CAP chunk); returns
        (eta0, level-0 dirty positions (host), delta values (device list))."""
        asm = self.asm
        outer0 = (stores["outer0"] if self.inc is not None
                  else self._ones_outer)
        pos_l, val_l = [], []
        for (en, chunk, nmc, valid) in self._pending_chunks(pending):
            pos_meta, _sw = self._omega_meta[en]
            stores["H0"], eta0, scaled = self._omega_fns[en](
                states, asm.edge_data, stores["H0"], eta0, outer0,
                jnp.asarray(chunk),
                jnp.asarray(nmc, dtype=asm.dtype),
                jnp.asarray(valid, dtype=asm.dtype))
            # host positions in the kernel's C-major order
            pos_l.append(np.stack([p[chunk] for p in pos_meta]).reshape(-1))
            val_l.append(scaled)
        if self.inc is not None:
            # the omega kernel donated the flat H buffer; re-sync the alias
            stores["H"] = stores["H0"]
        return eta0, pos_l, val_l

    def _refactor(self, stores):
        if self.inc is not None:
            return self.inc.refactor_full(stores)
        H0 = stores["H0"]
        # factor expects assembler order; invert the permutation
        stores["factor"] = self.chol._factor_jit(H0[self._inv_input_perm])
        return stores

    def _solve(self, stores, eta0):
        """Returns (dx, norm) with norm a device scalar."""
        if self.inc is not None:
            return self.inc.solve_with_norm(stores, eta0)
        dx = self.chol._solve_with_factor_jit(stores["factor"], eta0)
        return dx, jnp.linalg.norm(dx)

    # ------------------------------------------------------------------
    # marginals maintained INSIDE the incremental loop
    # (reference: the lambda solver recomputes/updates marginals after
    # convergence and incrementally from omega —
    # include/slam/Marginals.h:5224, NonlinearSolver_Lambda.h:670-705)
    # ------------------------------------------------------------------

    def _sigma_recompute(self, stores):
        """Recurrent sparse recovery from the MAINTAINED factor (the
        formerly-dead marginals_from_stores path): Sigma on the fill
        pattern, block diagonal extracted per vertex."""
        Sig = self.chol.marginals_from_stores(stores, self.inc)
        self._sigma_diag = Sig[jnp.asarray(self.chol.plan.diag_pos0)]
        self.marginals_trace.append("recalculate")
        return self._sigma_diag

    def _build_G(self, pend, states):
        """Square-root omega columns for a pending batch: edge jacobian
        columns (weight +1) + activation placeholder-pivot removals
        (weight -1).  Returns (G [Np*Bp, k], D [k] signs)."""
        from slam_plus_plus_tpu.marginals.covariance import (
            IncrementalMarginals)
        asm = self.asm
        cols, signs = [], []
        by_type: Dict[str, list] = {}
        act_cols = []
        for (en, el, nm) in pend:
            by_type.setdefault(en, []).append(el)
            if np.any(nm):
                et = EDGE_TYPES[en]
                for slot in np.flatnonzero(nm):
                    cs = int(asm.edge_data[en]["slot_cslot"][slot][el])
                    d = min(asm.Bp,
                            VERTEX_TYPES[et.vertex_types[slot]].tangent_dim)
                    act_cols.append((cs, d))
        for en, els in by_type.items():
            G = IncrementalMarginals.omega_sqrt_for_edges(asm, states, en,
                                                          els)
            cols.append(G)
            signs.extend([1.0] * G.shape[1])
        if act_cols:
            n = asm.Np * asm.Bp
            cols_np = np.zeros((n, sum(d for _c, d in act_cols)))
            j = 0
            for (cs, d) in act_cols:
                for dd in range(d):
                    cols_np[cs * asm.Bp + dd, j] = 1.0
                    j += 1
            cols.append(jnp.asarray(cols_np, dtype=asm.dtype))
            signs.extend([-1.0] * cols_np.shape[1])
        G = jnp.concatenate(cols, axis=1) if len(cols) > 1 else cols[0]
        return G, jnp.asarray(np.array(signs), dtype=asm.dtype)

    def _sigma_update(self, stores, G, D):
        """Woodbury diag update through the CURRENT maintained factor.

        Because the factor already includes omega, the correction uses the
        *post-update* solve X' = Sigma' G:
            Sigma'_diag = Sigma_diag - diag(X' (D - G^T X')^-1 X'^T)
        (derived from Update_BlockDiagonalMarginals_FBS_ExOmega's Woodbury
        with the stale/fresh roles exchanged; D = +/-1 signs handles the
        activation downdates exactly)."""
        k = int(G.shape[1])
        key = ("sigupd", k)
        if not hasattr(self, "_sig_jits"):
            self._sig_jits = {}
        if key not in self._sig_jits:
            inc = self.inc
            asm = self.asm

            def upd(core, sigma_diag, G, D):
                def one(col):
                    return inc._solve_scan(
                        core, col.reshape(asm.Np, asm.Bp)).reshape(-1)
                with jax.default_matmul_precision("highest"):
                    X = jax.vmap(one, in_axes=1, out_axes=1)(G)
                    M = jnp.linalg.inv(jnp.diag(D) - G.T @ X)
                    Xb = X.reshape(asm.Np, asm.Bp, k)
                    corr = jnp.einsum("nik,kl,njl->nij", Xb, M,
                                      Xb).reshape(asm.Np, asm.Bp * asm.Bp)
                    return sigma_diag - corr

            self._sig_jits[key] = jax.jit(upd)
        core = {kk: stores[kk] for kk in ("C", "W", "L", "s", "sv")}
        self._sigma_diag = self._sig_jits[key](core, self._sigma_diag, G, D)
        self.marginals_trace.append("update")
        return self._sigma_diag

    def sigma_diag(self):
        """Maintained per-vertex covariance diagonal [Np, Bp, Bp] (only
        when config.marginals.enabled)."""
        if self._sigma_diag is None:
            return None
        return np.asarray(self._sigma_diag).reshape(self.asm.Np, self.asm.Bp,
                                                    self.asm.Bp)

    # ------------------------------------------------------------------

    def run(self, verbose: bool = False):
        """Replay all edges with FastL semantics; returns (chi2, iters)."""
        if self._native is not None:
            t0 = time.perf_counter()
            chi2, iters, stats = self._native.run()
            self.elapsed = time.perf_counter() - t0
            stats["elapsed"] = self.elapsed
            self.stats = stats
            if verbose:
                print(f"fastl (native) done: {self.stats}")
            return chi2, iters
        t0 = time.perf_counter()
        asm = self.asm
        states = asm.snapshot_states(self.system)

        counts = {n: 0 for n in asm.edge_data}

        stores, eta0 = None, None
        # all solve points' walks were packed at construction; the inline
        # prepare_host below only runs for schedule deviations (none in
        # practice — the simulation mirrors this loop exactly)
        prepared: Dict[int, object] = dict(
            getattr(self, "_prepared_all", {}))
        lin_dirty = True   # report with one-time dx unless a push lands last
        outstanding = False
        pending: List[tuple] = []   # (ename, li, new_mask)
        n_since_solve = 0
        last_nap = 0
        total_iters = 0
        n_solves = 0
        n_pushes = 0
        n_full = 0
        n_steps_applied = 0
        omega_since_full = 0
        # f32 deployments: lambda itself accumulates thousands of f32
        # scatter-adds between pushes; on 10k-pose replays the drift
        # eventually corrupts the factor (city10k on-chip diverged to 1e16
        # chi2).  Periodically RE-ASSEMBLE lambda at the frozen
        # linearization — exact math is unchanged (same states => same
        # lambda), it only discards accumulated rounding, unlike the
        # round-4 factor-only redescents that could not fix drifted input.
        reassemble_every = (256 if asm.dtype == jnp.float32 else 0)
        solves_since_rebuild = 0

        for si, step in enumerate(self.steps):
            ename, li = step["ename"], step["li"]
            new_mask = np.zeros(EDGE_TYPES[ename].arity)
            for (slot, gid) in step["new_vs"]:
                self._queue_activation(ename, slot, li)
                new_mask[slot] = 1.0
            counts[ename] += 1
            outstanding = outstanding or step["closure"]
            pending.append((ename, li, new_mask))
            n_new_vs = step["n_active"] - last_nap
            if n_new_vs < self.every_n:
                continue
            last_nap = step["n_active"]

            if stores is None:
                states = self._flush_activations(states)
                stores, eta0 = self._init_stores(states, dict(counts),
                                                 step["n_active"])
                pending.clear()
                n_full += 1

            # --- optimize when loop closures are outstanding --------------
            if not outstanding:
                continue
            outstanding = False
            states = self._flush_activations(states)

            # --- omega update of the maintained factorization (LAZY: the
            # factor between solves is never read, and omega deltas are
            # additive, so materializing all pending edges here in one
            # batched dispatch gives bit-identical results to per-step
            # application at a fraction of the dispatches) -----------------
            fused_dx = None
            if pending and self.config.marginals.enabled:
                self._sigma_pending.extend(pending)
            if (reassemble_every and
                    solves_since_rebuild >= reassemble_every):
                # exact f32 drift cleanup (see above): rebuild lambda +
                # factor from states/counts; pending edges are already in
                # counts, so they are absorbed by the rebuild
                stores, eta0 = self._init_stores(states, dict(counts),
                                                 step["n_active"])
                pending.clear()
                n_full += 1
                solves_since_rebuild = 0
            if pending:
                n_pending = len(pending)
                chunks = (self._pending_chunks(pending)
                          if self.inc is not None else None)
                full_due = (self.full_refresh_interval and
                            omega_since_full + n_pending >=
                            self.full_refresh_interval)
                hp = (prepared.pop(si, self.inc._NOT_PREPARED)
                      if self.inc is not None else None)
                if self.inc is not None and hp is self.inc._NOT_PREPARED:
                    hp = self.inc.prepare_host(self._pending_pos(pending))
                if (self.inc is not None and not full_due and
                        len(chunks) == 1 and hp is not None):
                    # THE fast path (every_n=1): omega + dirty
                    # refactorization + solve in ONE dispatch
                    en, chunk, nmc, valid = chunks[0]
                    seg, buf, bot_sel, bot_h = hp
                    npdt = np.dtype(asm.dtype)
                    inner = {k: stores[k] for k in
                             ("H", "C", "W", "P", "dense", "L", "s", "sv",
                              "outer0")}
                    # raw numpy args: jit converts them on its C++ fast
                    # path; eager jnp.asarray per arg cost ~1.8 ms/solve
                    out, eta0, fdx, fnorm = self._fused1_fns[en](
                        inner, eta0, states, asm.edge_data,
                        chunk, nmc.astype(npdt), valid.astype(npdt),
                        seg, buf, bot_sel, bot_h)
                    stores.update(out)
                    stores["H0"] = out["H"]
                    fused_dx = (fdx, fnorm)
                    pending.clear()
                    omega_since_full += n_pending
                else:
                    eta0, dirty_pos, dirty_vals = self._apply_pending(
                        stores, eta0, states, pending)
                    omega_since_full += n_pending
                    pending.clear()
                    if full_due:
                        stores = self._refactor(stores)
                        omega_since_full = 0
                        n_full += 1
                    elif self.inc is not None:
                        res = self.inc.step(stores, eta0, dirty_pos,
                                            dirty_vals, host_packed=hp)
                        if res is None:   # dirty-capacity overflow
                            stores = self._refactor(stores)
                            n_full += 1
                        else:
                            stores, fdx, fnorm = res
                            fused_dx = (fdx, fnorm)
                    else:
                        stores = self._refactor(stores)
                n_steps_applied += 1
                # pipelining: the device is executing the step we just
                # dispatched — walk the NEXT solve point's reachability now
                # so its host half is free
                if self.inc is not None:
                    nxt = self._next_solve.get(si)
                    if nxt is not None and nxt not in prepared:
                        prepared[nxt] = self.inc.prepare_host(
                            self._sched[nxt])
            pushed_here = False
            for it in range(self.max_iterations):
                total_iters += 1
                if it == 0 and fused_dx is not None:
                    dx, norm_dev = fused_dx
                else:
                    dx, norm_dev = self._solve(stores, eta0)
                norm = float(norm_dev)
                # numerical-failure guard: a near-singular lambda can yield
                # an astronomically large FINITE step; pushing it destroys
                # the state irrecoverably.  Reject like a failed Cholesky
                # (reference aborts the iteration on linear-solver failure,
                # NonlinearSolver_Lambda.h:666-668).
                if not np.isfinite(norm) or norm > 1e5 or \
                        norm <= self.dx_threshold:
                    lin_dirty = True
                    break  # discard dx, keep frozen linearization
                # push: linearization moves -> full relinearize + refactor
                states = asm._update_jit(
                    states, dx, jnp.zeros((1, asm.Bl), dtype=asm.dtype))
                n_pushes += 1
                pushed_here = True
                lin_dirty = False
                stores, eta0 = self._init_stores(states, dict(counts),
                                                 step["n_active"])
                n_full += 1
                omega_since_full = 0
                solves_since_rebuild = 0

            # --- marginals maintained in the loop (MarginalsPolicy):
            # after a push the linearization moved -> recurrent recompute
            # from the maintained factor; omega-only solve points get the
            # exact Woodbury diag update; decisions are logged for the
            # update-vs-recalculate evidence (reference
            # NonlinearSolver_Lambda.h:670-705, Marginals.h:5224)
            mp = self.config.marginals
            if (mp.enabled and self.inc is not None and
                    n_solves % max(mp.increment_every, 1) == 0):
                if (pushed_here or self._sigma_diag is None or
                        not mp.relinearize_update):
                    self._sigma_recompute(stores)
                    self._sigma_pending.clear()
                elif self._sigma_pending:
                    G, D = self._build_G(self._sigma_pending, states)
                    if G.shape[1] <= 96:
                        self._sigma_update(stores, G, D)
                    else:
                        self._sigma_recompute(stores)
                    self._sigma_pending.clear()
            n_solves += 1

        states = self._flush_activations(states)
        # trailing pending edges (closure edges with no new vertex): refresh
        # the factorization so the final solution includes them
        if stores is not None and pending:
            eta0, _pos, _vals = self._apply_pending(stores, eta0, states,
                                                    pending)
            pending.clear()
            stores = self._refactor(stores)
            lin_dirty = True

        # the reference reports chi2/solution at linearization (+) pending
        # one-time dx when no push materialized it (f_Chi_Squared_Error_Denorm,
        # reference NonlinearSolver_FastL.h:582-605: CalculateOneTimeDx +
        # PushValuesInGraphSystem, evaluate, revert)
        if stores is not None and lin_dirty and self.onetime_dx:
            dx, _norm = self._solve(stores, eta0)
            if bool(jnp.all(jnp.isfinite(dx))):
                states = asm._update_jit(
                    states, dx, jnp.zeros((1, asm.Bl), dtype=asm.dtype))

        full_counts = {n: counts[n] for n in asm.edge_data}
        chi2 = float(asm.chi2_active(states, full_counts))
        asm.writeback_states(self.system, states)
        self.elapsed = time.perf_counter() - t0
        self.stats = dict(steps=len(self.steps), omega_steps=n_steps_applied,
                          pushes=n_pushes, full_refactors=n_full,
                          iters=total_iters, elapsed=self.elapsed)
        if verbose:
            print(f"fastl done: {self.stats}")
        return chi2, total_iters
