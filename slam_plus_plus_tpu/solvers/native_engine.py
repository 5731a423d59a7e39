"""ctypes binding + wiring for the native incremental replay engine
(native/inc_engine.cpp).

The CPU deployment path of the incremental solvers: the whole replay (omega
scatter, delta-propagated MIS-level refactorization, solve, push decisions,
activations) runs as one C++ call over the SAME symbolic plan the JAX
engine uses — removing the XLA per-op dispatch + jax tracing tax that
dominates small-graph CPU replays.  The GPU keeps the fused-scan engine.

Supported: SE(2) pose graphs + 2D range-bearing landmark graphs, f64,
dirty-refresh, no in-loop marginals.  Everything else falls back to JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libspp_inc.so")
_lib = None

_VKIND = {"pose2d": 0, "landmark2d": 1}
_EKIND = {"edge_pose2d": 0, "edge_pose_landmark2d": 1}

_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f64p = ctypes.POINTER(ctypes.c_double)


def ensure_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR, "libspp_inc.so"],
                           check=True, capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    i64, u8p, i64p, f64p = ctypes.c_int64, _u8p, _i64p, _f64p
    vp, dbl = ctypes.c_void_p, ctypes.c_double
    lib.spp_inc_create.restype = vp
    lib.spp_inc_create.argtypes = [
        i64, i64, i64, i64p, i64p, i64p, u8p, i64p, i64p, i64p, u8p, i64p,
        i64p, i64p, i64p, i64p, i64p, i64, i64, i64p, i64p, i64p, f64p, i64]
    lib.spp_inc_add_vtype.restype = None
    lib.spp_inc_add_vtype.argtypes = [vp, i64, i64, i64, i64, i64p, f64p]
    lib.spp_inc_add_etype.restype = None
    lib.spp_inc_add_etype.argtypes = [vp, i64, i64, i64, i64, i64, i64p,
                                      i64p, i64p, f64p, f64p, i64p, u8p,
                                      i64p]
    lib.spp_inc_set_schedule.restype = None
    lib.spp_inc_set_schedule.argtypes = [vp, i64, i64p, i64p, i64p, u8p,
                                         u8p, i64, i64, i64, dbl, i64]
    lib.spp_inc_run.restype = dbl
    lib.spp_inc_run.argtypes = [vp, ctypes.POINTER(ctypes.c_int64),
                                ctypes.POINTER(ctypes.c_int64),
                                ctypes.POINTER(ctypes.c_int64),
                                ctypes.POINTER(ctypes.c_int64)]
    lib.spp_inc_get_states.restype = None
    lib.spp_inc_get_states.argtypes = [vp, i64, f64p]
    lib.spp_inc_destroy.restype = None
    lib.spp_inc_destroy.argtypes = [vp]
    _lib = lib
    return lib


def _i64(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.int64))


def _u8(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.uint8))


def _f64(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


def _pi(a):
    return a.ctypes.data_as(_i64p)


def _pu(a):
    return a.ctypes.data_as(_u8p)


def _pf(a):
    return a.ctypes.data_as(_f64p)


class NativeReplay:
    """Builds the native engine from a FastLSolver's structures and runs
    the full replay.  Construct via `try_build` (None = unsupported)."""

    @staticmethod
    def supported(solver) -> bool:
        import numpy as _np
        from slam_plus_plus_tpu.config import device_policy
        if os.environ.get("SLAMPP_NATIVE", "auto") in ("0", "off"):
            return False
        policy = device_policy()
        if policy.platform != "cpu" or policy.dtype != _np.float64:
            return False
        if solver.refresh != "dirty" or solver.full_refresh_interval:
            return False
        if solver.config.marginals.enabled:
            return False
        asm = solver.asm
        if len(solver.chol.plan.levels) < 1:
            return False
        if not all(p.name in _EKIND for p in asm.plans):
            return False
        if not all(t in _VKIND for t in asm.type_names):
            return False
        return ensure_lib() is not None

    @staticmethod
    def try_build(solver) -> Optional["NativeReplay"]:
        if not NativeReplay.supported(solver):
            return None
        return NativeReplay(solver)

    def __init__(self, solver):
        lib = ensure_lib()
        asm = solver.asm
        plan = solver.chol.plan
        B = int(asm.Bp)
        N = int(asm.Np)
        L = len(plan.levels)
        self._keep = []  # keep numpy buffers alive

        def keep(a):
            self._keep.append(a)
            return a

        meta = keep(_i64([[lv.K, lv.K_next, lv.n, lv.n_next, lv.n_elim,
                           len(lv.u_src), len(lv.pa), len(lv.carry_src)]
                          for lv in plan.levels]).reshape(-1))
        cat = (lambda f: keep(_i64(np.concatenate(
            [np.asarray(f(lv)).ravel() for lv in plan.levels]
            or [np.zeros(0)]))))
        catu = (lambda f: keep(_u8(np.concatenate(
            [np.asarray(f(lv)).ravel() for lv in plan.levels]
            or [np.zeros(0)]))))
        elim_diag = cat(lambda lv: lv.elim_diag_idx)
        u_src = cat(lambda lv: lv.u_src)
        u_flip = catu(lambda lv: lv.u_flip)
        u_elim = cat(lambda lv: lv.u_elim)
        pa = cat(lambda lv: lv.pa)
        pb = cat(lambda lv: lv.pb)
        p_flip = catu(lambda lv: lv.p_flip)
        p_dst = cat(lambda lv: lv.p_dst)
        c_src = cat(lambda lv: lv.carry_src)
        c_dst = cat(lambda lv: lv.carry_dst)
        elim_orig = cat(lambda lv: lv.elim_orig)
        rest_orig = cat(lambda lv: lv.rest_orig)
        u_rest = cat(lambda lv: lv.u_rest_next)

        nb = int(plan.n_bottom)
        bot_idx0 = np.asarray(plan._bottom_idx)[:, 0]
        nbB = nb * B
        bot_row = keep(_i64(bot_idx0 // (nbB * B)))
        bot_col = keep(_i64((bot_idx0 % nbB) // B))
        KB = len(bot_idx0)

        diag_pos0 = keep(_i64(plan.diag_pos0))
        # tangent-dim mask per class slot
        from slam_plus_plus_tpu.models.types import VERTEX_TYPES
        p_mask = np.zeros((N, B))
        for tname in asm.type_names:
            td = min(B, VERTEX_TYPES[tname].tangent_dim)
            cs = asm.type_cslot[tname]
            p_mask[np.asarray(cs[:solver.system.vertex_stores[tname].n]),
                   :td] = 1.0
        p_mask = keep(_f64(p_mask))
        anchor = int(asm.anchor_cslot if asm.anchor_cslot is not None else -1)

        self.h = lib.spp_inc_create(
            B, N, L, _pi(meta), _pi(elim_diag), _pi(u_src), _pu(u_flip),
            _pi(u_elim), _pi(pa), _pi(pb), _pu(p_flip), _pi(p_dst),
            _pi(c_src), _pi(c_dst), _pi(elim_orig), _pi(rest_orig),
            _pi(u_rest), nb, KB, _pi(bot_row), _pi(bot_col), _pi(diag_pos0),
            _pf(p_mask), anchor)

        self._vt_names = list(asm.type_names)
        for tname in self._vt_names:
            vt = VERTEX_TYPES[tname]
            store = solver.system.vertex_stores[tname]
            csl = keep(_i64(asm.type_cslot[tname][:store.n]))
            st = keep(_f64(store.data))
            lib.spp_inc_add_vtype(ctypes.c_void_p(self.h), _VKIND[tname],
                                  vt.state_dim, vt.tangent_dim, store.n,
                                  _pi(csl), _pf(st))

        self._et_names = [p.name for p in asm.plans]
        vt_index = {t: i for i, t in enumerate(self._vt_names)}
        for p in asm.plans:
            store = solver.system.edge_stores[p.name]
            E = store.n
            sl = keep(_i64(np.stack(
                [np.asarray(a[:E]) for a in p.slot_local])))
            sc = keep(_i64(np.stack(
                [np.asarray(a[:E]) for a in p.slot_cslot])))
            sv = keep(_i64([vt_index[t] for t in p.slot_types]))
            z = keep(_f64(store.measurements[:E]))
            info = keep(_f64(store.informations[:E].reshape(E, -1)))
            pos_meta, swap_meta = solver._omega_meta[p.name]
            pos = keep(_i64(np.stack(
                [np.asarray(a[:E]) for a in pos_meta])))
            swap = keep(_u8(np.stack(
                [np.asarray(a[:E]) for a in swap_meta])))
            cab = keep(_i64([[a, b] for (a, b, _s, _w) in p.pp_contribs]
                            ).reshape(-1))
            lib.spp_inc_add_etype(
                ctypes.c_void_p(self.h), _EKIND[p.name], len(p.slot_types),
                E, store.measurements.shape[1], len(p.pp_contribs),
                _pi(sl), _pi(sc), _pi(sv), _pf(z), _pf(info), _pi(pos),
                _pu(swap), _pi(cab))

        steps = solver.steps
        et_index = {n: i for i, n in enumerate(self._et_names)}
        S = len(steps)
        max_ar = max((len(p.slot_types) for p in asm.plans), default=2)
        st_et = keep(_i64([et_index[s["ename"]] for s in steps]))
        st_li = keep(_i64([s["li"] for s in steps]))
        st_na = keep(_i64([s["n_active"] for s in steps]))
        st_cl = keep(_u8([1 if s["closure"] else 0 for s in steps]))
        nm = np.zeros((S, max_ar), dtype=np.uint8)
        for i, s in enumerate(steps):
            for (slot, _gid) in s["new_vs"]:
                nm[i, slot] = 1
        st_nm = keep(_u8(nm))
        lib.spp_inc_set_schedule(
            ctypes.c_void_p(self.h), S, _pi(st_et), _pi(st_li), _pi(st_na),
            _pu(st_cl), _pu(st_nm), max_ar, solver.every_n,
            solver.max_iterations, ctypes.c_double(solver.dx_threshold),
            1 if solver.onetime_dx else 0)
        self._lib = lib
        self._solver = solver

    def run(self):
        lib = self._lib
        it = ctypes.c_int64()
        pu = ctypes.c_int64()
        fu = ctypes.c_int64()
        so = ctypes.c_int64()
        chi2 = lib.spp_inc_run(ctypes.c_void_p(self.h), ctypes.byref(it),
                               ctypes.byref(pu), ctypes.byref(fu),
                               ctypes.byref(so))
        # write back final states
        from slam_plus_plus_tpu.models.types import VERTEX_TYPES
        for vi, tname in enumerate(self._vt_names):
            store = self._solver.system.vertex_stores[tname]
            out = np.zeros((store.n, VERTEX_TYPES[tname].state_dim))
            lib.spp_inc_get_states(ctypes.c_void_p(self.h), vi, _pf(out))
            store.states[:store.n] = out
        stats = dict(steps=len(self._solver.steps), pushes=int(pu.value),
                     full_refactors=int(fu.value), iters=int(it.value),
                     omega_steps=int(so.value))
        return float(chi2), int(it.value), stats

    def __del__(self):
        try:
            if getattr(self, "h", None):
                self._lib.spp_inc_destroy(ctypes.c_void_p(self.h))
        except Exception:
            pass
