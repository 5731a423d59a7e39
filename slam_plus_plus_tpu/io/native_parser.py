"""ctypes binding for the native C++ g2o reader (native/g2o_reader.cpp).

The native reader tokenizes + float-parses the whole file at C++ speed and
returns columnar (kind, ids, values) records; this module applies the same
conventions as io/parser.py to build the GraphSystem — bulk-vectorized for
the hot tokens (VERTEX_CAM / VERTEX_XYZ / EDGE_P2C dominate venice-scale BA
files), per-record for the rare ones.

``parse_g2o_fast(path)`` transparently falls back to the pure-Python parser
when the shared library is unavailable (it is built on demand with make).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from slam_plus_plus_tpu.graph.system import GraphSystem
from slam_plus_plus_tpu.io import parser as pyparser

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libspp_native.so")

# token kinds — keep in sync with native/g2o_reader.cpp
(TK_UNKNOWN, TK_VERTEX2, TK_EDGE2, TK_LANDMARK2_XY, TK_LANDMARK2_RB,
 TK_VERTEX3, TK_EDGE3, TK_EDGE3_AXISANGLE, TK_VERTEX_XYZ, TK_LANDMARK3_XYZ,
 TK_VERTEX_CAM, TK_VERTEX_INTRINSICS, TK_VERTEX_SCAM, TK_VERTEX_SPHERON,
 TK_EDGE_P2C, TK_EDGE_P2CI, TK_EDGE_P2SC, TK_EDGE_SPHERON_XYZ,
 TK_ROCV_TRANSMITTER, TK_ROCV_TRANSMITTER_UF, TK_ROCV_RECEIVER,
 TK_ROCV_DELTA_TIME, TK_ROCV_RANGE, TK_CONSISTENCY_MARKER, TK_EQUIV,
 TK_COUNT) = range(26)

_lib = None


def ensure_lib() -> Optional[ctypes.CDLL]:
    """Load (building on demand) the native reader; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR, "libspp_native.so"],
                           check=True, capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.spp_parse.restype = ctypes.c_void_p
    lib.spp_parse.argtypes = [ctypes.c_char_p]
    lib.spp_num_records.restype = ctypes.c_int64
    lib.spp_num_records.argtypes = [ctypes.c_void_p]
    lib.spp_num_values.restype = ctypes.c_int64
    lib.spp_num_values.argtypes = [ctypes.c_void_p]
    lib.spp_copy_records.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.spp_copy_values.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.spp_stat.restype = ctypes.c_int64
    lib.spp_stat.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.spp_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def read_records(path: str):
    """(records [N,6] int32, values flat f64, stats) or None."""
    lib = ensure_lib()
    if lib is None:
        return None
    h = lib.spp_parse(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        n = lib.spp_num_records(h)
        nv = lib.spp_num_values(h)
        records = np.empty((n, 6), dtype=np.int32)
        values = np.empty(nv, dtype=np.float64)
        if n:
            lib.spp_copy_records(h, records.ctypes.data_as(ctypes.c_void_p))
        if nv:
            lib.spp_copy_values(h, values.ctypes.data_as(ctypes.c_void_p))
        stats = dict(lines=lib.spp_stat(h, 0), unknown=lib.spp_stat(h, 1),
                     truncated=lib.spp_stat(h, 2))
        return records, values, stats
    finally:
        lib.spp_free(h)


def _vals(records, values, rows, n):
    """Gather n doubles per row: [len(rows), n]."""
    off = records[rows, 5]
    idx = off[:, None] + np.arange(n)[None, :]
    return values[idx]


def _sym_from_upper_bulk(ut, n):
    """[K, n(n+1)/2] upper listings -> [K, n, n] symmetric."""
    K = len(ut)
    m = np.zeros((K, n, n))
    k = 0
    for i in range(n):
        for j in range(i, n):
            m[:, i, j] = ut[:, k]
            m[:, j, i] = ut[:, k]
            k += 1
    return m


def _invert_cam_pose_bulk(pos, q_xyzw):
    """Vectorized VERTEX_CAM world-pose inversion (parser._invert_cam_pose)."""
    q = q_xyzw / np.linalg.norm(q_xyzw, axis=1, keepdims=True)
    qx, qy, qz, qw = -q[:, 0], -q[:, 1], -q[:, 2], q[:, 3]  # conjugate
    p = -pos
    u = np.stack([qx, qy, qz], axis=1)
    uv = np.cross(u, p)
    uuv = np.cross(u, uv)
    t = p + 2 * (qw[:, None] * uv + uuv)
    # quat -> axis-angle (w>=0 wrap)
    flip = qw < 0
    qw = np.where(flip, -qw, qw)
    u = np.where(flip[:, None], -u, u)
    vn = np.linalg.norm(u, axis=1)
    angle = 2.0 * np.arctan2(vn, qw)
    scale = np.where(vn < 1e-12, 0.0, angle / np.maximum(vn, 1e-30))
    aa = u * scale[:, None]
    return np.concatenate([t, aa], axis=1)


_BULK_KINDS = (TK_VERTEX_CAM, TK_VERTEX_XYZ, TK_EDGE_P2C)


def parse_g2o_fast(path: str, system: Optional[GraphSystem] = None,
                   on_edge=None, on_marker=None,
                   use_vertex_init: bool = False) -> GraphSystem:
    """Native-reader parse; falls back to the pure-Python parser when the
    native library is unavailable or per-edge callbacks are requested."""
    if on_edge is not None or on_marker is not None:
        return pyparser.parse_g2o(path, system, on_edge, on_marker,
                                  use_vertex_init)
    out = read_records(path)
    if out is None:
        return pyparser.parse_g2o(path, system, on_edge, on_marker,
                                  use_vertex_init)
    records, values, stats = out
    if system is None:
        system = GraphSystem()

    kinds = records[:, 0]
    present = set(np.unique(kinds).tolist())
    is_ba = bool(present & {TK_VERTEX_CAM, TK_VERTEX_INTRINSICS,
                            TK_VERTEX_SCAM, TK_VERTEX_SPHERON, TK_EDGE_P2C,
                            TK_EDGE_P2CI, TK_EDGE_P2SC, TK_EDGE_SPHERON_XYZ})

    # ---- bulk fast path: contiguous runs of hot tokens -----------------
    i = 0
    N = len(records)
    while i < N:
        k = kinds[i]
        j = i + 1
        while j < N and kinds[j] == k:
            j += 1
        run = np.arange(i, j)
        if k == TK_VERTEX_CAM and is_ba:
            v = _vals(records, values, run, 12)
            pose = _invert_cam_pose_bulk(v[:, 0:3], v[:, 3:7])
            intr = v[:, 7:12].copy()
            intr[:, 4] *= 0.5 * (intr[:, 0] + intr[:, 1])  # d * mean focal
            system.bulk_add_vertices("cam", records[run, 1],
                                     np.concatenate([pose, intr], axis=1))
        elif k == TK_VERTEX_XYZ and is_ba:
            system.bulk_add_vertices("xyz", records[run, 1],
                                     _vals(records, values, run, 3))
        elif k == TK_EDGE_P2C:
            v = _vals(records, values, run, 5)
            info = _sym_from_upper_bulk(v[:, 2:5], 2)
            # file order: <point> <cam>; internal slot order: (cam, point)
            vids = np.stack([records[run, 2], records[run, 1]], axis=1)
            system.bulk_add_edges("edge_p2c", vids, v[:, 0:2], info)
        else:
            # rare tokens: route each record through the python parser's
            # single-line semantics by reconstructing the minimal dispatch
            for r in run:
                _dispatch_record(system, records[r], values, is_ba,
                                 use_vertex_init)
        i = j

    stats_obj = pyparser.ParseStats()
    stats_obj.lines = int(stats["lines"])
    stats_obj.edges = sum(s.n for s in system.edge_stores.values())
    stats_obj.vertices = len(system.vertex_order)
    system.parse_stats = stats_obj
    return system


def _dispatch_record(system, rec, values, is_ba, use_vertex_init):
    """Single-record dispatch mirroring io/parser.py conventions."""
    k = rec[0]
    ids = rec[1:4]
    off = rec[5]
    nv = rec[4]
    v = values[off:off + nv]

    if k == TK_VERTEX2:
        if use_vertex_init:
            system.add_vertex(int(ids[0]), "pose2d", v[:3])
    elif k == TK_EDGE2:
        info = pyparser._sym_from_upper(list(v[3:9]), 3)
        system.add_edge("edge_pose2d", (int(ids[0]), int(ids[1])), v[:3], info)
    elif k == TK_LANDMARK2_XY:
        from slam_plus_plus_tpu.models import se2_types
        z, info = se2_types.xy_measurement_to_polar(v[:2])
        system.add_edge("edge_pose_landmark2d", (int(ids[0]), int(ids[1])),
                        z, info)
    elif k == TK_LANDMARK2_RB:
        info = pyparser._sym_from_upper(list(v[2:5]), 2)
        system.add_edge("edge_pose_landmark2d", (int(ids[0]), int(ids[1])),
                        v[:2], info)
    elif k == TK_VERTEX3:
        if use_vertex_init:
            aa = pyparser._rpy_to_axis_angle(v[3], v[4], v[5])
            system.add_vertex(int(ids[0]), "pose3d",
                              np.concatenate([v[:3], aa]))
    elif k == TK_EDGE3:
        aa = pyparser._rpy_to_axis_angle(v[3], v[4], v[5])
        z = np.concatenate([v[:3], aa])
        info = pyparser._sym_from_upper(list(v[6:27]), 6)
        system.add_edge("edge_pose3d", (int(ids[0]), int(ids[1])), z, info)
    elif k == TK_EDGE3_AXISANGLE:
        info = pyparser._sym_from_upper(list(v[6:27]), 6)
        system.add_edge("edge_pose3d", (int(ids[0]), int(ids[1])), v[:6], info)
    elif k == TK_VERTEX_XYZ:
        if is_ba:
            system.add_vertex(int(ids[0]), "xyz", v[:3])
    elif k == TK_LANDMARK3_XYZ:
        info = pyparser._sym_from_upper(list(v[3:9]), 3)
        system.add_edge("edge_pose_landmark3d", (int(ids[0]), int(ids[1])),
                        v[:3], info)
    elif k == TK_VERTEX_CAM:
        pose = pyparser._invert_cam_pose(v[0:3], v[3], v[4], v[5], v[6])
        fx, fy, cx, cy, d = v[7:12]
        system.add_vertex(int(ids[0]), "cam", np.concatenate(
            [pose, [fx, fy, cx, cy, d * 0.5 * (fx + fy)]]))
    elif k == TK_VERTEX_INTRINSICS:
        fx, fy, cx, cy, d = v[:5]
        system.add_vertex(int(ids[0]), "intrinsics",
                          np.array([fx, fy, cx, cy, d * 0.5 * (fx + fy)]))
    elif k == TK_VERTEX_SCAM:
        pose = pyparser._invert_cam_pose(v[0:3], v[3], v[4], v[5], v[6])
        fx, fy, cx, cy, d, b = v[7:13]
        system.add_vertex(int(ids[0]), "scam", np.concatenate(
            [pose, [fx, fy, cx, cy, d * 0.5 * (fx + fy), b]]))
    elif k == TK_VERTEX_SPHERON:
        pose = pyparser._invert_cam_pose(v[0:3], v[3], v[4], v[5], v[6])
        system.add_vertex(int(ids[0]), "spheron", pose)
    elif k == TK_EDGE_P2C:
        info = pyparser._sym_from_upper(list(v[2:5]), 2)
        system.add_edge("edge_p2c", (int(ids[1]), int(ids[0])), v[:2], info)
    elif k == TK_EDGE_P2CI:
        info = pyparser._sym_from_upper(list(v[2:5]), 2)
        system.add_edge("edge_p2ci", (int(ids[1]), int(ids[0]), int(ids[2])),
                        v[:2], info)
    elif k == TK_EDGE_P2SC:
        info = pyparser._sym_from_upper(list(v[3:9]), 3)
        system.add_edge("edge_p2sc", (int(ids[1]), int(ids[0])), v[:3], info)
    elif k == TK_EDGE_SPHERON_XYZ:
        info = pyparser._sym_from_upper(list(v[3:9]), 3)
        system.add_edge("edge_spheron_xyz", (int(ids[1]), int(ids[0])),
                        v[:3], info)
    elif k == TK_ROCV_TRANSMITTER:
        system.add_vertex(int(ids[0]), "landmark3d", v[:3])
    elif k == TK_ROCV_TRANSMITTER_UF:
        F = pyparser._sym_from_upper(list(v[:6]), 3)
        system.add_edge("edge_landmark3d_prior", (int(ids[0]),),
                        np.zeros(3), F)
    elif k == TK_ROCV_RECEIVER:
        system.add_vertex(int(ids[0]), "pos_vel3d", v[:6])
    elif k == TK_ROCV_DELTA_TIME:
        info = pyparser._sym_from_upper(list(v[1:22]), 6)
        system.add_edge("edge_rocv_const_vel", (int(ids[0]), int(ids[1])),
                        v[:1], info)
    elif k == TK_ROCV_RANGE:
        system.add_edge("edge_rocv_range", (int(ids[0]), int(ids[1])),
                        v[:1], np.array([[v[1]]]))
    # markers / EQUIV: no-op on the non-callback path
