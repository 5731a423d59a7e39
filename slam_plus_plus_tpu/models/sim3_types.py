"""Sim(3) incremental-SfM types (reference include/slam/Sim3_Types.h).

Round-1 subset: the Sim3 camera vertex, Sim3 pose-pose edge, and the XYZ
"other-observing" reprojection edge — the core of the incremental-BA-3dv
pipeline.  The reference declares ~30 edge permutations ({XYZ, InvDepth,
InvDist} x {self, other} x {with/without intrinsics} x {pixel/angle error},
Sim3_Types.h:247-3598); the remaining permutations are follow-on work and
share all math below.

Conventions:
  * cam_sim3 vertex stores 12: [t(3) aa(3) s(1)] (world->camera Sim3, tRs) +
    intrinsics [fx fy cx cy d'] (Sim3_Types.h:178 CVertexCamSim3); tangent 7,
    ⊞ composes with Exp of the sim(3) delta;
  * reprojection: point transformed by the camera Sim3 then pinhole+radial
    projection identical to the BA path.
"""

from __future__ import annotations

import jax.numpy as jnp

from slam_plus_plus_tpu.manifolds import sim3, so3
from slam_plus_plus_tpu.models.types import edge_type, vertex_type


def _cam_sim3_boxplus(x, dx):
    return jnp.concatenate([sim3.boxplus(x[:7], dx), x[7:]])


CAM_SIM3 = vertex_type("cam_sim3", 12, 7, _cam_sim3_boxplus, schur_class="pose")
SIM3_POSE = vertex_type("sim3_pose", 7, 7, sim3.boxplus, schur_class="pose")
# inverse-depth (3D: [u, v, inv_depth] in owner frame) and inverse-distance
# (1D) landmarks for the LS/LO edge families
INV_DEPTH = vertex_type("inv_depth", 3, 3, lambda x, dx: x + dx,
                        schur_class="landmark")
INV_DIST = vertex_type("inv_dist", 1, 1, lambda x, dx: x + dx,
                       schur_class="landmark")


def _project_sim3(cam_state, point_world):
    """Transform by the world->camera Sim3, then pinhole + radial distortion
    (same pixel-space distortion as the BA path)."""
    x = sim3.transform_point(cam_state[:7], point_world)
    fx, fy, cx, cy, d = (cam_state[7], cam_state[8], cam_state[9],
                         cam_state[10], cam_state[11])
    k = d / (0.5 * (fx + fy))
    inv_z = 1.0 / x[2]
    u = fx * x[0] * inv_z + cx
    v = fy * x[1] * inv_z + cy
    du, dv = u - cx, v - cy
    w = 1.0 + k * (du * du + dv * dv)
    return jnp.stack([cx + w * du, cy + w * dv])


def _p2c_sim3_residual(states, z):
    cam_state, point = states
    return z - _project_sim3(cam_state, point)


EDGE_P2C_SIM3 = edge_type("edge_p2c_sim3", ("cam_sim3", "xyz"), 2, 2,
                          _p2c_sim3_residual)


def _pose_cam_sim3_residual(states, z):
    """Sim3 pose-pose edge (CEdgePoseCamSim3): r = log(z^-1 * (x0^-1 x1))."""
    x0, x1 = states
    rel = sim3.relative_to(x0[:7], x1[:7])
    z_sim = jnp.concatenate([z[:3], z[3:6], z[6:7]])
    err = sim3.compose(sim3.inverse(z_sim), rel)
    return sim3.log(err)


EDGE_POSE_CAM_SIM3 = edge_type("edge_pose_cam_sim3", ("cam_sim3", "cam_sim3"),
                               7, 7, _pose_cam_sim3_residual)


def _invdepth_to_world(owner_cam_state, lm):
    """Inverse-depth landmark [u_n, v_n, q]: the point at normalized image
    coords (u_n, v_n) and depth 1/q in the *owner* camera, mapped to world."""
    q = jnp.maximum(jnp.abs(lm[2]), 1e-12) * jnp.sign(jnp.where(lm[2] == 0, 1.0, lm[2]))
    p_cam = jnp.concatenate([lm[:2], jnp.ones(1)]) / q
    cam_to_world = sim3.inverse(owner_cam_state[:7])
    return sim3.transform_point(cam_to_world, p_cam)


def _p2c_invdepth_lo_residual(states, z):
    """Other-observing inverse-depth edge: landmark owned by cam0, observed
    by cam1 (LO family, Sim3_Types.h)."""
    owner, observer, lm = states
    pw = _invdepth_to_world(owner, lm)
    return z - _project_sim3(observer, pw)


EDGE_P2C_INVDEPTH_LO = edge_type(
    "edge_p2c_invdepth_lo", ("cam_sim3", "cam_sim3", "inv_depth"), 2, 2,
    _p2c_invdepth_lo_residual)


def _p2c_invdepth_ls_residual(states, z):
    """Self-observing inverse-depth edge: projecting into the owner itself
    (LS family) — the residual only depends on (u_n, v_n)."""
    owner, lm = states
    pw = _invdepth_to_world(owner, lm)
    return z - _project_sim3(owner, pw)


EDGE_P2C_INVDEPTH_LS = edge_type("edge_p2c_invdepth_ls", ("cam_sim3", "inv_depth"),
                                 2, 2, _p2c_invdepth_ls_residual)


def _p2c_xyz_ls_residual(states, z):
    """Self-observing XYZ edge (LS family): project a world point into the
    owner camera itself (Sim3_Types.h LS variants)."""
    owner, lm = states
    return z - _project_sim3(owner, lm)


EDGE_P2C_XYZ_LS = edge_type("edge_p2c_xyz_ls", ("cam_sim3", "xyz"), 2, 2,
                            _p2c_xyz_ls_residual)


# inverse-distance landmarks: state [dx, dy, dz, q] — a unit-ish direction in
# the OWNER camera frame (constant after init) and the optimized inverse
# distance q; tangent is 1-dof (reference CVertexInvDist, Sim3_Types.h:102,
# stores the direction as a constant alongside the 1D state)
INV_DIST4 = vertex_type("inv_dist4", 4, 1,
                        lambda x, dx: jnp.concatenate([x[:3], x[3:] + dx]),
                        schur_class="landmark")


def _invdist_to_world(owner_cam_state, lm):
    q = lm[3]
    sign = jnp.where(q == 0, 1.0, jnp.sign(q))
    q = sign * jnp.maximum(jnp.abs(q), 1e-12)
    p_cam = lm[:3] / q
    cam_to_world = sim3.inverse(owner_cam_state[:7])
    return sim3.transform_point(cam_to_world, p_cam)


def _p2c_invdist_lo_residual(states, z):
    owner, observer, lm = states
    return z - _project_sim3(observer, _invdist_to_world(owner, lm))


EDGE_P2C_INVDIST_LO = edge_type(
    "edge_p2c_invdist_lo", ("cam_sim3", "cam_sim3", "inv_dist4"), 2, 2,
    _p2c_invdist_lo_residual)


def _p2c_invdist_ls_residual(states, z):
    owner, lm = states
    return z - _project_sim3(owner, _invdist_to_world(owner, lm))


EDGE_P2C_INVDIST_LS = edge_type(
    "edge_p2c_invdist_ls", ("cam_sim3", "inv_dist4"), 2, 2,
    _p2c_invdist_ls_residual)


def _project_sim3_intr(cam_state, intr, point_world):
    """Projection with a separate intrinsics vertex (the 'I' variants)."""
    x = sim3.transform_point(cam_state[:7], point_world)
    fx, fy, cx, cy, d = intr[0], intr[1], intr[2], intr[3], intr[4]
    k = d / (0.5 * (fx + fy))
    inv_z = 1.0 / x[2]
    u = fx * x[0] * inv_z + cx
    v = fy * x[1] * inv_z + cy
    du, dv = u - cx, v - cy
    w = 1.0 + k * (du * du + dv * dv)
    return jnp.stack([cx + w * du, cy + w * dv])


def _p2ci_xyz_lo_residual(states, z):
    cam, lm, intr = states
    return z - _project_sim3_intr(cam, intr, lm)


EDGE_P2CI_XYZ_SIM3 = edge_type(
    "edge_p2ci_xyz_sim3", ("cam_sim3", "xyz", "intrinsics"), 2, 2,
    _p2ci_xyz_lo_residual)


# ======================================================================
# the full reference edge grid: {XYZ, InvDepth, InvDist} landmarks x
# {G: world-frame, LS: owner-local self-observation, LO: owner-local
# other-observation} frames x {P2C: intrinsics from the camera vertex /
# baked, P2CI: separate optimized intrinsics vertex} x {pixel, angle}
# error (reference include/slam/Sim3_Types.h:247-3598, 27 edge classes).
#
# Landmark parameterization converters (Sim3SolverBase.h:455-514):
#   inv_depth [u, v, q]   -> camera/world xyz [u/q, v/q, 1/q]
#   inv_dist4 [dx,dy,dz,q]-> xyz dir/q (direction constant, q optimized)
# ======================================================================


def _safe_q(q):
    sign = jnp.where(q == 0, 1.0, jnp.sign(q))
    return sign * jnp.maximum(jnp.abs(q), 1e-12)


def _invdepth_to_xyz(lm):
    return jnp.concatenate([lm[:2], jnp.ones(1)]) / _safe_q(lm[2])


def _invdist4_to_xyz(lm):
    return lm[:3] / _safe_q(lm[3])


def _project_local(x, fx, fy, cx, cy, d):
    """Pinhole + pixel-space radial distortion of a camera-frame point."""
    k = d / (0.5 * (fx + fy))
    inv_z = 1.0 / x[2]
    u = fx * x[0] * inv_z + cx
    v = fy * x[1] * inv_z + cy
    du, dv = u - cx, v - cy
    w = 1.0 + k * (du * du + dv * dv)
    return jnp.stack([cx + w * du, cy + w * dv])


def _angle_err3(x_cam, z, fx, fy, cx, cy, d):
    """Reference *_AngleErr residual (Sim3SolverBase.h:2920-2965): the
    CROSS PRODUCT of the normalized predicted ray and the normalized
    undistorted observation ray — a 3-vector whose norm is sin(angle).
    Replicates the reference's k = d / (.5 * fx * fy) quirk ("SOSO: works
    better for mono") and the fixed-point radial undistortion."""
    k = d / (0.5 * fx * fy)
    duv = z - jnp.stack([cx, cy])
    # invert w(r) * duv = duv_obs by fixed point (r converges fast, k small)
    dud = duv
    for _ in range(5):
        r2 = jnp.sum(dud * dud)
        dud = duv / (1.0 + k * r2)
    x_inv = jnp.stack([dud[0] / fx, dud[1] / fy, jnp.ones(())])
    a = x_cam / jnp.linalg.norm(x_cam)
    b = x_inv / jnp.linalg.norm(x_inv)
    return jnp.cross(a, b)


def _world_to_cam(cam_state, pw):
    return sim3.transform_point(cam_state[:7], pw)


def _local_to_cam(owner, observer, p_local):
    """Owner-local point seen from the observer: world = owner^-1 o local
    (our storage is world->camera, matching _invdepth_to_world)."""
    pw = sim3.transform_point(sim3.inverse(owner[:7]), p_local)
    return sim3.transform_point(observer[:7], pw)


def _intr_of(cam_state):
    return (cam_state[7], cam_state[8], cam_state[9], cam_state[10],
            cam_state[11])


def _z_intr(z):
    """LS unary edges carry the (constant) owner intrinsics baked into the
    measurement tail [u, v, fx, fy, cx, cy, d] — this registry's
    equivalent of the reference's constant m_p_camera pointer
    (Sim3_Types.h:732: 'This is needed for the intrinsics')."""
    return z[:2], (z[2], z[3], z[4], z[5], z[6])


# ---- G family: world-frame landmarks ---------------------------------

def _p2c_invdepth_g(states, z):
    lm, cam = states
    return z - _project_local(_world_to_cam(cam, _invdepth_to_xyz(lm)),
                              *_intr_of(cam))


EDGE_P2C_INVDEPTH_G = edge_type("edge_p2c_invdepth_g",
                                ("inv_depth", "cam_sim3"), 2, 2,
                                _p2c_invdepth_g)


def _p2c_invdist_g(states, z):
    lm, cam = states
    return z - _project_local(_world_to_cam(cam, _invdist4_to_xyz(lm)),
                              *_intr_of(cam))


EDGE_P2C_INVDIST_G = edge_type("edge_p2c_invdist_g",
                               ("inv_dist4", "cam_sim3"), 2, 2,
                               _p2c_invdist_g)


def _p2ci_invdepth_g(states, z):
    lm, cam, intr = states
    return z - _project_local(_world_to_cam(cam, _invdepth_to_xyz(lm)),
                              intr[0], intr[1], intr[2], intr[3], intr[4])


EDGE_P2CI_INVDEPTH_G = edge_type("edge_p2ci_invdepth_g",
                                 ("inv_depth", "cam_sim3", "intrinsics"),
                                 2, 2, _p2ci_invdepth_g)


# ---- LS family: owner-local landmarks, self-observation --------------
# Faithful to the reference these are UNARY in the landmark (the owner pose
# cancels out of its own observation; Sim3_Types.h:726 "note that this is a
# unary edge"); intrinsics ride the measurement (P2C) or a vertex (P2CI).

def _p2c_xyz_ls_unary(states, z7):
    (lm,) = states
    z, intr = _z_intr(z7)
    return z - _project_local(lm, *intr)


EDGE_P2C_XYZ_LS_U = edge_type("edge_p2c_xyz_ls_u", ("xyz",), 2, 7,
                              _p2c_xyz_ls_unary)


def _p2c_invdepth_ls_unary(states, z7):
    (lm,) = states
    z, intr = _z_intr(z7)
    return z - _project_local(_invdepth_to_xyz(lm), *intr)


EDGE_P2C_INVDEPTH_LS_U = edge_type("edge_p2c_invdepth_ls_u", ("inv_depth",),
                                   2, 7, _p2c_invdepth_ls_unary)


def _p2c_invdist_ls_unary(states, z7):
    (lm,) = states
    z, intr = _z_intr(z7)
    return z - _project_local(_invdist4_to_xyz(lm), *intr)


EDGE_P2C_INVDIST_LS_U = edge_type("edge_p2c_invdist_ls_u", ("inv_dist4",),
                                  2, 7, _p2c_invdist_ls_unary)


def _p2ci_xyz_ls(states, z):
    lm, intr = states
    return z - _project_local(lm, intr[0], intr[1], intr[2], intr[3],
                              intr[4])


EDGE_P2CI_XYZ_LS = edge_type("edge_p2ci_xyz_ls", ("xyz", "intrinsics"),
                             2, 2, _p2ci_xyz_ls)


def _p2ci_invdepth_ls(states, z):
    lm, intr = states
    return z - _project_local(_invdepth_to_xyz(lm), intr[0], intr[1],
                              intr[2], intr[3], intr[4])


EDGE_P2CI_INVDEPTH_LS = edge_type("edge_p2ci_invdepth_ls",
                                  ("inv_depth", "intrinsics"), 2, 2,
                                  _p2ci_invdepth_ls)


# ---- LO family: owner-local landmarks, other-observation -------------

def _p2c_xyz_lo(states, z):
    owner, observer, lm = states
    return z - _project_local(_local_to_cam(owner, observer, lm),
                              *_intr_of(observer))


EDGE_P2C_XYZ_LO = edge_type("edge_p2c_xyz_lo",
                            ("cam_sim3", "cam_sim3", "xyz"), 2, 2,
                            _p2c_xyz_lo)


def _p2ci_xyz_lo(states, z):
    owner, observer, lm, intr = states
    return z - _project_local(_local_to_cam(owner, observer, lm),
                              intr[0], intr[1], intr[2], intr[3], intr[4])


EDGE_P2CI_XYZ_LO = edge_type(
    "edge_p2ci_xyz_lo", ("cam_sim3", "cam_sim3", "xyz", "intrinsics"),
    2, 2, _p2ci_xyz_lo)


def _p2ci_invdepth_lo(states, z):
    owner, observer, lm, intr = states
    return z - _project_local(
        _local_to_cam(owner, observer, _invdepth_to_xyz(lm)),
        intr[0], intr[1], intr[2], intr[3], intr[4])


EDGE_P2CI_INVDEPTH_LO = edge_type(
    "edge_p2ci_invdepth_lo",
    ("cam_sim3", "cam_sim3", "inv_depth", "intrinsics"), 2, 2,
    _p2ci_invdepth_lo)


# ---- Landmark family: direct 3D observation of the landmark ----------
# (reference CEdgeLandmark_*_Sim3_{LS,LO}, Sim3_Types.h:2129-2610)

def _landmark_xyz_ls(states, z):
    (lm,) = states
    return z - lm


EDGE_LANDMARK_XYZ_LS = edge_type("edge_landmark_xyz_ls", ("xyz",), 3, 3,
                                 _landmark_xyz_ls)


def _landmark_xyz_lo(states, z):
    owner, observer, lm = states
    return z - _local_to_cam(owner, observer, lm)


EDGE_LANDMARK_XYZ_LO = edge_type("edge_landmark_xyz_lo",
                                 ("cam_sim3", "cam_sim3", "xyz"), 3, 3,
                                 _landmark_xyz_lo)


def _landmark_invdepth_ls(states, z):
    (lm,) = states
    return z - _invdepth_to_xyz(lm)


EDGE_LANDMARK_INVDEPTH_LS = edge_type("edge_landmark_invdepth_ls",
                                      ("inv_depth",), 3, 3,
                                      _landmark_invdepth_ls)


def _landmark_invdepth_lo(states, z):
    owner, observer, lm = states
    return z - _local_to_cam(owner, observer, _invdepth_to_xyz(lm))


EDGE_LANDMARK_INVDEPTH_LO = edge_type(
    "edge_landmark_invdepth_lo", ("cam_sim3", "cam_sim3", "inv_depth"),
    3, 3, _landmark_invdepth_lo)


# ---- AngleErr family (3D cross-product residual) ---------------------

def _p2c_xyz_angle(states, z):
    cam, lm = states
    return _angle_err3(_world_to_cam(cam, lm), z, *_intr_of(cam))


EDGE_P2C_XYZ_ANGLE = edge_type("edge_p2c_xyz_angle", ("cam_sim3", "xyz"),
                               3, 2, _p2c_xyz_angle)


def _p2ci_xyz_angle(states, z):
    cam, lm, intr = states
    return _angle_err3(_world_to_cam(cam, lm), z, intr[0], intr[1],
                       intr[2], intr[3], intr[4])


EDGE_P2CI_XYZ_ANGLE = edge_type("edge_p2ci_xyz_angle",
                                ("cam_sim3", "xyz", "intrinsics"), 3, 2,
                                _p2ci_xyz_angle)


def _p2c_invdepth_angle(states, z):
    cam, lm = states
    return _angle_err3(_world_to_cam(cam, _invdepth_to_xyz(lm)), z,
                       *_intr_of(cam))


EDGE_P2C_INVDEPTH_ANGLE = edge_type("edge_p2c_invdepth_angle",
                                    ("cam_sim3", "inv_depth"), 3, 2,
                                    _p2c_invdepth_angle)


def _p2ci_invdepth_angle(states, z):
    cam, lm, intr = states
    return _angle_err3(_world_to_cam(cam, _invdepth_to_xyz(lm)), z,
                       intr[0], intr[1], intr[2], intr[3], intr[4])


EDGE_P2CI_INVDEPTH_ANGLE = edge_type(
    "edge_p2ci_invdepth_angle", ("cam_sim3", "inv_depth", "intrinsics"),
    3, 2, _p2ci_invdepth_angle)


def _p2ci_xyz_angle_ls(states, z):
    lm, intr = states
    return _angle_err3(lm, z, intr[0], intr[1], intr[2], intr[3], intr[4])


EDGE_P2CI_XYZ_ANGLE_LS = edge_type("edge_p2ci_xyz_angle_ls",
                                   ("xyz", "intrinsics"), 3, 2,
                                   _p2ci_xyz_angle_ls)


def _p2ci_xyz_angle_lo(states, z):
    owner, observer, lm, intr = states
    return _angle_err3(_local_to_cam(owner, observer, lm), z,
                       intr[0], intr[1], intr[2], intr[3], intr[4])


EDGE_P2CI_XYZ_ANGLE_LO = edge_type(
    "edge_p2ci_xyz_angle_lo",
    ("cam_sim3", "cam_sim3", "xyz", "intrinsics"), 3, 2,
    _p2ci_xyz_angle_lo)


def _p2ci_invdepth_angle_ls(states, z):
    lm, intr = states
    return _angle_err3(_invdepth_to_xyz(lm), z, intr[0], intr[1], intr[2],
                       intr[3], intr[4])


EDGE_P2CI_INVDEPTH_ANGLE_LS = edge_type(
    "edge_p2ci_invdepth_angle_ls", ("inv_depth", "intrinsics"), 3, 2,
    _p2ci_invdepth_angle_ls)


def _p2ci_invdepth_angle_lo(states, z):
    owner, observer, lm, intr = states
    return _angle_err3(
        _local_to_cam(owner, observer, _invdepth_to_xyz(lm)), z,
        intr[0], intr[1], intr[2], intr[3], intr[4])


EDGE_P2CI_INVDEPTH_ANGLE_LO = edge_type(
    "edge_p2ci_invdepth_angle_lo",
    ("cam_sim3", "cam_sim3", "inv_depth", "intrinsics"), 3, 2,
    _p2ci_invdepth_angle_lo)
