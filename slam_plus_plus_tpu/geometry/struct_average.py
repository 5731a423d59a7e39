"""Rigid 3D structure averaging from repeated observations.

Reference analogue: include/geometry/StructAverage.h
CAverage_RigidStructure::Calculate — each observation of an n-point rigid
structure is Kabsch-aligned to the first observation and the aligned point
clouds are averaged, then re-centered.

Accelerator-first shape: all observations align in ONE batched pass (vmapped
Kabsch over the observation axis) instead of the reference's sequential
per-observation loop; the SVDs are tiny 3x3 batched ops.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def _kabsch_rt(src, dst):
    """Rigid transform (R, t) minimizing ||R src + t - dst|| (one pair of
    [n, 3] clouds; the reference's CAttitudeEstimator_Kabsch role,
    include/geometry/Kabsch.h)."""
    c_s = jnp.mean(src, axis=0)
    c_d = jnp.mean(dst, axis=0)
    H = (src - c_s).T @ (dst - c_d)
    U, _s, Vt = jnp.linalg.svd(H)
    det = jnp.linalg.det(Vt.T @ U.T)
    S = jnp.diag(jnp.array([1.0, 1.0, 1.0]).astype(H.dtype))
    S = S.at[2, 2].set(det)
    R = Vt.T @ S @ U.T
    t = c_d - R @ c_s
    return R, t


def average_structure(observations):
    """observations: [n_obs, n_points, 3] repeated observations of a rigid
    structure (first observation is the alignment anchor).  Returns the
    centered average structure [n_points, 3]."""
    obs = jnp.asarray(observations)
    anchor = obs[0]

    def align(cloud):
        R, t = _kabsch_rt(cloud, anchor)
        return cloud @ R.T + t

    aligned = jax.vmap(align)(obs)
    avg = jnp.mean(aligned, axis=0)
    return avg - jnp.mean(avg, axis=0)


def average_structure_np(flat_points: np.ndarray, n_structure: int):
    """Reference-interface variant: a flat [N, 3] array holding N/n
    complete observations back to back (CAverage_RigidStructure::Calculate,
    StructAverage.h:62-112)."""
    pts = np.asarray(flat_points, dtype=np.float64)
    n_obs = len(pts) // n_structure
    obs = pts[:n_obs * n_structure].reshape(n_obs, n_structure, 3)
    return np.asarray(average_structure(obs))
