"""Landmark-parameterization comparison — the ba_parameter_acra analogue.

Reference: src/ba_parameter_acra/MainL.cpp — experiments for the ACRA-2015
paper "The Effect of Different Parameterisations in Incremental Structure
from Motion" (Lui, Ila, Drummond, Mahony): the same incremental SfM sequence
optimized under XYZ / inverse-depth / inverse-distance landmark
parameterizations, reporting per-marker chi2 and convergence behavior.

Accelerator-native: one synthetic Sim3 sequence, three GraphSystems (one per
parameterization built from the Sim3 grid in models/sim3_types.py), each
driven by the same incremental schedule; the comparison table is the
program output.

Usage:  python -m slam_plus_plus_tpu.app.ba_parameter_acra [n_cams]
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np

import jax.numpy as jnp

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.graph.system import GraphSystem
from slam_plus_plus_tpu.manifolds import sim3
from slam_plus_plus_tpu.models.sim3_types import (_project_local,
                                                  _world_to_cam)
from slam_plus_plus_tpu.solvers.lm import LevenbergMarquardtSolver

INTR = np.array([500.0, 500.0, 320.0, 240.0, 0.0])


def make_sim3_sequence(n_cams=8, n_points=120, noise_px=0.3, seed=3):
    """Cameras on an arc observing a cloud; returns ground truth + pixel
    observations [(cam, point, uv)]."""
    rng = np.random.default_rng(seed)
    points = rng.uniform(-1.5, 1.5, (n_points, 3))
    points[:, 2] += 5.0
    cams = []
    for c in range(n_cams):
        t = np.array([0.8 * np.sin(0.3 * c), 0.05 * c, 0.4 * c * 0.1])
        aa = np.array([0.0, 0.04 * np.sin(0.5 * c), 0.0])
        cams.append(np.concatenate([t, aa, [1.0], INTR]))
    obs = []
    for c, cam in enumerate(cams):
        for p in range(n_points):
            x = np.asarray(_world_to_cam(jnp.asarray(cam),
                                         jnp.asarray(points[p])))
            if x[2] < 0.5:
                continue
            uv = np.asarray(_project_local(jnp.asarray(x), *INTR))
            if 0 <= uv[0] < 640 and 0 <= uv[1] < 480:
                obs.append((c, p, uv + rng.normal(0, noise_px, 2)))
    return cams, points, obs


def _build(param: str, cams, points, obs, rng):
    """One GraphSystem under the given landmark parameterization.

    xyz: world-frame points + edge_p2c_sim3 (the G family).
    invdepth / invdist: owner-local landmarks (first observing camera owns
    the point) with LS unary self-observation + LO other-observation edges,
    exactly the reference's incremental-SfM structure."""
    sys_ = GraphSystem()
    n_cams = len(cams)
    for c, cam in enumerate(cams):
        sys_.add_vertex(c, "cam_sim3", cam)
    info2 = np.eye(2)
    owner_of: Dict[int, int] = {}
    first_obs: Dict[int, np.ndarray] = {}
    for (c, p, uv) in obs:
        if p not in owner_of:
            owner_of[p] = c
            first_obs[p] = uv
    noisy = {p: points[p] + rng.normal(0, 0.04, 3) for p in owner_of}
    for p, own in owner_of.items():
        vid = n_cams + p
        if param == "xyz":
            sys_.add_vertex(vid, "xyz", noisy[p])
        else:
            x = np.asarray(_world_to_cam(jnp.asarray(cams[own]),
                                         jnp.asarray(noisy[p])))
            if param == "invdepth":
                sys_.add_vertex(vid, "inv_depth",
                                np.array([x[0] / x[2], x[1] / x[2],
                                          1.0 / x[2]]))
            else:
                # direction from the first OBSERVATION ray (pixel-accurate;
                # the reference's init practice — a direction derived from
                # the noisy 3D point would freeze perpendicular error into
                # the constant part of the parameterization), range from
                # the noisy point
                uv = first_obs[p]
                ray = np.array([(uv[0] - INTR[2]) / INTR[0],
                                (uv[1] - INTR[3]) / INTR[1], 1.0])
                ray /= np.linalg.norm(ray)
                sys_.add_vertex(vid, "inv_dist4",
                                np.concatenate(
                                    [ray, [1.0 / np.linalg.norm(x)]]))
    for (c, p, uv) in obs:
        vid = n_cams + p
        own = owner_of[p]
        if param == "xyz":
            sys_.add_edge("edge_p2c_sim3", (c, vid), uv, info2)
        elif c == own:
            z7 = np.concatenate([uv, INTR])
            name = ("edge_p2c_invdepth_ls_u" if param == "invdepth"
                    else "edge_p2c_invdist_ls_u")
            sys_.add_edge(name, (vid,), z7, info2)
        else:
            name = ("edge_p2c_invdepth_lo" if param == "invdepth"
                    else "edge_p2c_invdist_lo")
            sys_.add_edge(name, (own, c, vid), uv, info2)
    return sys_


def run_comparison(n_cams=8, n_points=120, seed=3, max_iters=10,
                   verbose=True) -> List[dict]:
    cams, points, obs = make_sim3_sequence(n_cams, n_points, seed=seed)
    rows = []
    for param in ("xyz", "invdepth", "invdist"):
        rng = np.random.default_rng(99)
        sys_ = _build(param, cams, points, obs, rng)
        lm = LevenbergMarquardtSolver(sys_)
        chi0 = lm.chi2()
        chi2, iters = lm.optimize(max_iters)
        rows.append(dict(param=param, n_edges=len(obs), chi2_init=chi0,
                         chi2_final=chi2, iters=iters))
    if verbose:
        print(f"# acra parameterization study: {n_cams} cams, "
              f"{n_points} points, {len(obs)} observations")
        print(f"{'param':10s} {'chi2 init':>14s} {'chi2 final':>14s} "
              f"{'iters':>6s}")
        for r in rows:
            print(f"{r['param']:10s} {r['chi2_init']:14.2f} "
                  f"{r['chi2_final']:14.4f} {r['iters']:6d}")
    return rows


if __name__ == "__main__":
    # analysis tool: reference-fidelity f64 on the host (the many small
    # per-parameterization kernels are not an accelerator-shaped workload)
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    run_comparison(n_cams=n)
