"""Schur-complement solver tests: elimination must equal the full solve.

Reference analogue: the GPU-vs-CPU verification hook
(reference src/slam/LinearSolver_Schur_GPU.cpp:58-61) — here the trusted
side is the host scipy solve of the full partitioned system.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.assembly.assembler import Assembler
from slam_plus_plus_tpu.io import datasets
from slam_plus_plus_tpu.io.parser import parse_g2o
from slam_plus_plus_tpu.linalg.host_solver import HostSparseSolver
from slam_plus_plus_tpu.linalg.schur import SchurSolver


@pytest.fixture(scope="module", params=["landmark2d", "ba"])
def system(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("schur")
    if request.param == "landmark2d":
        gp, gl, pe, le = datasets.make_landmark_2d(n_poses=60, n_landmarks=25, seed=5)
        p = str(tmp / "lm.txt")
        datasets.write_g2o_landmark_2d(p, pe, le)
    else:
        cams, pts, obs = datasets.make_ba_scene(n_cams=8, n_points=120, seed=6)
        p = str(tmp / "ba.txt")
        datasets.write_g2o_ba(p, cams, pts, obs)
    return parse_g2o(p)


def test_schur_matches_full_solve(system):
    asm = Assembler(system)
    bs = asm.assemble(asm.snapshot_states(system))
    # damp like LM does in practice: pure-GN BA is gauge-deficient (7-dof
    # mono gauge vs one identity anchor) and the comparison would be
    # dominated by null-space noise amplification
    from slam_plus_plus_tpu.solvers.lm import damp_system
    bs = damp_system(bs, float(bs.max_hdiag) * 1e-3, asm.pp_diag_ids_dev)
    schur = SchurSolver(asm)
    dx_p, dx_l = schur.solve(bs)

    host = HostSparseSolver()
    ref_p, ref_l = host.solve_partitioned(asm, bs)

    # mask out padded tangent dims (zero on both sides by construction)
    assert np.abs(np.asarray(dx_p) - ref_p).max() < 1e-6
    assert np.abs(np.asarray(dx_l) - ref_l).max() < 1e-6


def test_schur_residual(system):
    """lambda dx = eta verified directly: residual of the scalar system."""
    asm = Assembler(system)
    bs = asm.assemble(asm.snapshot_states(system))
    from slam_plus_plus_tpu.solvers.lm import damp_system
    bs = damp_system(bs, float(bs.max_hdiag) * 1e-3, asm.pp_diag_ids_dev)
    schur = SchurSolver(asm)
    dx_p, dx_l = schur.solve(bs)

    from slam_plus_plus_tpu.linalg.bsr import partitioned_to_scipy
    A = partitioned_to_scipy(
        asm.pp_rows, asm.pp_cols, np.asarray(bs.pp_blocks), asm.Np, asm.Bp,
        asm.pl_rows, asm.pl_cols, np.asarray(bs.pl_blocks),
        np.asarray(bs.ll_blocks), asm.Nl, asm.Bl)
    x = np.concatenate([np.asarray(dx_p).ravel(), np.asarray(dx_l).ravel()])
    b = np.concatenate([np.asarray(bs.eta_p).ravel(), np.asarray(bs.eta_l).ravel()])
    res = np.abs(A @ x - b).max() / max(np.abs(b).max(), 1.0)
    assert res < 1e-8


def test_host_solver_symbolic_reuse(system):
    """Repeated solves of the same sparsity pattern must reuse the cached
    fill-reducing ordering (reference keeps the symbolic factorization
    across calls, LinearSolver_UberBlock.h:272) and stay correct."""
    asm = Assembler(system)
    states = asm.snapshot_states(system)
    bs = asm.assemble(states)
    from slam_plus_plus_tpu.solvers.lm import damp_system
    bs = damp_system(bs, float(bs.max_hdiag) * 1e-3, asm.pp_diag_ids_dev)

    host = HostSparseSolver()
    p1, l1 = host.solve_partitioned(asm, bs)
    assert host._pattern_key is not None
    key_after_first = host._pattern_key
    perm = host._perm_c

    # second solve, same pattern different values: ordering must be reused
    bs2 = damp_system(bs, float(bs.max_hdiag) * 1e-2, asm.pp_diag_ids_dev)
    p2, l2 = host.solve_partitioned(asm, bs2)
    assert host._pattern_key == key_after_first
    assert host._perm_c is perm

    # correctness of the reuse path vs a fresh solver
    fresh = HostSparseSolver()
    p2f, l2f = fresh.solve_partitioned(asm, bs2)
    assert np.abs(p2 - p2f).max() < 1e-8
    assert np.abs(l2 - l2f).max() < 1e-8


def test_degree_bucketed_panels_match(tmp_path):
    """Degree-bucketed uniform panels (per-bucket M instead of the global
    max, round-3 VERDICT weak #3) are bit-identical to the unbucketed
    einsum on a skewed-degree scene."""
    import jax.numpy as jnp
    from slam_plus_plus_tpu.solvers.lm import damp_system

    cams, pts, obs = datasets.make_ba_scene(n_cams=20, n_points=300, seed=9)
    rng = np.random.default_rng(0)
    keep = [o for o in obs
            if rng.random() < (0.15 + 0.85 * (o[0] % 7 == 0))]
    p = str(tmp_path / "bk.txt")
    datasets.write_g2o_ba(p, cams, pts, keep)
    s = parse_g2o(p)
    asm = Assembler(s)
    sch = SchurSolver(asm)
    assert any(len(c.get("buckets", [])) > 1
               for c in sch._uniform_channels), "buckets did not engage"
    bs = asm.assemble(asm.snapshot_states(s))
    bs = damp_system(bs, bs.max_hdiag * jnp.asarray(1e-3, dtype=asm.dtype),
                     asm.pp_diag_ids_dev)
    dxp, dxl = sch.solve(bs)

    sch2 = SchurSolver(asm)
    for c in sch2._uniform_channels:
        c.pop("buckets", None)
    dxp2, dxl2 = sch2.solve(bs)
    assert np.abs(np.asarray(dxp) - np.asarray(dxp2)).max() < 1e-12
    assert np.abs(np.asarray(dxl) - np.asarray(dxl2)).max() < 1e-12


def test_sparse_reduced_clique_fast_path(tmp_path):
    """The uniform-layout clique einsum (gather-free pair products) must
    reproduce the generic gathered sparse-reduced solve."""
    import numpy as np
    import slam_plus_plus_tpu.models
    from slam_plus_plus_tpu.io import datasets as D
    from slam_plus_plus_tpu.io.parser import parse_g2o
    from slam_plus_plus_tpu.assembly.assembler import Assembler
    from slam_plus_plus_tpu.config import SolverConfig
    from slam_plus_plus_tpu.linalg.schur import SchurSolver

    cams, pts, obs = D.make_ba_scene_large(n_cams=24, n_points=400,
                                           obs_per_point=6, seed=5)
    p = str(tmp_path / "clq.txt")
    D.write_g2o_ba(p, cams, pts, obs)
    s = parse_g2o(p)
    asm = Assembler(s, SolverConfig())
    states = asm.snapshot_states(s)
    bs = asm.assemble(states)
    from slam_plus_plus_tpu.solvers.lm import damp_system
    bs = damp_system(bs, float(bs.max_hdiag) * 1e-3, asm.pp_diag_ids_dev)

    sch = SchurSolver(asm, sparse_reduced_limit=1)  # force sparse path
    assert sch.sparse_reduced
    assert sch._clique_uniform is not None, "uniform clique must engage"
    dx_p1, dx_l1 = sch._solve_jit(bs)

    sch._clique_uniform = None                    # generic gathered path
    import jax
    dx_p2, dx_l2 = jax.jit(sch._solve_sparse_impl)(bs)
    scale = max(float(np.abs(np.asarray(dx_p2)).max()), 1e-9)
    assert np.allclose(np.asarray(dx_p1), np.asarray(dx_p2),
                       atol=1e-8 * scale)
    assert np.allclose(np.asarray(dx_l1), np.asarray(dx_l2),
                       atol=1e-6 * max(float(np.abs(np.asarray(dx_l2)).max()), 1e-9))


def test_uniform_panels_match_segment_sum(tmp_path):
    """The one-hot einsum panels Ut and Wt equal a plain NumPy segment-sum
    construction of U (the camera-landmark blocks) and U C^-1."""
    cams, pts, obs = datasets.make_ba_scene(n_cams=7, n_points=90, seed=12)
    p = str(tmp_path / "ba.txt")
    datasets.write_g2o_ba(p, cams, pts, obs)
    system = parse_g2o(p)
    asm = Assembler(system)
    bs = asm.assemble(asm.snapshot_states(system))
    from slam_plus_plus_tpu.solvers.lm import damp_system
    bs = damp_system(bs, float(bs.max_hdiag) * 1e-3, asm.pp_diag_ids_dev)
    sch = SchurSolver(asm)
    assert sch.panel_mode == "uniform"
    _c_inv, Ut, Wt = sch._uniform_panels(bs)

    Np, Bp, Nl, Bl = asm.Np, asm.Bp, asm.Nl, asm.Bl
    blocks = np.asarray(bs.pl_blocks).reshape(-1, Bp, Bl)
    U = np.zeros((Np, Nl, Bp, Bl))
    np.add.at(U, (asm.pl_rows, asm.pl_cols), blocks[:len(asm.pl_rows)])
    U = U.transpose(0, 2, 1, 3).reshape(Np * Bp, Nl * Bl)
    C = np.asarray(bs.ll_blocks).reshape(Nl, Bl, Bl)
    cinv = np.zeros((Nl * Bl, Nl * Bl))
    for li in range(Nl):
        cinv[li * Bl:(li + 1) * Bl, li * Bl:(li + 1) * Bl] = \
            np.linalg.inv(C[li])
    W = U @ cinv
    scale = np.abs(U).max()
    assert np.abs(np.asarray(Ut) - U.T).max() < 1e-9 * scale
    assert np.abs(np.asarray(Wt) - W.T).max() < 1e-9 * np.abs(W).max()
