#!/usr/bin/env python
"""Stage profile of the venice-real LM iteration on the default device.

Times the sparse-reduced Schur solve's pieces (gathers, pair products,
segment-sums, reduced factor) and the LM bookkeeping (assembly, chi2)
standalone, to attribute the per-iteration time.

    python scripts/prof_venice.py
"""
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import jax
    import jax.numpy as jnp
    from slam_plus_plus_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import slam_plus_plus_tpu.models  # noqa: F401
    from slam_plus_plus_tpu.io.parser import parse_g2o
    from slam_plus_plus_tpu.solvers.lm import LevenbergMarquardtSolver
    from slam_plus_plus_tpu.ops import planar

    print("backend:", jax.default_backend(), flush=True)
    from slam_plus_plus_tpu.io import datasets as D
    path = os.path.join(tempfile.mkdtemp(prefix="prof_venice_"),
                        "venice_real.g2o")
    D.write_g2o_ba(path, *D.make_ba_scene_large(
        n_cams=871, n_points=100000, obs_per_point=8, seed=871))
    s = parse_g2o(path)
    lm = LevenbergMarquardtSolver(s)
    asm = lm.asm
    sch = lm._schur
    states = asm.snapshot_states(s)
    bs = asm.assemble(states)
    jax.block_until_ready(bs.pp_blocks)

    def t(label, fn, n=10):
        out = fn()
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        jax.block_until_ready(out)
        print(f"{label}: {(time.perf_counter()-t0)/n*1e3:.1f} ms",
              flush=True)
        return out

    Np, Bp, Nl, Bl = asm.Np, asm.Bp, asm.Nl, asm.Bl
    t("assemble (800k edges)", lambda: asm.assemble(states))
    t("chi2 only", lambda: asm.chi2(states))

    c_inv = planar.binv(bs.ll_blocks, Bl)
    u = bs.pl_blocks
    f_w = jax.jit(lambda u, ci: planar.bmm(
        u, ci[sch._pl_cols_dev], Bp, Bl, Bl))
    w = t("w = u @ c_inv[cols] (800k gather+bmm)",
          lambda: f_w(u, c_inv))
    f_pair = jax.jit(lambda w, u: planar.bmm_A_Bt(
        w[sch._fill_pa], u[sch._fill_pb], Bp, Bl, Bp))
    prod = t("pair products (2x3.6M gather + bmm)",
             lambda: f_pair(w, u))
    import jax.ops
    f_seg = jax.jit(lambda p: jax.ops.segment_sum(
        p, sch._fill_dst, num_segments=sch.Ksc))
    sc_fill = t("segment_sum 3.6M -> Ksc", lambda: f_seg(prod))
    sc = jnp.zeros((sch.Ksc, Bp * Bp), dtype=u.dtype)
    sc = sc.at[sch._pp_to_sc].set(bs.pp_blocks) - sc_fill
    f_fact = jax.jit(lambda sc, rhs:
                     sch._reduced_chol._factor_solve_impl(sc, rhs))
    t("reduced MIS factor+solve (871 cams)",
      lambda: f_fact(sc, bs.eta_p))
    import numpy as _np
    f_solve = jax.jit(sch._solve_sparse_impl)
    def run_solve():
        return f_solve(bs)
    t("full sparse schur solve (clique path)", run_solve)
    # LM iteration end-to-end (damp + solve + update + chi2)
    from slam_plus_plus_tpu.solvers.lm import damp_system
    def lm_iter():
        b2 = asm.assemble(states)
        b2 = damp_system(b2, b2.max_hdiag * 1e-3, asm.pp_diag_ids_dev)
        dxp, dxl = f_solve(b2)
        st2 = asm.update(states, dxp, dxl)
        return asm.chi2(st2)
    t("LM-iteration equivalent (assemble+damp+solve+update+chi2)",
      lm_iter, n=5)
    print(f"Ksc={sch.Ksc} fill_pairs={len(sch._fill_pa)} "
          f"clique={sch._clique_uniform is not None}", flush=True)


if __name__ == "__main__":
    main()
