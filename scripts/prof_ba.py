#!/usr/bin/env python
"""Stage profile of the BA iteration, and the fused P2C kernel against the
generic jacfwd edge kernel.

    python scripts/prof_ba.py [--scenes bench,venice] [--reps 20]

For each scene (bench: 100 cams / 8000 points / 457k observations, seed
77; venice: 871 cams / 100k points / 800k observations, seed 871) it times
``Assembler._edge_sums`` and the whole damped-GN step
(``solvers.lm.make_damped_gn_step``) with the kernel off and on, in the
order off, on, on, off; the edge kernel alone the same way; then the
solve's stages.  Each time is the median
of ``--reps`` calls, each ended by ``block_until_ready``.  Prints one JSON
line per measurement, naming the device.
"""
import argparse
import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def timeit(fn, *args, reps=20):
    """(median ms, min ms) over reps synchronous calls, after a warm-up."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), min(ts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", default="bench,venice")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from slam_plus_plus_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import slam_plus_plus_tpu.models  # noqa: F401
    from slam_plus_plus_tpu.assembly.assembler import Assembler
    from slam_plus_plus_tpu.config import SolverConfig
    from slam_plus_plus_tpu.io import datasets as D
    from slam_plus_plus_tpu.io.native_parser import parse_g2o_fast
    from slam_plus_plus_tpu.linalg.schur import SchurSolver
    from slam_plus_plus_tpu.solvers.lm import make_damped_gn_step

    d = jax.devices()[0]
    device = dict(platform=d.platform, kind=d.device_kind,
                  count=len(jax.devices()))

    def emit(**rec):
        print(json.dumps(dict(rec, device=device)), flush=True)

    tmp = tempfile.mkdtemp(prefix="prof_ba_")
    for scene in args.scenes.split(","):
        p = os.path.join(tmp, scene + ".g2o")
        if scene == "bench":
            D.write_g2o_ba(p, *D.make_ba_scene(n_cams=100, n_points=8000,
                                               seed=77))
        else:
            D.write_g2o_ba(p, *D.make_ba_scene_large(
                n_cams=871, n_points=100000, obs_per_point=8, seed=871))
        system = parse_g2o_fast(p)
        asms = {mode: Assembler(system, dataclasses.replace(
            SolverConfig(), use_pallas=mode)) for mode in ("off", "on")}
        states = asms["off"].snapshot_states(system)
        progs = {}
        for mode, asm in asms.items():
            progs[mode] = (
                jax.jit(asm._edge_sums),
                jax.jit(make_damped_gn_step(asm, SchurSolver(asm))))
        for mode in ("off", "on", "on", "off"):
            sums, step = progs[mode]
            t_sums = timeit(sums, states, asms[mode].edge_data,
                            reps=args.reps)
            t_step = timeit(step, states, asms[mode].edge_data,
                            reps=args.reps)
            emit(scene=scene, p2c_kernel=mode,
                 edges=sum(pl.E for pl in asms[mode].plans),
                 edge_sums_ms=t_sums[0], edge_sums_min_ms=t_sums[1],
                 step_ms=t_step[0], step_min_ms=t_step[1])

        # the edge kernel alone, on the same gathered states
        asm = asms["off"]
        plan = next(pl for pl in asm.plans if pl.name == "edge_p2c")
        data = asm.edge_data[plan.name]
        gathered = tuple(states[t][data["slot_local"][k]]
                         for k, t in enumerate(plan.slot_types))
        generic = jax.jit(asm._kernels[plan.name])
        fused = jax.jit(lambda g: asm._pallas_edge_terms(plan, g, data))
        for mode in ("off", "on", "on", "off"):
            ms = (timeit(generic, gathered, data["z"], data["info"],
                         reps=args.reps) if mode == "off" else
                  timeit(fused, gathered, reps=args.reps))
            emit(scene=scene, p2c_kernel=mode, stage="edge_kernel_only",
                 edges=plan.E, ms=ms[0], min_ms=ms[1])

        # solve stages (default kernel choice)
        asm = Assembler(system)
        solver = SchurSolver(asm)
        bs = asm.assemble(states)
        if solver.panel_mode != "uniform":
            continue
        panels = jax.jit(solver._uniform_panels)
        c_inv, Ut, Wt = panels(bs)
        sc_fn = jax.jit(lambda Ut, Wt, pp: solver._dense_pp(pp) - Wt.T @ Ut)
        sc = sc_fn(Ut, Wt, bs.pp_blocks)

        @jax.jit
        def chol(sc, rhs):
            L = jnp.linalg.cholesky(sc)
            y = jax.scipy.linalg.solve_triangular(L, rhs, lower=True)
            return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)

        emit(scene=scene, stage="uniform_panels",
             ms=timeit(panels, bs, reps=args.reps)[0])
        emit(scene=scene, stage="sc_gemm_dense_pp",
             ms=timeit(sc_fn, Ut, Wt, bs.pp_blocks, reps=args.reps)[0])
        emit(scene=scene, stage="dense_chol_trisolve", n=int(sc.shape[0]),
             ms=timeit(chol, sc, bs.eta_p.reshape(-1), reps=args.reps)[0])


if __name__ == "__main__":
    main()
