#!/usr/bin/env python
"""Benchmark: bundle-adjustment damped GN/Schur solve, per-iteration time.

Prints ONE JSON line:
  {"metric": "ba_solve_iter", "value": <ms>, "unit": "ms", "vs_baseline": <x>}

Workload: synthetic Venice-analogue BA scene — 100 cameras, 8000 points,
457543 observations (deterministic seed 77), full damped Gauss-Newton step:
lambda/eta assembly (457k reprojection jacobians), Schur elimination of the
8000 landmark blocks (13.5M block-pair products), dense reduced-camera
Cholesky (600x600), landmark back-substitution, vertex ⊞ update.

Baseline: the reference SLAM++ binary (x64, single core as its papers
measure, OMP_NUM_THREADS=1) on the IDENTICAL dataset file runs Lambda-LM at
9.326 s / 4 iterations = 2331.6 ms per iteration (lambda refresh 2.63 s +
linear solve 6.55 s dominate; measured 2026-08-17 on an x86 CPU host).
vs_baseline = baseline_ms / ours_ms (>1 : we are faster).

Correctness gate: our final chi2 after 4 steps must be within 1.05x of the
reference's converged 222855.82 (we typically land slightly BELOW it).
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REF_MS_PER_ITER = 2331.6   # reference slam_plus_plus, single core, same file
REF_FINAL_CHI2 = 222855.82

N_CAMS, N_POINTS, SEED = 100, 8000, 77
TIMED_STEPS = 4


def main():
    import jax

    from slam_plus_plus_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    import slam_plus_plus_tpu.models  # noqa: F401
    from slam_plus_plus_tpu.assembly.assembler import Assembler
    from slam_plus_plus_tpu.io import datasets
    from slam_plus_plus_tpu.io.native_parser import parse_g2o_fast
    from slam_plus_plus_tpu.linalg.schur import SchurSolver
    from slam_plus_plus_tpu.solvers.lm import make_damped_gn_step

    d = jax.devices()[0]
    device = dict(platform=d.platform, kind=d.device_kind,
                  count=len(jax.devices()))
    print(f"device: {device}", file=sys.stderr)

    tmp = tempfile.mkdtemp(prefix="bench_")
    path = os.path.join(tmp, f"bench_ba_{N_CAMS}_{N_POINTS}_{SEED}.txt")
    cams, pts, obs = datasets.make_ba_scene(n_cams=N_CAMS, n_points=N_POINTS,
                                            seed=SEED)
    datasets.write_g2o_ba(path, cams, pts, obs)
    system = parse_g2o_fast(path)

    asm = Assembler(system)
    step_jit = jax.jit(make_damped_gn_step(asm, SchurSolver(asm)))
    states = asm.snapshot_states(system)

    # --- stage 1: trace + XLA compile (AOT, no execution; persistent-cache
    # hits land here as a near-zero time)
    t0 = time.perf_counter()
    compiled = step_jit.lower(states, asm.edge_data).compile()
    t_compile = time.perf_counter() - t0
    print(f"trace+compile: {t_compile:.1f}s", file=sys.stderr)

    # --- stage 2: first execution (device buffers + dispatch path warmup)
    t0 = time.perf_counter()
    out, chi2 = compiled(states, asm.edge_data)
    jax.block_until_ready(out)
    t_first = time.perf_counter() - t0
    print(f"first-step execute: {t_first:.1f}s "
          f"(initial chi2 {float(chi2):.1f})", file=sys.stderr)
    step_jit = compiled

    # timed steps (each = one full assemble+solve+update iteration)
    states_t = states
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        states_t, chi2 = step_jit(states_t, asm.edge_data)
    jax.block_until_ready(states_t)
    elapsed = time.perf_counter() - t0
    ms_per_iter = elapsed / TIMED_STEPS * 1000.0

    final_chi2 = float(chi2)
    if final_chi2 > REF_FINAL_CHI2 * 1.05:
        print(f"FAIL: chi2 {final_chi2:.1f} exceeds 1.05x reference "
              f"{REF_FINAL_CHI2:.1f}", file=sys.stderr)
        sys.exit(1)
    print(f"chi2 after {TIMED_STEPS} steps: {final_chi2:.1f} "
          f"(reference converged: {REF_FINAL_CHI2:.1f})", file=sys.stderr)

    # --- incremental side-cell: a manhattan FastL replay on the native
    # C++ engine (CPU, f64), in a subprocess so this process's device
    # backend is untouched.  Reference binary on the same file:
    # manhattan3500 -nsp 1 -fL = 1.49 s (534 solves).
    inc_extra = {}
    try:
        import json as _json
        import subprocess
        code = r"""
import json, os, sys, time
sys.path.insert(0, %r)
import jax
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)
import slam_plus_plus_tpu.models
from slam_plus_plus_tpu.io.datasets import make_manhattan_2d, write_g2o_2d
from slam_plus_plus_tpu.io.parser import parse_g2o
from slam_plus_plus_tpu.solvers.fastl import FastLSolver
ipath = os.path.join(%r, 'bench_fastl_3500_101.txt')
poses, edges = make_manhattan_2d(n_poses=3500, seed=101, loop_prob=0.3)
write_g2o_2d(ipath, edges, poses)
t0 = time.perf_counter()
s = parse_g2o(ipath)
fl = FastLSolver(s, every_n=1)
chi2, iters = fl.run()
el = time.perf_counter() - t0
print(json.dumps(dict(
    fastl_m3500_wall_s=round(el, 2),
    fastl_m3500_ms_per_applied_step=round(
        el / max(fl.stats.get('omega_steps', 1), 1) * 1000.0, 2),
    fastl_m3500_chi2=round(float(chi2), 2),
    fastl_native=bool(fl._native is not None))))
""" % (os.path.dirname(os.path.abspath(__file__)), tmp)
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=600)
        inc_extra = _json.loads(out.stdout.strip().splitlines()[-1])
        print(f"fastl m3500 (cpu deployment): {inc_extra}", file=sys.stderr)
    except Exception as e:  # noqa: BLE001 — the headline metric still prints
        print(f"fastl bench skipped: {e}", file=sys.stderr)

    print(json.dumps({
        "metric": "ba_solve_iter",
        "value": round(ms_per_iter, 2),
        "unit": "ms",
        "vs_baseline": round(REF_MS_PER_ITER / ms_per_iter, 2),
        "device": device,
        "breakdown_s": {"trace_compile": round(t_compile, 1),
                        "first_execute": round(t_first, 1)},
        **inc_extra,
    }))


if __name__ == "__main__":
    main()
