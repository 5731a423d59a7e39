#!/usr/bin/env python
"""Incremental device-vs-CPU crossover measurement.

Runs the FastL engine on growing pose-graph replays on either backend and
records wall / per-applied-step times.  The hypothesis: per-level batches
widen with graph size, so the scan-fused device engine should close on (or
pass) the CPU's native engine somewhere in the 10k-100k-pose regime.

Usage:
  python scripts/crossover.py --backend cpu   # CPU side (f64, native engine)
  python scripts/crossover.py --backend gpu   # device side (f32, scan engine)
Prints one JSON line per size (and appends them to --out when given).
"""
import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=["cpu", "gpu"], required=True)
    ap.add_argument("--sizes", default="3500,10000,30000")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", args.backend)
    if args.backend == "cpu":
        jax.config.update("jax_enable_x64", True)
    from slam_plus_plus_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import slam_plus_plus_tpu.models  # noqa: F401
    from slam_plus_plus_tpu.io import datasets as D
    from slam_plus_plus_tpu.io.parser import parse_g2o
    from slam_plus_plus_tpu.solvers.fastl import FastLSolver

    tmp = tempfile.mkdtemp(prefix="xover_")

    for n in [int(s) for s in args.sizes.split(",")]:
        path = os.path.join(tmp, f"xover_city_{n}.txt")
        poses, edges = D.make_city_2d(n_poses=n, seed=102)
        D.write_g2o_2d(path, edges, poses)
        s = parse_g2o(path)
        t0 = time.time()
        sv = FastLSolver(s, every_n=1)
        t_con = time.time() - t0
        t0 = time.time()
        chi2, iters = sv.run()
        t_run = time.time() - t0
        rec = dict(backend=args.backend, n_poses=n,
                   construct_s=round(t_con, 1), run_s=round(t_run, 1),
                   chi2=round(float(chi2), 2), iters=int(iters),
                   solves=int(sv.stats.get("omega_steps", 0) +
                              sv.stats.get("full_refactors", 0)),
                   ms_per_applied=round(
                       t_run / max(sv.stats.get("omega_steps", 1), 1)
                       * 1000, 2),
                   pushes=int(sv.stats.get("pushes", 0)))
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
