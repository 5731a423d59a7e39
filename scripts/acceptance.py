#!/usr/bin/env python
"""Acceptance suite: golden-value regression against the reference binary.

The analogue of the reference's scripts/tests/unit_tests.sh (14 datasets x
batch/incremental configs, integer-rounded chi2 comparison at the 1.05x
bound).  The md5-pinned originals live on SourceForge and cannot be fetched
in this environment, so each row regenerates a deterministic synthetic
dataset at the same SCALE and problem class, runs the reference SLAM++
binary (.refbuild/bin/slam_plus_plus) on the identical file for the golden,
then runs our solver and compares.

Usage:  python scripts/acceptance.py [--quick] [--out docs/ACCEPTANCE.md]
"""
import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
REF_BIN = os.path.join(ROOT, ".refbuild", "bin", "slam_plus_plus")

import jax

# SLAMPP_ACCEPT_BACKEND=cpu (default; f64, oracle-grade) | gpu (f32 — the
# 1.05x bound still applies)
BACKEND = os.environ.get("SLAMPP_ACCEPT_BACKEND", "cpu")
if BACKEND not in ("cpu", "gpu"):
    raise SystemExit(f"SLAMPP_ACCEPT_BACKEND={BACKEND!r}: expected cpu|gpu")
jax.config.update("jax_platforms", BACKEND)
if BACKEND == "cpu":
    jax.config.update("jax_enable_x64", True)

from slam_plus_plus_tpu.utils.cache import enable_compilation_cache  # noqa: E402
enable_compilation_cache()

import numpy as np

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.io import datasets as D
from slam_plus_plus_tpu.io.parser import parse_g2o


def run_reference(path, flags):
    cmd = [REF_BIN, "-i", path, "-nb"] + flags
    out = subprocess.run(cmd, capture_output=True, text=True,
                         cwd=tempfile.gettempdir(),
                         timeout=1800).stdout
    m_chi = re.findall(r"denormalized chi2 error: ([0-9.eE+-]+)", out)
    m_it = re.findall(r"solver took (\d+) iterations", out)
    return (float(m_chi[-1]) if m_chi else float("nan"),
            int(m_it[-1]) if m_it else -1)


def ours_batch(path, solver="gn", iters=5):
    s = parse_g2o(path)
    t0 = time.time()
    if solver == "gn":
        from slam_plus_plus_tpu.solvers.gauss_newton import GaussNewtonSolver
        sv = GaussNewtonSolver(s)
    elif solver == "lm":
        from slam_plus_plus_tpu.solvers.lm import LevenbergMarquardtSolver
        sv = LevenbergMarquardtSolver(s)
    chi2, n = sv.optimize(iters)
    return chi2, n, time.time() - t0


def ours_incremental(path, mode):
    s = parse_g2o(path)
    t0 = time.time()
    if mode == "fastl":
        from slam_plus_plus_tpu.solvers.fastl import FastLSolver
        sv = FastLSolver(s, every_n=1)
        chi2, n = sv.run()
    else:
        from slam_plus_plus_tpu.solvers.incremental import IncrementalSolver
        sv = IncrementalSolver(s, every_n=1, mode="lambda")
        chi2, n = sv.run()
    return chi2, n, time.time() - t0


def gen(name):
    path = os.path.join(tempfile.gettempdir(), f"acc_{name}.txt")
    if os.path.exists(path):
        return path
    if name == "manhattan3500":
        poses, edges = D.make_manhattan_2d(n_poses=3500, seed=101,
                                           loop_prob=0.3)
        D.write_g2o_2d(path, edges, poses)
    elif name == "city10k":
        poses, edges = D.make_city_2d(n_poses=10000, seed=102)
        D.write_g2o_2d(path, edges, poses)
    elif name == "w100k":
        poses, edges = D.make_city_2d(n_poses=100000, seed=77)
        D.write_g2o_2d(path, edges, poses)
    elif name == "sphere2500":
        # milder noise than the default so the REFERENCE converges too: at
        # the old noise level its LM stalled at chi2 6.26M while ours reached
        # 34k, making the ratio meaningless ("not worse", not parity).  At
        # this level both optimizers land on the identical optimum
        # (34090.37, ref 11 LM iters with -mfnsi 30) and the ratio is real
        # parity evidence.
        poses, edges = D.make_sphere_3d(n_poses=2500, seed=103,
                                        trans_noise=0.01, rot_noise=0.005)
        D.write_g2o_3d(path, edges, poses)
    elif name == "trees10k":
        gp, gl, pe, le = D.make_landmark_2d(n_poses=10000, n_landmarks=2000,
                                            world=110.0, obs_radius=8.0,
                                            seed=104)
        D.write_g2o_landmark_2d(path, pe, le)
    elif name == "trees10k_incr":
        # the real cityTrees10k has ~14k measurements over 10k poses; the
        # batch row's denser variant (93k obs) is kept for batch coverage
        gp, gl, pe, le = D.make_landmark_2d(n_poses=10000, n_landmarks=2000,
                                            world=110.0, obs_radius=2.0,
                                            seed=104)
        D.write_g2o_landmark_2d(path, pe, le)
    elif name == "vp_scale":
        # victoria-park class: few landmarks, each observed many times
        gp, gl, pe, le = D.make_landmark_2d(n_poses=3400, n_landmarks=150,
                                            world=40.0, obs_radius=10.0,
                                            seed=7)
        D.write_g2o_landmark_2d(path, pe, le)
    elif name == "intel_scale":
        poses, edges = D.make_manhattan_2d(n_poses=800, seed=105,
                                           loop_prob=0.4)
        D.write_g2o_2d(path, edges, poses)
    elif name == "garage3d":
        # parking-garage class (SE3 helix + inter-floor closures); the
        # reference's GN and fastL both DIVERGE on this family (see
        # docs/ACCEPTANCE.md notes) — LM is the parity configuration
        gt, edges = D.make_garage_3d(seed=9)
        D.write_g2o_3d_axisangle(path, edges)
    elif name == "ba_venice_class":
        cams, pts, obs = D.make_ba_scene(n_cams=100, n_points=8000, seed=77)
        D.write_g2o_ba(path, cams, pts, obs)
    elif name == "ba_venice_real":
        # the reference's HEADLINE scale (venice871.g2o: 871 cams, ~100k
        # points, unit_tests.sh:184-189): 871 cams x 100k pts x 800k obs
        cams, pts, obs = D.make_ba_scene_large(n_cams=871, n_points=100000,
                                               obs_per_point=8, seed=871)
        D.write_g2o_ba(path, cams, pts, obs)
    return path


ROWS = [
    # (row name, dataset, ref flags, ours runner, quick?)
    ("manhattan3500 batch -po", "manhattan3500", ["-po"],
     lambda p: ours_batch(p, "gn", 5), True),
    ("intel-scale batch -po", "intel_scale", ["-po"],
     lambda p: ours_batch(p, "gn", 5), True),
    ("city10k batch -po", "city10k", ["-po"],
     lambda p: ours_batch(p, "gn", 5), True),
    ("sphere2500 batch (LM)", "sphere2500", ["-po", "-,\\lm", "-mfnsi", "30"],
     lambda p: ours_batch(p, "lm", 30), True),
    ("garage-class SE(3) batch (LM)", "garage3d",
     ["-po", "-,\\lm", "-mfnsi", "20"],
     lambda p: ours_batch(p, "lm", 20), True),
    ("trees10k batch (landmarks)", "trees10k", [],
     lambda p: ours_batch(p, "gn", 5), True),
    ("w100K batch -po", "w100k", ["-po"],
     lambda p: ours_batch(p, "gn", 5), False),
    ("ba venice-class batch (LM)", "ba_venice_class", ["-us", "-,\\lm"],
     lambda p: ours_batch(p, "lm", 5), False),
    ("ba venice-real batch (LM) 871cams/100k pts", "ba_venice_real",
     ["-us", "-,\\lm"], lambda p: ours_batch(p, "lm", 5), False),
    ("manhattan3500 incr lambda -nsp 1", "manhattan3500", ["-po", "-nsp", "1"],
     lambda p: ours_incremental(p, "lambda"), False),
    ("city10k incr lambda -nsp 1", "city10k", ["-po", "-nsp", "1"],
     lambda p: ours_incremental(p, "lambda"), False),
    ("manhattan3500 incr fastL -nsp 1", "manhattan3500",
     ["-po", "-nsp", "1", "-fL"],
     lambda p: ours_incremental(p, "fastl"), False),
    ("intel-scale incr fastL -nsp 1", "intel_scale",
     ["-po", "-nsp", "1", "-fL"],
     lambda p: ours_incremental(p, "fastl"), True),
    ("vp-scale incr fastL -nsp 1 (landmarks)", "vp_scale",
     ["-nsp", "1", "-fL"],
     lambda p: ours_incremental(p, "fastl"), False),
    ("trees10k incr fastL -nsp 1 (landmarks)", "trees10k_incr",
     ["-nsp", "1", "-fL"],
     lambda p: ours_incremental(p, "fastl"), False),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="only the fast rows")
    ap.add_argument("--rows", default=None, help="substring filter")
    ap.add_argument("--no-ref", action="store_true",
                    help="skip the reference binary (record ours only; "
                         "used by tests/test_acceptance_replay.py against "
                         "previously recorded goldens)")
    ap.add_argument("--out", default=os.path.join(ROOT, "docs",
                                                  "ACCEPTANCE.md"))
    args = ap.parse_args()

    def flush_out(results):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("# Acceptance — golden regression vs the reference "
                    "binary\n\n"
                    "Synthetic datasets at the reference regression suite's "
                    "scales (unit_tests.sh analogue; the md5-pinned "
                    "originals are not fetchable here).  Goldens produced "
                    "by the reference build on the identical files; bound "
                    "1.05x final chi2.\n\n")
            f.write("| row | ref chi2 | ref iters | ours chi2 | ours iters "
                    "| ours time | ratio | verdict |\n|---|---|---|---|---|"
                    "---|---|---|\n")
            for r in results:
                f.write(f"| {r['row']} | {r['ref_chi2']:.2f} | "
                        f"{r['ref_iters']} | {r['chi2']:.2f} | {r['iters']} "
                        f"| {r['seconds']}s | {r['ratio']} | "
                        f"{'PASS' if r['passed'] else 'FAIL'} |\n")
        with open(os.path.splitext(args.out)[0] + ".json", "w") as f:
            json.dump(results, f, indent=1)

    results = []
    for (name, ds, flags, runner, quick) in ROWS:
        if args.quick and not quick:
            continue
        if args.rows and args.rows not in name:
            continue
        results.append(_run_row(name, ds, flags, runner, args, flush_out,
                                results))
    print(json.dumps({"passed": sum(r["passed"] for r in results),
                      "total": len(results)}))
    if not all(r["passed"] for r in results):
        sys.exit(1)


def _run_row(name, ds, flags, runner, args, flush_out, results):
    path = gen(ds)
    print(f"== {name}", flush=True)
    if args.no_ref:
        ref_chi2, ref_iters = float("nan"), -1
    else:
        ref_chi2, ref_iters = run_reference(path, flags)
        print(f"   reference: chi2={ref_chi2:.2f} iters={ref_iters}",
              flush=True)
    chi2, iters, secs = runner(path)
    if args.no_ref:
        ratio, ok = float("nan"), True
    else:
        ratio = chi2 / ref_chi2 if ref_chi2 > 0 else \
            (1.0 if chi2 <= 0.01 else float("inf"))
        ok = ratio <= 1.05
    print(f"   ours:      chi2={chi2:.2f} iters={iters} "
          f"({secs:.1f}s)  ratio={ratio:.4f}  "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    row = dict(row=name, ref_chi2=ref_chi2,
               ref_iters=ref_iters, chi2=chi2, iters=iters,
               seconds=round(secs, 1), ratio=round(ratio, 4),
               passed=bool(ok))
    flush_out(results + [row])
    return row


if __name__ == "__main__":
    main()
