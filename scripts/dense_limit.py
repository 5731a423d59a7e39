#!/usr/bin/env python
"""Time the manhattan3500 ``-nsp 1`` lambda replay at two dense-solve
limits, to choose ``DevicePolicy.dense_limit`` for a device.

    python scripts/dense_limit.py [--limits 6000,20000] [--rounds 2]

The replay runs ``IncrementalSolver`` without the fused FastL delegate, so
the limit decides its linear backend: 10500 scalar dims go to the dense
Cholesky under a limit of 20000 and to the MIS-Schur block Cholesky under
6000.  Limits run in turns (a, b, b, a for two rounds); each line gives the
construction and replay seconds and the final chi2.
"""
import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--limits", default="6000,20000")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import jax
    from slam_plus_plus_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import slam_plus_plus_tpu.models  # noqa: F401
    from slam_plus_plus_tpu import config
    from slam_plus_plus_tpu.io import datasets as D
    from slam_plus_plus_tpu.io.native_parser import parse_g2o_fast
    from slam_plus_plus_tpu.solvers import incremental

    d = jax.devices()[0]
    device = dict(platform=d.platform, kind=d.device_kind,
                  count=len(jax.devices()))
    p = os.path.join(tempfile.mkdtemp(prefix="dense_limit_"), "m3500.g2o")
    poses, edges = D.make_manhattan_2d(n_poses=3500, seed=101, loop_prob=0.3)
    D.write_g2o_2d(p, edges, poses)

    limits = [int(x) for x in args.limits.split(",")]
    order = []
    for r in range(args.rounds):
        order += limits if r % 2 == 0 else limits[::-1]
    base = config.device_policy()
    for limit in order:
        policy = dataclasses.replace(base, dense_limit=limit)
        incremental.device_policy = lambda platform=None, p=policy: p
        system = parse_g2o_fast(p)
        t0 = time.perf_counter()
        inc = incremental.IncrementalSolver(system, every_n=1,
                                            max_iterations=10,
                                            dx_threshold=20.0,
                                            allow_fused=False)
        t_con = time.perf_counter() - t0
        t0 = time.perf_counter()
        chi2, iters = inc.run()
        t_run = time.perf_counter() - t0
        print(json.dumps(dict(
            dense_limit=limit, dense_direct=bool(inc._dense_direct),
            construct_s=t_con, replay_s=t_run, chi2=float(chi2),
            iters=int(iters), device=device)), flush=True)


if __name__ == "__main__":
    main()
