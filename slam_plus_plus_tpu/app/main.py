"""slam_plus_plus_tpu CLI — flag-compatible with the reference app.

Reference analogue: src/slam_app/Main.cpp:41 (main), TCommandLineArgs
(include/slam_app/Main.h:1645, defaults src/slam_app/Main.cpp:670-707) and
the per-family dispatchers n_Run_*_Solver (include/slam_app/Main.h:1782).

Supported flags (reference names):
  -i <file>          input dataset (g2o dialect)
  -po                pose-only (expect no landmarks; informational)
  -nsp <N>           nonlinear solve every N vertices (incremental mode)
  -lsp <N>           linear solve every N vertices (incremental mode)
  -A | -,\\ | -,\\lm   solver: A (GN over A) / lambda (GN) / lambda-LM
  -fL | -L | -,\\dl   FastL / L / dogleg — mapped to the incremental engine
  -us                use Schur complement (auto-on for landmark problems)
  -dm                compute marginals after the final solve
  -mnsi <N>          max nonlinear-solve iterations        (default 10)
  -nset <e>          nonlinear-solve dx threshold          (default 20)
  -mfnsi <N>         max final-optimization iterations     (default 5)
  -fnset <e>         final-optimization dx threshold       (default 0.01)
  -s / -v            silent / verbose
  -nb                no bitmaps (plots)
  -dx <file>         write solution (default solution.txt; '' disables)
  --cpu              force the CPU backend (f64) — useful for verification
  -rmut              run block-matrix unit tests and exit
  -rmb <name> <type> run block-matrix benchmarks (type: alloc|factor|all)
  -gt <file>         ground-truth file: print ATE/RPE after the solve
  -dsi <dir>         dump a solution file at every incremental solve
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_argparser():
    p = argparse.ArgumentParser(
        prog="slam_plus_plus_tpu",
        description="Accelerator-native incremental sparse NLS optimizer "
                    "(SLAM / BA), flag-compatible with SLAM++")
    p.add_argument("-i", "--input", default=None)
    p.add_argument("-po", "--pose-only", action="store_true")
    p.add_argument("-nsp", "--nonlinear-solve-period", type=int, default=0)
    p.add_argument("-lsp", "--linear-solve-period", type=int, default=0)
    p.add_argument("-A", dest="solver", action="store_const", const="a")
    p.add_argument("-lm", "-,\\lm", dest="solver", action="store_const",
                   const="lambda_lm")
    p.add_argument("-fL", "-L", dest="solver", action="store_const",
                   const="fast_l")
    p.add_argument("-dl", "-,\\dl", dest="solver", action="store_const",
                   const="lambda_dl")
    p.add_argument("-us", "--use-schur", action="store_true")
    p.add_argument("-dm", "--marginals", action="store_true")
    p.add_argument("-mnsi", type=int, default=10)
    p.add_argument("-nset", type=float, default=20.0)
    p.add_argument("-mfnsi", type=int, default=5)
    p.add_argument("-fnset", type=float, default=0.01)
    p.add_argument("-s", "--silent", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-nb", "--no-bitmaps", action="store_true")
    p.add_argument("-dx", "--solution", default="solution.txt")
    p.add_argument("--cpu", action="store_true")
    # block-matrix self tests / benchmarks (reference -rmut / -rmb,
    # src/slam_app/Main.cpp:91-104); these short-circuit before parsing
    p.add_argument("-rmut", "--run-matrix-unit-tests", action="store_true")
    p.add_argument("-rmb", "--run-matrix-benchmarks", nargs=2,
                   metavar=("NAME", "TYPE"), default=None)
    # trajectory evaluation vs ground truth (reference ErrorEval.h:40-240)
    p.add_argument("-gt", "--ground-truth", default=None,
                   help="ground-truth g2o/solution file for ATE/RPE")
    p.add_argument("--rpe-delta", type=int, default=1)
    # per-solve solution dumps (reference -iBAsi, include/slam_app/
    # Main.h:1684-1685)
    p.add_argument("-dsi", "--dump-each-step", default=None,
                   metavar="DIR", help="write solution_NNNN.txt per solve")
    # multi-host (multi-process) runtime: jax.distributed wiring.  The
    # reference has no distributed backend (SURVEY §2.3 P6); this is the
    # capability this build adds (parallel/multihost.py).
    p.add_argument("--dist-coord", default=None, metavar="HOST:PORT",
                   help="jax.distributed coordinator address")
    p.add_argument("--dist-nprocs", type=int, default=None)
    p.add_argument("--dist-procid", type=int, default=None)
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    from slam_plus_plus_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    if (args.dist_coord or args.dist_nprocs or
            __import__("os").environ.get("SLAMPP_COORD")):
        from slam_plus_plus_tpu.parallel import multihost
        multihost.initialize(args.dist_coord, args.dist_nprocs,
                             args.dist_procid)
        if not args.silent:
            print(multihost.process_summary())

    # -rmut / -rmb short-circuit before any dataset work (reference
    # src/slam_app/Main.cpp:91-104)
    if args.run_matrix_unit_tests:
        from slam_plus_plus_tpu.app.block_unit import run_unit_tests
        return 0 if run_unit_tests(verbose=not args.silent) else 1
    if args.run_matrix_benchmarks is not None:
        from slam_plus_plus_tpu.app.block_unit import run_benchmarks
        name, btype = args.run_matrix_benchmarks
        run_benchmarks(name, btype, verbose=not args.silent)
        return 0

    if args.input is None:
        print("error: no input file (-i)", file=sys.stderr)
        return 1

    import slam_plus_plus_tpu.models  # noqa: F401 (register the type zoo)
    from slam_plus_plus_tpu.io.native_parser import ensure_lib, parse_g2o_fast
    from slam_plus_plus_tpu.io.parser import peek_dataset
    from slam_plus_plus_tpu.solvers.gauss_newton import GaussNewtonSolver
    from slam_plus_plus_tpu.solvers.lm import LevenbergMarquardtSolver

    flags = peek_dataset(args.input)
    is_ba = flags["has_ba"] or flags["has_stereo"] or flags["has_spheron"]
    if not args.silent:
        fam = [k for k, v in flags.items() if v]
        print(f"dataset: {args.input} ({', '.join(fam) or 'unknown'})")

    t_parse0 = time.perf_counter()
    system = parse_g2o_fast(args.input)
    t_parse = time.perf_counter() - t_parse0
    if not args.silent:
        nv = len(system.vertex_order)
        ne = sum(s.n for s in system.edge_stores.values())
        print(f"parsed {nv} vertices, {ne} edges in {t_parse:.3f}s")
    if args.verbose:
        print("parser: " + ("native" if ensure_lib() is not None
                            else "python (native reader unavailable)"))
    if not system.edge_stores:
        print("error: no edges in the dataset", file=sys.stderr)
        return 1

    # solver selection: BA defaults to lambda-LM like the reference
    # (src/slam_app/Main.cpp:205-210); everything else to lambda (GN)
    solver_kind = args.solver or ("lambda_lm" if is_ba else "lambda")

    incremental = args.nonlinear_solve_period > 0 or args.linear_solve_period > 0

    # per-solve dumps (reference -iBAsi per-step solution saving)
    dump_dir = args.dump_each_step
    if dump_dir:
        os.makedirs(dump_dir, exist_ok=True)
    n_dumped = [0]

    def dump_step(solver_obj, si, states):
        if not dump_dir:
            return
        solver_obj.asm.writeback_states(system, states)
        _dump_solution(system,
                       os.path.join(dump_dir,
                                    f"solution_{n_dumped[0]:05d}.txt"))
        n_dumped[0] += 1

    t0 = time.perf_counter()
    if incremental:
        every_n = args.nonlinear_solve_period or args.linear_solve_period
        max_it = args.mnsi if args.nonlinear_solve_period else 1
        thresh = args.nset if args.nonlinear_solve_period else 0.0
        if solver_kind == "fast_l":
            from slam_plus_plus_tpu.solvers.fastl import FastLSolver
            inc = FastLSolver(system, every_n=every_n,
                              max_iterations=max_it, dx_threshold=thresh)
            chi2, iters = inc.run(verbose=args.verbose)
        else:
            from slam_plus_plus_tpu.solvers.incremental import (
                IncrementalSolver)
            inc = IncrementalSolver(system, every_n=every_n,
                                    max_iterations=max_it,
                                    dx_threshold=thresh,
                                    allow_fused=not dump_dir)
            chi2, iters = inc.run(verbose=args.verbose,
                                  on_step=dump_step if dump_dir else None)
        elapsed = time.perf_counter() - t0
        print(f"done. it took {elapsed:.5f} sec")
        print(f"solver took {iters} iterations")
    else:
        if solver_kind == "lambda_dl":
            from slam_plus_plus_tpu.solvers.dogleg import DoglegSolver
            cls = DoglegSolver
        elif solver_kind == "a":
            from slam_plus_plus_tpu.solvers.a_solver import ASolver
            cls = ASolver
        elif solver_kind == "lambda_lm":
            cls = LevenbergMarquardtSolver
        else:
            cls = GaussNewtonSolver
        solver = cls(system)
        if args.verbose:
            print(f"initial denormalized chi2 error: {solver.chi2():.2f}")
        chi2, iters = solver.optimize(args.mfnsi, args.fnset,
                                      verbose=args.verbose)
        elapsed = time.perf_counter() - t0
        print(f"done. it took {elapsed:.5f} sec")
        print(f"solver took {iters} iterations")

    print(f"denormalized chi2 error: {chi2:.2f}")

    if args.verbose:
        from slam_plus_plus_tpu.utils.memusage import format_report
        print(format_report())

    if args.ground_truth:
        _evaluate_vs_ground_truth(system, args.ground_truth, args.rpe_delta)

    if args.marginals:
        from slam_plus_plus_tpu.assembly.assembler import Assembler
        from slam_plus_plus_tpu.marginals import Marginals
        asm = Assembler(system)
        bs = asm.assemble(asm.snapshot_states(system))
        marg = Marginals(asm).compute(bs)
        import numpy as np
        print("marginals: mean pose sigma "
              f"{float(np.sqrt(np.abs(np.asarray(marg.p_diag)).mean())):.6f}")

    if args.solution:
        _dump_solution(system, args.solution)
        if not args.silent:
            print(f"solution written to {args.solution}")

    if not args.no_bitmaps:
        try:
            from slam_plus_plus_tpu.app.plot import plot_system
            out = plot_system(system, "solution.png")
            if out and not args.silent:
                print(f"plot written to {out}")
        except Exception as e:  # plotting is best-effort, like the reference
            print(f"warning: plot failed: {e}", file=sys.stderr)
    return 0


def _evaluate_vs_ground_truth(system, gt_path, rpe_delta):
    """ATE/RPE of the solved trajectory vs a ground-truth file (g2o vertex
    lines or a plain solution.txt).  Reference: CErrorEvaluation
    (include/slam/ErrorEval.h:40,138,208-240) with Kabsch alignment."""
    import numpy as np
    from slam_plus_plus_tpu.evaluation.error_eval import evaluate_trajectory

    def load_states(path):
        rows = []
        with open(path) as f:
            for line in f:
                tok = line.split()
                if not tok:
                    continue
                if tok[0].upper().startswith("VERTEX"):
                    rows.append((int(tok[1]),
                                 np.array([float(x) for x in tok[2:]])))
                elif all(c in "0123456789.eE+- " for c in line.strip()):
                    rows.append((len(rows),
                                 np.array([float(x) for x in tok])))
        rows.sort(key=lambda r: r[0])
        return [r[1] for r in rows]

    gt = load_states(gt_path)
    est = []
    for gid in sorted(system.vertex_directory.keys()):
        tname, li = system.vertex_directory[gid]
        est.append(system.vertex_stores[tname].states[li])
    n = min(len(gt), len(est))
    dim = min(min(len(g) for g in gt[:n]), min(len(e) for e in est[:n]))
    gt_a = np.stack([g[:dim] for g in gt[:n]])
    est_a = np.stack([e[:dim] for e in est[:n]])
    m = evaluate_trajectory(est_a, gt_a, delta=rpe_delta)
    print(f"ATE RMSE: {m['ate_rmse']:.6f}")
    print(f"RPE trans RMSE: {m['rpe_trans_rmse']:.6f}  "
          f"rot RMSE: {m['rpe_rot_rmse']:.6f}  (delta={rpe_delta})")


def _dump_solution(system, path):
    """Vertex states in global-id order (reference CFlatSystem::Dump)."""
    with open(path, "w") as f:
        for gid in sorted(system.vertex_directory.keys()):
            tname, li = system.vertex_directory[gid]
            state = system.vertex_stores[tname].states[li]
            f.write(" ".join(f"{v:.10f}" for v in state) + "\n")


if __name__ == "__main__":
    sys.exit(main())
