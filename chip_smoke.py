#!/usr/bin/env python
"""Smoke test of the solve path on an NVIDIA GPU, at the reference's scale.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --chips 4    # landmark-sharded BA on 4 cards vs 1

Phases (one process, one card, in order; each prints one line with its
result and its gate, and the script exits non-zero if any fails):

  device            a GPU is JAX's default device (never falls back)
  ba_venice_real    871 cams / 100k points / 800k observations, LM through
                    the CLI (-us -lm -mfnsi 5)
  ba_bench_scene    100 cams / 8000 points / 457k observations, 4 damped
                    GN steps; the fused P2C kernel against the generic
                    jacfwd path at 457k and 800k edges
  se3_sphere2500    SE(3) pose graph through the CLI (-po -lm -mfnsi 30)
  fastl_manhattan3500  incremental FastL through the CLI (-po -nsp 1 -fL),
                    on the device's scanned engine

The goldens below come from the reference SLAM++ binary (CPU, f64) on the
identical generated files.  The last line of output is one JSON object
naming the device.
"""

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# reference binary, -us -lm -mfnsi 5, make_ba_scene_large(871, 100000, 8,
# seed=871) (the reference's venice871.g2o scale, unit_tests.sh:184-189)
VENICE_INITIAL_CHI2 = 42556937.59
VENICE_FINAL_CHI2 = 323432.49
VENICE_ITERS = 5
# reference binary, -lm to convergence, make_ba_scene(100, 8000, seed=77)
BENCH_FINAL_CHI2 = 222855.82
# reference binary, -po -lm -mfnsi 30 (converged in 11 iterations),
# make_sphere_3d(2500, seed=103, trans_noise=0.01, rot_noise=0.005)
SPHERE_FINAL_CHI2 = 34090.37
# reference binary, -po -nsp 1 -fL, make_manhattan_2d(3500, seed=101,
# loop_prob=0.3)
MANHATTAN_FASTL_CHI2 = 1418.70

CHI2_BOUND = 1.05        # the reference suite's final-chi2 bound
# f32 sum over 800k terms, in an order set by atomics
INITIAL_CHI2_RTOL = 1e-5
# f32 psum order across cards
SHARDED_CHI2_RTOL = 1e-4
# fused kernel vs jacfwd, block-scaled max error (tests/test_pallas.py)
P2C_TOL = 1e-4


def _device_line():
    import jax
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        print(f"device: FAIL — JAX's default device is {d.platform!r}, "
              "not a GPU", flush=True)
        sys.exit(2)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        smi = [f"nvidia-smi unavailable: {e}"]
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    print(f"device: PASS — {d.device_kind}, {len(devs)} visible, "
          f"jax {jax.__version__} (gate: platform == 'gpu')", flush=True)
    return dict(platform=d.platform, kind=d.device_kind, count=len(devs))


def _run_cli(argv):
    """Run the CLI in-process; returns its stdout (echoed)."""
    from slam_plus_plus_tpu.app.main import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    sys.stdout.write("".join("    | " + ln + "\n"
                             for ln in out.splitlines()))
    if rc != 0:
        raise RuntimeError(f"CLI exited {rc}")
    return out


def _cli_result(out):
    def last(pat, cast):
        m = re.findall(pat, out, flags=re.M)
        return cast(m[-1]) if m else None
    return dict(
        initial=last(r"^initial denormalized chi2 error: (\S+)", float),
        final=last(r"^denormalized chi2 error: (\S+)", float),
        iters=last(r"^solver took (\d+) iterations", int))


def _peak_device_mb():
    from slam_plus_plus_tpu.utils.memusage import device_memory
    return {dev: round(st["peak_bytes_in_use"] / 2**20, 1)
            for dev, st in device_memory().items()}


# ---------------------------------------------------------------- scenes

def venice_file(tmp, n_cams=871, n_points=100000, obs_per_point=8,
                seed=871):
    from slam_plus_plus_tpu.io import datasets as D
    p = os.path.join(tmp, f"venice_{n_cams}_{n_points}_{seed}.g2o")
    if not os.path.exists(p):
        D.write_g2o_ba(p, *D.make_ba_scene_large(
            n_cams=n_cams, n_points=n_points, obs_per_point=obs_per_point,
            seed=seed))
    return p


def bench_file(tmp, n_cams=100, n_points=8000, seed=77):
    from slam_plus_plus_tpu.io import datasets as D
    p = os.path.join(tmp, f"bench_{n_cams}_{n_points}_{seed}.g2o")
    if not os.path.exists(p):
        D.write_g2o_ba(p, *D.make_ba_scene(n_cams=n_cams, n_points=n_points,
                                           seed=seed))
    return p


# ---------------------------------------------------------------- phases

def phase_ba_venice_real(tmp, **scene):
    p = venice_file(tmp, **scene)
    r = _cli_result(_run_cli(["-i", p, "-us", "-lm", "-mfnsi", "5", "-nb",
                              "-dx", "", "-v"]))
    r["peak_mb"] = _peak_device_mb()
    return r


def p2c_compare(path):
    """Max block-scaled error of the fused P2C kernel against the generic
    jacfwd kernel, over every per-edge output, at the file's full width."""
    import dataclasses
    import jax
    import numpy as np
    from slam_plus_plus_tpu.assembly.assembler import Assembler
    from slam_plus_plus_tpu.config import SolverConfig
    from slam_plus_plus_tpu.io.native_parser import parse_g2o_fast

    system = parse_g2o_fast(path)
    asm = Assembler(system, dataclasses.replace(SolverConfig(),
                                                use_pallas="off"))
    plan = next(p for p in asm.plans if p.name == "edge_p2c")
    data = asm.edge_data[plan.name]
    states = asm.snapshot_states(system)
    gathered = tuple(states[t][data["slot_local"][k]]
                     for k, t in enumerate(plan.slot_types))
    ref = jax.jit(asm._kernels[plan.name])(gathered, data["z"], data["info"])
    fused = jax.jit(lambda g: asm._pallas_edge_terms(plan, g, data))(gathered)
    ref_l, fused_l = jax.tree.leaves(ref), jax.tree.leaves(fused)
    assert len(ref_l) == len(fused_l)
    err = 0.0
    for a, b in zip(ref_l, fused_l):
        a = np.asarray(a, dtype=np.float64).reshape(plan.E, -1)
        b = np.asarray(b, dtype=np.float64).reshape(plan.E, -1)
        if not np.all(np.isfinite(b)):
            return float("inf"), plan.E
        err = max(err, float(np.abs(a - b).max() /
                             max(np.abs(a).max(), 1.0)))
    return err, plan.E


def phase_ba_bench_scene(tmp, venice_path, steps=4, **scene):
    import jax
    from slam_plus_plus_tpu.assembly.assembler import Assembler
    from slam_plus_plus_tpu.io.native_parser import parse_g2o_fast
    from slam_plus_plus_tpu.linalg.schur import SchurSolver
    from slam_plus_plus_tpu.solvers.lm import make_damped_gn_step

    p = bench_file(tmp, **scene)
    system = parse_g2o_fast(p)
    asm = Assembler(system)
    step = jax.jit(make_damped_gn_step(asm, SchurSolver(asm)))
    states = asm.snapshot_states(system)
    for _ in range(steps):
        states, _chi2 = step(states, asm.edge_data)
    final = float(asm.chi2(states))
    r = dict(final=final, pallas=asm._pallas_plans,
             edges=sum(pl.E for pl in asm.plans))
    r["p2c_err"], r["p2c_edges"] = {}, {}
    for name, path in (("bench", p), ("venice", venice_path)):
        r["p2c_err"][name], r["p2c_edges"][name] = p2c_compare(path)
    return r


def _gen_pose_graph(tmp, kind):
    from slam_plus_plus_tpu.io import datasets as D
    p = os.path.join(tmp, f"{kind}.g2o")
    if kind == "sphere2500":
        poses, edges = D.make_sphere_3d(n_poses=2500, seed=103,
                                        trans_noise=0.01, rot_noise=0.005)
        D.write_g2o_3d(p, edges, poses)
    else:
        poses, edges = D.make_manhattan_2d(n_poses=3500, seed=101,
                                           loop_prob=0.3)
        D.write_g2o_2d(p, edges, poses)
    return p


def phase_se3_sphere2500(tmp):
    p = _gen_pose_graph(tmp, "sphere2500")
    return _cli_result(_run_cli(["-i", p, "-po", "-lm", "-mfnsi", "30",
                                 "-nb", "-dx", ""]))


def phase_fastl_manhattan3500(tmp):
    p = _gen_pose_graph(tmp, "manhattan3500")
    out = _run_cli(["-i", p, "-po", "-nsp", "1", "-fL", "-nb", "-dx", "",
                    "-v"])
    r = _cli_result(out)
    r["engine"] = ("native" if "fastl (native) done" in out else
                   "scan" if "fastl done" in out else "unknown")
    return r


def phase_sharded(tmp, n, iters=5, **scene):
    """Landmark-sharded BA on an n-card mesh against the same optimizer on
    a 1-card mesh; per-iteration chi2 of both."""
    import jax
    from slam_plus_plus_tpu.io.native_parser import parse_g2o_fast
    from slam_plus_plus_tpu.parallel import ShardedBAOptimizer, make_lm_mesh

    devs = jax.devices()
    if len(devs) < n:
        raise RuntimeError(f"need {n} devices, have {len(devs)}")
    p = venice_file(tmp, **scene)

    def trace(mesh_devs):
        opt = ShardedBAOptimizer(parse_g2o_fast(p),
                                 make_lm_mesh(devices=mesh_devs))
        cam, xyz = opt._cam_snapshot(), opt.xyz
        chis = []
        t0 = time.perf_counter()
        for _ in range(iters):
            cam, xyz, chi2 = opt._step(cam, xyz, opt._l_mask,
                                       opt._type_rows, opt._tree_of_plans())
            chis.append(float(chi2))
        secs = time.perf_counter() - t0
        shard_rows = opt.xyz.sharding.shard_shape(opt.xyz.shape)[0]
        return opt, chis, shard_rows, secs

    _o1, chis1, _r1, secs1 = trace(devs[:1])
    del _o1
    opt_n, chis_n, rows_n, secs_n = trace(devs[:n])
    rel = [abs(a - b) / max(abs(b), 1.0) for a, b in zip(chis_n, chis1)]
    mem = {str(d): {k: int(v) for k, v in (d.memory_stats() or {}).items()
                    if k in ("bytes_in_use", "peak_bytes_in_use",
                             "bytes_limit")}
           for d in devs[:n]}
    return dict(chi2_1=chis1, chi2_n=chis_n, max_rel=max(rel),
                shard_rows=rows_n, expected_rows=opt_n.Nl_pad // n,
                secs_1=round(secs1, 3), secs_n=round(secs_n, 3), memory=mem)


# ---------------------------------------------------------------- gates

def _gate_line(name, ok, result, gate):
    print(f"{name}: {'PASS' if ok else 'FAIL'} — {result} (gate: {gate})",
          flush=True)
    return ok


def run_one_card(tmp):
    results = {}

    def phase(name, fn, check):
        t0 = time.perf_counter()
        try:
            r = fn()
        except Exception:  # noqa: BLE001 — reported, and the run fails
            traceback.print_exc()
            print(f"{name}: FAIL — raised (see stderr)", flush=True)
            return False
        r["seconds"] = round(time.perf_counter() - t0, 1)
        results[name] = r
        ok, gate = check(r)
        return _gate_line(name, ok, json.dumps(r, default=str), gate)

    oks = []
    oks.append(phase(
        "ba_venice_real", lambda: phase_ba_venice_real(tmp),
        lambda r: (r["initial"] is not None and r["final"] is not None and
                   abs(r["initial"] - VENICE_INITIAL_CHI2) <=
                   INITIAL_CHI2_RTOL * VENICE_INITIAL_CHI2 and
                   r["final"] <= CHI2_BOUND * VENICE_FINAL_CHI2 and
                   r["iters"] == VENICE_ITERS,
                   f"initial {VENICE_INITIAL_CHI2} rtol {INITIAL_CHI2_RTOL}, "
                   f"final <= {CHI2_BOUND} x {VENICE_FINAL_CHI2}, "
                   f"iters == {VENICE_ITERS}")))
    oks.append(phase(
        "ba_bench_scene",
        lambda: phase_ba_bench_scene(tmp, venice_file(tmp)),
        lambda r: (r["final"] <= CHI2_BOUND * BENCH_FINAL_CHI2 and
                   all(e < P2C_TOL for e in r["p2c_err"].values()),
                   f"chi2 <= {CHI2_BOUND} x {BENCH_FINAL_CHI2}, P2C kernel "
                   f"vs jacfwd block-scaled max error < {P2C_TOL}")))
    oks.append(phase(
        "se3_sphere2500", lambda: phase_se3_sphere2500(tmp),
        lambda r: (r["final"] is not None and
                   r["final"] <= CHI2_BOUND * SPHERE_FINAL_CHI2,
                   f"final <= {CHI2_BOUND} x {SPHERE_FINAL_CHI2}")))
    oks.append(phase(
        "fastl_manhattan3500", lambda: phase_fastl_manhattan3500(tmp),
        lambda r: (r["final"] is not None and r["engine"] == "scan" and
                   r["final"] <= CHI2_BOUND * MANHATTAN_FASTL_CHI2,
                   f"final <= {CHI2_BOUND} x {MANHATTAN_FASTL_CHI2}, "
                   "scanned device engine")))
    return all(oks)


def run_sharded(tmp, n):
    try:
        r = phase_sharded(tmp, n)
    except Exception:  # noqa: BLE001 — reported, and the run fails
        traceback.print_exc()
        print(f"sharded_ba_{n}: FAIL — raised (see stderr)", flush=True)
        return False
    for dev, st in r["memory"].items():
        print(f"    {dev}: {st}", flush=True)
    ok = (r["max_rel"] <= SHARDED_CHI2_RTOL and
          r["shard_rows"] == r["expected_rows"])
    return _gate_line(f"sharded_ba_{n}", ok, json.dumps(r),
                      f"per-iteration chi2 vs 1-card mesh rtol "
                      f"{SHARDED_CHI2_RTOL}, Nl_pad/{n} landmarks per card")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1,
                    help="1: every one-card phase; N > 1: only the "
                         "landmark-sharded BA on N cards against 1")
    args = ap.parse_args(argv)

    device = _device_line()
    sys.path.insert(0, ROOT)
    from slam_plus_plus_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import slam_plus_plus_tpu.models  # noqa: F401 (register the type zoo)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.chips > 1:
            ok = run_sharded(tmp, args.chips)
        else:
            ok = run_one_card(tmp)
    if not ok:
        print("chip_smoke: FAIL", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
