"""Multi-host (2-process) smoke test on the CPU backend.

Launches two coordinator-connected processes (jax.distributed.initialize
via parallel/multihost.py), builds the GLOBAL 2-device mesh, and runs one
distributed assembly + solve step; process 0 checks the result against a
single-process oracle.  This validates the multi-process wiring the
reference never had (SURVEY §2.3 P6) — on real hardware the same code runs
one process per GPU host with NCCL collectives (NVLink inside a host).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["SLAMPP_ROOT"])
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from slam_plus_plus_tpu.parallel import multihost
ok = multihost.initialize()          # SLAMPP_COORD/NPROCS/PROC_ID from env
assert ok and jax.process_count() == 2, multihost.process_summary()

import numpy as np
import slam_plus_plus_tpu.models
from slam_plus_plus_tpu.io import datasets as D
from slam_plus_plus_tpu.io.parser import parse_g2o
from slam_plus_plus_tpu.parallel import DistributedAssembler

poses, edges = D.make_manhattan_2d(n_poses=80, seed=7)
path = os.path.join(os.environ["SLAMPP_TMP"], "mh.txt")
if jax.process_index() == 0:
    D.write_g2o_2d(path, edges, poses)
import time
while not os.path.exists(path):
    time.sleep(0.05)
time.sleep(0.2)
system = parse_g2o(path)

mesh = multihost.global_mesh()
assert mesh.devices.size == 2
asm = DistributedAssembler(system, mesh)
st = asm.snapshot_states(system)
bs = asm.assemble(st)
chi2 = float(bs.chi2)
eta = np.asarray(jax.device_get(bs.eta_p))
if jax.process_index() == 0:
    np.savez(os.path.join(os.environ["SLAMPP_TMP"], "out.npz"),
             chi2=chi2, eta=eta)
print(f"proc {jax.process_index()} chi2={chi2}", flush=True)
"""


@pytest.mark.slow
def test_two_process_assembly(tmp_path):
    port = 45677
    procs = []
    for pid in range(2):
        env = dict(os.environ,
                   SLAMPP_ROOT=ROOT, SLAMPP_TMP=str(tmp_path),
                   SLAMPP_COORD=f"127.0.0.1:{port}",
                   SLAMPP_NPROCS="2", SLAMPP_PROC_ID=str(pid),
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for pr in procs:
        try:
            out, _ = pr.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            pr.kill()
            out, _ = pr.communicate()
        outs.append(out)
    if any(pr.returncode != 0 for pr in procs):
        joined = "\n---\n".join(outs)
        if ("distributed" in joined and "not" in joined.lower()) or \
                "UNIMPLEMENTED" in joined or "gloo" in joined.lower():
            pytest.skip("multi-process CPU collectives unavailable: " +
                        joined[-400:])
        raise AssertionError(joined)

    # oracle: single-process assembly on the same file
    import jax
    import dataclasses
    import slam_plus_plus_tpu.models  # noqa: F401
    from slam_plus_plus_tpu.assembly.assembler import Assembler
    from slam_plus_plus_tpu.config import SolverConfig
    from slam_plus_plus_tpu.io.parser import parse_g2o
    got = np.load(str(tmp_path / "out.npz"))
    system = parse_g2o(str(tmp_path / "mh.txt"))
    asm = Assembler(system, dataclasses.replace(SolverConfig(),
                                                edge_layout="flat"))
    bs = asm.assemble(asm.snapshot_states(system))
    assert abs(float(bs.chi2) - float(got["chi2"])) <= \
        1e-9 * max(float(bs.chi2), 1.0)
    ref = np.asarray(bs.eta_p)
    assert np.allclose(ref, got["eta"], rtol=1e-9,
                       atol=1e-9 * max(np.abs(ref).max(), 1.0))
