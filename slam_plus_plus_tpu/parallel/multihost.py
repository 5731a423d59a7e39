"""Multi-host (multi-process) entry: jax.distributed wiring + global mesh.

The reference is single-process (SURVEY.md §2.3 P6: no MPI/NCCL anywhere in
its tree); multi-host execution is a capability this build adds
(SURVEY §7 stage 9).  Design:

  * one controller process per host, `jax.distributed.initialize` against a
    coordinator (standard JAX multi-controller model);
  * `global_mesh()` builds a 1-D mesh over ALL processes' devices — the
    same `shard_map` programs used single-process (parallel/dist.py,
    parallel/sharded_ba.py, parallel/dist_cholesky.py) then run with their
    `psum`s carried by NCCL — NVLink between the cards of one host, the
    network across hosts — with no code changes (JAX partitions
    collectives by the mesh's device order);
  * configuration comes from explicit args, the standard cluster env
    (JAX's cluster auto-detection), or SLAMPP_* variables for manual
    bring-up.

CLI: slam_plus_plus_tpu.app.main --dist-coord host:port --dist-nprocs N
--dist-procid I (see app/main.py), or env SLAMPP_COORD/SLAMPP_NPROCS/
SLAMPP_PROC_ID.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


_initialized = False


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None) -> bool:
    """Idempotently initialize jax.distributed.

    Falls back to env (SLAMPP_COORD, SLAMPP_NPROCS, SLAMPP_PROC_ID), then
    to JAX's own cluster auto-detection (e.g. SLURM).  Returns True
    if a multi-process runtime was initialized, False for single-process
    operation (no coordinator configured anywhere).
    """
    global _initialized
    import jax

    if _initialized:
        return True
    coordinator = coordinator or os.environ.get("SLAMPP_COORD")
    if num_processes is None and os.environ.get("SLAMPP_NPROCS"):
        num_processes = int(os.environ["SLAMPP_NPROCS"])
    if process_id is None and os.environ.get("SLAMPP_PROC_ID"):
        process_id = int(os.environ["SLAMPP_PROC_ID"])

    if coordinator is None and num_processes is None:
        # cluster auto-detection: initialize() with no args succeeds
        # under a cluster manager JAX recognises, raises elsewhere —
        # treat failure as single-process.
        try:
            jax.distributed.initialize()
            _initialized = True
            return True
        except Exception:
            return False
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)
    _initialized = True
    return True


def is_multiprocess() -> bool:
    import jax
    return jax.process_count() > 1


def global_mesh(axis: str = "edges"):
    """1-D mesh over every device of every process (the sharded programs'
    collectives then span hosts: NVLink inside one, the network
    across)."""
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()), (axis,))


def process_summary() -> str:
    import jax
    return (f"process {jax.process_index()}/{jax.process_count()}, "
            f"{jax.local_device_count()} local / "
            f"{jax.device_count()} global devices")
