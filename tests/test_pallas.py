"""Fused P2C kernel (ops/pallas_p2c.py, Pallas Triton route).

On the CPU the kernel runs in interpret mode (asked for here, never by the
library); the compiled kernel is checked on the card by the ``gpu`` test
below and by ``chip_smoke.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu import config
from slam_plus_plus_tpu.assembly import assembler as assembler_mod
from slam_plus_plus_tpu.assembly.assembler import Assembler
from slam_plus_plus_tpu.config import SolverConfig
from slam_plus_plus_tpu.io import datasets as D
from slam_plus_plus_tpu.io.parser import parse_g2o
from slam_plus_plus_tpu.ops import pallas_p2c


@pytest.fixture
def interpret_kernel(monkeypatch):
    monkeypatch.setattr(pallas_p2c, "p2c_edge_terms", functools.partial(
        pallas_p2c.p2c_edge_terms, interpret=True))


def _ba_system(tmp_path, n_cams, n_points, seed):
    cams, pts, obs = D.make_ba_scene(n_cams=n_cams, n_points=n_points,
                                     seed=seed)
    p = str(tmp_path / "pk.txt")
    D.write_g2o_ba(p, cams, pts, obs)
    return parse_g2o(p)


def _assert_systems_match(b_ref, b_pl):
    for name in ("pp_blocks", "pl_blocks", "ll_blocks", "eta_p", "eta_l"):
        a = np.asarray(getattr(b_ref, name))
        b = np.asarray(getattr(b_pl, name))
        scale = max(np.abs(a).max(), 1.0)
        assert np.abs(a - b).max() < 1e-4 * scale, name
    assert abs(float(b_ref.chi2) - float(b_pl.chi2)) < 1e-4 * float(b_ref.chi2)
    assert abs(float(b_ref.max_hdiag) - float(b_pl.max_hdiag)) < \
        1e-4 * float(b_ref.max_hdiag)


# (n_cams, n_points, layout): the uniform layout pads edges to Nl * M; the
# flat layout keeps the raw observation count, not a multiple of BLOCK
@pytest.mark.parametrize("n_cams,n_points,layout", [
    (6, 60, "auto"),
    (9, 211, "flat"),
])
def test_pallas_assemble_matches_jacfwd(tmp_path, interpret_kernel,
                                        n_cams, n_points, layout):
    system = _ba_system(tmp_path, n_cams, n_points, seed=80)
    base = SolverConfig(dtype=jnp.float32, edge_layout=layout)
    a_ref = Assembler(system, dataclasses.replace(base, use_pallas="off"))
    a_pl = Assembler(system, dataclasses.replace(base, use_pallas="on"))
    assert a_pl._pallas_plans == ("edge_p2c",)
    if layout == "flat":
        assert a_pl.plans[0].E % pallas_p2c.BLOCK != 0

    st = a_ref.snapshot_states(system)
    _assert_systems_match(a_ref.assemble(st), a_pl.assemble(st))


@pytest.mark.parametrize("E", [5, pallas_p2c.BLOCK, pallas_p2c.BLOCK + 37])
def test_p2c_kernel_padding(tmp_path, E):
    """Any edge count: the wrapper pads to whole blocks and slices back,
    and every output keeps the edge-major shape the assembler reduces."""
    system = _ba_system(tmp_path, 8, 120, seed=3)
    asm = Assembler(system, SolverConfig(dtype=jnp.float32,
                                         edge_layout="flat",
                                         use_pallas="off"))
    plan = asm.plans[0]
    assert plan.E >= E
    data = asm.edge_data[plan.name]
    st = asm.snapshot_states(system)
    g = tuple(st[t][data["slot_local"][k][:E]]
              for k, t in enumerate(plan.slot_types))
    z, info = data["z"][:E], data["info"][:E]
    ref = asm._kernels[plan.name](g, z, info)
    out = pallas_p2c.p2c_edge_terms(g[0], g[1], z, info.reshape(E, 4),
                                    interpret=True)
    shapes = [(E,) if d == 0 else (E, d) for _n, d in pallas_p2c.OUT_WIDTHS]
    assert [o.shape for o in out] == shapes
    chi2_e, hdiag_e, gc, gp, hcc, hcp, hpp = out
    pairs = [(ref[0], chi2_e), (ref[1], hdiag_e), (ref[2][0], gc),
             (ref[2][1], gp), (ref[3][0], hcc), (ref[5][0], hcp),
             (ref[4][0], hpp)]
    for a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() < 1e-4 * max(np.abs(a).max(), 1.0)


@pytest.mark.parametrize("platform,dtype,expect", [
    ("gpu", jnp.float32, ("edge_p2c",)),
    ("gpu", jnp.float64, ()),
    ("cpu", jnp.float32, ()),
])
def test_pallas_auto_selection(tmp_path, monkeypatch, platform, dtype,
                               expect):
    """use_pallas="auto" picks the kernel for f32 on the GPU only."""
    policy = config.device_policy(platform)
    monkeypatch.setattr(assembler_mod, "device_policy", lambda: policy)
    monkeypatch.setattr(assembler_mod, "apply_matmul_precision",
                        lambda: None)
    system = _ba_system(tmp_path, 5, 40, seed=4)
    asm = Assembler(system, SolverConfig(dtype=dtype))
    assert asm._pallas_plans == expect


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided here, never at import time."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: the compiled Triton kernel needs the card "
                    "(set SLAMPP_TEST_PLATFORMS=cpu,cuda there)")


@pytest.mark.gpu
def test_pallas_compiled_matches_jacfwd(tmp_path, gpu_device):
    system = _ba_system(tmp_path, 12, 400, seed=81)
    base = SolverConfig(dtype=jnp.float32)
    with jax.default_device(gpu_device), \
            jax.default_matmul_precision("highest"):
        a_ref = Assembler(system, dataclasses.replace(base, use_pallas="off"))
        a_pl = Assembler(system, dataclasses.replace(base, use_pallas="on"))
        st = a_ref.snapshot_states(system)
        _assert_systems_match(a_ref.assemble(st), a_pl.assemble(st))
