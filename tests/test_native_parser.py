"""Native C++ reader vs pure-Python parser: byte-identical graph builds."""

import numpy as np
import pytest

import slam_plus_plus_tpu.models  # noqa: F401
from slam_plus_plus_tpu.io import datasets as D
from slam_plus_plus_tpu.io.native_parser import ensure_lib, parse_g2o_fast
from slam_plus_plus_tpu.io.parser import parse_g2o



@pytest.fixture
def native_lib():
    """The native reader, or a skip: decided here, never at import time."""
    lib = ensure_lib()
    if lib is None:
        pytest.skip("native lib unavailable")
    return lib


def _same(s1, s2):
    assert len(s1.vertex_order) == len(s2.vertex_order)
    assert s1.vertex_order == s2.vertex_order
    assert set(s1.edge_stores) == set(s2.edge_stores)
    for t in s1.vertex_stores:
        # bulk-vectorized pose inversion may round differently at 1 ulp
        assert np.allclose(s1.vertex_stores[t].data, s2.vertex_stores[t].data,
                           rtol=0, atol=1e-14)
    for t in s1.edge_stores:
        a, b = s1.edge_stores[t], s2.edge_stores[t]
        assert a.n == b.n
        assert np.array_equal(a.vertex_ids[:a.n], b.vertex_ids[:b.n])
        assert np.array_equal(a.measurements[:a.n], b.measurements[:b.n])
        assert np.array_equal(a.informations[:a.n], b.informations[:b.n])


@pytest.mark.parametrize("family", ["man", "lm", "ba", "sphere", "rocv"])
def test_native_matches_python(tmp_path, family, native_lib):
    if family == "man":
        poses, edges = D.make_manhattan_2d(n_poses=120, seed=50)
        p = str(tmp_path / "f.txt")
        D.write_g2o_2d(p, edges, poses)
    elif family == "lm":
        gp, gl, pe, le = D.make_landmark_2d(n_poses=60, n_landmarks=25, seed=51)
        p = str(tmp_path / "f.txt")
        D.write_g2o_landmark_2d(p, pe, le)
    elif family == "ba":
        cams, pts, obs = D.make_ba_scene(n_cams=6, n_points=80, seed=52)
        p = str(tmp_path / "f.txt")
        D.write_g2o_ba(p, cams, pts, obs)
    elif family == "sphere":
        poses, edges = D.make_sphere_3d(n_poses=60, seed=53)
        p = str(tmp_path / "f.txt")
        D.write_g2o_3d(p, edges, poses)
    else:
        tx, traj, ranges, dt = D.make_rocv_scene(n_steps=40, seed=54)
        p = str(tmp_path / "f.txt")
        D.write_g2o_rocv(p, tx, traj, ranges, dt)

    _same(parse_g2o(p), parse_g2o_fast(p))


def test_reader_builds_only_its_own_library(monkeypatch, tmp_path):
    """Building the reader must not need the embedding library's
    python3-config: make is asked for libspp_native.so alone."""
    from slam_plus_plus_tpu.io import native_parser as NP
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        raise OSError("no make here")

    monkeypatch.setattr(NP, "_lib", None)
    monkeypatch.setattr(NP, "_LIB_PATH", str(tmp_path / "missing.so"))
    monkeypatch.setattr(NP.subprocess, "run", fake_run)
    assert NP.ensure_lib() is None
    assert calls == [["make", "-C", NP._NATIVE_DIR, "libspp_native.so"]]


def test_cli_verbose_names_parser(tmp_path, capsys, monkeypatch, native_lib):
    from slam_plus_plus_tpu.app.main import main
    from slam_plus_plus_tpu.utils import cache
    monkeypatch.setattr(cache, "enable_compilation_cache", lambda: None)
    poses, edges = D.make_manhattan_2d(n_poses=40, seed=2)
    p = str(tmp_path / "m.g2o")
    D.write_g2o_2d(p, edges, poses)
    assert main(["-i", p, "-po", "-v", "-nb", "-dx", "", "-mfnsi", "1"]) == 0
    assert "parser: native" in capsys.readouterr().out
