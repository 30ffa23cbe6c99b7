"""bench.py's lane grid, parity-lane choice and entry behaviour (the
measurement itself runs on the GPU; see chip_smoke.py)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench  # noqa: E402


@pytest.mark.parametrize("L", [4096, 16, 12, 7])
def test_pots_grid_covers_the_travel(L):
    levels, drive, tone, lane_values, cfg = bench._lane_grid("pots", L)
    assert levels is None and cfg == dict(lane_input_idx=(1, 2))
    assert lane_values.shape == (L, 2)
    for axis in (drive, tone):
        assert axis.min() == pytest.approx(0.05)
        if len(set(axis)) > 1:                  # a prime L has one drive
            assert axis.max() == pytest.approx(0.95)
    assert len({(d, t) for d, t in lane_values}) == L   # distinct lanes


@pytest.mark.parametrize("L,K", [(4096, 16), (64, 8), (5, 16)])
def test_parity_lanes_are_deterministic(L, K):
    stress = bench._stress_lanes("pots", L)
    a = bench._select_parity_lanes(L, K, stress)
    b = bench._select_parity_lanes(L, K, stress)
    assert a == b == sorted(set(a))
    assert all(0 <= i < L for i in a)
    assert set(stress) <= set(a)
    assert {0, L - 1} <= set(a)


def test_flagship_parity_lanes_have_cached_references():
    """The committed reference cache scores all 18 flagship lanes."""
    L = 4096
    levels, drive, tone, _, _ = bench._lane_grid("pots", L)
    stress = bench._stress_lanes("pots", L)
    assert len(stress) == 2
    sel = bench._select_parity_lanes(L, 16, stress)
    assert len(sel) == 18
    args = bench.resolve_args(bench.build_parser().parse_args([]))
    refs, got = bench._parity_refs(
        args, "pots", "chain", 44100, 5, "steady", sel,
        lambda i: (1.0, float(drive[i]), float(tone[i])), cached_only=True)
    assert got == sel
    for pw, st in refs:
        assert pw.shape == st.shape == (44100,)
        assert np.all(np.isfinite(pw)) and np.max(np.abs(st)) > 1e-3


def test_parity_db():
    ref = np.array([0.0, 1.0, -2.0])
    assert bench.parity_db(ref + 2e-5, ref, 2.0) == pytest.approx(-100.0)
    assert bench.parity_db(ref, ref, 2.0) < -300


def _run(args, **env):
    e = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable, str(REPO / "bench.py"), *args],
                          cwd=REPO, env=e, capture_output=True, text=True,
                          timeout=600)


def test_bench_refuses_without_gpu():
    p = _run(["--lanes", "16", "--seconds", "0.001"])
    assert p.returncode != 0
    assert "GPU" in p.stderr
    assert p.stdout.strip() == ""


def test_bench_smoke_names_its_device(tmp_path):
    import json
    p = _run(["--smoke"],
             ACME_TPU_HOSTREF_CACHE=str(tmp_path / "refs.npz"))
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["device"]["platform"] == "cpu"
    assert out["converged"] and out["finite"]
    assert out["parity_db"] < -100


def test_flagship_cell_defaults():
    """The default command line is the flagship cell: 4096 lanes, 1 s
    windows at 44.1 kHz, steady starts, the reference's tolerance."""
    a = bench.resolve_args(bench.build_parser().parse_args([]))
    assert (a.lanes, a.seconds, a.fs, a.reps) == (4096, 1.0, 44100, 5)
    assert (a.model, a.powerup) == ("chain", "steady")
    assert a.parity_lanes == 16
    assert bench.resolve_args(
        bench.build_parser().parse_args(["--no-parity"])).parity_lanes == 0


def test_device_info_names_the_platform():
    d = bench.device_info()
    assert d["platform"] == "cpu" and d["count"] >= 1
    assert d["card"] is None or isinstance(d["card"], str)
