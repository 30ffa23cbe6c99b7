"""Lane-axis sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from acme_tpu import models as M
from acme_tpu.engine import compile_model
from acme_tpu.parallel import lane_mesh, sharded_run, sharded_run_sweep


@pytest.fixture(scope="module")
def clipper_cm():
    return compile_model(M.diodeclipper_model())


def test_virtual_mesh_present():
    assert len(jax.devices()) == 8


def test_sharded_run_matches_local(clipper_cm):
    cm = clipper_cm
    T = 300
    L = 16
    u = np.stack([a * np.sin(2 * np.pi * 1000 / 44100 * np.arange(T))[None, :]
                  for a in np.linspace(0.1, 1.0, L)])
    mesh = lane_mesh(8)
    y_sh, _, info = sharded_run(cm, u, mesh)
    y_loc, _, _ = cm.run(u)
    np.testing.assert_allclose(np.asarray(y_sh), np.asarray(y_loc), atol=1e-12)
    assert bool(np.all(np.asarray(info.converged)))


def test_sharded_sweep_birdie():
    cm = compile_model(M.birdie_model())  # vol pot is input index 1
    T = 200
    L = 16
    u_time = 0.1 * np.sin(2 * np.pi * 1000 / 44100 * np.arange(T))[None, :]
    vols = np.linspace(0.1, 1.0, L)[:, None]
    mesh = lane_mesh(8)
    y_sh, _, info = sharded_run_sweep(cm, u_time, vols, (1,), mesh)
    assert bool(np.all(np.asarray(info.converged)))
    # spot-check one lane against the unsharded full-input path
    u_full = np.vstack([u_time, np.full((1, T), vols[5, 0])])
    y5, _, _ = cm.run(u_full)
    np.testing.assert_allclose(np.asarray(y_sh)[5], np.asarray(y5), atol=1e-11)


def test_sweep_equals_full_input():
    cm = compile_model(M.birdie_model())
    T = 150
    u_time = 0.1 * np.sin(2 * np.pi * 880 / 44100 * np.arange(T))[None, :]
    lane_vals = np.array([[0.3], [0.9]])
    y_sw, _, _ = cm.run_sweep(u_time, lane_vals, (1,))
    for i in range(2):
        u_full = np.vstack([u_time, np.full((1, T), lane_vals[i, 0])])
        yi, _, _ = cm.run(u_full)
        np.testing.assert_allclose(np.asarray(y_sw)[i], np.asarray(yi), atol=1e-12)


def test_lanes_not_divisible_raises(clipper_cm):
    mesh = lane_mesh(8)
    u = np.zeros((3, 1, 10))
    with pytest.raises(ValueError, match="not divisible"):
        sharded_run(clipper_cm, u, mesh)


def test_sharded_state_spans_the_mesh(clipper_cm):
    """The carry comes back sharded over every device of the mesh (no
    device holds all lanes)."""
    from acme_tpu.parallel import sharded_run

    mesh = lane_mesh(8)
    u = 0.3 * np.ones((16, 1, 12))
    _, st, _ = sharded_run(clipper_cm, u, mesh)
    owners = {s.device for s in st["x"].addressable_shards}
    assert len(owners) == 8
    assert all(s.data.shape[0] == 2 for s in st["x"].addressable_shards)
