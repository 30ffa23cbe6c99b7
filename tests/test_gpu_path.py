"""The main path on the GPU, exercised here on the CPU: the scan engine's
run_sweep as bench.py and chip_smoke.py drive it -- ahead-of-time compile,
chunked state carry, lane independence, full-precision products -- and
the committed steady seeds and float64 references the card run is checked
against."""

import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from acme_tpu import models as M
from acme_tpu.engine import compile_model

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench  # noqa: E402


def _db(err, ref):
    return 20 * np.log10(err / np.max(np.abs(ref)) + 1e-300)


@pytest.fixture(scope="module")
def birdie_cm():
    return compile_model(M.birdie_model())


@pytest.fixture(scope="module")
def flagship():
    model = bench._build_model("pots", "chain", 44100)
    return model, compile_model(model, tol=1e-10)


def test_compile_sweep_then_run_reuses_the_executable(birdie_cm):
    T = 48
    u = (0.1 * np.sin(2 * np.pi * 1000 / 44100 * np.arange(T)))[None, :]
    vols = np.linspace(0.2, 0.9, 5)[:, None]
    assert birdie_cm.compile_sweep(u, vols, (1,)) > 0
    y, st, info = birdie_cm.run_sweep(u, vols, (1,))
    n = birdie_cm._scan_sweep._cache_size()
    y2, _, _ = birdie_cm.run_sweep(u, vols, (1,), state=st)
    assert birdie_cm._scan_sweep._cache_size() == n   # no retrace
    assert np.asarray(y).shape == np.asarray(y2).shape == (5, 1, T)
    assert bool(np.asarray(info.converged).all())


@pytest.mark.parametrize("split", [1, 17, 32, 63])
def test_run_sweep_chunks_carry_state_exactly(birdie_cm, split):
    """Streaming a window in two calls, carrying the state, equals one
    call bit for bit (the block-streaming contract)."""
    T = 64
    u = (0.1 * np.sin(2 * np.pi * 1000 / 44100 * np.arange(T)))[None, :]
    vols = np.array([[0.3], [0.8]])
    y, _, _ = birdie_cm.run_sweep(u, vols, (1,))
    y1, st, _ = birdie_cm.run_sweep(u[:, :split], vols, (1,))
    y2, _, _ = birdie_cm.run_sweep(u[:, split:], vols, (1,), state=st)
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(y1), np.asarray(y2)], axis=2),
        np.asarray(y))


@pytest.mark.parametrize("name,idx,values", [
    ("birdie_model", (1,), [[0.2], [0.5], [0.9], [0.65]]),
    ("superover_model", (1, 2), [[0.1, 0.9], [0.5, 0.5], [0.9, 0.2],
                                 [0.3, 0.7]]),
])
def test_run_sweep_lanes_are_independent(name, idx, values):
    """Permuting the lanes permutes the outputs and nothing else: no lane
    reads another (what makes the lane axis shardable)."""
    m = getattr(M, name)(**({"drive": None, "tone": None, "level": 1.0}
                            if name == "superover_model" else {}))
    cm = compile_model(m)
    T = 32
    u = (0.2 * np.sin(2 * np.pi * 1000 / 44100 * np.arange(T)))[None, :]
    lv = np.asarray(values)
    perm = np.array([2, 0, 3, 1])
    y, _, _ = cm.run_sweep(u, lv, idx)
    yp, _, _ = cm.run_sweep(u, lv[perm], idx)
    np.testing.assert_array_equal(np.asarray(yp), np.asarray(y)[perm])


@pytest.mark.parametrize("name,kw", [
    ("diodeclipper_model", {}),
    ("sallenkey_model", {}),
    ("birdie_model", {}),
    ("superover_model", {}),
    ("superover_model", dict(drive=None, tone=None, level=1.0,
                             vb_source=True)),
])
def test_engine_products_run_at_full_precision(name, kw):
    """Every matrix product of the scan step asks for HIGHEST precision:
    in float32 mode the GPU must not fall back to TF32 products."""
    m = getattr(M, name)(**kw)
    cm = compile_model(m)
    carry = cm.initial_state(3)
    u_t = jnp.zeros((3, m.nu), cm.dtype)
    jx = jax.make_jaxpr(cm.step_fn())(carry, u_t)

    def dots(j):
        for e in j.eqns:
            if e.primitive.name == "dot_general":
                yield e
            for v in e.params.values():
                for s in (v if isinstance(v, (list, tuple)) else [v]):
                    inner = getattr(s, "jaxpr", s)
                    if hasattr(inner, "eqns"):
                        yield from dots(inner)

    found = list(dots(jx.jaxpr))
    assert found
    for e in found:
        prec = e.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), prec


def test_float32_engine_tracks_float64():
    """The float32 engine (its default tolerance 5e-4 is scaled to
    float32) stays near the float64 one on the clipper."""
    T = 200
    u = (0.5 * np.sin(2 * np.pi * 1000 / 44100 * np.arange(T)))[None, :]
    y64, _, _ = compile_model(M.diodeclipper_model()).run(u)
    y32, _, info = compile_model(M.diodeclipper_model(),
                                 dtype=jnp.float32).run(u)
    assert np.asarray(y32).dtype == np.float32
    assert _db(np.max(np.abs(np.asarray(y32, np.float64)
                             - np.asarray(y64))), np.asarray(y64)) < -50


@pytest.mark.parametrize("lane", [0, 1, 2048, 4095])
def test_committed_seeds_reproduce_cached_references(flagship, lane):
    """The committed steady seeds (engine carry, seed3) start the flagship
    lanes where the cached float64 references started: the first samples
    of a run from them match the references far below -100 dB."""
    model, cm = flagship
    grid = bench._lane_grid("pots", 4096)
    tag = "seed3_pots_chain_fs44100_L4096"
    state = bench._steady_seed_cached(cm, grid[3], tag)
    st = jax.tree.map(lambda a: a[lane:lane + 1], state)
    T = 441
    u = 0.2 * np.sin(2 * np.pi * 1000 / 44100 * np.arange(T))
    y, _, info = cm.run_sweep(u[None], grid[3][lane:lane + 1], (1, 2),
                              state=st)
    args = bench.resolve_args(bench.build_parser().parse_args([]))
    refs, sel = bench._parity_refs(
        args, "pots", "chain", 44100, 5, "steady", [lane],
        lambda i: (1.0, float(grid[1][i]), float(grid[2][i])),
        cached_only=True)
    assert sel == [lane]
    pw, st_ref = refs[0]
    err = np.max(np.abs(np.asarray(y)[0, 0] - pw[:T]))
    assert 20 * np.log10(err / np.max(np.abs(st_ref))) < -110
    assert bool(np.asarray(info.converged).all())


def test_steady_seed_cache_round_trip(tmp_path, monkeypatch):
    """A seed-cache miss computes the engine's steady carry, stores it
    under the tag, and a second call loads the same carry back."""
    monkeypatch.setenv("ACME_TPU_SEED_CACHE", str(tmp_path / "seeds.npz"))
    cm = compile_model(M.birdie_model())
    vols = np.array([[0.3], [0.7]])
    s1 = bench._steady_seed_cached(cm, vols, "t_birdie", lane_idx=(1,))
    keys = set(np.load(tmp_path / "seeds.npz").files)
    assert keys == {"t_birdie_x", "t_birdie_p0", "t_birdie_z0",
                    "t_birdie_dzdp0"}
    s2 = bench._steady_seed_cached(cm, vols, "t_birdie", lane_idx=(1,))
    for a, b in zip(jax.tree.leaves(s1), jax.tree.leaves(s2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_iteration_histogram_counts_every_lane_sample(birdie_cm):
    T = 40
    u = (0.1 * np.sin(2 * np.pi * 1000 / 44100 * np.arange(T)))[None, :]
    vols = np.array([[0.25], [0.75], [0.5]])
    _, _, info = birdie_cm.run_sweep(u, vols, (1,))
    assert np.asarray(info.iters).shape == (T, 3, 1)
    edges, counts = info.iter_histogram()
    assert counts.shape == (1, len(edges) + 1)
    assert counts.sum() == T * 3


def test_run_sweep_rejects_mismatched_inputs(birdie_cm):
    u = np.zeros((2, 8))              # birdie has 2 inputs, one is a lane
    with pytest.raises(ValueError, match="lane inputs"):
        birdie_cm.run_sweep(u, np.full((4, 1), 0.5), (1,))
    with pytest.raises(ValueError, match="lane inputs"):
        birdie_cm.compile_sweep(u, np.full((4, 1), 0.5), (1,))


def test_run_sweep_equals_full_inputs_on_the_flagship_model(flagship):
    """The flagship's pot lanes through run_sweep equal run() with the pot
    positions written into a full (L, nu, T) input."""
    model, cm = flagship
    T = 24
    u = 0.2 * np.sin(2 * np.pi * 1000 / 44100 * np.arange(T))
    lv = np.array([[0.2, 0.8], [0.6, 0.3]])
    y, _, _ = cm.run_sweep(u[None], lv, (1, 2))
    full = np.zeros((2, model.nu, T))
    full[:, 0] = u
    full[:, 1:] = lv[:, :, None]
    yf, _, _ = cm.run(full)
    np.testing.assert_allclose(np.asarray(y), np.asarray(yf), rtol=0,
                               atol=1e-13)
