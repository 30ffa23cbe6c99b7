"""Device-runtime (JAX scan engine) tests: golden parity against the host
reference runtime, lane batching consistency, convergence-failure semantics.

Parity bound: the driver's north star is -100 dB output error
(BASELINE.md); both runtimes are float64 here, so we check well below that.
"""

import numpy as np
import pytest

import acme_tpu as A
from acme_tpu import models as M
from acme_tpu.engine import compile_model
from acme_tpu.ops.linsolve import solve_dense

import jax.numpy as jnp


def _db(err, ref):
    return 20 * np.log10(err / np.max(np.abs(ref)) + 1e-300)


@pytest.fixture(scope="module")
def sine():
    return np.sin(2 * np.pi * 1000 / 44100 * np.arange(1500))[None, :]


class TestSolveDense:
    def test_solves(self):
        rng = np.random.default_rng(0)
        for n in (1, 2, 3, 5, 8):
            J = rng.normal(size=(n, n))
            b = rng.normal(size=(n, 2))
            X, ok = solve_dense(jnp.asarray(J), jnp.asarray(b))
            assert bool(ok)
            np.testing.assert_allclose(J @ np.asarray(X), b, atol=1e-10)

    def test_singular_flags_not_raises(self):
        X, ok = solve_dense(jnp.zeros((3, 3)), jnp.ones((3, 1)))
        assert not bool(ok)
        assert np.all(np.isfinite(np.asarray(X)))

    def test_pivoting(self):
        # leading zero pivot requires a row swap
        J = jnp.array([[0.0, 1.0], [1.0, 0.0]])
        b = jnp.array([[2.0], [3.0]])
        X, ok = solve_dense(J, b)
        assert bool(ok)
        np.testing.assert_allclose(np.asarray(X).ravel(), [3.0, 2.0])


def test_diodeclipper_parity(sine):
    m = M.diodeclipper_model()
    cm = compile_model(m)
    y, _, info = cm.run(sine)
    yh = A.run(M.diodeclipper_model(), sine)
    assert bool(np.all(np.asarray(info.converged)))
    assert _db(np.max(np.abs(np.asarray(y) - yh)), yh) < -120


def test_birdie_parity(sine):
    cm = compile_model(M.birdie_model(vol=0.8))
    y, _, info = cm.run(sine)
    yh = A.run(M.birdie_model(vol=0.8), sine)
    assert bool(np.all(np.asarray(info.converged)))
    assert _db(np.max(np.abs(np.asarray(y) - yh)), yh) < -120


@pytest.mark.slow
def test_superover_parity(sine):
    cm = compile_model(M.superover_model(drive=1.0, tone=1.0, level=1.0))
    y, _, info = cm.run(sine)
    yh = A.run(M.superover_model(drive=1.0, tone=1.0, level=1.0), sine)
    assert bool(np.all(np.asarray(info.converged)))
    assert _db(np.max(np.abs(np.asarray(y) - yh)), yh) < -100


def test_state_carry_across_runs(sine):
    cm = compile_model(M.diodeclipper_model())
    y1, st, _ = cm.run(sine[:, :700])
    y2, st, _ = cm.run(sine[:, 700:], state=st)
    yfull, _, _ = cm.run(sine)
    np.testing.assert_allclose(
        np.hstack([np.asarray(y1), np.asarray(y2)]), np.asarray(yfull),
        atol=1e-12)


def test_lane_batching_matches_single(sine):
    m = M.birdie_model()  # varying vol: 2 inputs
    cm = compile_model(m)
    L = 4
    vols = np.linspace(0.2, 1.0, L)
    ub = np.stack([np.vstack([sine[0], np.full(sine.shape[1], v)]) for v in vols])
    yb, _, _ = cm.run(ub)
    for i in (0, 3):
        yi, _, _ = cm.run(ub[i])
        np.testing.assert_allclose(np.asarray(yb[i]), np.asarray(yi), atol=1e-11)


def test_nonconvergence_semantics():
    # diode driven backwards by a current source has no solution
    circ = A.Circuit()
    circ.add("d", A.diode())
    circ.add("src", A.currentsource())
    circ.connect(("src", "+"), ("d", "+"))
    circ.connect(("src", "-"), ("d", "-"))
    circ.add("probe", A.voltageprobe())
    circ.connect(("probe", "+"), ("d", "+"))
    circ.connect(("probe", "-"), ("d", "-"))
    model = A.DiscreteModel(circ, 1)
    cm = compile_model(model)
    y, _, info = cm.run(np.array([[1.0, 1.0]]))
    assert bool(np.all(np.asarray(info.converged)))
    cm2 = compile_model(A.DiscreteModel(circ, 1))
    with pytest.warns(UserWarning, match="Failed to converge"):
        y, _, info = cm2.run(np.array([[-1.0]]))
    assert not bool(np.all(np.asarray(info.converged)))


def test_linear_model_runs(sine):
    cm = compile_model(M.sallenkey_model())
    y, _, info = cm.run(sine)
    yh = A.run(M.sallenkey_model(), sine)
    np.testing.assert_allclose(np.asarray(y), yh, atol=1e-12)


def test_per_lane_model_matrices():
    """Component-value sweep via per-lane matrices: each lane is a
    diodeclipper compiled with a different series resistor; the batch
    runtime must match per-lane host runs."""
    from acme_tpu.engine import compile_models
    from acme_tpu.models import diodeclipper
    rs = [820.0, 1000.0, 1500.0, 4700.0]

    def build(r):
        circ = diodeclipper()
        circ.delete("r1")
        circ.add("r1", A.resistor(r))
        circ.connect(("r1", 1), ("j_in", "+"))
        circ.connect(("r1", 2), ("d1", "+"))
        return A.DiscreteModel(circ, 1 / 44100)

    models = [build(r) for r in rs]
    T = 400
    u = 2.0 * np.sin(2 * np.pi * 1000 / 44100 * np.arange(T))[None, :]
    bm = compile_models(models)
    y, state, info = bm.run(u)
    assert y.shape == (len(rs), 1, T)
    assert bool(np.all(np.asarray(info.converged)))
    for i, r in enumerate(rs):
        yh = A.run(build(r), u)
        assert np.max(np.abs(np.asarray(y[i]) - yh)) < 2e-7
    # distinct resistors must give distinct outputs
    assert np.max(np.abs(np.asarray(y[0]) - np.asarray(y[-1]))) > 1e-3


def test_no_retrace_and_no_bulk_host_fetch(sine):
    """Hot-loop regression guard (the reference asserts 0 bytes allocated
    per run!, test/runtests.jl:712-715): a second
    run with the same shapes must not retrace/recompile, and the warn-path
    finiteness check must reduce on device (two scalars), not fetch the
    full output."""
    cm = compile_model(M.diodeclipper_model())
    y1, st, _ = cm.run(sine)
    n_traces = cm._scan._cache_size()
    y2, st, _ = cm.run(sine, state=st)
    assert cm._scan._cache_size() == n_traces, "same-shape run retraced"
    # the device-side reduction helper is jitted once, reused across runs
    from acme_tpu.engine import _finite_conv
    n_fc = _finite_conv._cache_size()
    y3, st, _ = cm.run(sine, state=st)
    assert _finite_conv._cache_size() == n_fc
