"""Example-circuit integration tests: steady state, linearization,
composite elements (mirrors test/runtests.jl:294-384, 664-796).
"""

import numpy as np
import pytest

import acme_tpu as A
from acme_tpu import models as M
from acme_tpu.circuit import composite_element
from acme_tpu.runtime import linearize, steadystate_


def checksteady(model):
    """Run one zero-input sample from the steady state; x must not move
    (ref runtests.jl:664-671)."""
    x_steady = steadystate_(model)
    for s in model.solvers:
        s.set_resabstol(1e-13)
    A.run(model, np.zeros((model.nu, 1)))
    return np.allclose(model.x, x_steady, atol=1e-9)


def linearization_error(model, amplitude):
    """Max deviation of the linearized model on a chirp
    (ref runtests.jl:673-682; shorter chirp, same construction)."""
    linmodel = linearize(model)
    N = 8000
    u = (amplitude * np.sin(np.pi / 2 * np.arange(N + 1) ** 2 / N))[None, :]
    steadystate_(model)
    steadystate_(linmodel)
    y = A.run(model, u)
    ylin = A.run(linmodel, u)
    return float(np.max(np.abs(y - ylin)))


def test_sallenkey_steady():
    model = M.sallenkey_model()
    y = A.run(model, np.sin(2 * np.pi * 1000 / 44100 * np.arange(4410))[None, :])
    assert y.shape == (1, 4410)
    assert checksteady(model)


def test_diodeclipper_steady_and_linearization():
    model = M.diodeclipper_model()
    assert model.np(0) == 1
    y = A.run(model, np.sin(2 * np.pi * 1000 / 44100 * np.arange(4410))[None, :])
    assert y.shape == (1, 4410)
    assert checksteady(model)
    assert linearization_error(M.diodeclipper_model(), 1e-3) < 1e-15


def test_birdie_steady_and_linearization():
    model = M.birdie_model(vol=0.8)
    assert model.np(0) == 2
    y = A.run(model, np.sin(2 * np.pi * 1000 / 44100 * np.arange(4410))[None, :])
    assert y.shape == (1, 4410)
    assert checksteady(model)
    assert linearization_error(M.birdie_model(vol=0.8), 1e-4) < 1e-7


@pytest.mark.slow
def test_superover_steady_and_linearization():
    model = M.superover_model(drive=1.0, tone=1.0, level=1.0)
    assert model.np(0) == 5
    y = A.run(model, np.sin(2 * np.pi * 1000 / 44100 * np.arange(4410))[None, :])
    assert y.shape == (1, 4410)
    assert checksteady(model)
    # SuperOver really is not very linear (ref runtests.jl:749); the bound
    # here is looser than the reference's because our chirp is 8k samples
    # (not 50k), so it sweeps frequency faster
    assert linearization_error(
        M.superover_model(drive=1.0, tone=1.0, level=1.0), 1e-4) < 2e-4


def test_homotopy_solver_scalar_quadratic():
    """z^2 - 1 + p = 0 has no real solution for p > 1
    (ref runtests.jl:207-219)."""
    from acme_tpu.solvers import HomotopySolver, ParametricNonLinEq, SimpleSolver

    def func(res, J, scratch, z):
        p, Jp = scratch
        res[0] = z[0] ** 2 - 1 + p[0]
        J[0, 0] = 2 * z[0]
        Jp[0, 0] = 1.0

    rng = np.random.default_rng(1)
    nleq = ParametricNonLinEq(func, nn=1, np_=1)
    solver = HomotopySolver(nleq, np.zeros(1), np.ones(1), base=SimpleSolver)
    solver.solve(np.array([-0.5 + rng.random()]))
    assert solver.hasconverged()
    solver.solve(np.array([1.5 + rng.random()]))
    assert not solver.hasconverged()


def test_kdtree_exact_recovery():
    from acme_tpu.kdtree import KDTree
    rng = np.random.default_rng(2)
    for num in (1, 3, 7, 20, 50):
        ps = rng.random((4, num))
        t = KDTree(ps)
        for i in range(num):
            idx = t.nearest(ps[:, i])
            np.testing.assert_array_equal(ps[:, idx], ps[:, i])


def test_kdtree_nn_vs_bruteforce():
    from acme_tpu.kdtree import KDTree
    rng = np.random.default_rng(3)
    ps = rng.random((6, 5000))
    t = KDTree(ps)
    for _ in range(20):
        p = rng.random(6)
        best = int(np.argmin(np.sum((ps - p[:, None]) ** 2, axis=0)))
        idx = t.nearest(p)
        assert np.sum((p - ps[:, idx]) ** 2) == pytest.approx(
            np.sum((p - ps[:, best]) ** 2))


def test_linear_solver():
    """ref runtests.jl:23-41."""
    from acme_tpu.solvers import LinearSolver
    solver = LinearSolver(3)
    Amat = np.array([[1.0, 0.5, 0.4], [2.0, 4.0, 1.7], [4.0, 7.0, 9.1]])
    assert solver.setlhs(Amat)
    rng = np.random.default_rng(4)
    x = rng.random(3)
    y = np.empty(3)
    solver.solve(y, x)
    np.testing.assert_allclose(Amat @ y, x, atol=1e-12)
    y2 = x.copy()
    solver.solve(y2, y2)  # aliased solve
    np.testing.assert_allclose(Amat @ y2, x, atol=1e-12)
    with pytest.raises(ValueError):
        solver.setlhs(np.zeros((2, 3)))
    with pytest.raises(ValueError):
        solver.solve(np.zeros(2), np.zeros(3))
    assert not solver.setlhs(np.zeros((3, 3)))  # singular -> False


# --- composite elements (ref runtests.jl:294-384) --------------------------

def _ref_divider(extra=()):
    circ = A.Circuit()
    circ.add("r1", A.resistor(100e3))
    circ.add("r2", A.resistor(1e3))
    circ.connect(("r1", "2"), ("r2", "1"))
    circ.add("src", A.voltagesource(5))
    circ.connect(("src", "+"), ("r1", "1"))
    circ.connect(("src", "-"), ("r2", "2"))
    for name, elem, pins in extra:
        circ.add(name, elem)
        for p, target in pins:
            circ.connect((name, p), target)
    return circ


def _run_composite_vs_ref(subcirc_extra, ref_extra, u=None):
    sub = _ref_divider(subcirc_extra)
    U = composite_element(sub, pinmap={1: ("r2", "1"), 2: ("r2", "2")})
    circ = A.Circuit()
    circ.add("U", U)
    circ.add("J", A.voltageprobe(gp=2))
    circ.connect(("J", "+"), ("U", "1"))
    circ.connect(("J", "-"), ("U", "2"))
    model = A.DiscreteModel(circ, 1 / 44100)
    y = A.run(model, u if u is not None else np.zeros((0, 100)))

    refcirc = _ref_divider(ref_extra)
    refcirc.add("J", A.voltageprobe(gp=2))
    refcirc.connect(("J", "+"), ("r2", "1"))
    refcirc.connect(("J", "-"), ("r2", "2"))
    refmodel = A.DiscreteModel(refcirc, 1 / 44100)
    yref = A.run(refmodel, np.zeros((0, y.shape[1])))
    np.testing.assert_allclose(y, yref, atol=1e-12)


def test_composite_element_linear():
    _run_composite_vs_ref((), ())


def test_composite_element_with_state():
    cap = ("c", A.capacitor(1e-6), [("1", ("r2", "1")), ("2", ("r2", "2"))])
    _run_composite_vs_ref((cap,), (cap,))


def test_composite_element_with_nonlinearity():
    cap = ("c", A.capacitor(1e-6), [("1", ("r2", "1")), ("2", ("r2", "2"))])
    dio = ("d", A.diode(), [("+", ("r2", "1")), ("-", ("r2", "2"))])
    _run_composite_vs_ref((cap, dio), (cap, dio))


def test_composite_element_input_driven():
    # sub-circuit with an input voltage source; driving it with 5 V must
    # equal the constant-source reference
    sub = A.Circuit()
    sub.add("r1", A.resistor(100e3))
    sub.add("r2", A.resistor(1e3))
    sub.connect(("r1", "2"), ("r2", "1"))
    sub.add("src", A.voltagesource())
    sub.connect(("src", "+"), ("r1", "1"))
    sub.connect(("src", "-"), ("r2", "2"))
    U = composite_element(sub, pinmap={1: ("r2", "1"), 2: ("r2", "2")})
    circ = A.Circuit()
    circ.add("U", U)
    circ.add("J", A.voltageprobe(gp=2))
    circ.connect(("J", "+"), ("U", "1"))
    circ.connect(("J", "-"), ("U", "2"))
    model = A.DiscreteModel(circ, 1 / 44100)
    y = A.run(model, 5 * np.ones((1, 100)))

    refcirc = _ref_divider()
    refcirc.add("J", A.voltageprobe(gp=2))
    refcirc.connect(("J", "+"), ("r2", "1"))
    refcirc.connect(("J", "-"), ("r2", "2"))
    refmodel = A.DiscreteModel(refcirc, 1 / 44100)
    yref = A.run(refmodel, np.zeros((0, 100)))
    np.testing.assert_allclose(y, yref, atol=1e-12)


def test_decomposition_shape_fixtures():
    """Pin the solver-input dimensions np for every reference fixture
    (ref test/runtests.jl:733,744,757-759,768-770,777,786-791): these shapes
    encode the whole nldecompose/reduce_pdims pipeline and must not drift."""
    from fractions import Fraction

    def nps(model):
        return tuple(model.np(k) for k in range(model.nsubsystems))

    def simplified(**kw):
        """Base superover + stiff external vb source: breaks the bias
        feedback so nldecompose can split the nonlinearity into a chain
        (ref runtests.jl:751-755)."""
        circ = M.superover(**kw)
        circ.add("vbsrc", A.voltagesource(4.5))
        circ.connect(("vbsrc", "+"), "vb")
        circ.connect(("vbsrc", "-"), "gnd")
        return circ

    assert nps(M.birdie_model(vol=None)) == (3,)          # runtests.jl:733
    assert nps(M.superover_model(drive=1.0, tone=1.0, level=1.0)) == (5,)
    fixed = dict(drive=1.0, tone=1.0, level=1.0)
    assert nps(A.DiscreteModel(simplified(**fixed), Fraction(1, 44100))) \
        == (2, 1, 2)                                      # runtests.jl:757-759
    assert nps(A.DiscreteModel(simplified(**fixed), Fraction(1, 44100),
                               decompose_nonlinearity=False)) == (5,)
    assert nps(M.superover_model()) == (11,)              # runtests.jl:777
    assert nps(A.DiscreteModel(simplified(), Fraction(1, 44100))) \
        == (2, 2, 2, 4)                                   # runtests.jl:786-791


@pytest.mark.xfail(strict=True, reason="multi-root circuit: the chain "
                   "decomposition tracks a different (valid) root than the "
                   "monolithic solve — same in the reference, which marks "
                   "the simplified model's steady state @test_broken "
                   "(test/runtests.jl:763-764)")
def test_superover_chain_decomposition_output_invariance():
    """nldecompose does not change outputs when the per-sample solution is
    unique (asserted on the 3-diode circuit mirroring
    test/runtests.jl:267-292 in test_circuits_host.py).  The vb-source
    superover is NOT such a circuit: measured on the f64 host oracle, the
    decomposed np=(2,1,2) chain and the monolithic np=(5,) model settle
    onto different periodic orbits (plateau diff ~0.17 of a ~1.3 peak,
    persisting from identical near-zero initial states), i.e. the global
    system has multiple roots per sample and the two solve orders track
    different ones.  The monolithic orbit matches the full (unpinned-vb)
    superover to ~0.02; the reference has the same behavior and disables
    its steady check for exactly this model.  strict xfail: if this ever
    starts passing, the root structure changed — investigate."""
    from fractions import Fraction

    def build(**kw):
        circ = M.superover(drive=1.0, tone=1.0, level=1.0, vb_source=True)
        return A.DiscreteModel(circ, Fraction(1, 44100), **kw)

    m_chain = build()
    m_mono = build(decompose_nonlinearity=False)
    assert tuple(m_chain.np(k) for k in range(m_chain.nsubsystems)) \
        == (2, 1, 2)
    assert tuple(m_mono.np(k) for k in range(m_mono.nsubsystems)) == (5,)
    T = 600
    u = 0.4 * np.sin(2 * np.pi * 1000 / 44100 * np.arange(T))[None, :]
    y_chain = A.run(m_chain, u)
    y_mono = A.run(m_mono, u)
    ref = np.max(np.abs(y_mono))
    assert np.max(np.abs(y_chain - y_mono)) < 1e-8 * max(ref, 1.0)


@pytest.mark.xfail(strict=False, reason="chain-decomposed sym superover "
                   "steady state is broken in the reference too "
                   "(test/runtests.jl:763-764 @test_broken)")
def test_superover_sym_steady_broken():
    from fractions import Fraction
    circ = M.superover(drive=1.0, tone=1.0, level=1.0)
    circ.add("vbsrc", A.voltagesource(4.5))
    circ.connect(("vbsrc", "+"), "vb")
    circ.connect(("vbsrc", "-"), "gnd")
    model = A.DiscreteModel(circ, Fraction(1, 44100))
    assert checksteady(model)


def test_checkpoint_roundtrip_engine_state(tmp_path):
    """save_state/load_state must round-trip the scan engine's carry,
    which contains WarmStart NamedTuples (regression: NamedTuples were
    saved under numeric keys but loaded by field name)."""
    from acme_tpu.engine import compile_model
    from acme_tpu.utils.checkpoint import load_state, save_state

    model = M.diodeclipper_model()
    cm = compile_model(model)
    u = 0.5 * np.sin(2 * np.pi * 1000 / 44100 * np.arange(64))[None, :]
    y1, state, _ = cm.run(u)
    path = str(tmp_path / "carry.npz")
    save_state(path, state)
    restored = load_state(path, cm.initial_state(1))
    y2a, _, _ = cm.run(u, state=restored)
    y2b, _, _ = cm.run(u, state=state)
    np.testing.assert_allclose(np.asarray(y2a), np.asarray(y2b), atol=0)


def test_element_equality_distinguishes_parameters():
    """diode(is_=1e-15) != diode(is_=1e-12); equal parameters compare
    equal even across separately-constructed closures."""
    assert A.diode(is_=1e-12) == A.diode(is_=1e-12)
    assert A.diode(is_=1e-15) != A.diode(is_=1e-12)
    assert A.diode(is_=1e-12, eta=2.0) != A.diode(is_=1e-12)
    assert A.bjt("npn") == A.bjt("npn")
    assert A.bjt("npn", bf=100.0) != A.bjt("npn")
    assert A.resistor(1e3) == A.resistor(1e3)
    assert A.resistor(1e3) != A.resistor(2e3)
