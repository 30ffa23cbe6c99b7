"""Lane-batched steady states: runtime.steadystate_sweep and the scan
engine's per-lane steady start (CompiledModel.steady_initial_state).

Reference analog: steadystate!/run! state persistence (ACME.jl:474-503,
552-568), here vectorized over a lane axis of constant inputs so the
power-up transient of a parameter-grid run is eliminated entirely."""

import warnings
from fractions import Fraction

import numpy as np
import pytest

import acme_tpu as A
from acme_tpu import models as M
from acme_tpu.runtime import steadystate, steadystate_sweep


def test_steadystate_sweep_matches_scalar_birdie():
    """Well-behaved circuit: the sweep must agree with the scalar
    reference-faithful steadystate per lane -- except along eigenvalue -1
    modes of A (undamped sample-rate alternation, a trapezoidal
    artifact): the scalar solver returns the cycle MIDPOINT (the fixed
    point of f), the sweep returns an on-orbit PHASE point (fixed point
    of f^2, what the dynamics actually visits -- the better warm-start
    seed).  The difference must lie entirely in that alternating
    subspace."""
    m = M.birdie_model()
    a = np.asarray(m.a, float)
    # alternating subspace: null(I + A)
    U_, s_, Vt_ = np.linalg.svd(np.eye(m.nx) + a)
    V_alt = Vt_[s_ <= m.nx * np.finfo(float).eps * s_[0]].T
    vols = np.array([0.1, 0.5, 0.99])
    u_lanes = np.stack([np.zeros(3), vols], axis=1)
    x, z, conv = steadystate_sweep(m, u_lanes, runin=256)
    assert conv.all()
    for i, v in enumerate(vols):
        xs, zs = steadystate(m, np.array([0.0, v]), return_z=True)
        d = x[i] - xs
        if V_alt.size:
            d = d - V_alt @ (V_alt.T @ d)      # project off alternation
        assert np.max(np.abs(d)) <= 1e-9 * max(np.max(np.abs(xs)), 1e-12)
        assert np.max(np.abs(z[i] - zs)) <= 1e-8 * max(np.max(np.abs(zs)), 1.0)


def test_steadystate_sweep_linear_model():
    m = M.sallenkey_model()
    x, z, conv = steadystate_sweep(m, np.zeros((2, m.nu)))
    assert conv.all() and z.shape[1] == 0
    # fixed point of the linear update
    xn = m.a @ x.T + m.x0[:, None]
    assert np.max(np.abs(xn - x.T)) < 1e-12


@pytest.mark.slow
def test_steadystate_sweep_chain_superover_certifies_floor_free():
    """The hard case: chain-decomposed superover (singular I - A, slow
    bias-rail modes with tau ~ 30k-150k samples; the reference marks its
    steady state @test_broken, test/runtests.jl:763-764).

    History matters here: rounds 3-4 measured a ~4e-4 residual "dead
    zone" at this model's steady state (bias pair reverse-biased, no
    root) and built the certified-with-floor contract around it.  Round
    5 root-caused the dead zone as an ARTIFACT of a model-derivation bug
    (reduce_pdims omitted the earlier-z fold into the C/Fy consumers --
    inherited from the reference, whose own varying-pot output check is
    an open TODO, runtests.jl:792-793); on the fixed model the steady
    state is an ordinary solver-reachable root and every lane certifies
    with floors at f64 noise level (measured <= ~1e-10).  The
    certified-with-floor machinery stays (return_floors, kernel gate
    absorption) for genuinely floored circuits; this test now pins the
    fixed model: certification at the default run-in with NO significant
    floor."""
    circ = M.superover(level=1.0, vb_source=True)
    m = A.DiscreteModel(circ, Fraction(1, 44100))
    drives = np.array([0.50, 0.05])
    tones = np.array([0.50, 0.05])
    u_lanes = np.stack([np.zeros(2), drives, tones], axis=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        x, z, conv, floors = steadystate_sweep(m, u_lanes,
                                               return_floors=True)
    assert np.isfinite(x).all() and np.isfinite(z).all()
    assert conv.all()
    # no dead zone on the fixed model: floors sit at f64 solve noise
    assert floors.max() < 1e-8
    for i in range(2):
        m.x[:] = x[i]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            y = A.run(m, np.broadcast_to(u_lanes[i][:, None],
                                         (m.nu, 150)).copy())
        # the certified states are output-quiet under the host
        # (period-2-aware: eigenvalue -1 alternation is on-orbit).
        # Bound 2e-5: the host solver lands on a z a solver-noise step
        # away from the seeded point and relaxes with tau ~ 1e3 samples
        # (measured excursion 3.2e-6 decaying to 2e-8 within the window;
        # -94 dB of the ~1 V signal scale -- the same phenomenon
        # test_steadystate_sweep_certifies_chain_superover_endstop
        # documents), not a wrong-root latch (those sit volts away)
        assert np.max(np.abs(y[:, 2:] - y[:, :-2])) < 2e-5
        assert np.max(np.abs(y[:, 0])) < 1e-3


def test_steadystate_sweep_certifies_chain_superover_endstop():
    """drive=tone=1.0 (pot end-stop) chain superover: the vb bias rail
    settles with tau ~ 30k samples, so a long run-in is needed; the host
    arbiter must then accept the candidate even though the host solver's
    own first samples show a small RELAXING excursion (~1e-5 relative,
    tau ~ 1e3) from landing on a slightly different z -- solver noise,
    not a root walk-away (the round-3 arbiter read that excursion as
    drift and kept the whole level sweep cold)."""
    m = M.superover_model(drive=1.0, tone=1.0, level=1.0, fs=44100,
                          vb_source=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        x, z, conv = steadystate_sweep(m, np.zeros((1, m.nu)),
                                       runin=65536, attempts=1)
    assert conv.all()
    assert np.isfinite(x).all() and np.isfinite(z).all()


def test_engine_steady_initial_state_birdie():
    """Seeded f64 scan engine: from steady_initial_state the output is
    flat at each lane's steady value from sample 0 (no transient)."""
    from acme_tpu.engine import compile_model

    m = M.birdie_model()
    cm = compile_model(m)
    vols = np.array([[0.25], [0.75]])
    state = cm.steady_initial_state(vols, (1,))
    T = 64
    y, _, info = cm.run_sweep(np.zeros((1, T)), vols, (1,), state=state)
    y = np.asarray(y)
    for lane, vol in enumerate((0.25, 0.75)):
        xs, zs = steadystate(m, np.array([0.0, vol]), return_z=True)
        y_ss = (m.dy @ xs + m.ey @ np.array([0.0, vol]) + m.fy @ zs
                + m.y0)[0]
        assert np.max(np.abs(y[lane, 0] - y_ss)) < 1e-8


@pytest.mark.slow
def test_steadystate_sweep_512_lane_pots_grid():
    """Production-scale smoke of the lane-batched steady machinery: a
    512-lane drive x tone grid must certify EVERY lane at the default
    run-in and report floors at f64 solve noise.

    On the round-5 fixed model (reduce_pdims earlier-z fold) the bias
    rail settles with tau such that runin=256/512 certifies NOWHERE
    (0/512 measured) while runin=4096 -- the new default -- certifies
    4096/4096 on the full grid floor-free (seed-cache generation log,
    floors max ~9e-11); the round-4 "4085/4096 with 4e-4 floors" numbers
    were artifacts of the broken model."""
    circ = M.superover(level=1.0, vb_source=True)
    m = A.DiscreteModel(circ, Fraction(1, 44100))
    L = 512
    a = 16
    drives = np.repeat(np.linspace(0.05, 0.95, a), L // a)
    tones = np.tile(np.linspace(0.05, 0.95, L // a), a)
    u_lanes = np.stack([np.zeros(L), drives, tones], axis=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        x, z, conv, floors = steadystate_sweep(m, u_lanes,
                                               return_floors=True)
    assert np.isfinite(x).all() and np.isfinite(z).all()
    assert np.isfinite(floors).all()
    assert conv.all(), f"only {conv.sum()}/{L} lanes certified"
    assert floors.max() < 1e-8
