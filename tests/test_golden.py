"""Golden-output parity: the host runtime vs committed 50-digit traces.

The traces (tests/golden/*.npz) come from an INDEPENDENT simulator --
arbitrary-precision mpmath Newton re-implemented from the equations alone
(acme_tpu/utils/golden.py) -- breaking the scan -> host
self-referential parity chain.  The reference
leaves golden outputs as its own TODO
(/root/reference/test/runtests.jl:691,702,727); SURVEY.md section 4 names
golden-output parity as a required addition.

The host runtime solves to abstol 1e-10 in float64
(/root/reference/src/solvers.jl:175 semantics), so its error against a
50-digit truth is residual-limited: well below -120 dB of the signal
peak on every bundled example.
"""

import os

import numpy as np
import pytest

from acme_tpu import models as M
from acme_tpu.runtime import run

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

CASES = {
    "diodeclipper": lambda: M.diodeclipper_model(fs=44100),
    "sallenkey": lambda: M.sallenkey_model(fs=44100),
    "birdie": lambda: M.birdie_model(vol=0.8, fs=44100),
    "superover": lambda: M.superover_model(drive=1.0, tone=1.0, level=1.0,
                                           fs=44100),
    # pots-AS-INPUTS superover corners (variable-pot element,
    # /root/reference/src/elements.jl:20-31; np=11 fixture
    # test/runtests.jl:777): the flagship bench axis gets its own
    # independent anchors
    "superover_pots_lo": lambda: M.superover_model(level=1.0, fs=44100),
    "superover_pots_mid": lambda: M.superover_model(level=1.0, fs=44100),
    "superover_pots_hi": lambda: M.superover_model(level=1.0, fs=44100),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_runtime_matches_golden(name):
    data = np.load(os.path.join(HERE, f"{name}.npz"))
    u, y_gold = data["u"], data["y"]
    model = CASES[name]()
    if "x_init" in data:
        # steady-seeded trace: both sides start from the identical
        # representable (float64) state the generator saved
        model.x[:] = data["x_init"]
    # at the default 1e-10 abstol the np=5 superover block's solve error
    # (cond(J) * residual) sits at ~-113 dB; tighten toward the f64 floor
    # for the parity assertion (the setter mirrors solvers.jl:181)
    for s in model.solvers:
        s.set_resabstol(1e-13)
    y = run(model, u)
    ref = max(float(np.max(np.abs(y_gold))), 1e-9)
    err = float(np.max(np.abs(y - y_gold)))
    db = 20 * np.log10(err / ref + 1e-300)
    assert db < -120, f"{name}: host vs golden {db:.1f} dB (ref peak {ref})"


def test_golden_traces_nontrivial():
    """Guard against a silently degenerate trace (all-zero output)."""
    for name in CASES:
        y = np.load(os.path.join(HERE, f"{name}.npz"))["y"]
        assert np.max(np.abs(y)) > 1e-6, name
