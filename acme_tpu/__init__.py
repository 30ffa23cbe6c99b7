"""acme_tpu: analog circuit modeling and emulation on the GPU.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of ACME.jl
(HSU-ANT/ACME.jl): describe a circuit as a netlist, derive -- exactly, in
rational arithmetic -- a discrete-time nonlinear state-space model, then
run it.

Two runtimes share one compiled model:
  * the host runtime (acme_tpu.runtime): numpy float64, per-sample loop with
    the reference's variable-iteration Newton/homotopy/caching solver chain;
    this is the semantics oracle.
  * the device runtime (acme_tpu.engine): a ``lax.scan`` over time whose
    body is a batched, per-lane-masked Newton with previous-sample warm
    starts and a homotopy fallback, vmapped/sharded over thousands of
    circuit instances ("lanes"), on the GPU when there is one.

Precision: the build pipeline is exact; the runtimes default to float64
(set ACME_TPU_X64=0 before import to run float32 everywhere).
"""

from __future__ import annotations

import os

# Enable x64 before anything touches jax.numpy.  The reference runs its hot
# loop entirely in Float64 (src/ACME.jl:118-148); float64 is therefore the
# parity-safe default, with float32 available for speed (see BASELINE.md).
if os.environ.get("ACME_TPU_X64", "1") != "0":
    import jax as _jax

    _jax.config.update("jax_enable_x64", True)

from .circuit import Circuit, composite_element, parse_netlist  # noqa: E402
from .element import Element, NLFunc  # noqa: E402
from .elements import (bjt, capacitor, currentprobe, currentsource, diode,  # noqa: E402
                       inductor, mosfet, opamp, potentiometer, resistor,
                       transformer, voltageprobe, voltagesource)
from .model import DiscreteModel  # noqa: E402
from .runtime import (ModelRunner, linearize, run, steadystate,  # noqa: E402
                      steadystate_, steadystate_sweep)
from .solvers import (CachingSolver, HomotopySolver, SimpleSolver,  # noqa: E402
                      default_solver, homotopy_simple_solver)

__all__ = [
    "Circuit", "parse_netlist", "composite_element",
    "Element", "NLFunc", "DiscreteModel",
    "resistor", "potentiometer", "capacitor", "inductor", "transformer",
    "voltagesource", "currentsource", "voltageprobe", "currentprobe",
    "diode", "bjt", "mosfet", "opamp",
    "run", "ModelRunner", "steadystate", "steadystate_",
    "steadystate_sweep", "linearize",
    "SimpleSolver", "HomotopySolver", "CachingSolver",
    "default_solver", "homotopy_simple_solver",
]

__version__ = "0.2.0"
