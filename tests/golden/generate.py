#!/usr/bin/env python
"""Generate the committed golden traces (tests/golden/*.npz).

Each trace is produced by acme_tpu.utils.golden.golden_run -- a 50-digit
mpmath per-sample simulator that shares nothing with the production
runtimes except the frozen model matrices and the element residual
definitions (see that module's docstring).  The traces break the repo's
self-referential parity chain (scan -> host -> transcribed
semantics); the reference's own tests leave golden outputs as a TODO
(/root/reference/test/runtests.jl:691,702,727).

Deterministic: fixed inputs, fixed precision.  Re-run to regenerate after
a model-build change (the matrices are part of the trace identity; the
test compares the HOST RUNTIME on the same freshly built model, so a
compiler change that alters the matrices legitimately regenerates).

Runtime: ~2-4 min total (superover's nn=7 object-array Newton dominates).
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from acme_tpu import models as M                     # noqa: E402
from acme_tpu.utils.golden import golden_run, golden_steadystate  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FS = 44100
T = 300


def cases():
    t = np.arange(T)
    sine = np.sin(2 * np.pi * 1000 / FS * t)[None, :]
    yield ("diodeclipper", M.diodeclipper_model(fs=FS), 0.5 * sine, False)
    yield ("sallenkey", M.sallenkey_model(fs=FS), 0.5 * sine, False)
    yield ("birdie", M.birdie_model(vol=0.8, fs=FS), 0.1 * sine, False)
    # the reference-faithful (un-decomposed, np=5) superover: golden Newton
    # warm-starts per sample like the host chain; the full model is
    # single-subsystem, so there is no decomposition multi-root ambiguity.
    # Steady-seeded (golden_steadystate, itself independent mpmath): from
    # x = 0 the AC-coupled output stays ~1e-9 for tens of ms (bias-rail
    # tau is 30k-150k samples) and a 300-sample cold trace is degenerate.
    yield ("superover", M.superover_model(drive=1.0, tone=1.0, level=1.0,
                                          fs=FS), 0.2 * sine, True)
    # pots-AS-INPUTS superover (variable pots, the flagship bench axis;
    # reference fixture np=11, test/runtests.jl:777): drive/tone corner
    # traces so the varying-pot element path
    # (/root/reference/src/elements.jl:20-31) has an independent anchor
    # too.  Un-decomposed variant: single subsystem, no decomposition
    # multi-root ambiguity, and I - A stays invertible for
    # golden_steadystate's folded solve.  Steady at each corner's own
    # constant pot inputs (u rows: 0 = audio, 1 = drive, 2 = tone).
    for cname, dr, tn in (("pots_lo", 0.05, 0.05),
                          ("pots_mid", 0.5, 0.5),
                          ("pots_hi", 0.95, 0.95)):
        mv = M.superover_model(level=1.0, fs=FS)
        uv = np.vstack([0.2 * sine,
                        np.full((1, T), dr), np.full((1, T), tn)])
        yield (f"superover_{cname}", mv, uv, np.array([0.0, dr, tn]))


def main():
    only = set(sys.argv[1:])       # generate.py [name ...] regenerates a subset
    for name, model, u, steady in cases():
        if only and name not in only:
            continue
        t0 = time.time()
        extra = {}
        if steady is not False:
            # True -> steady at u = 0; an array -> steady at that
            # constant input (pots-corner traces)
            u_const = None if steady is True else steady
            x_init, z_init = golden_steadystate(model, u_const=u_const,
                                                dps=50)
            extra = {"x_init": x_init, "z_init": z_init}
        y = golden_run(model, u, dps=50, **extra)
        np.savez_compressed(os.path.join(HERE, f"{name}.npz"),
                            u=u.astype(np.float64),
                            y=y.astype(np.float64),
                            fs=FS, dps=50, **extra)
        print(f"{name}: T={u.shape[1]} ny={y.shape[0]} "
              f"peak={np.max(np.abs(y)):.4f}  ({time.time()-t0:.1f}s)",
              flush=True)


if __name__ == "__main__":
    main()
