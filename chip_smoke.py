#!/usr/bin/env python
"""Smoke test of the main path on the GPU, at the flagship's full width.

    python chip_smoke.py              # the flagship on one card
    python chip_smoke.py --devices 4  # lane sharding over 4 cards, only

Phases (each prints its numbers on a line of its own):

  1. device   -- JAX must see a GPU; prints the card's name and power limit.
  2. flagship -- the main path, ``CompiledModel.run_sweep`` (the float64
                 scan engine), on the flagship cell at full width: the
                 chain-decomposed superover with drive and tone pots as
                 lane inputs, 4096 lanes over the drive x tone grid at
                 44.1 kHz, every lane started at its committed steady seed,
                 the reference's Newton tolerance.  Windows are cut to
                 4410 samples so the run fits its time limit: compile,
                 first window, one warm-up and 5 timed chained windows.
  3. parity   -- (a) the flagship's first window on 16 stratified lanes
                 plus 2 stress lanes against the committed float64
                 references (their first 4410 samples); (b) the same 18
                 lanes over a whole 1 s window at the oracle tolerance
                 1e-12 against the same references.

With ``--devices N`` only the multi-card phase runs: ``sharded_run_sweep``
over an N-card mesh against the unsharded engine, 16 lanes x 256 samples.

Every failure exits non-zero and prints no result.  The last line of a
passing run is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
LANES = 4096
WINDOW = 4410       # samples per timed window (0.1 s at 44.1 kHz)
REF_WINDOW = 44100  # samples per cached reference window


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def report(phase, **numbers):
    print(f"[{phase}] " + json.dumps(numbers), flush=True)


def smoke_args(*argv):
    import bench
    return bench.resolve_args(bench.build_parser().parse_args(list(argv)))


def parity_lanes(args):
    """The 18 parity lanes, their cached 1 s references and stress flags."""
    import bench
    levels, drive, tone, lane_values, _ = bench._lane_grid("pots", LANES)
    stress = bench._stress_lanes("pots", LANES)
    sel = bench._select_parity_lanes(LANES, 16, stress)
    refs, sel = bench._parity_refs(
        args, "pots", "chain", REF_WINDOW, 5, "steady", sel,
        lambda i: (1.0, float(drive[i]), float(tone[i])), cached_only=True)
    check(len(sel) == 18, f"{len(sel)} of 18 parity lanes have cached "
          "references")
    return sel, [i in stress for i in sel], refs, lane_values[sel]


def summarize(dbs, stress):
    plain = [d for d, s in zip(dbs, stress) if not s]
    return {"worst_non_stress_db": max(plain),
            "median_db": float(sorted(dbs)[len(dbs) // 2]),
            "stress_lanes_db": [d for d, s in zip(dbs, stress) if s]}


def phase_flagship(args):
    import numpy as np

    import bench
    r = bench.run_cell(args, LANES, args.reps, 0, "flagship",
                       keep_first=True)
    report("flagship", lanes=LANES, window_samples=r["window_samples"],
           tol=r["tol"], compile_s=r["compile_s"],
           first_run_s=r["first_run_s"], ms_per_window=r["ms_per_window"],
           rt_per_lane=r["rt"], msamples_per_s=r["msamples_per_s"],
           converged=r["converged"],
           iters_per_lane_sample=r["iters_per_sample_mean"])
    check(r["finite"], "flagship output not finite")
    check(r["converged"], "flagship run: some lane-samples did not converge")
    sel, stress, refs, _ = parity_lanes(args)
    y0 = np.asarray(r["first_window"][np.asarray(sel), 0, :])
    T = y0.shape[1]
    dbs = [bench.parity_db(y0[n], pw[:T], max(float(np.abs(st).max()),
                                               1e-12))
           for n, (pw, st) in enumerate(refs)]
    s = summarize(dbs, stress)
    report("parity_flagship", lanes=len(sel), samples=T, **s)
    check(s["worst_non_stress_db"] <= -100.0,
          f"flagship first window vs references: "
          f"{s['worst_non_stress_db']} dB > -100 dB on a non-stress lane")
    return r


def phase_reference(args):
    import numpy as np

    import bench
    from acme_tpu.engine import compile_model
    sel, stress, refs, lv = parity_lanes(args)
    model = bench._build_model("pots", "chain", args.fs)
    # the references' own protocol: per-lane steady start (seeding tol
    # 1e-9), then the tol=1e-12 oracle over a whole window
    state = compile_model(model, tol=1e-9).steady_initial_state(lv, (1, 2))
    cm = compile_model(model, tol=1e-12)
    u = 0.2 * np.sin(2 * np.pi * 1000 / args.fs * np.arange(REF_WINDOW))
    t0 = time.time()
    y, _, info = cm.run_sweep(u[None, :], lv, (1, 2), state=state)
    y = np.asarray(y)
    dt = time.time() - t0
    dbs = [bench.parity_db(y[n, 0], pw, max(float(np.abs(st).max()), 1e-12))
           for n, (pw, st) in enumerate(refs)]
    s = summarize(dbs, stress)
    report("parity_reference", lanes=len(sel), samples=REF_WINDOW, tol=1e-12,
           compile_and_window_s=round(dt, 1),
           converged=bool(np.asarray(info.converged).all()), **s)
    check(np.all(np.isfinite(y)), "reference-window output not finite")
    check(s["worst_non_stress_db"] <= -110.0,
          f"1 s window at tol 1e-12 vs references: "
          f"{s['worst_non_stress_db']} dB > -110 dB on a non-stress lane")


def phase_multi(args, ndev, lanes=16, samples=256):
    import numpy as np

    import jax

    import bench
    from acme_tpu.engine import compile_model
    from acme_tpu.parallel import lane_mesh, sharded_run_sweep

    check(len(jax.devices()) >= ndev,
          f"{ndev} cards asked for, JAX sees {len(jax.devices())}")
    mesh = lane_mesh(ndev)
    model = bench._build_model("pots", "chain", args.fs)
    cm = compile_model(model)
    lv = bench._lane_grid("pots", LANES)[3][:: LANES // lanes][:lanes]
    u = 0.2 * np.sin(2 * np.pi * 1000 / args.fs * np.arange(samples))
    t0 = time.time()
    ys, st, info = sharded_run_sweep(cm, u[None, :], lv, (1, 2), mesh)
    owners = sorted({str(s.device) for s in st["x"].addressable_shards})
    ys = np.asarray(ys)
    ts = time.time() - t0
    yl, _, _ = cm.run_sweep(u[None, :], lv, (1, 2))
    yl = np.asarray(yl)
    diff = float(np.max(np.abs(ys - yl)))
    scale = float(np.max(np.abs(yl)))
    report("multi", cards=ndev, lanes=lanes, samples=samples,
           sharded_compile_and_run_s=round(ts, 1), state_shards_on=owners,
           max_abs_diff=diff, scale=scale,
           converged=bool(np.asarray(info.converged).all()))
    check(len(owners) == ndev, f"state sits on {owners}, not {ndev} cards")
    check(np.all(np.isfinite(ys)) and diff <= 1e-12 * max(scale, 1.0),
          f"sharded scan engine differs from unsharded by {diff}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="1 (default): the flagship on one card; N > 1: "
                         "only the lane-sharding phase, over N cards")
    opts = ap.parse_args(argv)
    if not (os.path.isfile(os.path.join(HERE, "acme_tpu", "__init__.py"))
            and os.path.isfile(os.path.join(HERE, "bench.py"))):
        print("chip_smoke.py runs from a checkout of the repository "
              "(acme_tpu/ and bench.py beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {devs}",
              file=sys.stderr)
        return 1
    import bench
    from acme_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    t_start = time.time()
    try:
        report("device", platform=devs[0].platform,
               kind=devs[0].device_kind, count=len(devs))
        card = bench.card_info()
        print(f"card: {card}", flush=True)
        check(card, "nvidia-smi gave no card name and power limit")
        args = smoke_args("--seconds", str(WINDOW / 44100))
        if opts.devices > 1:
            phase_multi(args, opts.devices)
        else:
            phase_flagship(args)
            phase_reference(args)
        report("done", total_s=round(time.time() - t_start, 1))
    except Exception as e:
        import traceback
        traceback.print_exc()
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
