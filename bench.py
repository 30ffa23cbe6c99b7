#!/usr/bin/env python
"""Benchmark: superover parameter sweep on one GPU.

Headline workload (BASELINE.md): the 'Der Super Over' overdrive at
44.1 kHz across a drive x tone pot grid -- L independent parameter lanes
through the float64 scan engine (``CompiledModel.run_sweep``), every lane
started at ITS OWN steady state (runtime.steadystate_sweep, cached).
Metrics: real-time factor per lane at 4096 lanes, aggregate Msamples/s,
and set-up time split into compile and first window.

The benched circuit is the reference's own *simplified* superover (adds
the stiff vb bias source, test/runtests.jl:751-755), whose nonlinearity
decomposes into a chain of small subsystems -- np=(2,2,2,2) with pots
varying.  CAVEAT (pinned by a strict xfail in tests/test_examples.py): in
multi-root regions the decomposed chain tracks a different valid orbit
than the un-decomposed circuit (``--model full``), so chain parity is
defined against the chain oracle (both sides decompose identically).

Timing methodology: N chained runs ending with a forced device-to-host
fetch of a few samples; the per-run cost is the amortized wall time.

Parity: a stratified sample of lanes (4 corners + seeded interior, 16 by
default, plus 2 pinned stress lanes) is checked against cached float64
references from the same engine at the oracle tolerance tol=1e-12 (the
engine is pinned against the per-sample host runtime at <= -110 dB by
tests/, and the host runtime against independent 50-digit mpmath traces by
tests/test_golden.py), on the first window and the chained steady window.
The reference-faithful tolerance 1e-10 (solvers.jl:175) carries its own
solver noise at max-slew samples; the 1e-12 and 1e-13 oracle series agree
to <= -133 dB.  References are cached on disk (.hostref_cache.npz,
committed, 1 s windows) and so are the per-lane steady seeds
(.steadyseed_cache.npz) -- deterministic host-side numpy, minutes cold at
4096 lanes.

The measurement needs a GPU and fails without one; ``--smoke`` is an
explicit tiny CPU run (API liveness, no timing claim) and ``--gen-refs``
regenerates the reference cache on the CPU.

Prints ONE JSON line: {"metric", "value", "unit", "device", ...extras}.
Diagnostics go to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _build_model(sweep: str, variant: str, fs: int):
    from acme_tpu.models import superover_model
    vb = variant == "chain"
    if sweep == "pots":
        return superover_model(drive=None, tone=None, level=1.0, fs=fs,
                               vb_source=vb)
    return superover_model(drive=1.0, tone=1.0, level=1.0, fs=fs,
                           vb_source=vb)


def _lane_grid(sweep: str, L: int):
    """The lane axis: (levels, drive, tone, lane_values, lane_cfg); the
    pots grid feeds lane_values into circuit inputs lane_cfg["lane_input_idx"],
    the level sweep scales the shared input row by lane_values."""
    import numpy as np
    if sweep == "pots":
        # drive x tone grid over 5%..95% pot travel (the exact end stops
        # are singular operating points; the reference warns there too)
        a = max(1, int(np.sqrt(L)))
        while L % a:
            a -= 1
        b = L // a
        drive = np.repeat(np.linspace(0.05, 0.95, a), b)
        tone = np.tile(np.linspace(0.05, 0.95, b), a)
        return (None, drive, tone, np.stack([drive, tone], axis=1),
                dict(lane_input_idx=(1, 2)))
    levels = np.linspace(0.1, 2.0, L)
    return levels, None, None, levels[:, None], dict(lane_scale_idx=(0,))


def _scan_parity_worker(payload):
    """Compute float64 references for ALL parity lanes in one batched run
    of the scan engine (seeded per the run's power-up protocol).

    The scan engine is the parity oracle here because it is (a) pinned
    against the per-sample host runtime at <= -110 dB on every bundled
    example by tests/test_engine.py + tests/test_examples.py (and the
    host runtime against independent 50-digit mpmath golden traces by
    tests/test_golden.py), and (b) vectorized over lanes, so 16
    reference lanes cost one batched run instead of 16 serial
    pure-python runs.  Runs in a spawn subprocess pinned to the CPU, so
    the benchmark process keeps the card to itself.

    Window bookkeeping matches the bench protocol exactly: the power-up
    reference is window 1; the steady reference is window 2 + reps (the
    bench run does the first window, one untimed warm-up, then ``reps``
    timed chained runs)."""
    (sweep, variant, fs, T, reps, levels, drives, tones, powerup) = payload
    import numpy as np

    import jax

    jax.config.update("jax_platforms", "cpu")
    from acme_tpu.engine import compile_model
    from acme_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()  # scan compiles are minutes on one core

    model = _build_model(sweep, variant, fs)
    # REFERENCE TOLERANCE MATTERS: the reference-faithful absolute Newton
    # tolerance (1e-10, solvers.jl:175) leaves ~1e-5 z error at max-slew
    # samples where the residual->z sensitivity spikes -- measured: the
    # 1e-10 oracle differs from a 1e-13 oracle by -92.5 dB worst on the
    # level sweep.  References for a -100 dB parity target therefore run
    # at tol=1e-12 (the 1e-12 and 1e-13 oracle series agree to
    # <= -133 dB).
    cm = compile_model(model, tol=1e-12)
    # steady seeding: exact per-lane fixed points can sit at operating
    # points whose f64 residual floor is just above the engine's strict
    # 1e-10 absolute tolerance; a slightly relaxed tol keeps the solves
    # certifying there (z error ~ cond * 1e-9, far below parity scale)
    cm_seed = compile_model(model, tol=1e-9) if powerup == "steady" \
        else None
    base = 0.2 * np.sin(2 * np.pi * 1000 / fs * np.arange(T))
    if sweep == "pots":
        lane_values = np.stack([drives, tones], axis=1)
        # powerup="steady": the bench run starts at the per-lane steady
        # state, so the reference must too (same protocol both sides)
        state = cm_seed.steady_initial_state(lane_values, (1, 2)) \
            if powerup == "steady" else None
        y_pw, state, _ = cm.run_sweep(base[None, :], lane_values, (1, 2),
                                      state=state)
        y_st = y_pw
        for _ in range(reps + 1):
            y_st, state, _ = cm.run_sweep(base[None, :], lane_values,
                                          (1, 2), state=state)
    else:
        u = np.asarray(levels)[:, None, None] * base[None, None, :]
        state = None
        if powerup == "steady":
            # level lanes share one steady state (input scale, audio at 0)
            s1 = cm_seed.steady_initial_state()
            state = cm.initial_state(len(levels), x=np.asarray(s1["x"])[0])
            state["warms"] = tuple(
                type(w)(p=np.broadcast_to(np.asarray(sw.p)[0],
                                          np.asarray(w.p).shape),
                        z=np.broadcast_to(np.asarray(sw.z)[0],
                                          np.asarray(w.z).shape),
                        dzdp=np.broadcast_to(np.asarray(sw.dzdp)[0],
                                             np.asarray(w.dzdp).shape))
                for w, sw in zip(state["warms"], s1["warms"]))
        y_pw, state, _ = cm.run(u, state=state)
        y_st = y_pw
        for _ in range(reps + 1):
            y_st, state, _ = cm.run(u, state=state)
    return (np.asarray(y_pw[:, 0, :], np.float32),
            np.asarray(y_st[:, 0, :], np.float32))


def _select_parity_lanes(L, K, stress=()):
    """Stratified parity lane sample: 4 corners + seeded interior, plus
    any explicit ``stress`` lanes (added on top of K).  Deterministic
    (fixed seed) so bench runs and --gen-refs agree on which lanes carry
    cached references."""
    import numpy as np
    rng = np.random.default_rng(20260817)
    corners = [0, L - 1, L // 2, 1] if L >= 4 else list(range(L))
    interior = sorted(
        set(rng.integers(2, max(L - 2, 3), size=4 * K).tolist())
        - set(corners))[:max(0, K - len(corners))]
    return sorted(set(corners[:K]) | set(interior)
                  | set(i for i in stress if 0 <= i < L))


def _stress_lanes(sweep, L):
    """Known hard lanes that the stratified sample under-covers, pinned
    so the parity story is measured exactly where the solver works
    hardest.  Pots grid: two dead-zone-TRAVERSAL lanes (drive ~0.76-0.78,
    mid tone) where the audio swing crosses subsystem 1's residual dead
    zone ~200 samples/s, where a float32 solver missed its gate; their
    parity vs the f64 oracle is what bounds such solves."""
    if sweep == "pots" and L >= 64:
        return [int(0.78711 * L), int(0.80713 * L)]
    return []


def _parity_refs(args, sweep, variant, T, reps, powerup, lanes_sel,
                 lane_params, cached_only=False):
    """Fetch (or compute + cache) the f64 scan-engine references for the
    selected lanes; returns ([(y_pw, y_st)], lanes) for the lanes that
    have references.

    ``cached_only=True`` (the default for timed bench runs) never
    COMPUTES references -- a cold 16-lane tol=1e-12 oracle run costs ~1 h
    of single-core CPU, which must never gate a timed benchmark.
    References come from the committed
    .hostref_cache.npz, regenerated by ``--gen-refs`` after protocol
    changes; lanes without cached references are dropped from the
    parity sample with a log line (no silent caps); RT numbers are
    unaffected."""
    import numpy as np
    cache_path = os.environ.get(
        "ACME_TPU_HOSTREF_CACHE", os.path.join(HERE, ".hostref_cache.npz"))
    cache = {}
    if os.path.exists(cache_path):
        try:
            cache = dict(np.load(cache_path))
        except Exception as e:  # corrupt cache: recompute
            log(f"reference cache unreadable ({e}); recomputing")

    def lanekey(i):
        lv, d, tn = lane_params(i)
        tag = "_steady" if powerup == "steady" else ""
        # scan2: references at oracle tol=1e-12 (scan1 keys carried the
        # reference-faithful 1e-10 solver's own -92 dB noise).
        # scan3: the round-5 reduce_pdims fold fix changed EVERY
        # decomposed (chain) model -- the varying-pot one catastrophically
        # (its output row read a dead z component), and the fixed-pot
        # chain one measurably too (its reduced subsystems carry nonzero
        # earlier-z couplings of 1e-4..4e-6, so the fold lines are not
        # no-ops there either; measured: pre-fix level refs scored the
        # post-fix kernel at +15 dB power-up).  Only the un-decomposed
        # 'full' variant (single subsystem, offset 0) is untouched and
        # keeps its scan2 keys.
        ver = "scan2" if variant == "full" and sweep != "pots" else "scan3"
        return ("{}_{}_{}_fs{}_T{}_r{}_lv{:.6f}_d{:.6f}_t{:.6f}{}"
                .format(ver, sweep, variant, args.fs, T, reps, lv, d, tn,
                        tag))

    missing = [i for i in lanes_sel if lanekey(i) + "_pw" not in cache]
    t0 = time.time()
    if missing and cached_only:
        log(f"parity refs: {len(missing)}/{len(lanes_sel)} lanes have no "
            "cached reference and cached_only is set; "
            "scoring parity on the cached subset only")
        lanes_sel = [i for i in lanes_sel if i not in set(missing)]
        missing = []
    if missing:
        payload = (sweep, variant, args.fs, T, reps,
                   np.array([lane_params(i)[0] for i in missing]),
                   np.array([lane_params(i)[1] for i in missing]),
                   np.array([lane_params(i)[2] for i in missing]),
                   powerup)
        if args.smoke or getattr(args, "gen_refs", False):
            ys_pw, ys_st = _scan_parity_worker(payload)
        else:
            import multiprocessing as mp
            ctx = mp.get_context("spawn")
            plat = os.environ.get("JAX_PLATFORMS")
            os.environ["JAX_PLATFORMS"] = "cpu"  # the worker stays off the card
            try:
                with ctx.Pool(1) as pool:
                    ys_pw, ys_st = pool.apply(_scan_parity_worker,
                                              (payload,))
            finally:
                if plat is None:
                    os.environ.pop("JAX_PLATFORMS", None)
                else:
                    os.environ["JAX_PLATFORMS"] = plat
        for n, i in enumerate(missing):
            cache[lanekey(i) + "_pw"] = ys_pw[n]
            cache[lanekey(i) + "_st"] = ys_st[n]
        try:
            np.savez_compressed(cache_path, **cache)
        except Exception as e:
            log(f"reference cache not saved: {e}")
    log(f"float64 parity refs (scan engine): {len(lanes_sel)} lanes "
        f"({len(missing)} computed, {len(lanes_sel)-len(missing)} cached) "
        f"in {time.time()-t0:.1f}s")
    return ([(cache[lanekey(i) + "_pw"], cache[lanekey(i) + "_st"])
             for i in lanes_sel], lanes_sel)


# Steady-seed cache protocol version: bump when steady_initial_state's
# protocol, the model numbering or the carry layout changes -- the
# committed .steadyseed_cache.npz would otherwise be silently reused with
# stale states.  seed3: the scan engine's carry (x plus per-subsystem
# warm starts p, z, dz/dp), in physical units.
SEED_TAG_VER = "seed3"


def _steady_seed_cached(cm, lane_values, tag, lane_idx=(1, 2)):
    """Per-lane steady seeds are deterministic host-side numpy (minutes
    at 4096 lanes), so cache them on disk (committed) keyed by the
    workload tag; returns the engine's carry."""
    import numpy as np

    import jax.numpy as jnp
    from acme_tpu.ops.newton import WarmStart
    path = os.environ.get("ACME_TPU_SEED_CACHE",
                          os.path.join(HERE, ".steadyseed_cache.npz"))
    cache = {}
    if os.path.exists(path):
        try:
            cache = dict(np.load(path))
        except Exception as e:
            log(f"seed cache unreadable ({e}); recomputing")
    keys = ["x"] + [f"{k}{i}" for i in range(cm.nsub)
                    for k in ("p", "z", "dzdp")]
    if all(f"{tag}_{k}" in cache for k in keys):
        log(f"steady seed: cache hit ({tag})")
        D = lambda k: jnp.asarray(cache[f"{tag}_{k}"], cm.dtype)
        return {"x": D("x"), "warms": tuple(
            WarmStart(p=D(f"p{i}"), z=D(f"z{i}"), dzdp=D(f"dzdp{i}"))
            for i in range(cm.nsub))}
    t0 = time.time()
    state = cm.steady_initial_state(lane_values, lane_idx)
    log(f"steady_initial_state: {time.time()-t0:.1f}s (cached for reuse)")
    cache[f"{tag}_x"] = np.asarray(state["x"])
    for i, w in enumerate(state["warms"]):
        cache[f"{tag}_p{i}"] = np.asarray(w.p)
        cache[f"{tag}_z{i}"] = np.asarray(w.z)
        cache[f"{tag}_dzdp{i}"] = np.asarray(w.dzdp)
    try:
        np.savez_compressed(path, **cache)
    except Exception as e:
        log(f"seed cache not saved: {e}")
    return state


def card_info():
    """The card's name and power limit as nvidia-smi reports them
    (``None`` where nvidia-smi is not available)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def device_info():
    """Where the numbers were measured, as JAX and nvidia-smi report it."""
    import jax
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d), "card": card_info()}


def make_cell(args, L):
    """Build the pots cell: (compiled model, u_time, lane grid, state)."""
    import numpy as np

    from acme_tpu.engine import compile_model
    t0 = time.time()
    model = _build_model("pots", args.model, args.fs)
    log(f"model build: {time.time()-t0:.1f}s ({args.model}) "
        f"np={[model.np(i) for i in range(model.nsubsystems)]} "
        f"nn={[model.nn(i) for i in range(model.nsubsystems)]} "
        f"nx={model.nx}")
    T = max(16, int(round(args.seconds * args.fs)))
    u_time = (0.2 * np.sin(2 * np.pi * 1000 / args.fs
                           * np.arange(T)))[None, :]
    grid = _lane_grid("pots", L)
    cm = compile_model(model)   # the reference's tolerance, 1e-10
    state = None
    if args.powerup == "steady":
        tag = f"{SEED_TAG_VER}_pots_{args.model}_fs{args.fs}_L{L}"
        state = _steady_seed_cached(cm, grid[3], tag)
    return cm, u_time, grid, state


def parity_db(y, ref, scale):
    import numpy as np
    return round(20 * np.log10(
        float(np.max(np.abs(np.asarray(y) - ref))) / scale + 1e-300), 2)


def run_cell(args, L, reps, parity_lanes, label, keep_first=False):
    """One benchmark cell: build, seed, compile, first window, one
    untimed warm-up, ``reps`` timed chained windows, parity on a
    stratified lane sample.  Returns a metrics dict (with the first
    window's output under "first_window" when ``keep_first``)."""
    import numpy as np
    cm, u_time, grid, state = make_cell(args, L)
    levels, drive, tone, lane_values, _ = grid
    T = u_time.shape[1]
    idx = (1, 2)
    compile_s = cm.compile_sweep(u_time, lane_values, idx, state)
    t0 = time.time()
    y0, state, info = cm.run_sweep(u_time, lane_values, idx, state=state)
    _ = np.asarray(y0[:1, :1, :8])  # sync: true completion (tiny fetch)
    first_s = time.time() - t0
    conv_all = info.converged.all()
    log(f"[{label}] compile: {compile_s:.1f}s  first window: "
        f"{first_s:.1f}s")
    out = {"compile_s": round(compile_s, 1), "first_run_s": round(first_s, 2),
           "tol": cm.tol, "window_samples": T}
    if keep_first:
        out["first_window"] = y0
    t0 = time.time()
    y, state, info = cm.run_sweep(u_time, lane_values, idx, state=state)
    conv_all = conv_all & info.converged.all()
    _ = np.asarray(y[:1, :1, :8])
    log(f"[{label}] warmup chained run: {time.time()-t0:.1f}s")
    t0 = time.time()
    for _ in range(reps):
        y, state, info = cm.run_sweep(u_time, lane_values, idx, state=state)
        conv_all = conv_all & info.converged.all()
    _ = np.asarray(y[:1, :1, :8])  # sync
    wall = (time.time() - t0) / reps
    out["converged"] = bool(conv_all)
    out["iters_per_sample_mean"] = round(
        float(np.asarray(info.iters.sum(dtype="int64"))) / (T * L), 3)
    out["finite"] = bool(np.all(np.isfinite(np.asarray(y))))
    audio_s = T / args.fs
    rt = audio_s / wall
    out["ms_per_window"] = round(wall * 1e3, 2)
    out["rt"] = round(rt, 5)
    out["msamples_per_s"] = round(rt * L * args.fs / 1e6, 4)
    log(f"[{label}] timed: {wall*1e3:.1f} ms/run for {audio_s:.3f}s audio "
        f"x {L} lanes ({reps} chained reps)")
    log(f"[{label}] RT-factor per lane: {rt:.4f}x   aggregate: "
        f"{rt*L:.0f}x realtime   ({rt*L*args.fs/1e6:.3f} Msamples/s)")

    if parity_lanes > 0:
        K = min(parity_lanes, L)
        stress = _stress_lanes("pots", L)
        lanes_sel = _select_parity_lanes(L, K, stress)

        def lane_params(i):
            return 1.0, float(drive[i]), float(tone[i])

        cached_only = not getattr(args, "compute_refs", False)
        results, lanes_sel = _parity_refs(args, "pots", args.model, T, reps,
                                          args.powerup, lanes_sel,
                                          lane_params,
                                          cached_only=cached_only)
        per_lane = []
        for i, (yh_pw, yh_st) in zip(lanes_sel, results):
            scale = max(float(np.max(np.abs(yh_st))), 1e-12)
            db_pw = parity_db(y0[i, 0, :], yh_pw, scale)
            db_st = parity_db(y[i, 0, :], yh_st, scale)
            per_lane.append((i, i in stress, db_pw, db_st))
            log(f"[{label}]   lane {i}{' (stress)' if i in stress else ''}:"
                f" first window {db_pw:.1f} dB, steady {db_st:.1f} dB")
        if per_lane:
            pw = [r[2] for r in per_lane]
            st = [r[3] for r in per_lane]
            out["parity_db"] = max(pw)
            out["parity_steady_db"] = max(st)
            out["parity_median_db"] = round(float(np.median(st)), 2)
            out["parity_lanes"] = len(per_lane)
            out["parity_per_lane"] = per_lane
            log(f"[{label}] parity: first window worst {out['parity_db']} "
                f"dB; steady worst {out['parity_steady_db']} dB median "
                f"{out['parity_median_db']} dB over {len(per_lane)} lanes")
        else:
            log(f"[{label}] parity: SKIPPED (no cached references for "
                f"{T}-sample windows)")
    return out


def gen_refs(args):
    """Regenerate the f64 parity-reference cache on the CPU.

    Computes the scan-engine oracle series for every lane the default
    bench run scores, in lane chunks (``--gen-refs-chunk``, default 16 =
    one batched run: the scan engine is lane-vectorized and
    overhead-dominated on CPU, so a 16-lane batch costs barely more than a
    4-lane one; smaller chunks trade wall time for resumability, each
    chunk saving the cache on completion).  A bench run with non-default
    --powerup/--reps/--lanes/--seconds produces different cache keys and
    must gen-refs with the same flags.  Run once after a protocol or
    oracle change, then commit .hostref_cache.npz."""
    args.gen_refs = True
    T = max(16, int(round(args.seconds * args.fs)))
    L = args.lanes
    levels, drive, tone, _lv, _cfg = _lane_grid("pots", L)
    lanes_sel = _select_parity_lanes(L, min(args.parity_lanes, L),
                                     _stress_lanes("pots", L))

    def lane_params(i):
        return 1.0, float(drive[i]), float(tone[i])

    log(f"gen-refs: pots/{args.model} reps={args.reps} "
        f"powerup={args.powerup} lanes={lanes_sel}")
    for c in range(0, len(lanes_sel), args.gen_refs_chunk):
        _parity_refs(args, "pots", args.model, T, args.reps, args.powerup,
                     lanes_sel[c:c + args.gen_refs_chunk], lane_params)
    log("gen-refs: done")


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--seconds", type=float, default=1.0,
                    help="audio seconds per window")
    ap.add_argument("--fs", type=int, default=44100)
    ap.add_argument("--reps", type=int, default=5,
                    help="chained timed windows (amortized)")
    ap.add_argument("--model", choices=["chain", "full"], default="chain",
                    help="chain = reference's simplified (vb-source) "
                         "decomposed superover; full = un-decomposed")
    ap.add_argument("--powerup", choices=["steady", "cold"],
                    default="steady",
                    help="'steady' = every lane starts at its own "
                         "host-computed steady state (seeds cached on "
                         "disk); 'cold' = the reference's initial state")
    ap.add_argument("--parity-lanes", type=int, default=16,
                    help="stratified parity sample size (0 disables)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CPU run (API liveness, no timing claim)")
    ap.add_argument("--gen-refs", action="store_true",
                    help="regenerate the f64 parity-reference cache on "
                         "the CPU (hours cold, resumable) and exit")
    ap.add_argument("--gen-refs-chunk", type=int, default=16,
                    help="lanes per gen-refs cache-save chunk")
    ap.add_argument("--no-parity", action="store_true",
                    help="skip the float64 parity check")
    ap.add_argument("--compute-refs", action="store_true",
                    help="allow the parity pass to COMPUTE missing "
                         "references in-run (~1 h/16 lanes of single-core "
                         "CPU; default scores from the committed cache "
                         "only -- use --gen-refs to fill it)")
    ap.add_argument("--primary-only", action="store_true",
                    help="run the primary cell only (the only cell; kept "
                         "so existing command lines still work)")
    return ap


def resolve_args(args):
    """Defaults that depend on other options."""
    if args.no_parity:
        args.parity_lanes = 0
    return args


def main():
    args = resolve_args(build_parser().parse_args())
    if args.gen_refs:
        os.environ["JAX_PLATFORMS"] = "cpu"
        gen_refs(args)
        return

    if args.smoke:
        os.environ["JAX_PLATFORMS"] = "cpu"
        args.lanes = 16
        args.seconds = min(args.seconds, 0.005)
        args.powerup = "cold"
        args.reps = 1
        args.parity_lanes = min(args.parity_lanes, 2)
        args.compute_refs = True  # tiny T: refs are cheap, keys unique
        # ... and kept out of the committed cache
        import tempfile
        os.environ.setdefault("ACME_TPU_HOSTREF_CACHE", os.path.join(
            tempfile.gettempdir(), "acme_smoke_refs.npz"))

    import jax

    from acme_tpu.utils.cache import enable_compile_cache
    if args.smoke:
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        # a measurement without the card is not a measurement: no CPU
        # fallback
        raise SystemExit(f"bench.py measures on a GPU; JAX found "
                         f"{jax.devices()} (use --smoke for a CPU check)")
    enable_compile_cache()
    device = device_info()
    log(f"devices: {jax.devices()}  card: {device['card']}")

    L = args.lanes
    extras = {}
    failed = False
    try:
        primary = run_cell(args, L, args.reps, args.parity_lanes, "primary")
        rt_per_lane = primary.pop("rt")
        extras.update(primary)
    except Exception as e:
        # even a dead primary produces the JSON line (value null + error),
        # and the process then exits non-zero
        log(f"[primary] FAILED: {e!r}")
        import traceback
        traceback.print_exc(file=sys.stderr)
        rt_per_lane = None
        failed = True
        extras["primary_error"] = repr(e)[:300]

    variant_note = ("chain model: the reference's simplified vb-source "
                    "superover; decomposition-faithful, but a different "
                    "circuit from the full np=5 superover in multi-root "
                    "regions" if args.model == "chain" else "full model")
    print(json.dumps({
        "metric": "superover RT-factor per lane @44.1kHz, "
                  f"{L} lanes (drive x tone pot grid, {variant_note}), "
                  "float64 scan engine"
                  + (", per-lane steady-seeded"
                     if args.powerup == "steady" else ""),
        "value": rt_per_lane,
        "unit": "x realtime per lane",
        "device": device,
        **extras,
    }))
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
