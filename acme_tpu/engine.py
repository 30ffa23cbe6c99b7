"""Device runtime: lax.scan over time, vmapped over a lane axis.

The host per-sample loop (/root/reference/src/ACME.jl:650-715) becomes::

    carry = (x, warm starts per subsystem, convergence stats)
    (carry, (y, conv)) = lax.scan(step, carry, u_time_major)

where ``step`` performs the ordered subsystem chain (each subsystem's p
depends on the z of earlier subsystems in the *same* sample, ACME.jl:675-697)
with batched GEMVs over lanes, and each subsystem solve is the masked
Newton+homotopy of acme_tpu.ops.newton vmapped over lanes.

Lanes are independent circuit instances (parameter sweeps via pot inputs,
audio channels, voices): the north-star scaling axis.  No communication is
needed between lanes, so multi-chip scaling is pure data-parallel sharding of
the lane axis (see acme_tpu.parallel).

Failure semantics: the reference warns on non-convergence and errors on
non-finite results mid-run (ACME.jl:688-694); here convergence flags are
per-lane per-sample outputs surfaced after the scan (RunInfo), and `run`
raises/warns on the host afterwards to match.
"""

from __future__ import annotations

import warnings
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .model import DiscreteModel
# full-precision products: a float32 engine (ACME_TPU_X64=0) must not run
# its GEMVs at the GPU's default reduced (TF32) matmul precision
from .ops.newton import WarmStart, _mm as mm, make_subsystem_solver

__all__ = ["CompiledModel", "compile_model", "BatchCompiledModel",
           "compile_models", "RunInfo"]


class RunInfo(NamedTuple):
    """Per-sample solver diagnostics (the reference's needediterations and
    warn-path flags, solvers.jl:205 / ACME.jl:688-694)."""

    converged: jnp.ndarray   # (T, L) bool
    iters: jnp.ndarray       # (T, L, nsub) int32 Newton iterations per
    #                          subsystem (sum over axis -1 for totals)

    def iter_histogram(self, bins=(1, 2, 3, 5, 8, 13, 21, 34, 55)):
        """Per-subsystem histogram of Newton iteration counts: returns
        (edges, counts (nsub, len(edges)+1)) over all samples and lanes."""
        import numpy as np
        it = np.asarray(self.iters).reshape(-1, self.iters.shape[-1])
        edges = np.asarray(bins)
        counts = np.stack([
            np.bincount(np.digitize(it[:, k], edges),
                        minlength=len(edges) + 1)
            for k in range(it.shape[1])])
        return edges, counts


@jax.jit
def _finite_conv(y, conv):
    """Device-side reduction for the warn path: two scalars instead of the
    full output array (the reference checks per sample, ACME.jl:688-694)."""
    return jnp.all(jnp.isfinite(y)), jnp.all(conv)


class CompiledModel:
    """A DiscreteModel frozen to device arrays with a jitted scan runtime.

    ``dtype`` defaults to float64 (requires jax_enable_x64, on by default in
    this package) for reference parity; pass jnp.float32 for speed.
    ``tol`` defaults to the reference's 1e-10 for float64 and 5e-4 for
    float32 (residuals are in Ampere/Volt-scale units).
    """

    def __init__(self, model: DiscreteModel, *, dtype=None, tol=None,
                 newton_maxiter=500, homotopy=True, warn=True):
        if dtype is None:
            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        self.dtype = dtype
        if tol is None:
            tol = 1e-10 if dtype == jnp.float64 else 5e-4
        self.tol = float(tol)
        self.homotopy = homotopy
        self.warn = warn
        self.model = model          # kept for steady_initial_state

        D = lambda m: jnp.asarray(m, dtype)
        self.a, self.b, self.c = D(model.a), D(model.b), D(model.c)
        self.x0 = D(model.x0)
        self.dy, self.ey, self.fy = D(model.dy), D(model.ey), D(model.fy)
        self.y0 = D(model.y0)
        self.nx = model.nx
        self.nu = model.nu
        self.ny = model.ny
        self.nn_total = model.nn()
        self.nsub = model.nsubsystems

        self.subs = []
        self._solvers = []
        off = 0
        for k in range(model.nsubsystems):
            sub = {
                "dq": D(model.dqs[k]), "eq": D(model.eqs[k]),
                "fqprev": D(model.fqprevs[k]), "fq": D(model.fqs[k]),
                "pexp": D(model.pexps[k]), "q0": D(model.q0s[k]),
                "off": off, "nn": model.nn(k), "np": model.np(k),
            }
            off += model.nn(k)
            self.subs.append(sub)
            solve = make_subsystem_solver(
                model.nl_funcs[k], sub["fq"], sub["pexp"], sub["q0"],
                tol=self.tol, maxiter=newton_maxiter, homotopy=homotopy)
            self._solvers.append(jax.vmap(solve))

        # initial warm starts: origin (p=0, z=init_z) with dz/dp evaluated
        # there, exactly as the reference solver constructors do
        # (ACME.jl:253-260, solvers.jl:164-178)
        self._init_warm = []
        for k, sub in enumerate(self.subs):
            p0 = np.zeros(sub["np"])
            z0 = np.asarray(model.init_zs[k], float)
            q = np.asarray(model.q0s[k]) + np.asarray(model.pexps[k]) @ p0 \
                + np.asarray(model.fqs[k]) @ z0
            res, Jq = model.nl_funcs[k](np, q)
            J = Jq @ np.asarray(model.fqs[k])
            Jp = Jq @ np.asarray(model.pexps[k])
            try:
                dzdp = -np.linalg.solve(J, Jp)
            except np.linalg.LinAlgError:
                dzdp = np.zeros_like(Jp)
            self._init_warm.append(WarmStart(p=D(p0), z=D(z0), dzdp=D(dzdp)))

        self._nl_funcs = model.nl_funcs
        scan_fn, step = self._make_scan()
        self._step = step
        # no donate_argnums on the public paths: callers may legitimately
        # re-run from a kept state object (e.g. restart from a checkpoint),
        # which a donated carry would invalidate with an obscure error
        self._scan = jax.jit(scan_fn)
        self._scan_sweep = jax.jit(self._make_sweep_scan(step),
                                   static_argnums=(3,))

    # -- state ------------------------------------------------------------
    def initial_state(self, lanes: int = 1, x=None):
        """Scan carry for ``lanes`` independent circuit instances."""
        def tile(v, extra=()):
            return jnp.broadcast_to(v, (lanes,) + v.shape).reshape((lanes,) + v.shape)

        if x is None:
            x = jnp.zeros((lanes, self.nx), self.dtype)
        else:
            x = jnp.broadcast_to(jnp.asarray(x, self.dtype), (lanes, self.nx))
        warms = tuple(
            WarmStart(p=tile(w.p), z=tile(w.z), dzdp=tile(w.dzdp))
            for w in self._init_warm)
        return {"x": x, "warms": warms}

    def steady_initial_state(self, lane_values=None, lane_input_idx=(),
                             runin: int = 4096):
        """Per-lane steady scan carry: every lane starts at the steady
        state of ITS OWN constant inputs, computed host-side by
        :func:`acme_tpu.runtime.steadystate_sweep` (reference analog:
        ``steadystate!`` + ``run!`` state persistence, ACME.jl:499-503).

        ``lane_values`` (L, len(lane_input_idx)) as passed to
        :meth:`run_sweep`; time-varying inputs are taken at 0.  With
        ``lane_values=None`` one lane at u = 0."""
        from .runtime import steadystate_sweep
        model = self.model
        if lane_values is None:
            u_lanes = np.zeros((1, model.nu))
        else:
            lane_values = np.asarray(lane_values, float)
            u_lanes = np.zeros((lane_values.shape[0], model.nu))
            u_lanes[:, list(lane_input_idx)] = lane_values
        L = u_lanes.shape[0]
        xs, zs, conv = steadystate_sweep(model, u_lanes, runin=runin)
        if not conv.all():
            # Uncertified lanes get the standard COLD start, not the
            # near-steady point: at bistable pot corners the uncertified
            # point can be a wrong-root latch, and warm origins seeded
            # there make every sample of the subsequent walk back to the
            # host branch a homotopy grind (measured: a 16-lane run that
            # completes in seconds from cold ground to a halt).  Cold
            # lanes just power up normally.
            warnings.warn(f"steady_initial_state: {int((~conv).sum())}/{L} "
                          "lanes did not certify steady; they start COLD "
                          "and power up dynamically.")
            xs = np.where(conv[:, None], xs, 0.0)
            zs = np.where(conv[:, None],
                          zs, np.concatenate([np.asarray(z0, float)
                                              for z0 in model.init_zs])
                          [None, :]) if zs.size else zs
        D = lambda m: jnp.asarray(m, self.dtype)
        warms = []
        off = 0
        for k, sub in enumerate(self.subs):
            nn_k, np_k = sub["nn"], sub["np"]
            p_l = (xs @ np.asarray(model.dqs[k], float).T
                   + u_lanes @ np.asarray(model.eqs[k], float).T
                   + zs @ np.asarray(model.fqprevs[k], float).T)
            fq = np.asarray(model.fqs[k], float)
            pexp = np.asarray(model.pexps[k], float)
            q = (np.asarray(model.q0s[k], float)[:, None]
                 + pexp @ p_l.T + fq @ zs.T[off:off + nn_k])
            with np.errstate(all="ignore"):
                _, Jq = model.nl_funcs[k](np, q)   # (nn, nq, L)
                J = np.einsum("ijl,jk->lik", Jq, fq)
                Jp = np.einsum("ijl,jk->lik", Jq, pexp)
                d = -np.linalg.pinv(J) @ Jp if nn_k else \
                    np.zeros((L, 0, np_k))
            bad = ~np.isfinite(d).all(axis=(1, 2))
            if bad.any():
                d[bad] = np.asarray(self._init_warm[k].dzdp, float)
            # sensitivity sanity: at a cond-spike steady point the
            # pinv-based dz/dp can reach ~1e6; the extrapolated start
            # z0 = zw + dzdp (p - wp) then explodes as soon as the
            # signal moves p, and every solve becomes a homotopy grind.
            # The engine itself never installs such origins (singular
            # points skip the update, newton.py dzdp_at); a zeroed
            # sensitivity (constant warm start) is safe -- the first
            # convergent solve replaces it with the engine's own.
            if nn_k:
                steep = np.abs(d).max(axis=(1, 2)) > 1e3
                d[steep] = 0.0
            if not conv.all():
                # cold lanes carry the engine's exact init origin
                # (p = 0, z = init_z, dzdp at that point) -- a wp
                # computed from the cold state would claim init_z solves
                # at p = Eq u, which is false at pot corners and sends
                # the first homotopy down a garbage path
                p_l = np.where(conv[:, None], p_l,
                               np.asarray(self._init_warm[k].p,
                                          float)[None])
                d = np.where(conv[:, None, None], d,
                             np.asarray(self._init_warm[k].dzdp,
                                        float)[None])
            warms.append(WarmStart(p=D(p_l), z=D(zs[:, off:off + nn_k]),
                                   dzdp=D(d)))
            off += nn_k
        return {"x": D(xs), "warms": tuple(warms)}

    # -- scan body ----------------------------------------------------------
    def _make_scan(self):
        subs = self.subs
        solvers = self._solvers
        a, b, c, x0 = self.a, self.b, self.c, self.x0
        dy, ey, fy, y0 = self.dy, self.ey, self.fy, self.y0
        nn_total = self.nn_total

        def step(carry, u_t):
            # u_t: (L, nu)
            x = carry["x"]
            L = x.shape[0]
            z_acc = jnp.zeros((L, nn_total), x.dtype)
            warms_out = []
            conv = jnp.ones((L,), bool)
            iters_k = []
            for k, sub in enumerate(subs):
                p = mm(x, sub["dq"].T) + mm(u_t, sub["eq"].T) \
                    + mm(z_acc, sub["fqprev"].T)
                result = solvers[k](p, carry["warms"][k])
                z_acc = jax.lax.dynamic_update_slice(
                    z_acc, result.z, (0, sub["off"]))
                warms_out.append(result.warm)
                conv = conv & result.converged
                iters_k.append(result.iters)
            iters = (jnp.stack(iters_k, axis=-1) if iters_k
                     else jnp.zeros((L, 0), jnp.int32))
            y = mm(x, dy.T) + mm(u_t, ey.T) + mm(z_acc, fy.T) + y0
            x_new = mm(x, a.T) + mm(u_t, b.T) + mm(z_acc, c.T) + x0
            return {"x": x_new, "warms": tuple(warms_out)}, (y, conv, iters)

        def scan_fn(carry, u_tm):
            return jax.lax.scan(step, carry, u_tm)

        return scan_fn, step

    def step_fn(self):
        """The single-step function (carry, u_t) -> (carry, (y, conv, iters))
        with u_t of shape (L, nu); exposed for jit-compile checks and custom
        drivers."""
        return self._step

    def _make_sweep_scan(self, step):
        nu = self.nu

        def sweep_scan(carry, u_time_tm, lane_values, lane_idx):
            """Scan where some circuit inputs are shared time series and the
            rest are per-lane constants (parameter sweeps: pots as inputs,
            ref elements.jl:20-31 -- the lane axis never materializes a full
            (L, nu, T) input).  ``lane_idx`` is a static tuple."""
            L = carry["x"].shape[0]
            time_idx = tuple(i for i in range(nu) if i not in lane_idx)

            def step_sweep(c, u_t):
                u_full = jnp.zeros((L, nu), self.dtype)
                if time_idx:
                    u_full = u_full.at[:, jnp.asarray(time_idx)].set(
                        jnp.broadcast_to(u_t, (L, len(time_idx))))
                if lane_idx:
                    u_full = u_full.at[:, jnp.asarray(lane_idx)].set(lane_values)
                return step(c, u_full)

            return jax.lax.scan(step_sweep, carry, u_time_tm)
        return sweep_scan

    def run_sweep(self, u_time, lane_values, lane_input_idx, state=None):
        """Parameter-sweep run: ``u_time`` (nu_time, T) is shared across all
        lanes; ``lane_values`` (L, k) are per-lane constants fed into the
        circuit inputs listed in ``lane_input_idx`` (e.g. pot positions).
        This is the 4096-lane drive x tone grid path: inputs stay O(T + L)
        instead of O(L*nu*T)."""
        state, (y_tm, conv, iters) = self._scan_sweep(
            *self._sweep_args(u_time, lane_values, lane_input_idx, state))
        y = jnp.transpose(y_tm, (1, 2, 0))
        return y, state, RunInfo(converged=conv, iters=iters)

    def compile_sweep(self, u_time, lane_values, lane_input_idx,
                      state=None) -> float:
        """Compile :meth:`run_sweep` for these arguments' shapes without
        running it (ahead of time, so set-up splits into compile and first
        run); returns the seconds spent."""
        import time
        args = self._sweep_args(u_time, lane_values, lane_input_idx, state)
        t0 = time.perf_counter()
        self._scan_sweep.lower(*args).compile()
        return time.perf_counter() - t0

    def _sweep_args(self, u_time, lane_values, lane_input_idx, state):
        u_time = jnp.asarray(u_time, self.dtype)
        lane_values = jnp.asarray(lane_values, self.dtype)
        L = lane_values.shape[0]
        lane_idx = tuple(int(i) for i in lane_input_idx)
        if u_time.shape[0] + len(lane_idx) != self.nu:
            raise ValueError("u_time rows + lane inputs must equal model inputs")
        if state is None:
            state = self.initial_state(L)
        return state, u_time.T, lane_values, lane_idx

    # -- execution ----------------------------------------------------------
    def run(self, u, state=None) -> Tuple[np.ndarray, dict, RunInfo]:
        """Run the model.

        ``u``: (nu, T) for a single lane or (L, nu, T) for a batch of lanes
        (row order = circuit input order, as in the reference).  Returns
        (y, new_state, info) with y shaped like u's output counterpart.
        """
        u = jnp.asarray(u, self.dtype)
        single = u.ndim == 2
        if single:
            u = u[None]
        L, nu, T = u.shape
        if nu != self.nu:
            raise ValueError(f"input has {nu} rows, but model has {self.nu} inputs")
        if state is None:
            state = self.initial_state(L)
        elif state["x"].shape[0] != L:
            raise ValueError(f"state has {state['x'].shape[0]} lanes, "
                             f"but input has {L}")
        u_tm = jnp.transpose(u, (2, 0, 1))  # (T, L, nu)
        state, (y_tm, conv, iters) = self._scan(state, u_tm)
        y = jnp.transpose(y_tm, (1, 2, 0))  # (L, ny, T)
        info = RunInfo(converged=conv, iters=iters)
        if self.warn:
            # reduce on device and fetch two scalars -- NOT the full (L,ny,T)
            # output: a host fetch here costs a device->host transfer of the
            # whole run plus a pipeline stall per call
            finite, all_conv = _finite_conv(y, conv)
            if not bool(finite):
                raise RuntimeError("Failed to converge while solving non-linear "
                                   "equation, got non-finite result.")
            if not bool(all_conv):
                warnings.warn("Failed to converge while solving non-linear equation.")
        if single:
            y = y[0]
        return y, state, info


def compile_model(model: DiscreteModel, **kw) -> CompiledModel:
    """Freeze a DiscreteModel into the device (scan) runtime."""
    return CompiledModel(model, **kw)


class BatchCompiledModel:
    """Per-lane model matrices: every lane carries its own A/B/C/dq/...
    (the natural completion of the lane axis -- lanes sweep *component
    values*, each lane a structurally identical model compiled from a
    different netlist parameterization, not just pot inputs).

    All models must share topology: identical dimensions and per-subsystem
    shapes (build them from the same circuit with different element
    values).  The nonlinearity closures of ``models[0]`` are used for every
    lane, so nonlinear device parameters (diode is/eta, BJT params, ...)
    must be identical across models -- sweep those via the matrices they
    enter (sources, linear elements, pots) or via pot inputs.
    """

    def __init__(self, models, *, dtype=None, tol=None, newton_maxiter=500,
                 homotopy=True):
        from .ops.newton import make_subsystem_solver_mats
        if not models:
            raise ValueError("need at least one model")
        m0 = models[0]
        for m in models[1:]:
            if (m.nx, m.nu, m.ny, m.nsubsystems) != \
                    (m0.nx, m0.nu, m0.ny, m0.nsubsystems) or any(
                    (m.nn(k), m.np(k)) != (m0.nn(k), m0.np(k))
                    for k in range(m0.nsubsystems)):
                raise ValueError(
                    "per-lane models must share dimensions/decomposition")
        if dtype is None:
            dtype = jnp.float64 if jax.config.jax_enable_x64 \
                else jnp.float32
        self.dtype = dtype
        if tol is None:
            tol = 1e-10 if dtype == jnp.float64 else 5e-4
        self.L = len(models)
        self.nx, self.nu, self.ny = m0.nx, m0.nu, m0.ny
        self.nn_total = m0.nn()
        self.nsub = m0.nsubsystems

        def S(get):
            return jnp.asarray(np.stack([np.asarray(get(m), float)
                                         for m in models]), dtype)

        self.a, self.b, self.c = S(lambda m: m.a), S(lambda m: m.b), \
            S(lambda m: m.c)
        self.x0 = S(lambda m: m.x0)
        self.dy, self.ey, self.fy = S(lambda m: m.dy), S(lambda m: m.ey), \
            S(lambda m: m.fy)
        self.y0 = S(lambda m: m.y0)
        self.subs = []
        self._solvers = []
        off = 0
        for k in range(self.nsub):
            sub = {
                "dq": S(lambda m: m.dqs[k]), "eq": S(lambda m: m.eqs[k]),
                "fqprev": S(lambda m: m.fqprevs[k]),
                "fq": S(lambda m: m.fqs[k]),
                "pexp": S(lambda m: m.pexps[k]),
                "q0": S(lambda m: m.q0s[k]),
                "off": off,
            }
            off += m0.nn(k)
            self.subs.append(sub)
            solve = make_subsystem_solver_mats(
                m0.nl_funcs[k], m0.nn(k), dtype=dtype, tol=float(tol),
                maxiter=newton_maxiter, homotopy=homotopy)
            self._solvers.append(jax.vmap(solve))

        # per-lane initial warm starts (origin p=0, z=that model's init z)
        warms = []
        for k in range(self.nsub):
            ps, zs, ds = [], [], []
            for m in models:
                p0 = np.zeros(m.np(k))
                z0 = np.asarray(m.init_zs[k], float)
                q = np.asarray(m.q0s[k]) + np.asarray(m.fqs[k]) @ z0
                res, Jq = m.nl_funcs[k](np, q)
                J = Jq @ np.asarray(m.fqs[k])
                Jp = Jq @ np.asarray(m.pexps[k])
                try:
                    dzdp = -np.linalg.solve(J, Jp)
                except np.linalg.LinAlgError:
                    dzdp = np.zeros_like(Jp)
                ps.append(p0)
                zs.append(z0)
                ds.append(dzdp)
            warms.append(WarmStart(
                p=jnp.asarray(np.stack(ps), dtype),
                z=jnp.asarray(np.stack(zs), dtype),
                dzdp=jnp.asarray(np.stack(ds), dtype)))
        self._init_warm = tuple(warms)

        subs = self.subs
        solvers = self._solvers
        a, b, c, x0 = self.a, self.b, self.c, self.x0
        dy, ey, fy, y0 = self.dy, self.ey, self.fy, self.y0
        nn_total = self.nn_total

        def mv(M, v):
            # batched per-lane matvec: (L, m, n) x (L, n) -> (L, m)
            return jnp.einsum("lmn,ln->lm", M, v,
                              precision=jax.lax.Precision.HIGHEST)

        def step(carry, u_t):
            x = carry["x"]
            L = x.shape[0]
            z_acc = jnp.zeros((L, nn_total), x.dtype)
            warms_out = []
            conv = jnp.ones((L,), bool)
            iters_k = []
            for k, sub in enumerate(subs):
                p = mv(sub["dq"], x) + mv(sub["eq"], u_t) \
                    + mv(sub["fqprev"], z_acc)
                result = solvers[k](p, carry["warms"][k], sub["fq"],
                                    sub["pexp"], sub["q0"])
                z_acc = jax.lax.dynamic_update_slice(
                    z_acc, result.z, (0, sub["off"]))
                warms_out.append(result.warm)
                conv = conv & result.converged
                iters_k.append(result.iters)
            iters = (jnp.stack(iters_k, axis=-1) if iters_k
                     else jnp.zeros((L, 0), jnp.int32))
            y = mv(dy, x) + mv(ey, u_t) + mv(fy, z_acc) + y0
            x_new = mv(a, x) + mv(b, u_t) + mv(c, z_acc) + x0
            return {"x": x_new, "warms": tuple(warms_out)}, (y, conv, iters)

        self._scan = jax.jit(lambda carry, u_tm: jax.lax.scan(
            step, carry, u_tm))

    def initial_state(self):
        return {"x": jnp.zeros((self.L, self.nx), self.dtype),
                "warms": self._init_warm}

    def run(self, u, state=None):
        """``u``: (nu, T) shared across lanes or (L, nu, T) per lane.
        Returns (y (L, ny, T), state, RunInfo)."""
        u = jnp.asarray(u, self.dtype)
        if u.ndim == 2:
            u = jnp.broadcast_to(u[None], (self.L,) + u.shape)
        if u.shape[0] != self.L or u.shape[1] != self.nu:
            raise ValueError(f"input shape {u.shape} does not match "
                             f"(L={self.L}, nu={self.nu}, T)")
        if state is None:
            state = self.initial_state()
        u_tm = jnp.transpose(u, (2, 0, 1))
        state, (y_tm, conv, iters) = self._scan(state, u_tm)
        y = jnp.transpose(y_tm, (1, 2, 0))
        return y, state, RunInfo(converged=conv, iters=iters)


def compile_models(models, **kw) -> BatchCompiledModel:
    """Freeze a batch of same-topology DiscreteModels into one runtime with
    per-lane model matrices (component-value sweeps)."""
    return BatchCompiledModel(models, **kw)
