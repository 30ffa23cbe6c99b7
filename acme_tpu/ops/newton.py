"""Per-lane Newton solver with extrapolated warm start and homotopy fallback.

This is the batched re-expression of the reference solver chain
(solvers.jl): SimpleSolver's Newton iteration becomes a
``lax.while_loop`` whose per-lane updates are masked (under vmap the loop
runs until every lane is done), the extrapolation origin becomes part of the
scan carry as (p, z, dz/dp), and HomotopySolver's bisection continuation
becomes an outer masked while loop engaged only for non-converged lanes.
The k-d-tree CachingSolver is intentionally replaced by the previous-sample
warm start (see SURVEY.md section 7): the scan carry plays the role of the
cache, which is both cheaper and deterministic across lanes.

All functions here are written for a single lane and vmapped by the engine;
all shapes are static.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .linsolve import solve_dense


def _mm(a, b):
    """Matrix product at full precision (a float32 solve must not run at
    the GPU's default reduced TF32 matmul precision)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)

__all__ = ["WarmStart", "SolveResult", "make_subsystem_solver",
           "make_subsystem_solver_mats"]


class WarmStart(NamedTuple):
    """Extrapolation origin: z(p) ~= z0 + dzdp @ (p - p0)
    (ref solvers.jl:183-215)."""
    p: jnp.ndarray      # (np,)
    z: jnp.ndarray      # (nn,)
    dzdp: jnp.ndarray   # (nn, np)


class SolveResult(NamedTuple):
    z: jnp.ndarray        # (nn,)
    converged: jnp.ndarray  # bool scalar
    warm: WarmStart
    iters: jnp.ndarray    # int32, total Newton iterations spent


class _NewtonState(NamedTuple):
    z: jnp.ndarray
    it: jnp.ndarray
    conv: jnp.ndarray
    stop: jnp.ndarray


class _HomotopyState(NamedTuple):
    a: jnp.ndarray
    best_a: jnp.ndarray
    warm: WarmStart
    z: jnp.ndarray
    conv: jnp.ndarray
    steps: jnp.ndarray
    iters: jnp.ndarray
    done: jnp.ndarray


def make_subsystem_solver(nl, fq, pexp, q0, *, tol=1e-10, maxiter=500,
                          homotopy=True, max_homotopy_steps=4096):
    """Build ``solve(p, warm) -> SolveResult`` for one nonlinear subsystem.

    ``nl`` is the subsystem NLFunc (q -> (res, Jq)); fq (nq, nn), pexp
    (nq, np), q0 (nq,) are the frozen model matrices.  Semantics per lane
    mirror the reference: Newton to max-abs residual < tol with at most
    ``maxiter`` iterations (solvers.jl:175,207), bail-out on singular or
    non-finite Jacobian keeping the current z, homotopy bisection from the
    warm-start origin towards the target on failure (solvers.jl:268-296).
    """
    fq = jnp.asarray(fq)
    pexp = jnp.asarray(pexp)
    q0 = jnp.asarray(q0)
    base = make_subsystem_solver_mats(
        nl, fq.shape[1], dtype=fq.dtype, tol=tol, maxiter=maxiter,
        homotopy=homotopy, max_homotopy_steps=max_homotopy_steps)

    def solve(p, warm: WarmStart) -> SolveResult:
        return base(p, warm, fq, pexp, q0)

    return solve


def make_subsystem_solver_mats(nl, nn, *, dtype=None, tol=1e-10,
                               maxiter=500, homotopy=True,
                               max_homotopy_steps=4096):
    """Like :func:`make_subsystem_solver` but the model matrices are runtime
    arguments: ``solve(p, warm, fq, pexp, q0)``.  vmapping over them gives
    per-lane model matrices -- lanes sweeping *component values*, not just
    pot inputs (each lane is a structurally identical model compiled from a
    different netlist parameterization)."""
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    def solve(p, warm, fq, pexp, q0):
        return _solve_impl(nl, nn, dtype, tol, maxiter, homotopy,
                           max_homotopy_steps, p, warm, fq, pexp, q0)

    return solve


def _solve_impl(nl, nn, dtype, tol, maxiter, homotopy, max_homotopy_steps,
                p_arg, warm_arg, fq, pexp, q0):

    def eval_rj(pfull, z):
        q = pfull + _mm(fq, z)
        res, Jq = nl(jnp, q)
        return res, _mm(Jq, fq), Jq

    def resmax_of(res):
        return jnp.max(jnp.abs(res)) if nn > 0 else jnp.zeros((), dtype)

    def newton(pfull, z0):
        def cond(s: _NewtonState):
            return ~s.stop

        def body(s: _NewtonState):
            res, J, _ = eval_rj(pfull, s.z)
            resmax = resmax_of(res)
            finite = jnp.isfinite(resmax) & jnp.all(jnp.isfinite(J))
            conv = resmax < tol
            dz, ok = solve_dense(J, res[:, None])
            bail = (~finite) | (~ok)
            step = (~conv) & (~bail)
            z = jnp.where(step, s.z - dz[:, 0], s.z)
            it = s.it + 1
            stop = conv | bail | (it >= maxiter)
            return _NewtonState(z=z, it=it, conv=conv, stop=stop)

        init = _NewtonState(z=z0, it=jnp.zeros((), jnp.int32),
                            conv=jnp.asarray(False), stop=jnp.asarray(nn == 0))
        out = jax.lax.while_loop(cond, body, init)
        conv = out.conv | jnp.asarray(nn == 0)
        return out.z, conv, out.it

    def dzdp_at(pfull, z):
        """-J^-1 Jp, the sensitivity used for extrapolation
        (ref solvers.jl:200-201).  Returns (dzdp, ok): with a singular or
        non-finite Jacobian at the solution, the reference skips the origin
        update entirely (solvers.jl:223-225 bails before the update at
        :233); callers must do the same or the poisoned sensitivity destroys
        every subsequent warm start."""
        _, J, Jq = eval_rj(pfull, z)
        d, ok = solve_dense(J, _mm(Jq, pexp))
        ok = ok & jnp.all(jnp.isfinite(d)) & jnp.all(jnp.isfinite(J))
        return -d, ok

    def solve(p, warm: WarmStart) -> SolveResult:
        z0 = warm.z + _mm(warm.dzdp, p - warm.p)
        pfull = q0 + _mm(pexp, p)
        z, conv, iters = newton(pfull, z0)

        if homotopy:
            start_p = warm.p

            def guard(done, new, old):
                return jax.tree_util.tree_map(
                    lambda a, b: jnp.where(done, b, a), new, old)

            def hcond(s: _HomotopyState):
                return ~s.done

            def hbody(s: _HomotopyState):
                pa = (1.0 - s.a) * start_p + s.a * p
                z0a = s.warm.z + _mm(s.warm.dzdp, pa - s.warm.p)
                pfa = q0 + _mm(pexp, pa)
                zz, cc, its = newton(pfa, z0a)
                dz_a, ok_a = dzdp_at(pfa, zz)
                new_warm = WarmStart(p=pa, z=zz, dzdp=dz_a)
                warm2 = guard(~(cc & ok_a), new_warm, s.warm)
                best_a = jnp.where(cc, s.a, s.best_a)
                new_a = jnp.where(cc, 1.0, (s.a + s.best_a) / 2.0)
                stuck = (~cc) & ~((s.best_a < new_a) & (new_a < s.a))
                steps = s.steps + 1
                # hopeless-path early exit: with best_a still 0 after 32
                # halvings the path point is within 2^-32 of the warm
                # origin and STILL fails -- the target tolerance is not
                # reachable anywhere on the path (e.g. an operating point
                # whose f64 residual floor sits above the absolute tol).
                # Bisection would otherwise halve to float underflow:
                # ~1075 steps x maxiter Newton = ~500k wasted iterations
                # per solve, every sample.
                hopeless = (best_a <= 0.0) & (steps >= 32)
                done = (best_a >= 1.0) | stuck | hopeless \
                    | (steps >= max_homotopy_steps)
                new = _HomotopyState(a=new_a, best_a=best_a, warm=warm2,
                                     z=zz, conv=cc, steps=steps,
                                     iters=s.iters + its, done=done)
                return guard(s.done, new, s)

            hinit = _HomotopyState(
                a=jnp.asarray(0.5, dtype), best_a=jnp.zeros((), dtype),
                warm=warm, z=z, conv=conv, steps=jnp.zeros((), jnp.int32),
                iters=iters, done=conv)
            hout = jax.lax.while_loop(hcond, hbody, hinit)
            engaged = ~conv
            z = jnp.where(engaged, hout.z, z)
            conv = jnp.where(engaged, hout.conv, conv)
            iters = jnp.where(engaged, hout.iters, iters)
            fallback_warm = jax.tree_util.tree_map(
                lambda h, w: jnp.where(engaged, h, w), hout.warm, warm)
        else:
            fallback_warm = warm

        # on convergence the origin moves to (p, z) (ref solvers.jl:231-234)
        # -- unless the Jacobian there is singular/non-finite, in which case
        # the old origin is kept (reference early-return semantics)
        dz_f, ok_f = dzdp_at(pfull, z)
        new_warm = WarmStart(p=p, z=z, dzdp=dz_f)
        upd = conv & ok_f
        warm_out = jax.tree_util.tree_map(
            lambda n, f: jnp.where(upd, n, f), new_warm, fallback_warm)
        return SolveResult(z=z, converged=conv, warm=warm_out, iters=iters)

    return solve(p_arg, warm_arg)
