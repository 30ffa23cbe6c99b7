"""Small dense linear solves, fully unrolled for static tiny n.

The Newton systems here are nn x nn with nn in {1..~14}; this is far below
any LAPACK/XLA batched-LU crossover, so we unroll partial-pivot Gaussian
elimination into straight-line jnp code (the analog of the reference's
hand-rolled LinearSolver, solvers.jl:38-137, which it hand-rolls for exactly
the same reason).  Under vmap every operation becomes one elementwise op
over the lane axis, which XLA fuses; the data-dependent pivot choice turns
into per-lane where-selects, keeping everything branch-free for XLA.

Singularity semantics follow the reference: a zero pivot marks the solve as
failed (ok=False) instead of raising; callers freeze the Newton step for
those lanes (solvers.jl:220-225).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["solve_dense"]


def solve_dense(J, B):
    """Solve J @ X = B for X; J is (n, n), B is (n, m), n static and tiny.

    Returns (X, ok) where ok is a scalar bool (False on singular/non-finite
    pivot).  On ok=False the returned X is garbage-but-finite; callers must
    mask it out.  Designed to be vmapped over a leading lane axis.
    """
    n = J.shape[0]
    m = B.shape[1]
    dtype = J.dtype
    if n == 0:
        return jnp.zeros((0, m), dtype=dtype), jnp.asarray(True)
    if n == 1:
        piv = J[0, 0]
        ok = (piv != 0) & jnp.isfinite(piv)
        safe = jnp.where(piv == 0, jnp.ones((), dtype), piv)
        return B / safe, ok

    A = jnp.concatenate([J, B], axis=1)  # (n, n+m)
    ok = jnp.asarray(True)
    rows = jnp.arange(n)
    for k in range(n):
        col = jnp.abs(A[:, k])
        col = jnp.where(rows >= k, col, -jnp.inf)
        piv_idx = jnp.argmax(col)
        piv_abs = col[piv_idx]
        ok = ok & (piv_abs > 0) & jnp.isfinite(piv_abs)
        # swap rows k and piv_idx (no-op when equal)
        row_k = A[k, :]
        row_p = A[piv_idx, :]
        A = A.at[k, :].set(row_p).at[piv_idx, :].set(row_k)
        piv = A[k, k]
        safe_piv = jnp.where(piv == 0, jnp.ones((), dtype), piv)
        factors = jnp.where(rows > k, A[:, k] / safe_piv, jnp.zeros((), dtype))
        A = A - factors[:, None] * A[k, :][None, :]
    # back substitution on the upper-triangular system
    X = jnp.zeros((n, m), dtype=dtype)
    for i in range(n - 1, -1, -1):
        rhs = A[i, n:]
        if i + 1 < n:
            rhs = rhs - jnp.matmul(A[i, i + 1:n], X[i + 1:, :],
                               precision=jax.lax.Precision.HIGHEST)
        d = A[i, i]
        safe_d = jnp.where(d == 0, jnp.ones((), dtype), d)
        X = X.at[i, :].set(rhs / safe_d)
    return X, ok
