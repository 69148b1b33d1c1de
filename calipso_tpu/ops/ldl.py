"""Dense unpivoted LDL^T for symmetric quasidefinite systems, with inertia.

Dense replacement for the vendored sparse QDLDL (reference
src/solver/qdldl.jl:1-745): the condensed KKT system is assembled dense with
static shapes, factorized by an unpivoted LDL^T (valid for quasidefinite
matrices under any symmetric permutation), and the inertia is read off the
signs of D (reference src/solver/linear_solver.jl:33-44). The up-looking
sparse factorization + AMD ordering of the reference is unnecessary here:
XLA gets static dense blocks, and structure exploitation happens at the
block level (trajopt stage-banded solver) rather than the scalar-nnz level.

The factorization loop is a lax.fori_loop of rank-1 updates (each O(n^2),
vectorized); triangular solves use XLA's native blocked
solve_triangular. A blocked panel variant is the planned fast path for
large n.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def ldl_factor(K):
    """Unpivoted LDL^T of symmetric K. Returns (L, d): unit-lower L and the
    diagonal d of D. Breakdown (zero pivot) produces inf/nan which the
    inertia readout classifies as a zero eigenvalue, triggering the
    regularization ladder exactly like a failed sparse refactorization."""
    n = K.shape[0]
    if n == 0:
        return jnp.zeros((0, 0), K.dtype), jnp.zeros((0,), K.dtype)
    rows = jnp.arange(n)

    def body(k, A):
        d = A[k, k]
        lower = rows > k
        l = jnp.where(lower, A[:, k] / d, jnp.zeros((), A.dtype))
        A = A - d * jnp.outer(l, l)
        A = A.at[:, k].set(jnp.where(lower, l, A[:, k]))
        return A

    A = lax.fori_loop(0, n, body, K)
    d = jnp.diagonal(A)
    L = jnp.tril(A, -1) + jnp.eye(n, dtype=K.dtype)
    return L, d


def ldl_solve(L, d, b):
    """Solve (L D L^T) x = b; b may be (n,) or (n, k)."""
    n = L.shape[0]
    if n == 0:
        return b
    vec = b.ndim == 1
    if vec:
        b = b[:, None]
    y = jax.scipy.linalg.solve_triangular(L, b, lower=True, unit_diagonal=True)
    y = y / d[:, None]
    x = jax.scipy.linalg.solve_triangular(
        L, y, lower=True, unit_diagonal=True, trans="T"
    )
    return x[:, 0] if vec else x


def inertia_counts(d):
    """(num_positive, num_negative, num_zero) from sign(D); non-finite
    pivots and pivots below a dtype-scaled relative threshold count as zero
    eigenvalues (reference linear_solver.jl:33-44 counts exact signs, which
    is safe in f64 only -- in f32 rounding noise around zero must trigger
    the regularization ladder instead of silently passing the inertia
    test, or indefinite systems go uncorrected and the line search
    stalls)."""
    if d.shape[0] == 0:
        z = jnp.zeros((), jnp.int32)
        return z, z, z
    eps = float(jnp.finfo(d.dtype).eps)
    tol = 10.0 * eps * jnp.max(jnp.abs(jnp.where(jnp.isfinite(d), d, 0.0)))
    finite = jnp.isfinite(d)
    pos = jnp.sum(finite & (d > tol))
    neg = jnp.sum(finite & (d < -tol))
    zero = d.shape[0] - pos - neg
    return pos, neg, zero
