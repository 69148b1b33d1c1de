"""Block-tridiagonal Cholesky over trajectory stages (Riccati sweep).

The dense-block replacement for sparse LDL^T on stage-banded trajopt KKT
systems (SURVEY.md section 7 step 7; reference relies on AMD-ordered QDLDL,
qdldl.jl:134-188): the condensed primal Schur complement S of a trajopt
problem is block-tridiagonal in stage blocks (d_t = nx_t + nu_t), so its
Cholesky factorization is a lax.scan of T small dense Cholesky +
triangular-solve + matmul steps -- O(T d^3) work and O(T d^2) memory
instead of O(n^3)/O(n^2) dense. Batched callers vmap these functions:
XLA lowers the per-stage Cholesky and triangular solves of a vmapped
scan to batched cuSOLVER/cuBLAS calls on the GPU.

Ragged stage widths are padded to d_max with identity diagonal blocks
(padded dimensions decouple exactly: unit pivots, zero couplings, zero
right-hand sides).

  S = [D_0  O_0'          ]        L_t L_t' = D_t - M_{t-1}' M_{t-1}
      [O_0  D_1  O_1'     ]        M_t     = L_t^{-1} O_t'... (see code)
      [     O_1  D_2  ... ]
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def factor(D, O):
    """Factorize the symmetric block-tridiagonal matrix with diagonal
    blocks D (T, d, d) and sub-diagonal blocks O (T-1, d, d), where block
    row t+1 contains O_t to the left of D_{t+1}.

    Returns (L, M): L (T, d, d) lower Cholesky factors, M (T-1, d, d) with
    M_t = L_t^{-1} O_t' (so the factor's sub-diagonal blocks are M_t').
    Non-PD pivots surface as NaN/Inf in L (inertia signal)."""
    T, d, _ = D.shape
    O_pad = jnp.concatenate([O, jnp.zeros((1, d, d), D.dtype)], axis=0)

    def step(M_prev, inputs):
        D_t, O_t = inputs
        S_t = D_t - M_prev.T @ M_prev
        L_t = jnp.linalg.cholesky(S_t)
        M_t = jax.scipy.linalg.solve_triangular(L_t, O_t.T, lower=True)
        return M_t, (L_t, M_t)

    _, (L, M) = lax.scan(step, jnp.zeros((d, d), D.dtype), (D, O_pad))
    return L, M[:-1]


def solve(L, M, b):
    """Solve S x = b given the factor from `factor`. b is (T, d)."""
    T, d, _ = L.shape
    M_pad = jnp.concatenate([jnp.zeros((1, d, d), L.dtype), M], axis=0)

    # forward: u_t = L_t^{-1} (b_t - M_{t-1}' u_{t-1})
    def fwd(u_prev, inputs):
        L_t, M_prev, b_t = inputs
        u_t = jax.scipy.linalg.solve_triangular(
            L_t, b_t - M_prev.T @ u_prev, lower=True
        )
        return u_t, u_t

    _, U = lax.scan(fwd, jnp.zeros((d,), b.dtype), (L, M_pad, b))

    # backward: x_t = L_t^{-T} (u_t - M_t x_{t+1})
    M_pad2 = jnp.concatenate([M, jnp.zeros((1, d, d), L.dtype)], axis=0)

    def bwd(x_next, inputs):
        L_t, M_t, u_t = inputs
        x_t = jax.scipy.linalg.solve_triangular(
            L_t, u_t - M_t @ x_next, lower=True, trans="T"
        )
        return x_t, x_t

    _, X = lax.scan(
        bwd, jnp.zeros((d,), b.dtype), (L, M_pad2, U), reverse=True
    )
    return X


def solve_multi(L, M, B):
    """Solve for multiple right-hand sides B (T, d, k)."""
    return jax.vmap(lambda b: solve(L, M, b), in_axes=2, out_axes=2)(B)
