"""Parallel-in-time block cyclic reduction for SPD block-tridiagonal systems.

The O(log T)-depth alternative to the serial Riccati sweep
(ops/riccati.py) for the stage-block tridiagonal primal Schur complement of
a trajopt KKT system (SURVEY.md section 2.4 item 3 / section 5: the
reference's AMD-ordered QDLDL, qdldl.jl:134-188, is inherently serial in
the horizon; cyclic reduction re-orders the elimination as nested
dissection so every level eliminates all odd-indexed stages at once).

At each level the odd block rows

    O_{2k} x_{2k} + D_{2k+1} x_{2k+1} + O_{2k+1}^T x_{2k+2} = b_{2k+1}

are eliminated in parallel (one batched Cholesky + batched triangular
solves + batched matmuls over all odd stages), producing a
half-size block-tridiagonal system over the even stages:

    D'_{2k}   = D_{2k}  - O_{2k}^T  D_{2k+1}^{-1} O_{2k}
                        - O_{2k-1}  D_{2k-1}^{-1} O_{2k-1}^T
    O'_k      = -O_{2k+1} D_{2k+1}^{-1} O_{2k}        (couples 2k -> 2k+2)
    b'_{2k}   = b_{2k} - O_{2k}^T D_{2k+1}^{-1} b_{2k+1}
                       - O_{2k-1} D_{2k-1}^{-1} b_{2k-1}

ceil(log2 T) levels of O(T/2^l) independent d x d block ops: O(T d^3)
total work (same order as the sweep, ~2x the constant) at O(log T)
sequential depth instead of O(T) -- the win for long horizons where the
scan's per-step latency dominates.

Every reduced system is a Schur complement of an SPD matrix, so all pivots
stay SPD and (like the Riccati backend) a non-PD matrix surfaces as
NaN/Inf in some level's Cholesky factor -- the inertia signal
(reference inertia.jl:7-11 target inertia <=> S PD).

Block convention matches ops/riccati.py: D (T, d, d) diagonal blocks,
O (T-1, d, d) with O_t the block at (row t+1, col t).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _chosolve(L, B):
    """A^{-1} B from the lower Cholesky factor L of A; batched over any
    leading dims."""
    y = jax.scipy.linalg.solve_triangular(L, B, lower=True)
    return jax.scipy.linalg.solve_triangular(L, y, lower=True, trans="T")


def num_levels(T: int) -> int:
    n, m = 0, T
    while m > 1:
        m = (m + 1) // 2
        n += 1
    return n


def factor(D, O):
    """Cyclic-reduction factorization.

    Returns (levels, L_final): `levels` is a tuple of per-level
    (L_odd, OL, OR) with L_odd (co, d, d) the Cholesky factors of the odd
    diagonal blocks, OL = O[0::2] (co, d, d) the couplings odd->even-left,
    OR = O[1::2] (ce-1, d, d) the couplings odd->even-right at that level;
    L_final is the Cholesky factor of the last remaining block."""
    T, d, _ = D.shape
    levels = []
    m = T
    while m > 1:
        co = m // 2  # odd-stage count
        cr = (m - 1) // 2  # = even-count - 1: number of new couplings
        Dodd = D[1::2]
        Lodd = jnp.linalg.cholesky(Dodd)
        OL = O[0::2]  # O_{2k}: couples even 2k (col) to odd 2k+1 (row)
        OR = O[1::2]  # O_{2k+1}: couples odd 2k+1 (col) to even 2k+2 (row)
        X1 = _chosolve(Lodd, OL)  # D_odd^{-1} O_{2k}
        Dn = D[0::2]
        Dn = Dn.at[:co].add(-jnp.einsum("kji,kjl->kil", OL, X1))
        if cr > 0:
            X2 = _chosolve(Lodd[:cr], jnp.swapaxes(OR, 1, 2))  # D^{-1} O_{2k+1}^T
            Dn = Dn.at[1 : cr + 1].add(-jnp.einsum("kij,kjl->kil", OR, X2))
            On = -jnp.einsum("kij,kjl->kil", OR, X1[:cr])
        else:
            On = jnp.zeros((0, d, d), D.dtype)
        Dn = 0.5 * (Dn + jnp.swapaxes(Dn, 1, 2))
        levels.append((Lodd, OL, OR))
        D, O, m = Dn, On, (m + 1) // 2
    L_final = jnp.linalg.cholesky(D[0])
    return tuple(levels), L_final


def solve(fact, b):
    """Solve S x = b given `fact` from `factor`. b is (T, d)."""
    levels, L_final = fact
    d = b.shape[-1]
    saved = []
    for Lodd, OL, OR in levels:
        co, cr = Lodd.shape[0], OR.shape[0]
        b_odd = b[1::2]
        u = _chosolve(Lodd, b_odd[..., None])[..., 0]  # D_odd^{-1} b_odd
        b_even = b[0::2]
        b_even = b_even.at[:co].add(-jnp.einsum("kji,kj->ki", OL, u))
        if cr > 0:
            b_even = b_even.at[1 : cr + 1].add(-jnp.einsum("kij,kj->ki", OR, u[:cr]))
        saved.append(b_odd)
        b = b_even
    x = _chosolve(L_final, b[0][:, None])[:, 0][None]  # (1, d)
    for (Lodd, OL, OR), b_odd in zip(reversed(levels), reversed(saved)):
        co, cr = Lodd.shape[0], OR.shape[0]
        rhs = b_odd - jnp.einsum("kij,kj->ki", OL, x[:co])
        if cr > 0:
            rhs = rhs.at[:cr].add(-jnp.einsum("kji,kj->ki", OR, x[1 : cr + 1]))
        x_odd = _chosolve(Lodd, rhs[..., None])[..., 0]
        m = co + x.shape[0]
        out = jnp.zeros((m, d), x.dtype)
        x = out.at[0::2].set(x).at[1::2].set(x_odd)
    return x


def solve_multi(fact, B):
    """Solve for multiple right-hand sides B (T, d, k)."""
    return jax.vmap(lambda b: solve(fact, b), in_axes=2, out_axes=2)(B)


def factors_finite(fact):
    """Scalar bool: every Cholesky pivot finite <=> S was SPD (the
    cyclic-reduction inertia signal)."""
    levels, L_final = fact
    flags = [jnp.all(jnp.isfinite(Lodd)) for Lodd, _, _ in levels]
    flags.append(jnp.all(jnp.isfinite(L_final)))
    return jnp.all(jnp.stack(flags)) if flags else jnp.asarray(True)
