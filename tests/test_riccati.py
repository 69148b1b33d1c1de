"""Block-tridiagonal Cholesky (Riccati sweep) vs dense reference."""

import numpy as np
import jax.numpy as jnp
import pytest

import chip_smoke
from calipso_tpu.ops import riccati


def make_block_tridiag(T, d, rng):
    D = np.zeros((T, d, d))
    O = np.zeros((T - 1, d, d))
    for t in range(T):
        A = rng.normal(size=(d, d))
        D[t] = A @ A.T + d * np.eye(d)
    for t in range(T - 1):
        O[t] = 0.3 * rng.normal(size=(d, d))
    S = np.zeros((T * d, T * d))
    for t in range(T):
        S[t * d : (t + 1) * d, t * d : (t + 1) * d] = D[t]
    for t in range(T - 1):
        S[(t + 1) * d : (t + 2) * d, t * d : (t + 1) * d] = O[t]
        S[t * d : (t + 1) * d, (t + 1) * d : (t + 2) * d] = O[t].T
    return D, O, S


def test_factor_solve_matches_dense():
    rng = np.random.default_rng(0)
    T, d = 7, 4
    D, O, S = make_block_tridiag(T, d, rng)
    L, M = riccati.factor(jnp.asarray(D), jnp.asarray(O))
    assert bool(jnp.all(jnp.isfinite(L)))
    b = rng.normal(size=(T, d))
    x = riccati.solve(L, M, jnp.asarray(b))
    want = np.linalg.solve(S, b.reshape(-1)).reshape(T, d)
    np.testing.assert_allclose(np.asarray(x), want, atol=1e-9)


def test_padded_identity_blocks():
    """Padded dimensions (identity diag, zero couplings, zero rhs)
    decouple exactly."""
    rng = np.random.default_rng(1)
    T, d = 5, 3
    D, O, S = make_block_tridiag(T, d, rng)
    dp = d + 2
    Dp = np.tile(np.eye(dp), (T, 1, 1))
    Op = np.zeros((T - 1, dp, dp))
    Dp[:, :d, :d] = D
    Op[:, :d, :d] = O
    b = rng.normal(size=(T, d))
    bp = np.zeros((T, dp))
    bp[:, :d] = b
    L, M = riccati.factor(jnp.asarray(Dp), jnp.asarray(Op))
    x = np.asarray(riccati.solve(L, M, jnp.asarray(bp)))
    want = np.linalg.solve(S, b.reshape(-1)).reshape(T, d)
    np.testing.assert_allclose(x[:, :d], want, atol=1e-9)
    np.testing.assert_allclose(x[:, d:], 0.0, atol=1e-12)


def test_non_pd_detected():
    rng = np.random.default_rng(2)
    T, d = 4, 3
    D, O, _ = make_block_tridiag(T, d, rng)
    D[2] = -np.eye(d)  # indefinite block
    L, _ = riccati.factor(jnp.asarray(D), jnp.asarray(O))
    assert not bool(jnp.all(jnp.isfinite(L)))


def test_multi_rhs():
    rng = np.random.default_rng(3)
    T, d = 6, 3
    D, O, S = make_block_tridiag(T, d, rng)
    L, M = riccati.factor(jnp.asarray(D), jnp.asarray(O))
    B = rng.normal(size=(T, d, 4))
    X = np.asarray(riccati.solve_multi(L, M, jnp.asarray(B)))
    want = np.linalg.solve(S, B.reshape(T * d, 4)).reshape(T, d, 4)
    np.testing.assert_allclose(X, want, atol=1e-9)


@pytest.mark.parametrize("B, T, d", chip_smoke.FACTOR_SHAPES)
def test_batched_factor_solve_matches_dense(B, T, d):
    """The batched factorization route (vmap of the dense Cholesky at T=1,
    of the Riccati sweep otherwise) at the shapes of the benchmark cells,
    against float64 residuals and a dense float64 NumPy solve."""
    x, rel = chip_smoke.factor_solve_residual(B, T, d, jnp.float64)
    assert rel < 1e-12
    D, O, b = chip_smoke.spd_blocks(B, T, d)
    for i in (0, B - 1):
        S = np.zeros((T * d, T * d))
        for t in range(T):
            S[t * d : (t + 1) * d, t * d : (t + 1) * d] = D[i, t]
        for t in range(T - 1):
            S[(t + 1) * d : (t + 2) * d, t * d : (t + 1) * d] = O[i, t]
            S[t * d : (t + 1) * d, (t + 1) * d : (t + 2) * d] = O[i, t].T
        want = np.linalg.solve(S, b[i].reshape(-1))
        np.testing.assert_allclose(x[i].reshape(-1), want, atol=1e-10)


@pytest.mark.parametrize("T, d", [(1, 32), (8, 54)])
def test_batched_nonpd_lane_is_nan(T, d):
    """Under vmap, a non-PD block in one lane makes that lane's factor
    non-finite (the inertia ladder's signal) and leaves the others
    finite."""
    assert chip_smoke.nonpd_lane_is_flagged(16, T, d, jnp.float64)
