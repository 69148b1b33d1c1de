"""Horizon-sharded block-tridiagonal solve (ops/spike.py): the
sequence-parallel (CP-like) axis. Runs on the 8-virtual-device CPU mesh
(tests/conftest.py), validating the partitioned Schur-complement
elimination against a dense solve and the single-device Riccati sweep."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from calipso_tpu.ops import riccati as rc
from calipso_tpu.ops import spike


def _random_spd_tridiag(rng, T, d, shift=6.0):
    O = jnp.asarray(rng.normal(size=(T - 1, d, d)))
    D = jnp.asarray(
        np.stack([(lambda A: A @ A.T + shift * np.eye(d))(rng.normal(size=(d, d))) for _ in range(T)])
    )
    n = T * d
    S = np.zeros((n, n))
    for t in range(T):
        S[t * d : (t + 1) * d, t * d : (t + 1) * d] = D[t]
    for t in range(T - 1):
        S[(t + 1) * d : (t + 2) * d, t * d : (t + 1) * d] = O[t]
        S[t * d : (t + 1) * d, (t + 1) * d : (t + 2) * d] = O[t].T
    w = np.linalg.eigvalsh(S).min()
    if w < 0.5:
        S += (0.5 - w) * np.eye(n)
        D = D + (0.5 - w) * jnp.eye(d)[None]
    return D, O, S


def _mesh():
    return Mesh(np.array(jax.devices()), axis_names=("stage",))


@pytest.mark.parametrize("T,d", [(16, 3), (32, 5), (64, 4)])
def test_spike_matches_dense(T, d):
    rng = np.random.default_rng(T + d)
    D, O, S = _random_spd_tridiag(rng, T, d)
    b = jnp.asarray(rng.normal(size=(T, d)))
    mesh = _mesh()
    x = jax.jit(lambda D, O, b: spike.solve_sharded(D, O, b, mesh, "stage"))(D, O, b)
    x_ref = np.linalg.solve(S, np.asarray(b).ravel()).reshape(T, d)
    assert np.abs(np.asarray(x) - x_ref).max() < 1e-10


def test_spike_matches_riccati_sweep():
    rng = np.random.default_rng(3)
    T, d = 24, 4
    D, O, _ = _random_spd_tridiag(rng, T, d)
    b = jnp.asarray(rng.normal(size=(T, d)))
    L, M = rc.factor(D, O)
    x_rc = rc.solve(L, M, b)
    x_sp = spike.solve_sharded(D, O, b, _mesh(), "stage")
    assert np.abs(np.asarray(x_sp) - np.asarray(x_rc)).max() < 1e-10


def test_spike_rejects_bad_split():
    rng = np.random.default_rng(0)
    D, O, _ = _random_spd_tridiag(rng, 12, 3)  # 12 not divisible by 8
    b = jnp.zeros((12, 3))
    with pytest.raises(ValueError, match="chunks"):
        spike.solve_sharded(D, O, b, _mesh(), "stage")


def test_spike_factor_apply_multi_rhs():
    """Split factor/apply phases (the linear_solver='spike' backend path),
    including multi-RHS solves (iterative refinement / sensitivity
    columns)."""
    rng = np.random.default_rng(11)
    T, d, k = 16, 3, 4
    D, O, S = _random_spd_tridiag(rng, T, d)
    mesh = _mesh()
    fact = jax.jit(lambda D, O: spike.factor_sharded(D, O, mesh, "stage"))(D, O)
    assert bool(spike.factors_finite(fact))
    b = jnp.asarray(rng.normal(size=(T, d)))
    x = spike.solve_fact(fact, b, mesh, "stage")
    x_ref = np.linalg.solve(S, np.asarray(b).ravel()).reshape(T, d)
    assert np.abs(np.asarray(x) - x_ref).max() < 1e-10
    B = jnp.asarray(rng.normal(size=(T, d, k)))
    X = spike.solve_fact(fact, B, mesh, "stage")
    X_ref = np.linalg.solve(S, np.asarray(B).reshape(T * d, k)).reshape(T, d, k)
    assert np.abs(np.asarray(X) - X_ref).max() < 1e-10


def test_spike_backend_full_solve():
    """linear_solver='spike': a full AL-IPM trajopt solve with the horizon
    sharded over the 8-device mesh reproduces the riccati backend's
    iterate sequence."""
    from calipso_tpu import TrajOptSolver, Options
    from calipso_tpu.models import pendulum

    horizon = 16  # 8 chunks x 2 stages

    def build(opts):
        prob = pendulum.swingup_problem(horizon)
        ts = TrajOptSolver(
            [lambda x, u, w: 0.01 * u @ u + 0.1 * (x[1] ** 2)] * (horizon - 1)
            + [lambda x, u, w: 0.1 * (x[1] ** 2)],
            [pendulum.discrete] * (horizon - 1),
            [2] * horizon,
            [1] * (horizon - 1),
            equality=[lambda x, u, w: x]
            + [None] * (horizon - 2)
            + [lambda x, u, w: x - jnp.array([np.pi, 0.0])],
            options=opts,
        )
        ts.initialize_states(prob["state_guess"])
        ts.initialize_actions([np.zeros(1)] * (horizon - 1))
        return ts.solve()

    r_ref = build(Options(linear_solver="riccati"))
    mesh = Mesh(np.array(jax.devices()), axis_names=("horizon",))
    r_sp = build(Options(linear_solver="spike", spike_mesh=mesh))
    for r in (r_ref, r_sp):
        assert bool(r.solved)
    assert int(r_sp.iterations) == int(r_ref.iterations)
    np.testing.assert_allclose(
        np.asarray(r_sp.variables), np.asarray(r_ref.variables), atol=1e-8
    )


def test_spike_backend_equality_general():
    """equality_general on the spike backend: the low-rank Schur border's
    banded solves go through the sharded factorization; iterates match the
    riccati border path."""
    from calipso_tpu import TrajOptSolver, Options
    from calipso_tpu.models import pendulum

    horizon = 16

    def build(opts):
        ts = TrajOptSolver(
            [lambda x, u, w: 0.01 * u @ u + 0.1 * (x[1] ** 2)] * (horizon - 1)
            + [lambda x, u, w: 0.1 * (x[1] ** 2)],
            [pendulum.discrete] * (horizon - 1),
            [2] * horizon,
            [1] * (horizon - 1),
            equality_general=lambda z, th: jnp.concatenate(
                [z[0:2], z[-2:] - jnp.array([np.pi, 0.0])]
            ),
            options=opts,
        )
        ts.initialize_states(pendulum.swingup_problem(horizon)["state_guess"])
        ts.initialize_actions([np.zeros(1)] * (horizon - 1))
        return ts.solve()

    r_ref = build(Options(linear_solver="riccati"))
    mesh = Mesh(np.array(jax.devices()), axis_names=("horizon",))
    r_sp = build(Options(linear_solver="spike", spike_mesh=mesh))
    for r in (r_ref, r_sp):
        assert bool(r.solved)
    assert int(r_sp.iterations) == int(r_ref.iterations)
    np.testing.assert_allclose(
        np.asarray(r_sp.variables), np.asarray(r_ref.variables), atol=1e-7
    )
