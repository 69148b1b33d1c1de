"""Riccati (block-tridiagonal) backend equivalence with the dense Schur
path on trajopt problems, including SOCs and ragged stage dims."""

import numpy as np
import pytest

from calipso_tpu import TrajOptSolver, Options
from calipso_tpu.models import pendulum, rocket

from tests.test_solver_nlp import assert_contract


def _solve(prob, method, seed=0, actions_scale=0.0):
    kw = {
        k: v
        for k, v in prob.items()
        if k not in ("state_guess", "state_initial", "state_goal", "action_guess", "penalty_initial")
    }
    ts = TrajOptSolver(options=Options(linear_solver=method), **kw)
    ts.initialize_states(prob["state_guess"])
    rng = np.random.default_rng(seed)
    ts.initialize_actions([actions_scale * rng.normal(size=k) for k in prob["num_actions"]])
    return ts, ts.solve()


def test_pendulum_riccati_matches_schur():
    prob = pendulum.swingup_problem(horizon=11)
    _, r1 = _solve(prob, "schur")
    _, r2 = _solve(prob, "riccati")
    assert_contract(r1)
    assert_contract(r2)
    assert int(r1.iterations) == int(r2.iterations)
    np.testing.assert_allclose(
        np.asarray(r1.variables), np.asarray(r2.variables), atol=1e-6
    )


def test_rocket_soc_riccati():
    prob = rocket.landing_problem(horizon=31)
    ts, r = _solve(prob, "riccati", actions_scale=1e-3)
    assert_contract(r)
    states, actions = ts.get_trajectory(r)
    for u in actions:
        assert np.linalg.norm(u[:2]) < u[2] + 1e-8


def _periodicity_problem(horizon=11):
    """Cross-stage coupling through equality_general (reference
    equality_general.jl): pendulum swingup with boundary conditions
    imposed on the whole trajectory vector — exercises the structured
    backends' low-rank Schur border (kkt._general_border)."""
    import jax.numpy as jnp

    objective = [
        *[(lambda x, u, w: 0.01 * u @ u + 0.1 * (x[1] ** 2))] * (horizon - 1),
        lambda x, u, w: 0.1 * (x[1] ** 2),
    ]

    def general(z, theta):
        return jnp.concatenate(
            [z[0:2] - jnp.array([0.0, 0.0]), z[-2:] - jnp.array([np.pi, 0.0])]
        )

    return dict(
        objective=objective,
        dynamics=[pendulum.discrete] * (horizon - 1),
        num_states=[2] * horizon,
        num_actions=[1] * (horizon - 1),
        equality_general=general,
        state_guess=pendulum.swingup_problem(horizon)["state_guess"],
        action_guess=[np.zeros(1)] * (horizon - 1),
    )


@pytest.mark.parametrize("method", ["riccati", "cr"])
def test_general_equality_border_matches_schur(method):
    """The low-rank Schur border must reproduce the dense
    Schur path exactly: same iterate sequence, same solution."""
    prob = _periodicity_problem()
    kw = {k: v for k, v in prob.items() if k not in ("state_guess", "action_guess")}

    def run(m):
        ts = TrajOptSolver(options=Options(linear_solver=m), **kw)
        ts.initialize_states(prob["state_guess"])
        ts.initialize_actions(prob["action_guess"])
        return ts.solve()

    r_ref = run("schur")
    r = run(method)
    assert_contract(r_ref)
    assert_contract(r)
    assert int(r.iterations) == int(r_ref.iterations)
    np.testing.assert_allclose(
        np.asarray(r.variables), np.asarray(r_ref.variables), atol=1e-6
    )
    z = np.asarray(r.variables)
    np.testing.assert_allclose(z[0:2], [0.0, 0.0], atol=1e-4)
    np.testing.assert_allclose(z[-2:], [np.pi, 0.0], atol=1e-4)


def test_general_equality_single_stage_fold():
    """General rows touching ONE stage need no border — the block-diagonal
    Gram fold alone is exact (kkt._riccati_blocks general fold)."""
    horizon = 5
    import jax.numpy as jnp

    prob = pendulum.swingup_problem(horizon)
    ts = TrajOptSolver(
        [lambda x, u, w: 0.01 * u @ u] * (horizon - 1) + [lambda x, u, w: 0.0],
        [pendulum.discrete] * (horizon - 1),
        [2] * horizon,
        [1] * (horizon - 1),
        equality_general=lambda z, th: z[-2:] - jnp.array([np.pi, 0.0]),
        equality=[lambda x, u, w: x] + [None] * (horizon - 1),
        options=Options(linear_solver="riccati"),
    )
    ts.initialize_states(prob["state_guess"])
    ts.initialize_actions([np.zeros(1)] * (horizon - 1))
    res = ts.solve()
    assert_contract(res)
    z = np.asarray(res.variables)
    np.testing.assert_allclose(z[-2:], [np.pi, 0.0], atol=1e-4)
