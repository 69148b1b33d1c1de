"""Linear-solver backend equivalence: the dense Schur-Cholesky path must
reproduce the reference-faithful dense-LDL path on the convergence
contract."""

import numpy as np
import jax.numpy as jnp
import pytest

from calipso_tpu import Solver, Options, empty_constraint

from tests.test_solver_nlp import assert_contract


@pytest.mark.parametrize("method", ["ldl", "schur"])
def test_wachter_backends(method):
    opts = Options(linear_solver=method)
    solver = Solver(
        lambda x: x[0],
        lambda x: jnp.array([x[0] ** 2 - x[1] - 1.0, x[0] - x[2] - 0.5]),
        lambda x: x[1:3],
        3,
        options=opts,
    )
    res = solver.solve(jnp.array([-2.0, 3.0, 1.0]))
    assert_contract(res, opts)
    np.testing.assert_allclose(np.asarray(res.variables), [1.0, 0.0, 0.5], atol=1e-3)


@pytest.mark.parametrize("method", ["ldl", "schur"])
def test_soc_backends(method):
    opts = Options(linear_solver=method)
    solver = Solver(
        lambda x, th: th[:3] @ x,
        lambda x, th: jnp.array([x[0] - th[3]]),
        lambda x, th: x,
        3,
        num_parameters=4,
        nonnegative_indices=[],
        second_order_indices=[[0, 1, 2]],
        options=opts,
    )
    res = solver.solve(
        jnp.array([0.3, -0.5, 0.2]), parameters=jnp.array([0.0, 1.0, 1.0, 0.5])
    )
    assert_contract(res, opts)
    x = np.asarray(res.variables)
    assert abs(np.linalg.norm(x[1:]) - 0.5) < 1e-3


@pytest.mark.parametrize("method", ["ldl", "schur"])
def test_differentiate_backends(method):
    # QP with analytic sensitivity dx*/db = [2/3, 1/3]
    opts = Options(linear_solver=method, differentiate=True, residual_tolerance=1e-8)
    solver = Solver(
        lambda x, th: 0.5 * x @ (th[:2] * x),
        lambda x, th: jnp.array([x[0] + x[1] - th[2]]),
        empty_constraint,
        2,
        parameters=jnp.array([2.0, 4.0, 1.0]),
        options=opts,
    )
    res = solver.solve(jnp.zeros(2))
    assert bool(res.solved)
    sens = np.asarray(res.sensitivity)[:2, 2]
    np.testing.assert_allclose(sens, [2.0 / 3.0, 1.0 / 3.0], atol=1e-3)
