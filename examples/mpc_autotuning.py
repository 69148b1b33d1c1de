"""Cart-pole MPC auto-tuning: learn MPC cost weights by gradient descent on
a closed-loop rollout loss, with `jax.grad` flowing through the solver's
implicit differentiation (counterpart of the reference's hand-written chain
rule, examples/autotuning/{autotuning,cartpole}.jl).

Run:  PYTHONPATH=. python examples/mpc_autotuning.py
"""

import sys, os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

# float64 on every platform: the examples run at the reference's f64
# tolerances
jax.config.update("jax_enable_x64", True)

from calipso_tpu import TrajOptSolver, Options
from calipso_tpu.apps import autotuning
from calipso_tpu.models import cartpole

T, nx, nu = 4, 4, 1  # short MPC horizon: every policy eval is a full solve


def stage_cost(x, u, w):
    return 0.5 * x @ (w[:4] * x) + 0.05 * (u @ u)


objective = [stage_cost] * (T - 1) + [lambda x, u, w: 0.5 * x @ (w[:4] * x)]
equality = [lambda x, u, w: x - w[4:8], *[None] * (T - 1)]
parameters = (
    [np.concatenate([np.ones(4), np.zeros(4)])]
    + [np.ones(4)] * (T - 2)
    + [10.0 * np.ones(4)]
)
ts = TrajOptSolver(
    objective,
    [cartpole.discrete] * (T - 1),
    [nx] * T,
    [nu] * (T - 1),
    equality=equality,
    parameters=parameters,
    options=Options(residual_tolerance=1e-6, equality_tolerance=1e-6,
                    complementarity_tolerance=1e-6),
)


def theta_builder(weights, state):
    return jnp.concatenate([weights, state] + [weights] * (T - 2) + [10.0 * jnp.ones(4)])


pol = autotuning.make_mpc_policy(
    ts,
    guess=np.zeros(ts.num_variables),
    theta_builder=theta_builder,
    action_indices=ts._action_indices[0],
    num_weights=4,
)


def sim(x, u):  # implicit-midpoint plant via fixed-point iteration
    y = x + 0.05 * cartpole.continuous(x, u)
    for _ in range(3):
        y = x + 0.05 * cartpole.continuous(0.5 * (x + y), u)
    return y


loss = autotuning.rollout_loss(
    pol.policy,
    sim,
    horizon=5,
    state_cost=np.diag([1.0, 5.0, 0.1, 0.1]),
    action_cost=0.01 * np.eye(1),
    state_reference=jnp.array([0.0, np.pi, 0.0, 0.0]),
    action_reference=np.zeros(1),
)
w0 = jnp.ones(4)
x0 = jnp.array([0.1, np.pi - 0.2, 0.0, 0.0])
w_tuned, history = autotuning.autotune(loss, w0, x0, max_iterations=5, verbose=True)
print(f"weights {np.asarray(w0)} -> {np.round(np.asarray(w_tuned), 3)}")
print(f"rollout loss {history[0]:.5f} -> {history[-1]:.5f}")
assert history[-1] < history[0]
