"""Acrobot MPC auto-tuning (reference examples/autotuning/acrobot.jl):

1. solve the reference swing-up trajectory with the full-horizon trajopt
   solver (reference acrobot.jl "## Reference" block);
2. build a short-horizon MPC policy whose stage cost weights are the
   learnable parameters, differentiable through the solver's implicit
   differentiation (jax.grad replaces the reference's hand-chained
   policy_jacobian_parameters/state, acrobot.jl:186-231);
3. descend the closed-loop rollout tracking loss against the reference
   tail (reference autotuning.jl:124-170 autotune!).

Run:  PYTHONPATH=. python examples/autotuning_acrobot.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# float64 on every platform: the examples run at the reference's f64
# tolerances
jax.config.update("jax_enable_x64", True)

import numpy as np
import jax.numpy as jnp

from calipso_tpu import TrajOptSolver, Options, linear_interpolation
from calipso_tpu.apps import autotuning
from calipso_tpu.models import acrobot

# ---- 1. reference swing-up (reference acrobot.jl horizon=101; shorter
# here to stay CPU-friendly headless) --------------------------------------
H, nx, nu = 31, 4, 1
state_initial = np.zeros(4)
state_goal = np.array([np.pi, 0.0, 0.0, 0.0])

objective = [lambda x, u, w: 1.0 * x[2:] @ x[2:] + 1.0 * u @ u] * (H - 1) + [
    lambda x, u, w: 1.0 * x[2:] @ x[2:]
]
equality = [
    lambda x, u, w: x - state_initial,
    *[None] * (H - 2),
    lambda x, u, w: x - state_goal,
]
ref = TrajOptSolver(
    objective,
    [acrobot.discrete] * (H - 1),
    [nx] * H,
    [nu] * (H - 1),
    equality=equality,
    options=Options(),
)
ref.initialize_states(linear_interpolation(state_initial, state_goal, H))
ref.initialize_actions([0.11 * np.ones(nu)] * (H - 1))
res = ref.solve()
assert bool(res.solved), "reference swing-up failed"
state_ref, action_ref = ref.get_trajectory(res)
print(f"reference swing-up solved: {int(res.iterations)} iterations")

# ---- 2. weight-parameterized MPC policy ----------------------------------
T = 4  # MPC horizon: every policy evaluation is a full contact-free solve


def stage_cost(x, u, w):
    dx = x - state_goal
    return 0.5 * dx @ (w[:4] * dx) + 0.05 * (u @ u)


mpc = TrajOptSolver(
    [stage_cost] * (T - 1) + [lambda x, u, w: 0.5 * (x - state_goal) @ (w[:4] * (x - state_goal))],
    [acrobot.discrete] * (T - 1),
    [nx] * T,
    [nu] * (T - 1),
    equality=[lambda x, u, w: x - w[4:8], *[None] * (T - 1)],
    parameters=[np.concatenate([np.ones(4), np.zeros(4)])]
    + [np.ones(4)] * (T - 2)
    + [10.0 * np.ones(4)],
    options=Options(
        residual_tolerance=1e-6, equality_tolerance=1e-6, complementarity_tolerance=1e-6
    ),
)


def theta_builder(log_weights, state):
    # tune log-weights: keeps every stage cost PSD, so a gradient step can
    # never hand the MPC an indefinite objective (a raw-weight descent
    # measured here walks w[3] negative and the rollout blows up)
    weights = jnp.exp(log_weights)
    return jnp.concatenate(
        [weights, state] + [weights] * (T - 2) + [10.0 * jnp.ones(4)]
    )


pol = autotuning.make_mpc_policy(
    mpc,
    guess=np.zeros(mpc.num_variables),
    theta_builder=theta_builder,
    action_indices=mpc._action_indices[0],
    num_weights=4,
)

# ---- 3. tune against the reference tail ----------------------------------
t0 = 24  # rollout starts on the reference trajectory near the top
R = 6
xref_tail = jnp.asarray(np.stack(state_ref[t0 : t0 + R]))
uref_tail = jnp.asarray(np.concatenate([np.stack(action_ref[t0 : t0 + R - 1]), np.zeros((1, 1))]))

def sim(x, u):  # implicit-midpoint plant via fixed-point iteration
    y = x + 0.05 * acrobot.continuous(x, u)
    for _ in range(3):
        y = x + 0.05 * acrobot.continuous(0.5 * (x + y), u)
    return y


loss = autotuning.rollout_loss(
    pol.policy,
    sim,
    horizon=R,
    state_cost=np.diag([10.0, 10.0, 1.0, 1.0]),
    action_cost=0.01 * np.eye(1),
    state_reference=xref_tail,
    action_reference=uref_tail,
)
w0 = jnp.zeros(4)  # log-weights: exp(0) = the untuned unit weights
x0 = jnp.asarray(state_ref[t0]) + jnp.array([0.05, -0.05, 0.0, 0.0])
w_tuned, history = autotuning.autotune(loss, w0, x0, max_iterations=5, verbose=True)
print(f"weights {np.exp(np.asarray(w0))} -> {np.round(np.exp(np.asarray(w_tuned)), 3)}")
print(f"rollout loss {history[0]:.5f} -> {history[-1]:.5f}")
assert history[-1] < history[0], "auto-tuning did not reduce the rollout loss"
print("ok")
