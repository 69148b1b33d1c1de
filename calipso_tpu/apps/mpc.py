"""Receding-horizon MPC: warmstarted repeated trajopt solves in a jitted
closed loop.

The reference's MPC workloads (examples/autotuning/cartpole.jl rollouts,
and the ContactImplicitMPC-based examples/contact_implicit/quadruped_mpc.jl)
re-solve a short-horizon trajopt problem every control step, reusing the
previous primal-dual point via `Options.warmstart` (reference
options.jl:57, solve.jl:10-13 — initialization is skipped, the previous
solution is the starting iterate). This module packages that pattern
for one compiled program: the measured state enters through a stage parameter so ONE
compiled solve program serves every control step, the previous primal-dual
`Blocks` pytree is the warmstart carry, and the whole closed loop is a
`lax.scan` — controller and plant both on-device, zero host round-trips.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from calipso_tpu.solver.api import solve_fn


class MPCStep(NamedTuple):
    """Per-control-step telemetry from a rollout."""

    states: jnp.ndarray  # (steps, nx) measured states
    actions: jnp.ndarray  # (steps, nu) applied first-stage actions
    solved: jnp.ndarray  # (steps,) per-step convergence flags
    iterations: jnp.ndarray  # (steps,) inner-iteration counts


def make_mpc_controller(
    trajopt_solver,
    guess,
    theta_builder: Callable,
    *,
    warmstart: bool = True,
):
    """Build a jittable MPC step `(state, warm) -> (action, warm', solved,
    iterations)`.

    trajopt_solver: a constructed `TrajOptSolver` whose stage-0 equality
        pins the state to a parameter (e.g. ``lambda x, u, w: x - w``).
    guess: flat variable guess used for the cold (first) solve.
    theta_builder: maps the measured state to the solver's flat parameter
        vector (stage-major order).
    warmstart: reuse the previous primal-dual point as the starting
        iterate (reference solve.jl:10-13). The first call should pass
        ``warm=None`` (cold start); subsequent calls pass the returned
        carry.
    """
    opts = trajopt_solver.solver.options.replace(warmstart=warmstart)
    run = solve_fn(trajopt_solver.solver.fns, trajopt_solver.solver.layout, opts)
    a_idx = jnp.asarray(np.asarray(trajopt_solver._action_indices[0]))
    guess = jnp.asarray(guess)

    def step(state, warm=None):
        theta = theta_builder(jnp.asarray(state))
        res = run(guess.astype(theta.dtype), theta, warm)
        action = res.state.p.x[a_idx]
        return action, res.state.p, res.state.solved, res.state.total_i

    return step


def mpc_rollout(
    controller,
    simulate: Callable,
    x0,
    num_steps: int,
) -> MPCStep:
    """Closed-loop rollout: cold-start solve at x0, then `lax.scan` over
    warmstarted MPC steps. `simulate(x, u) -> x_next` is the plant (which
    need not match the controller's internal model). Returns per-step
    telemetry; a non-converged step shows up in `solved`, never as an
    exception (no exceptions under jit)."""
    x0 = jnp.asarray(x0)
    u0, warm0, s0, i0 = controller(x0, None)
    x1 = simulate(x0, u0)

    def body(carry, _):
        x, warm = carry
        u, warm2, solved, iters = controller(x, warm)
        x2 = simulate(x, u)
        return (x2, warm2), (x, u, solved, iters)

    (_, _), (xs, us, ss, its) = lax.scan(
        body, (x1, warm0), None, length=num_steps - 1
    )
    return MPCStep(
        states=jnp.concatenate([x0[None], xs]),
        actions=jnp.concatenate([u0[None], us]),
        solved=jnp.concatenate([s0[None], ss]),
        iterations=jnp.concatenate([i0[None], its]),
    )
