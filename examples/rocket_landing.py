"""Rocket soft landing with a second-order-cone thrust constraint
(counterpart of reference examples / test/examples/rocket_landing.jl:
T=101, 903 variables, 100 three-dimensional SOCs).

Run:  PYTHONPATH=. python examples/rocket_landing.py
Runs in f64 at the reference's 1e-4 tolerances on any platform.
"""

import sys, os, time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from calipso_tpu import TrajOptSolver, Options
from calipso_tpu.models import rocket

jax.config.update("jax_enable_x64", True)
tol = 1e-4

prob = rocket.landing_problem(horizon=101)
kw = {k: v for k, v in prob.items() if k not in ("state_guess", "state_initial", "state_goal")}
opts = Options(
    residual_tolerance=tol, optimality_tolerance=tol, slack_tolerance=tol,
    equality_tolerance=tol, complementarity_tolerance=tol,
    iterative_refinement_tolerance=1e-10,
    linear_solver="cr",  # parallel-in-time factorization: best single-solve backend
)
ts = TrajOptSolver(options=opts, **kw)
ts.initialize_states(prob["state_guess"])
rng = np.random.default_rng(0)
ts.initialize_actions([1e-3 * rng.normal(size=3) for _ in range(100)])

t0 = time.time()
res = ts.solve()
jax.block_until_ready(res.state.p.x)
print(f"solved={bool(res.solved)} iterations={int(res.iterations)} "
      f"wall={time.time()-t0:.2f}s (includes compile)")

states, actions = ts.get_trajectory(res)
# the thrust stays inside the cone at every stage (reference
# rocket_landing.jl:82 checks the same property)
margins = [float(u[2] - np.linalg.norm(u[:2])) for u in actions]
print(f"final position error: {np.linalg.norm(np.asarray(states[-1])[:3]):.2e}")
print(f"min thrust-cone margin u3 - |u12|: {min(margins):.3e} (> 0)")
assert bool(res.solved) and min(margins) > -1e-6
