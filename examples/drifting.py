"""Cybertruck drift parking (reference
examples/contact_implicit/drifting.jl): plan a drift into a parking pose
with four contact points, friction-cone forces and contact
complementarity. The reference notes the problem is schedule-sensitive
("may need to run more than once", drifting.jl:125); this script pins the
converging configuration from the repo's test suite (schur backend, 1e-3
contract -- the reference's examples likewise tune per-problem options).

Run:  PYTHONPATH=. python examples/drifting.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# float64 on every platform: the examples run at the reference's f64
# tolerances
jax.config.update("jax_enable_x64", True)

import numpy as np

from calipso_tpu import TrajOptSolver, Options
from calipso_tpu.models import cyberdrift

prob = cyberdrift.drift_problem()
opts = Options(
    residual_tolerance=1e-3,
    optimality_tolerance=1e-3,
    equality_tolerance=1e-3,
    complementarity_tolerance=1e-3,
    slack_tolerance=1e-3,
    penalty_initial=10.0,
    linear_solver="schur",
)
kw = {
    k: v
    for k, v in prob.items()
    if k not in ("state_guess", "state_initial", "state_goal", "action_guess", "penalty_initial")
}
ts = TrajOptSolver(options=opts, **kw)
ts.initialize_states(prob["state_guess"])
rng = np.random.default_rng(1)
ts.initialize_actions(
    [
        np.concatenate([1e-3 * rng.normal(size=2), np.tile([1.0, 0.1, 0.1], 4)])
        for _ in range(14)
    ]
)
res = ts.solve()
assert bool(res.solved), "drift solve failed"
states, actions = ts.get_trajectory(res)
goal = np.asarray(prob["state_goal"])
err = np.abs(states[-1][0:3] - goal[0:3]).max()
print(
    f"drift parked: {int(res.iterations)} iterations, final pose error {err:.4f} "
    f"(x, y, yaw = {np.round(states[-1][0:3], 3)})"
)
assert err < 1e-2
print("ok")
