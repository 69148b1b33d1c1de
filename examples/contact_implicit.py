"""Contact-implicit trajectory optimization examples (reference
examples/contact_implicit/): hopper gait with cross-stage periodicity
through equality_general (riccati low-rank Schur border), and ball-in-cup
with string-length SOCs.

Run:  python examples/contact_implicit.py [hopper|ball|quadruped]
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


def _build(prob, options=Options()):
    kw = {
        k: v
        for k, v in prob.items()
        if k
        not in ("state_guess", "state_initial", "state_goal", "action_guess", "penalty_initial")
    }
    ts = TrajOptSolver(options=options, **kw)
    ts.initialize_states(prob["state_guess"])
    if "action_guess" in prob:
        ts.initialize_actions(prob["action_guess"])
    return ts


def hopper_gait():
    """Planar hopper gait: SOC friction cones, impact complementarity,
    joint limits, gait periodicity + travel coupling first/last stages
    through equality_general -- handled by the structured riccati backend
    as a low-rank border (reference test/examples/hopper_gait.jl)."""
    from calipso_tpu.models import hopper

    ts = _build(hopper.gait_problem(), options=Options(verbose=True, print_frequency=25))
    res = ts.solve()
    states, actions = ts.get_trajectory(res)
    print(f"solved={bool(res.solved)} iters={int(res.iterations)} "
          f"backend={ts.solver.options.linear_solver}")
    print(f"body travel: {states[-1][0] - states[0][0]:.3f} m "
          f"(z range {min(s[1] for s in states):.3f}..{max(s[1] for s in states):.3f})")


def ball_in_cup():
    """Ball-in-cup: swing the ball into the cup window with the string
    length as a second-order-cone constraint (reference
    test/examples/ball_in_cup.jl)."""
    from calipso_tpu.models import ball_in_cup as bic

    ts = _build(bic.problem())
    rng = np.random.default_rng(0)
    ts.initialize_actions(
        [np.concatenate([1e-3 * rng.normal(size=2), 1e-3 * np.ones(1)]) for _ in range(20)]
    )
    res = ts.solve()
    states, _ = ts.get_trajectory(res)
    print(f"solved={bool(res.solved)} iters={int(res.iterations)}")
    d = states[-1][4:6] - states[-1][6:8]
    print(f"final ball-cup distance: {np.linalg.norm(d):.3f} "
          f"(string length {bic.STRING_LENGTH})")


def quadruped_gait():
    """11-DOF planar quadruped gait with travel (reference
    examples/contact_implicit/quadruped_gait.jl)."""
    from calipso_tpu.models import quadruped

    ts = _build(quadruped.gait_problem(horizon=11, travel=0.2))
    res = ts.solve()
    states, _ = ts.get_trajectory(res)
    print(f"solved={bool(res.solved)} iters={int(res.iterations)} "
          f"travel={states[-1][0] - states[0][0]:.3f} m")


def quadruped_gait_v2():
    """Mirrored half-cycle gait with a foot-pinning stance phase
    (reference examples/contact_implicit/quadruped_gait_v2.jl): the
    final state repeats the leg-pair-MIRRORED first state advanced by
    the travel, and feet 1/3 are pinned for the first t_fix stages."""
    from calipso_tpu.models import quadruped
    import numpy as _np

    ts = _build(quadruped.gait_problem_v2(horizon=11, travel=0.2, t_fix=4))
    res = ts.solve()
    assert bool(res.solved)
    states, _ = ts.get_trajectory(res)
    q2_first = states[0][11:22]
    q2_last = states[-1][11:22]
    mirr = _np.asarray(quadruped.mirror_config(q2_first))
    err = _np.abs((q2_last - mirr)[1:]).max()
    print(f"solved={bool(res.solved)} iters={int(res.iterations)} "
          f"travel={q2_last[0] - q2_first[0]:.3f} m mirror_periodicity_err={err:.2e}")


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "hopper"
    {
        "hopper": hopper_gait,
        "ball": ball_in_cup,
        "quadruped": quadruped_gait,
        "quadruped_v2": quadruped_gait_v2,
    }[which]()
