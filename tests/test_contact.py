"""Contact-implicit trajopt tests (reference test/examples/
{ball_in_cup,hopper_gait}.jl): impact complementarity, SOC friction
cones, joint limits, gait periodicity. The hopper uses this repo's own
analytic planar model in place of the reference's RoboDojo wrapper."""

import numpy as np
import pytest

from calipso_tpu import TrajOptSolver, Options
from calipso_tpu.models import ball_in_cup, hopper

from tests.test_solver_nlp import assert_contract


def _build(prob, options=Options()):
    kw = {
        k: v
        for k, v in prob.items()
        if k not in ("state_guess", "state_initial", "state_goal", "action_guess", "penalty_initial")
    }
    ts = TrajOptSolver(options=options, **kw)
    ts.initialize_states(prob["state_guess"])
    if "action_guess" in prob:
        ts.initialize_actions(prob["action_guess"])
    return ts


def test_ball_in_cup():
    prob = ball_in_cup.problem()
    ts = _build(prob)
    rng = np.random.default_rng(0)
    ts.initialize_actions(
        [np.concatenate([1e-3 * rng.normal(size=2), 1e-3 * np.ones(1)]) for _ in range(20)]
    )
    res = ts.solve()
    assert_contract(res)
    states, _ = ts.get_trajectory(res)
    # ball ends inside the cup window and the string never exceeds length
    for x in states:
        d = x[4:6] - x[6:8]
        assert d @ d <= ball_in_cup.STRING_LENGTH**2 + 1e-3


@pytest.mark.heavy
def test_quadruped_drop():
    # reference test/examples/quadruped_drop.jl (own analytic 11-DOF planar
    # quadruped; see models/quadruped.py)
    from calipso_tpu.models import quadruped

    prob = quadruped.drop_problem(horizon=8, drop_height=0.1)
    ts = _build(prob)
    res = ts.solve()
    assert_contract(res)
    states, _ = ts.get_trajectory(res)
    # all four feet end on the ground (complementarity resolved)
    phi = np.asarray(quadruped.signed_distance(np.asarray(states[-1][11:22])))
    assert np.all(phi > -1e-4)
    assert np.all(phi < 1e-2)


@pytest.mark.heavy
def test_quadruped_gait():
    # reference test/examples/quadruped_gait.jl: periodic gait with a
    # travel requirement (the reference keeps this out of its CI runner;
    # here it runs)
    from calipso_tpu.models import quadruped

    prob = quadruped.gait_problem(horizon=11, travel=0.2)
    ts = _build(prob)
    res = ts.solve()
    assert_contract(res)
    states, _ = ts.get_trajectory(res)
    assert states[-1][0] - states[0][0] >= 0.2 - 1e-4


@pytest.mark.heavy
def test_quadruped_gait_v2():
    # reference examples/contact_implicit/quadruped_gait_v2.jl: mirrored
    # half-cycle gait (leg-pair permutation `perm`) with a foot-pinning
    # stance phase; the mirror periodicity + travel ride the same 11-row
    # equality_general border as gait_problem
    from calipso_tpu.models import quadruped

    prob = quadruped.gait_problem_v2(horizon=11, travel=0.2, t_fix=4)
    ts = _build(prob)
    res = ts.solve()
    assert_contract(res)
    states, _ = ts.get_trajectory(res)
    # travel
    assert states[-1][0] - states[0][0] >= 0.2 - 1e-4
    # mirror periodicity: q2_T == P q2_1 (+ travel in x), both configs
    q2_first = np.asarray(states[0][11:22])
    q2_last = np.asarray(states[-1][11:22])
    mirr = np.asarray(quadruped.mirror_config(q2_first))
    assert np.abs((q2_last - mirr)[1:]).max() < 1e-3
    assert abs(q2_last[0] - mirr[0] - 0.2) < 1e-3
    # stance phase: feet 1 and 3 pinned for the first t_fix stages
    q0 = quadruped._nominal_q()
    import jax.numpy as jnp

    for t in range(1, 4):
        q2 = jnp.asarray(states[t][11:22])
        for foot in (1, 3):
            want = np.asarray(quadruped.foot_position(jnp.asarray(q0), foot))
            got = np.asarray(quadruped.foot_position(q2, foot))
            assert np.abs(got - want).max() < 1e-3, (t, foot)


@pytest.mark.slow
def test_box_move():
    # reference test/examples/box_move.jl (own analytic planar box)
    from calipso_tpu.models import box

    prob = box.move_problem(horizon=11)
    ts = _build(prob)
    res = ts.solve()
    assert_contract(res)
    states, _ = ts.get_trajectory(res)
    np.testing.assert_allclose(states[-1][:6], np.asarray(prob["state_goal"]), atol=1e-3)
    # box never penetrates the ground
    for x in states[1:]:
        assert np.min(np.asarray(box.signed_distance(x[3:6]))) > -1e-4


@pytest.mark.heavy
def test_cyberdrift():
    # reference test/examples/cyberdrift.jl; the problem is schedule-
    # sensitive (the reference notes "may need to run more than once") --
    # pinned to a converging configuration
    from calipso_tpu.models import cyberdrift
    from calipso_tpu import Options as Opts

    prob = cyberdrift.drift_problem()
    opts = Opts(
        residual_tolerance=1e-3,
        optimality_tolerance=1e-3,
        equality_tolerance=1e-3,
        complementarity_tolerance=1e-3,
        slack_tolerance=1e-3,
        penalty_initial=10.0,
        linear_solver="schur",  # convergence path pinned with this backend
    )
    ts = _build(prob, options=opts)
    rng = np.random.default_rng(1)
    ts.initialize_actions(
        [
            np.concatenate([1e-3 * rng.normal(size=2), np.tile([1.0, 0.1, 0.1], 4)])
            for _ in range(14)
        ]
    )
    res = ts.solve()
    assert_contract(res, opts)
    states, _ = ts.get_trajectory(res)
    np.testing.assert_allclose(states[-1][0:3], np.asarray(prob["state_goal"][0:3]), atol=1e-2)


@pytest.mark.heavy
def test_state_triggered_rocket():
    # reference examples/state_triggered/rocket_landing.jl (T=51 exactly;
    # the problem is horizon-sensitive)
    from calipso_tpu.models import rocket

    prob = rocket.state_triggered_problem(horizon=51)
    ts = _build(prob, options=Options(penalty_initial=prob["penalty_initial"]))
    res = ts.solve()
    assert_contract(res)
    states, _ = ts.get_trajectory(res)
    # state-trigger: whenever x < a is strictly triggered, altitude >= b
    for x in states:
        if -x[0] + (-0.5) > 1e-4:
            assert x[2] - 3.0 > -1e-4


@pytest.mark.slow
def test_hopper_gait():
    prob = hopper.gait_problem(horizon=21)
    ts = _build(prob)
    res = ts.solve()
    assert_contract(res)
    states, actions = ts.get_trajectory(res)
    # gait travels at least the required distance
    assert states[-1][0] - states[0][0] >= 0.5 - 1e-4
    # friction stays in the cone: |beta2| <= beta1
    for u in actions:
        assert abs(u[7]) <= u[6] + 1e-6
        assert abs(u[9]) <= u[8] + 1e-6
