"""Golden-trajectory regression tests.

The reference pins quadruped_gait against a stored solution
(test/examples/quadruped_gait.jld2, runtests.jl:40-41); here f64 CPU
solutions for the three hardest example families are committed as npz
(tests/golden/, regenerated by the builder when a formulation
deliberately changes) and every future solve must land within tolerance
of them -- locking the actual trajectories against silent drift, not
just the convergence contract.

Contact trajectories are schedule-sensitive: the comparison uses the
physically meaningful coordinates (states along the trajectory) with a
tolerance loose enough for f32/backend noise but tight enough to catch a
changed solution branch.

Golden provenance (round-4 advisor finding): the hopper golden was
regenerated in commit 4094f20 alongside the assembly-numerics change it
guards, so the drift vs the PRE-change golden was measured after the
fact: 122 -> 150 iterations and max |delta variable| = 2.00 (mean
0.056) -- i.e. the reordering moved this contact problem to a DIFFERENT
local solution (both satisfy the 1e-4 acceptance contract; contact
problems are multi-modal). Goldens pin the current branch; regeneration
must always record the measured drift like this note does.
"""

import os

import numpy as np
import pytest

from calipso_tpu import TrajOptSolver, Options

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


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


def _states(ts, z):
    return np.concatenate([np.asarray(z)[idx] for idx in ts._state_indices])


def _iteration_band(r, gold, band=0.15):
    """Iteration-count stability band:
    total inner iterations must land within +-15% of the stored golden
    count, so ulp-level refactors that silently shift the f32/f64
    iteration budget (the 122 -> 150 hopper jump of round 4) fail a test
    instead of surfacing as a throughput regression in a bench."""
    got, ref = int(r.iterations), int(gold["iterations"])
    lo, hi = (1.0 - band) * ref, (1.0 + band) * ref
    assert lo <= got <= hi, (
        f"iteration count {got} outside +-{band:.0%} band of golden {ref} "
        f"([{lo:.0f}, {hi:.0f}]): deliberate formulation changes must "
        f"regenerate the golden (see module docstring)"
    )


def test_golden_rocket101():
    from calipso_tpu.models import rocket
    import jax.numpy as jnp

    gold = np.load(os.path.join(GOLDEN, "rocket101.npz"))
    prob = rocket.landing_problem(horizon=101)
    kw = {
        k: v
        for k, v in prob.items()
        if k not in ("state_guess", "state_initial", "state_goal")
    }
    ts = TrajOptSolver(options=Options(), **kw)
    guess = np.zeros(ts.num_variables)
    for t, idx in enumerate(ts._state_indices):
        guess[idx] = np.asarray(prob["state_guess"][t])
    rng = np.random.default_rng(0)
    for t, idx in enumerate(ts._action_indices):
        guess[idx] = 1e-3 * rng.normal(size=3)
    ts.solver.initialize(jnp.asarray(guess))
    r = ts.solver.solve()
    assert bool(r.solved)
    np.testing.assert_allclose(
        _states(ts, r.variables), _states(ts, gold["variables"]), atol=1e-3
    )
    # iteration-count drift guard (exactly reproducible in f64)
    assert abs(int(r.iterations) - int(gold["iterations"])) <= 2


@pytest.mark.slow
def test_golden_hopper_gait():
    from calipso_tpu.models import hopper

    gold = np.load(os.path.join(GOLDEN, "hopper_gait.npz"))
    ts = _build(hopper.gait_problem())
    r = ts.solve()
    assert bool(r.solved)
    np.testing.assert_allclose(
        _states(ts, r.variables), _states(ts, gold["variables"]), atol=1e-2
    )
    _iteration_band(r, gold)


@pytest.mark.heavy
def test_golden_quadruped_gait():
    from calipso_tpu.models import quadruped

    gold = np.load(os.path.join(GOLDEN, "quadruped_gait.npz"))
    ts = _build(quadruped.gait_problem(horizon=11, travel=0.2))
    r = ts.solve()
    assert bool(r.solved)
    np.testing.assert_allclose(
        _states(ts, r.variables), _states(ts, gold["variables"]), atol=1e-2
    )
    _iteration_band(r, gold)


@pytest.mark.heavy
def test_golden_quadruped_gait_v2():
    # mirror gait pinned against a stored trajectory, like the reference's
    # quadruped_mirror_gait.jld2
    from calipso_tpu.models import quadruped

    gold = np.load(os.path.join(GOLDEN, "quadruped_gait_v2.npz"))
    ts = _build(quadruped.gait_problem_v2(horizon=11, travel=0.2, t_fix=4))
    r = ts.solve()
    assert bool(r.solved)
    np.testing.assert_allclose(
        _states(ts, r.variables), _states(ts, gold["variables"]), atol=1e-2
    )
    _iteration_band(r, gold)
