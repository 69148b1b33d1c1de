"""Batched + sharded solving: vmap over scenarios and shard_map over the
8-device virtual CPU mesh (a new capability; the reference is
single-process, SURVEY.md section 2.4)."""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from calipso_tpu import BatchedSolver


def _make_batched():
    # friction-cone family parameterized by (v, mu*gamma)
    return BatchedSolver(
        lambda x, th: th[:3] @ x,
        lambda x, th: jnp.array([x[0] - th[3]]),
        lambda x, th: x,
        3,
        num_parameters=4,
        nonnegative_indices=[],
        second_order_indices=[[0, 1, 2]],
    )


def _scenarios(B, rng):
    thetas = np.zeros((B, 4))
    thetas[:, 1] = rng.uniform(0.1, 10.0, B)
    thetas[:, 2] = rng.uniform(0.1, 10.0, B)
    thetas[:, 3] = rng.uniform(0.1, 1.0, B)
    x0 = rng.normal(size=(B, 3))
    return jnp.asarray(x0), jnp.asarray(thetas)


def test_vmap_batch():
    bs = _make_batched()
    rng = np.random.default_rng(0)
    x0, th = _scenarios(16, rng)
    res = bs.solve(x0, th)
    assert bool(jnp.all(res.state.solved))
    x = np.asarray(res.state.p.x)
    # friction force opposes velocity, magnitude mu*gamma
    for i in range(16):
        v = np.asarray(th[i, 1:3])
        b = x[i, 1:3]
        assert np.max(np.abs(v / np.linalg.norm(v) + b / np.linalg.norm(b))) < 1e-3
        assert abs(np.linalg.norm(b) - float(th[i, 3])) < 1e-3


def _swingup_trajopt(**opt_kw):
    from calipso_tpu import TrajOptSolver, Options
    from calipso_tpu.models import pendulum

    prob = pendulum.swingup_problem(horizon=11, parametric_initial_state=True)
    kw = {
        k: v
        for k, v in prob.items()
        if k not in ("state_guess", "state_initial", "state_goal")
    }
    # pin riccati: these tests exercise the structured backend under
    # vmap/sharding ('auto' resolves small-n trajopt to schur below the
    # n<=96 crossover, solve.py resolve_options)
    ts = TrajOptSolver(options=Options(linear_solver="riccati", **opt_kw), **kw)
    assert ts.solver.options.linear_solver == "riccati"
    xg = np.array([np.pi, 0.0])
    ts.initialize_states([xg * t / 10 for t in range(11)])
    return ts


def test_sharded_trajopt_riccati():
    """vmap + mesh-sharded trajopt solves through the riccati backend via
    the public batched surface (the bench workload shape, on the 8-device
    CPU mesh)."""
    ts = _swingup_trajopt()
    bts = ts.batched()
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(0.2 * rng.normal(size=(16, 2)))
    mesh = Mesh(np.array(jax.devices()), axis_names=("batch",))
    res = bts.solve(parameters=x0s, mesh=mesh)
    assert bool(jnp.all(res.state.solved))
    res_ref = bts.solve(parameters=x0s)
    np.testing.assert_allclose(
        np.asarray(res.state.p.x), np.asarray(res_ref.state.p.x), atol=1e-10
    )


def test_batched_trajopt_warm_carry():
    """MPC-style warmstart carry through the public batched surface: the
    batched primal-dual point from a previous solve feeds the next one
    (per-lane guesses + warm Blocks), and the re-solve reconverges to the
    same solutions. (Iteration counts are NOT asserted monotone: a warm
    point still walks the fresh kappa=1 central path, reference
    initialize.jl semantics.)"""
    ts = _swingup_trajopt(warmstart=True)
    bts = ts.batched()
    rng = np.random.default_rng(2)
    x0s = jnp.asarray(0.2 * rng.normal(size=(8, 2)))
    res = bts.solve(parameters=x0s)
    assert bool(jnp.all(res.state.solved))
    # per-lane guesses: reuse each lane's solution as its own guess
    res2 = bts.solve(parameters=x0s, guess=res.state.p.x, warm=res.state.p)
    assert bool(jnp.all(res2.state.solved))
    np.testing.assert_allclose(
        np.asarray(res2.state.p.x), np.asarray(res.state.p.x), atol=1e-3
    )


def test_sharded_batch():
    devs = jax.devices()
    assert len(devs) == 8, f"expected 8 virtual devices, got {len(devs)}"
    mesh = Mesh(np.array(devs), axis_names=("batch",))
    bs = _make_batched()
    rng = np.random.default_rng(1)
    x0, th = _scenarios(16, rng)
    res = bs.solve(x0, th, mesh=mesh, axis="batch")
    assert bool(jnp.all(res.state.solved))

    # solutions match the unsharded run
    res_ref = bs.solve(x0, th)
    np.testing.assert_allclose(
        np.asarray(res.state.p.x), np.asarray(res_ref.state.p.x), atol=1e-10
    )
