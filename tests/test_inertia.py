"""Rank-deficiency detection and refinement-failure escalation.

The reference reads zero eigenvalues off QDLDL's sign(D) to trigger IC-2
dual regularization (reference linear_solver.jl:33-44, inertia.jl:41-47),
and re-solves the step on the full system when iterative refinement fails
(reference search_direction.jl:22, iterative_refinement.jl:50-53). The
Cholesky backends (schur/riccati/cr) detect near-rank-deficiency as
pivots collapsed below a dtype-scaled threshold (kkt._tiny_pivots)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from calipso_tpu import Solver, TrajOptSolver, Options, empty_constraint
from calipso_tpu.ops.cones import ConeLayout
from calipso_tpu.solver import kkt
from calipso_tpu.models import pendulum

from tests.test_solver_nlp import assert_contract


def _empty(n):
    return jnp.zeros((0, n)), jnp.zeros((0,)), jnp.zeros((0,))


def test_tiny_pivots_schur():
    """schur: a near-zero curvature direction shows up as a collapsed
    Cholesky pivot; a well-conditioned S reports zero."""
    n = 4
    layout = ConeLayout(0)
    gx, s, t = _empty(n)
    hx = gx

    def zeros_for(scale):
        Hxx = jnp.diag(jnp.array([1.0, 1.0, 1.0, scale]))
        fact = kkt.factorize(layout, Hxx, gx, hx, s, t, 1.0, 0.0, 0.0, "schur")
        return int(kkt.num_zero_eigs(fact, "schur"))

    assert zeros_for(1.0) == 0
    assert zeros_for(1.0e-30) == 1


@pytest.mark.parametrize("method", ["riccati", "cr", "spike"])
def test_tiny_pivots_structured(method):
    """riccati/cr/spike: collapsed stage-block pivots are detected through
    the block factorizations, excluding the padded unit pivots of ragged
    stages (kkt.num_zero_eigs). The final pendulum stage is 2-wide in a
    3-wide block layout (and, for spike, is a chunk separator), so the
    exclusion covers interior and separator padding."""
    horizon = 5 if method != "spike" else 16
    ts = TrajOptSolver(
        [lambda x, u, w: x @ x + u @ u] * (horizon - 1) + [lambda x, u, w: x @ x],
        [pendulum.discrete] * (horizon - 1),
        [2] * horizon,
        [1] * (horizon - 1),
    )
    st = ts.solver.fns.stage_structure
    n = st.num_variables
    layout = ConeLayout(0)
    # near-zero dynamics rows so the equality Gram gx'gx/c_eq stays below
    # the pivot threshold and the collapsed Hxx direction is visible
    gx = 1.0e-13 * jnp.asarray(
        np.random.default_rng(0).normal(size=(2 * (horizon - 1), n))
    )
    hx, s, t = jnp.zeros((0, n)), jnp.zeros((0,)), jnp.zeros((0,))
    if method == "spike":
        from jax.sharding import Mesh

        mesh, axis = Mesh(np.array(jax.devices()), ("horizon",)), "horizon"
    else:
        mesh = axis = None

    def zeros_for(scale_last, scale_all=1.0):
        d = np.full(n, scale_all)
        d[-1] = scale_last * scale_all
        # factorize under jit: the spike backend's shard_map needs a traced
        # context to place its replicated separator factors
        fact = jax.jit(
            lambda H: kkt.factorize(
                layout, H, gx, hx, s, t, 1.0, 0.0, 0.0, method, st, mesh, axis
            )
        )(jnp.diag(jnp.asarray(d)))
        return int(kkt.num_zero_eigs(fact, method, st))

    assert zeros_for(1.0) == 0
    assert zeros_for(1.0e-30) >= 1
    # padding-exclusion check: a healthy system whose real pivots are all
    # enormous pushes the relative tiny-pivot threshold above 1, so
    # unexcluded padded unit pivots would read as spurious rank deficiency
    # (the r2 spike defect, kkt.py num_zero_eigs)
    assert zeros_for(1.0, scale_all=1.0e30) == 0


def test_ic2_dual_regularization_converges():
    """A problem whose Lagrangian Hessian is PSD-singular along a
    constrained direction: IC-2's kappa-scaled eps_d (plus the ladder)
    must still converge on the default backend (reference inertia.jl:41-47
    behavior reproduced through the tiny-pivot signal)."""
    # min x2^2 s.t. x0 - x1 = 0 (duplicated row), x0 + x1 = 2
    # H = diag(0, 0, 2): singular along (1, 1, 0)/(1, -1, 0)
    solver = Solver(
        lambda x: x[2] ** 2,
        lambda x: jnp.array([x[0] - x[1], x[0] - x[1], x[0] + x[1] - 2.0]),
        empty_constraint,
        3,
    )
    res = solver.solve(jnp.array([0.3, -0.2, 1.0]))
    assert_contract(res)
    np.testing.assert_allclose(np.asarray(res.variables), [1.0, 1.0, 0.0], atol=1e-4)


def _wachter(opts):
    solver = Solver(
        lambda x: x[0],
        lambda x: jnp.array([x[0] ** 2 - x[1] - 1.0, x[0] - x[2] - 0.5]),
        lambda x: x[1:3],
        3,
        options=opts,
    )
    return solver.solve(jnp.array([-2.0, 3.0, 1.0]))


def _refine_setup():
    """A random equality-constrained QP KKT system, its healthy schur
    factorization, and the residual to solve against."""
    from calipso_tpu.solver.kkt import Blocks

    rng = np.random.default_rng(3)
    n, me, mc = 6, 3, 0
    layout = ConeLayout(0)
    P = rng.normal(size=(n, n))
    Hxx = jnp.asarray(P.T @ P + np.eye(n))
    gx = jnp.asarray(rng.normal(size=(me, n)))
    hx, s, t = jnp.zeros((0, n)), jnp.zeros((0,)), jnp.zeros((0,))
    rho = jnp.float64(7.0)
    fact = kkt.factorize(layout, Hxx, gx, hx, s, t, rho, 0.0, 0.0, "schur")
    res = Blocks(
        jnp.asarray(rng.normal(size=n)),
        jnp.asarray(rng.normal(size=me)),
        jnp.zeros((0,)),
        jnp.asarray(rng.normal(size=me)),
        jnp.zeros((0,)),
        jnp.zeros((0,)),
    )
    return layout, n, me, mc, Hxx, gx, hx, s, t, rho, fact, res


def _step_error(layout, Hxx, gx, hx, s, t, rho, fact, res, step):
    mv = kkt.matvec(layout, Hxx, gx, hx, s, t, rho, fact.eps_p, fact.eps_d, step)
    return float(max(abs(np.asarray(a - b)).max(initial=0.0) for a, b in zip(res, mv)))


def test_refinement_fallback_rescues_broken_factorization():
    """A factorization with no usable digits (corrupted Cholesky factor):
    refinement diverges, and refine_step must escalate to the full-system
    LU solve (reference search_direction.jl:22) and return an accurate
    step with the fallback counter set."""
    from calipso_tpu.solver.solve import refine_step

    layout, n, me, mc, Hxx, gx, hx, s, t, rho, fact, res = _refine_setup()
    broken = fact._replace(L=fact.L * 1.0e4)
    step0 = kkt.solve_with(layout, broken, res, n, me, mc, "schur")

    opts_on = Options(linear_solver="schur", refinement_fallback=True)
    stp, fired, _trips = refine_step(
        opts_on, layout, None, n, me, mc, step0, res, Hxx, gx, hx, broken, s, t, rho
    )
    assert int(fired) == 1
    assert _step_error(layout, Hxx, gx, hx, s, t, rho, broken, res, stp) < 1e-8

    # without the fallback the guarded-refined step stays garbage
    opts_off = opts_on.replace(refinement_fallback=False)
    stp_off, fired_off, _t2 = refine_step(
        opts_off, layout, None, n, me, mc, step0, res, Hxx, gx, hx, broken, s, t, rho
    )
    assert int(fired_off) == 0
    assert _step_error(layout, Hxx, gx, hx, s, t, rho, broken, res, stp_off) > 1e-2


def test_refinement_fallback_quiet_when_healthy():
    """With a healthy factorization the escalation never fires and the
    refined step is untouched; at the solver level the option is a no-op
    on well-conditioned problems."""
    from calipso_tpu.solver.solve import refine_step

    layout, n, me, mc, Hxx, gx, hx, s, t, rho, fact, res = _refine_setup()
    step0 = kkt.solve_with(layout, fact, res, n, me, mc, "schur")
    opts_on = Options(linear_solver="schur", refinement_fallback=True)
    stp, fired, _trips = refine_step(
        opts_on, layout, None, n, me, mc, step0, res, Hxx, gx, hx, fact, s, t, rho
    )
    assert int(fired) == 0
    assert _step_error(layout, Hxx, gx, hx, s, t, rho, fact, res, stp) < 1e-9

    res_on = _wachter(opts_on)
    assert_contract(res_on, opts_on)
    assert int(res_on.state.num_fallbacks) == 0
    res_off = _wachter(Options(linear_solver="schur"))
    assert int(res_on.iterations) == int(res_off.iterations)
    np.testing.assert_allclose(
        np.asarray(res_on.variables), np.asarray(res_off.variables), atol=0.0
    )


def test_refinement_fallback_default_off_is_pinned():
    """Pins the round-3 measured rationale for refinement_fallback=False
    by default (the reference escalates unconditionally,
    search_direction.jl:22; Options doc carries the numbers):

    1. no rescue to buy: on an f32 ill-conditioned QP (kappa ~ 1e6)
       where schur+refinement stalls short of the 1e-4 contract, a pure
       full-system LU solve stalls too (measured residuals 1.2e-3 vs
       4.0e-3) -- the limit is f32 itself, not the condensed
       factorization, so the escalation's trigger correctly never fires;
    2. cost with nothing bought: under vmap the lax.cond escalation
       lowers to a select that evaluates the dense (total x total) LU for
       EVERY lane on EVERY refinement call.

    Here: (1) the trigger stays quiet on the stalling problem, and the
    default really is off."""
    assert Options().refinement_fallback is False

    n, me = 8, 3
    rng = np.random.default_rng(7)
    Q = rng.normal(size=(n, n))
    d = np.logspace(0, 6, n)
    U = np.linalg.qr(Q)[0]
    P = jnp.asarray(((U * d) @ U.T + ((U * d) @ U.T).T) / 2, jnp.float32)
    A = jnp.asarray(rng.normal(size=(me, n)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(me,)), jnp.float32)
    q = jnp.asarray(rng.normal(size=(n,)), jnp.float32)
    solver = Solver(
        lambda x: 0.5 * x @ (P @ x) + q @ x,
        lambda x: A @ x - b,
        None,
        n,
        options=Options(refinement_fallback=True, max_outer_iterations=3),
    )
    res = solver.solve(jnp.zeros(n, jnp.float32))
    # f32 stalls short of the contract and the conservative divergence
    # trigger never swaps in an LU step (LU measured no better)
    assert int(np.asarray(res.state.num_fallbacks)) == 0


@pytest.mark.gpu
def test_nonpd_lane_is_nan_on_gpu(gpu):
    """Batched Cholesky on the GPU (cuSOLVER) keeps the inertia ladder's
    signal: a non-PD lane comes out non-finite, the others finite, at
    the schur and quadruped factorization shapes."""
    import chip_smoke

    with jax.default_device(gpu):
        assert chip_smoke.nonpd_lane_is_flagged(8192, 1, 32, jnp.float32)
        assert chip_smoke.nonpd_lane_is_flagged(128, 8, 54, jnp.float32)
