"""Tier-1 assembly-correctness tests on a random QP at a random cone-interior
point (mirrors reference test/solver/problem.jl:3-211): every residual
block, the condensed solve + expansion vs a dense solve of the full 6-block
system, the matrix-free matvec, and iterative-refinement error reduction."""

import numpy as np
import jax.numpy as jnp
import pytest

from calipso_tpu.ops.cones import ConeLayout
from calipso_tpu.solver import kkt
from calipso_tpu.solver.kkt import Blocks
from calipso_tpu.solver.problem import ProblemFunctions

N, ME, MC = 10, 5, 5


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    P = rng.normal(size=(N, N))
    P = P.T @ P
    q = rng.normal(size=N)
    A = rng.normal(size=(ME, N))
    xref = rng.normal(size=N)
    b = A @ xref
    G = rng.normal(size=(MC, N))
    h = G @ xref + rng.uniform(0, 1, MC)

    fns = ProblemFunctions(
        lambda x: x @ jnp.asarray(P) @ x + jnp.asarray(q) @ x,
        lambda x: jnp.asarray(A) @ x - jnp.asarray(b),
        lambda x: jnp.asarray(h) - jnp.asarray(G) @ x,
        N,
    )
    layout = ConeLayout(MC)

    point = Blocks(
        jnp.asarray(rng.normal(size=N)),
        jnp.asarray(rng.uniform(0.1, 1, ME)),
        jnp.asarray(rng.uniform(0.1, 1, MC)),
        jnp.asarray(rng.normal(size=ME)),
        jnp.asarray(rng.normal(size=MC)),
        jnp.asarray(rng.uniform(0.1, 1, MC)),
    )
    kappa, rho = 0.17, 52.0
    lam = jnp.asarray(rng.normal(size=ME))
    eps_p, eps_d = 0.12, 0.21
    consts = dict(P=P, q=q, A=A, b=b, G=G, h=h)
    return fns, layout, point, kappa, rho, lam, eps_p, eps_d, consts


def eval_residual(fns, layout, point, kappa, rho, lam):
    from calipso_tpu.ops import cones as cn

    x, y, z = point.x, point.y, point.z
    theta = jnp.zeros((0,))
    return kkt.residual(
        fns.fx(x, theta),
        fns.gty_x(x, theta, y),
        fns.htz_x(x, theta, z),
        fns.g(x, theta),
        fns.h(x, theta),
        cn.product(layout, point.s, point.t),
        layout.target(x.dtype),
        point,
        kappa,
        rho,
        lam,
    )


def dense_full_jacobian(consts, point, rho, eps_p, eps_d):
    """Full regularized 6-block Jacobian assembled densely from the
    definitions (orthant cones: arrow == diag)."""
    P, A, G = consts["P"], consts["A"], consts["G"]
    s, t = np.asarray(point.s), np.asarray(point.t)
    Hxx = 2 * P  # objective Hessian; constraints are affine
    Ieq, Ic = np.eye(ME), np.eye(MC)
    Z = np.zeros
    rows = [
        [Hxx + eps_p * np.eye(N), Z((N, ME)), Z((N, MC)), A.T, (-G).T, Z((N, MC))],
        [Z((ME, N)), (rho + eps_p) * Ieq, Z((ME, MC)), -Ieq, Z((ME, MC)), Z((ME, MC))],
        [Z((MC, N)), Z((MC, ME)), eps_p * Ic, Z((MC, ME)), -Ic, -Ic],
        [A, -Ieq, Z((ME, MC)), -eps_d * Ieq, Z((ME, MC)), Z((ME, MC))],
        [-G, Z((MC, ME)), -Ic, Z((MC, ME)), -eps_d * Ic, Z((MC, MC))],
        [Z((MC, N)), Z((MC, ME)), np.diag(t), Z((MC, ME)), Z((MC, MC)), np.diag(s) - eps_d * Ic],
    ]
    return np.block(rows)


def test_residual_blocks(setup):
    fns, layout, point, kappa, rho, lam, _, _, c = setup
    res = eval_residual(fns, layout, point, kappa, rho, lam)
    x, r, s, y, z, t = (np.asarray(v) for v in point)
    P, q, A, b, G, h = c["P"], c["q"], c["A"], c["b"], c["G"], c["h"]
    np.testing.assert_allclose(
        np.asarray(res.x), 2 * P @ x + q + A.T @ y + (-G).T @ z, atol=1e-10
    )
    np.testing.assert_allclose(np.asarray(res.r), np.asarray(lam) + rho * r - y, atol=1e-12)
    np.testing.assert_allclose(np.asarray(res.s), -z - t, atol=1e-12)
    np.testing.assert_allclose(np.asarray(res.y), A @ x - b - r, atol=1e-12)
    np.testing.assert_allclose(np.asarray(res.z), h - G @ x - s, atol=1e-12)
    np.testing.assert_allclose(np.asarray(res.t), s * t - kappa, atol=1e-12)


def test_condensed_step_equals_dense_solve(setup):
    fns, layout, point, kappa, rho, lam, eps_p, eps_d, c = setup
    res = eval_residual(fns, layout, point, kappa, rho, lam)
    theta = jnp.zeros((0,))
    Hxx = fns.lagrangian_hessian_xx(point.x, theta, point.y, point.z, True)
    gx, hx = fns.gx(point.x, theta), fns.hx(point.x, theta)

    fact = kkt.factorize(
        layout, Hxx, gx, hx, point.s, point.t, rho, jnp.float64(eps_p), jnp.float64(eps_d)
    )
    step = kkt.solve_with(layout, fact, res, N, ME, MC)

    J = dense_full_jacobian(c, point, rho, eps_p, eps_d)
    want = np.linalg.solve(J, np.asarray(res.all))
    np.testing.assert_allclose(np.asarray(step.all), want, atol=1e-8)


def test_matvec_matches_dense(setup):
    fns, layout, point, kappa, rho, lam, eps_p, eps_d, c = setup
    rng = np.random.default_rng(11)
    theta = jnp.zeros((0,))
    Hxx = fns.lagrangian_hessian_xx(point.x, theta, point.y, point.z, True)
    gx, hx = fns.gx(point.x, theta), fns.hx(point.x, theta)
    vec = rng.normal(size=N + 2 * ME + 3 * MC)
    d = Blocks(
        jnp.asarray(vec[:N]),
        jnp.asarray(vec[N : N + ME]),
        jnp.asarray(vec[N + ME : N + ME + MC]),
        jnp.asarray(vec[N + ME + MC : N + 2 * ME + MC]),
        jnp.asarray(vec[N + 2 * ME + MC : N + 2 * ME + 2 * MC]),
        jnp.asarray(vec[N + 2 * ME + 2 * MC :]),
    )
    out = kkt.matvec(layout, Hxx, gx, hx, point.s, point.t, rho, eps_p, eps_d, d)
    J = dense_full_jacobian(c, point, rho, eps_p, eps_d)
    np.testing.assert_allclose(np.asarray(out.all), J @ vec, atol=1e-9)


def test_refinement_reduces_error_f32(setup):
    """Iterative refinement against the exact 6-block operator shrinks the
    f32 factorization/condensation error monotonically below tolerance
    (reference problem.jl:206-211, iterative_refinement.jl:1-53). f32 on
    the accelerator is the case the mechanism exists for."""
    fns, layout, point, kappa, rho, lam, eps_p, eps_d, c = setup
    pt = Blocks(*(v.astype(jnp.float32) for v in point))
    res64 = eval_residual(fns, layout, point, kappa, rho, lam)
    res = Blocks(*(v.astype(jnp.float32) for v in res64))
    theta = jnp.zeros((0,), jnp.float32)
    Hxx = fns.lagrangian_hessian_xx(pt.x, theta, pt.y, pt.z, True)
    gx, hx = fns.gx(pt.x, theta), fns.hx(pt.x, theta)
    f32 = jnp.float32
    fact = kkt.factorize(
        layout, Hxx, gx, hx, pt.s, pt.t, f32(rho), f32(eps_p), f32(eps_d)
    )
    step = kkt.solve_with(layout, fact, res, N, ME, MC)

    def err_norm(stp):
        mv = kkt.matvec(layout, Hxx, gx, hx, pt.s, pt.t, f32(rho), f32(eps_p), f32(eps_d), stp)
        return float(jnp.max(jnp.abs(res.all - mv.all))), mv

    e0, mv = err_norm(step)
    errs = [e0]
    for _ in range(3):
        err = Blocks(*(a - b for a, b in zip(res, mv)))
        corr = kkt.solve_with(layout, fact, err, N, ME, MC)
        step = Blocks(*(a + b for a, b in zip(step, corr)))
        e, mv = err_norm(step)
        errs.append(e)
    assert errs[-1] < 1e-5, errs
    assert errs[-1] < errs[0], errs


def test_soc_condensed_step(setup):
    """Same condensation check with a mixed orthant + SOC layout."""
    rng = np.random.default_rng(12)
    mc = 5
    layout = ConeLayout(mc, nonnegative_indices=[0, 1], second_order_indices=[[2, 3, 4]])
    G = rng.normal(size=(mc, N))
    h = rng.normal(size=mc)
    P = rng.normal(size=(N, N))
    P = P.T @ P
    q = rng.normal(size=N)
    fns = ProblemFunctions(
        lambda x: x @ jnp.asarray(P) @ x + jnp.asarray(q) @ x,
        lambda x: jnp.zeros((0,)),
        lambda x: jnp.asarray(h) - jnp.asarray(G) @ x,
        N,
    )
    s = np.array([0.8, 1.2, 2.0, 0.3, -0.2])
    t = np.array([0.5, 0.9, 1.5, 0.1, 0.4])
    point = Blocks(
        jnp.asarray(rng.normal(size=N)),
        jnp.zeros((0,)),
        jnp.asarray(s),
        jnp.zeros((0,)),
        jnp.asarray(rng.normal(size=mc)),
        jnp.asarray(t),
    )
    kappa, rho, eps_p, eps_d = 0.3, 10.0, 0.05, 0.02
    res = eval_residual(fns, layout, point, kappa, rho, jnp.zeros((0,)))
    theta = jnp.zeros((0,))
    Hxx = fns.lagrangian_hessian_xx(point.x, theta, point.y, point.z, True)
    gx, hx = fns.gx(point.x, theta), fns.hx(point.x, theta)
    fact = kkt.factorize(
        layout, Hxx, gx, hx, point.s, point.t, rho, jnp.float64(eps_p), jnp.float64(eps_d)
    )
    step = kkt.solve_with(layout, fact, res, N, 0, mc)

    # dense reference with arrow blocks
    def arrow(u):
        n = len(u)
        Ar = u[0] * np.eye(n)
        Ar[0, :] = u
        Ar[:, 0] = u
        return Ar

    Cs = np.zeros((mc, mc))
    Ct = np.zeros((mc, mc))
    for idx in ([0], [1], [2, 3, 4]):
        Cs[np.ix_(idx, idx)] = arrow(t[idx])
        Ct[np.ix_(idx, idx)] = arrow(s[idx]) - eps_d * np.eye(len(idx))
    Ic = np.eye(mc)
    Z = np.zeros
    J = np.block(
        [
            [2 * P + eps_p * np.eye(N), Z((N, mc)), (-G).T, Z((N, mc))],
            [Z((mc, N)), eps_p * Ic, -Ic, -Ic],
            [-G, -Ic, -eps_d * Ic, Z((mc, mc))],
            [Z((mc, N)), Cs, Z((mc, mc)), Ct],
        ]
    )
    rhs = np.concatenate([np.asarray(res.x), np.asarray(res.s), np.asarray(res.z), np.asarray(res.t)])
    want = np.linalg.solve(J, rhs)

    # the SOC cone block is mildly nonsymmetric; the condensed solve is an
    # approximation that iterative refinement against the exact 6-block
    # operator drives to the true solution (reference
    # iterative_refinement.jl serves the same role for QDLDL's one-triangle
    # treatment)
    for _ in range(10):
        mv = kkt.matvec(layout, Hxx, gx, hx, point.s, point.t, rho, eps_p, eps_d, step)
        err = Blocks(*(a - b for a, b in zip(res, mv)))
        corr = kkt.solve_with(layout, fact, err, N, 0, mc)
        step = Blocks(*(a + b for a, b in zip(step, corr)))

    got = np.concatenate(
        [np.asarray(step.x), np.asarray(step.s), np.asarray(step.z), np.asarray(step.t)]
    )
    np.testing.assert_allclose(got, want, atol=1e-7)
