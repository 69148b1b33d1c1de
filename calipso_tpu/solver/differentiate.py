"""Implicit differentiation of the solution: dw*/dtheta = -J^-1 dR/dtheta.

Rebuild of the reference post-solve pass (reference
src/solver/differentiate.jl:1-61, residual_jacobian_parameters.jl:1-40).
The reference solves one column per parameter in a Python-style loop
(flagged "#TODO parallelize", differentiate.jl:28); here all parameter
columns go through the factorization as one batched triangular solve and
the expansion formulas are vmapped over columns -- one batched op instead of a loop.

dR/dtheta rows (zero for the slack rows r, s, t):
  variables:      fxt + d/dtheta grad_x(g'y) + d/dtheta grad_x(h'z)
  equality dual:  gt
  cone dual:      ht
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from calipso_tpu.ops import cones
from calipso_tpu.solver import kkt


def solution_sensitivity(fns, layout, opts, state, theta):
    """(total, num_parameters) sensitivity of w = (x, r, s, y, z, t) wrt
    theta, evaluated at the converged state. Returns zeros when the problem
    has no parameters."""
    dims = fns.dims
    n, me, mc, npar = dims.variables, dims.equality, dims.cone, dims.parameters
    if npar == 0:
        return jnp.zeros((dims.total, 0))
    with jax.default_matmul_precision(opts.matmul_precision):
        return _sensitivity(fns, layout, opts, state, theta)


def _sensitivity(fns, layout, opts, state, theta):
    dims = fns.dims
    n, me, mc, npar = dims.variables, dims.equality, dims.cone, dims.parameters

    p = state.p
    x, s, t, y, z = p.x, p.s, p.t, p.y, p.z
    rho = state.rho
    eps_p, eps_d = state.eps_p_used, state.eps_d_used

    # refactorize at the solution with the last-used regularization
    # (reference differentiate.jl:13-20)
    method = opts.linear_solver
    Hxx = fns.lagrangian_hessian_xx(x, theta, y, z, opts.constraint_tensor)
    gx = fns.gx(x, theta)
    hx = fns.hx(x, theta)
    if method == "lu":
        rxt = fns.fxt(x, theta)
        if me > 0:
            rxt = rxt + fns.gty_xt(x, theta, y)
        if mc > 0:
            rxt = rxt + fns.htz_xt(x, theta, z)
        J = kkt.full_matrix(layout, Hxx, gx, hx, s, t, rho, eps_p, eps_d)
        Jt = jnp.concatenate(
            [
                rxt,
                jnp.zeros((me + mc, npar), x.dtype),
                fns.gt(x, theta),
                fns.ht(x, theta),
                jnp.zeros((mc, npar), x.dtype),
            ],
            axis=0,
        )
        return -jnp.linalg.solve(J, Jt)
    structure = getattr(fns, "stage_structure", None)
    mesh, maxis = getattr(opts, "spike_mesh", None), getattr(opts, "spike_axis", None)
    fact = kkt.factorize(
        layout, Hxx, gx, hx, s, t, rho, eps_p, eps_d, method, structure, mesh, maxis
    )

    # dR/dtheta blocks
    rxt = fns.fxt(x, theta)
    if me > 0:
        rxt = rxt + fns.gty_xt(x, theta, y)
    if mc > 0:
        rxt = rxt + fns.htz_xt(x, theta, z)
    gt = fns.gt(x, theta)
    ht = fns.ht(x, theta)

    # condensed RHS per column: slack rows are zero, so the corrections
    # vanish and the symmetric RHS is just [rxt; gt; ht]
    rhs = jnp.concatenate([rxt, gt, ht], axis=0)  # (ns, p)
    d_sym = kkt.solve_sym(
        layout, fact, rhs, n, me, mc, method, structure, mesh, maxis
    )  # batched solves

    dx = d_sym[:n]
    dy = d_sym[n : n + me]
    dz = d_sym[n + me :]

    # expansion with zero slack residuals (reference search_direction.jl
    # formulas with rr = rs = rt = 0)
    e = layout.target(x.dtype)
    v = s - eps_d * e
    w = t + eps_p * v
    dr = dy / (rho + eps_p)

    def per_col(dz_col):
        ds = cones.arrow_solve(layout, w, cones.product(layout, v, dz_col))
        dt = cones.arrow_solve(layout, v, -cones.product(layout, t, ds))
        return ds, dt

    if mc > 0:
        ds, dt = jax.vmap(per_col, in_axes=1, out_axes=1)(dz)
    else:
        ds = jnp.zeros((0, npar), x.dtype)
        dt = jnp.zeros((0, npar), x.dtype)

    return -jnp.concatenate([dx, dr, ds, dy, dz, dt], axis=0)
