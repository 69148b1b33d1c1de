"""Problem abstraction: user callables + JAX autodiff.

Replaces the reference's symbolic codegen layer (reference
src/solver/codegen.jl:1-101, src/solver/methods.jl:1-67): instead of
Symbolics tracing user functions into sparse derivative callbacks, the user
supplies plain JAX-traceable Python callables and every derivative the
AL-IPM needs is a jax.grad / jacfwd / hessian transform, compiled (and
fused) by XLA inside the solve program. Sparsity handling disappears:
problems are dense-per-block with static shapes (the accelerator-friendly choice);
structure exploitation lives at the block level in the trajopt front-end.

Callback inventory mirrored from ProblemMethods (reference methods.jl:1-41):
  objective f, gradient fx, Hessian fxx, mixed fxt
  equality g, Jacobians gx/gt, scalarization (g'y) gradient + Hessians
  cone h, Jacobians hx/ht, scalarization (h'z) gradient + Hessians
"""

from __future__ import annotations

import inspect
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def empty_constraint(x, theta=None):
    """No-op constraint (reference src/trajectory_optimization/
    utilities: empty_constraint). Follows x's dtype so f32 solves stay
    f32 even with x64 enabled."""
    return jnp.zeros((0,), jnp.asarray(x).dtype)


def _normalize(fn: Callable) -> Callable:
    """Accept f(x) or f(x, theta); always call as f(x, theta). Only
    required positional parameters count (defaults like h=0.05 don't)."""
    if fn is empty_constraint:
        return fn
    try:
        sig = inspect.signature(fn)
        nargs = sum(
            1
            for p in sig.parameters.values()
            if p.kind
            in (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
            and p.default is inspect.Parameter.empty
        )
    except (TypeError, ValueError):
        nargs = 2
    if nargs >= 2:
        return fn
    return lambda x, theta, _f=fn: _f(x)


class Dimensions(NamedTuple):
    """Problem dimensions (reference src/solver/dimensions.jl:17-40)."""

    variables: int
    parameters: int
    equality: int
    cone: int

    @property
    def symmetric(self) -> int:
        return self.variables + self.equality + self.cone

    @property
    def total(self) -> int:
        return self.variables + 2 * self.equality + 3 * self.cone


class ProblemFunctions:
    """Dense autodiff oracle for (f, g, h) and every derivative the solver
    evaluates (reference src/solver/evaluate.jl dispatches the same set)."""

    def __init__(self, objective, equality, cone, num_variables, num_parameters=0):
        f = _normalize(objective)
        g = _normalize(equality if equality is not None else empty_constraint)
        h = _normalize(cone if cone is not None else empty_constraint)

        self.f = lambda x, theta: jnp.asarray(f(x, theta)).reshape(())
        self.g = lambda x, theta: jnp.asarray(g(x, theta)).reshape(-1)
        self.h = lambda x, theta: jnp.asarray(h(x, theta)).reshape(-1)

        # shape probe (trace only; no FLOPs)
        x0 = jnp.zeros((num_variables,))
        t0 = jnp.zeros((num_parameters,))
        me = int(jax.eval_shape(self.g, x0, t0).shape[0])
        mc = int(jax.eval_shape(self.h, x0, t0).shape[0])
        self.dims = Dimensions(int(num_variables), int(num_parameters), me, mc)

        # first/second derivatives in x
        self.fx = jax.grad(self.f)
        self.fxx = jax.jacfwd(jax.grad(self.f))
        self.gx = jax.jacfwd(self.g)
        self.hx = jax.jacfwd(self.h)

        # scalarized constraint-dual terms: grad_x(g'y), hess_x(g'y)
        # (reference codegen.jl:48-55 builds the same scalarizations)
        self.gty_x = jax.grad(lambda x, theta, y: self.g(x, theta) @ y)
        self.gty_xx = jax.jacfwd(self.gty_x)
        self.htz_x = jax.grad(lambda x, theta, z: self.h(x, theta) @ z)
        self.htz_xx = jax.jacfwd(self.htz_x)

        # parameter derivatives (used by differentiate!, reference
        # residual_jacobian_parameters.jl:1-40)
        self.fxt = jax.jacfwd(jax.grad(self.f), argnums=1)
        self.gt = jax.jacfwd(self.g, argnums=1)
        self.ht = jax.jacfwd(self.h, argnums=1)
        self.gty_xt = jax.jacfwd(self.gty_x, argnums=1)
        self.htz_xt = jax.jacfwd(self.htz_x, argnums=1)

    def lagrangian_hessian_xx(self, x, theta, y, z, constraint_tensor=True):
        """fxx + sum_i y_i grad^2 g_i + sum_i z_i grad^2 h_i (reference
        residual_jacobian_variables.jl:9-15)."""
        H = self.fxx(x, theta)
        if constraint_tensor:
            if self.dims.equality > 0:
                H = H + self.gty_xx(x, theta, y)
            if self.dims.cone > 0:
                H = H + self.htz_xx(x, theta, z)
        return H
