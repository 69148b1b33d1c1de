"""User-facing solver API.

Mirrors the reference's construction/solve surface (reference
src/solver/solver.jl:152-173 `Solver(objective, equality, cone,
num_variables)`, solve.jl `solve!`, initialize.jl `initialize!`) around the
functional jitted core. The functional core (`solve_fn`) is exposed for
vmap/pjit composition; the `Solver` class is the ergonomic wrapper.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from calipso_tpu.options import Options
from calipso_tpu.ops.cones import ConeLayout
from calipso_tpu.solver.problem import ProblemFunctions
from calipso_tpu.solver.solve import make_solve, resolve_options, State
from calipso_tpu.solver.kkt import Blocks
from calipso_tpu.solver import differentiate


class SolveResult(NamedTuple):
    state: State
    sensitivity: jnp.ndarray  # (total, num_parameters), zeros if not differentiated

    @property
    def variables(self):
        return self.state.p.x

    @property
    def solution(self) -> Blocks:
        return self.state.p

    @property
    def solved(self):
        return self.state.solved

    @property
    def iterations(self):
        return self.state.total_i


def solve_fn(fns: ProblemFunctions, layout: ConeLayout, opts: Options, callbacks=None):
    """Functional solve closure: (x0, theta, warm) -> SolveResult.
    Pure and shape-static: compose with jax.jit / vmap / shard_map."""
    opts = resolve_options(opts, fns)
    core = make_solve(fns, layout, opts, callbacks)

    def run(x0, theta=None, warm=None) -> SolveResult:
        x0 = jnp.asarray(x0)
        theta_arr = (
            jnp.zeros((fns.dims.parameters,), x0.dtype)
            if theta is None
            else jnp.asarray(theta, x0.dtype)
        )
        state = core(x0, theta_arr, warm)
        if opts.differentiate and fns.dims.parameters > 0:
            sens = differentiate.solution_sensitivity(fns, layout, opts, state, theta_arr)
        else:
            sens = jnp.zeros((fns.dims.total, fns.dims.parameters), x0.dtype)
        return SolveResult(state, sens)

    return run


def _print_banner(dims, opts):
    """Solve banner (reference print.jl:1-18 solver_info; repo identity +
    problem dimensions instead of the reference's ASCII art)."""
    print("-" * 72)
    print("calipso_tpu  conic augmented-Lagrangian interior-point solver (JAX)")
    print(
        f"variables {dims.variables}  equality {dims.equality}  cone {dims.cone}"
        f"  parameters {dims.parameters}"
    )
    print(
        f"linear_solver {opts.linear_solver}  line_search {opts.line_search_mode}"
        f"  differentiate {opts.differentiate}"
    )
    print("-" * 72)


def _print_status(result, dims, opts):
    """Final solve summary (reference print.jl:55-61 solver_status)."""
    st = result.state
    print("-" * 72)
    print(f"solution gradients: {opts.differentiate}")
    print(f"solve status:       {'success' if bool(st.solved) else 'failure'}")
    print(
        f"iterations:         {int(st.total_i)} "
        f"(outer {int(st.outer_i)}, LU fallbacks {int(st.num_fallbacks)})"
    )
    print(
        f"violations:         residual {float(st.residual_violation):.2e}  "
        f"equality {float(st.equality_violation):.2e}  "
        f"comp {float(st.cone_product_violation):.2e}  "
        f"slack {float(st.slack_violation):.2e}"
    )
    if dims.variables < 10:
        import numpy as np

        print(f"solution:           {np.round(np.asarray(result.variables), 3)}")
    print("-" * 72)


class Solver:
    """Conic AL-IPM solver for
        min_x c(x; theta)  s.t.  g(x; theta) = 0,  h(x; theta) in K.

    Example (the Wachter problem, reference test/solver/wachter.jl):
        solver = Solver(lambda x: x[0],
                        lambda x: jnp.array([x[0]**2 - x[1] - 1, x[0] - x[2] - 0.5]),
                        lambda x: x[1:3], 3)
        solver.initialize(jnp.array([-2.0, 3.0, 1.0]))
        result = solver.solve()
    """

    def __init__(
        self,
        objective,
        equality,
        cone,
        num_variables: int,
        *,
        parameters=None,
        num_parameters: Optional[int] = None,
        nonnegative_indices=None,
        second_order_indices=None,
        options: Options = Options(),
        _fns=None,  # pre-built (structured) problem functions
    ):
        import calipso_tpu

        # lazy persistent-compile-cache enablement (safe here: the backend
        # is about to be initialized by the first jit anyway)
        calipso_tpu._maybe_enable_cache()
        if parameters is not None:
            parameters = jnp.asarray(parameters).reshape(-1)
            num_parameters = parameters.shape[0]
        self.parameters = parameters
        npar = int(num_parameters or 0)

        self.fns = _fns if _fns is not None else ProblemFunctions(
            objective, equality, cone, num_variables, npar
        )
        self.layout = ConeLayout(
            self.fns.dims.cone, nonnegative_indices, second_order_indices
        )
        options = resolve_options(options, self.fns)
        self.options = options
        self.dims = self.fns.dims
        self._callbacks = None
        self._run = jax.jit(solve_fn(self.fns, self.layout, options))
        self._guess = None
        self._warm = None

    def callbacks(self, inner=None, outer=None):
        """Install host-side per-step / per-outer-iteration callbacks
        (reference callback_inner/outer)."""
        self._callbacks = (inner, outer)
        self._run = jax.jit(solve_fn(self.fns, self.layout, self.options, self._callbacks))
        return self

    def initialize(self, x0):
        """Set the primal initial guess (reference initialize.jl:9-14)."""
        self._guess = jnp.asarray(x0)
        return self

    def solve(self, x0=None, parameters=None, warm: Optional[Blocks] = None) -> SolveResult:
        if x0 is None:
            x0 = self._guess
        if x0 is None:
            raise ValueError("no initial guess: call initialize(x0) or pass x0")
        theta = parameters if parameters is not None else self.parameters
        if warm is None and self.options.warmstart:
            warm = self._warm
        if self.options.verbose:
            _print_banner(self.dims, self.options)
        try:
            result = self._run(jnp.asarray(x0), theta, warm)
        except jax.errors.JaxRuntimeError as err:
            # some jax builds mis-lower the in-jit row callback for some
            # programs (custom call loses its FFI registration); degrade
            # to banner + summary instead of failing the solve
            if not (self.options.verbose and "callback" in str(err)):
                raise
            import warnings

            warnings.warn(
                "verbose iteration rows disabled (runtime cannot execute "
                f"the in-jit print callback: {str(err)[:120]})"
            )
            quiet = solve_fn(
                self.fns, self.layout, self.options.replace(verbose=False),
                self._callbacks,
            )
            self._run = jax.jit(quiet)
            result = self._run(jnp.asarray(x0), theta, warm)
        if self.options.verbose:
            jax.block_until_ready(result.state.p.x)
            _print_status(result, self.dims, self.options)
        self._warm = result.state.p  # retained for warmstart MPC loops
        return result
