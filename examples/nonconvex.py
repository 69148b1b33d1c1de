"""Non-convex NLP examples (reference examples/nonconvex/{wachter,
maratos,complementarity}.jl): three classic hard small problems solved
with verbose output.

Run:  python examples/nonconvex.py            (GPU if available)
      JAX_PLATFORMS=cpu python examples/nonconvex.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# float64 on every platform: the examples run at the reference's f64
# tolerances
jax.config.update("jax_enable_x64", True)
import numpy as np
import jax.numpy as jnp

from calipso_tpu import Solver, Options, empty_constraint


def wachter():
    """Wächter's counterexample: vanilla line-search IPMs stall; the filter
    + slack reset handles it (x* = [1, 0, 0.5])."""
    solver = Solver(
        lambda x: x[0],
        lambda x: jnp.array([x[0] ** 2 - x[1] - 1.0, x[0] - x[2] - 0.5]),
        lambda x: x[1:3],
        3,
        options=Options(verbose=True, print_frequency=5),
    )
    res = solver.solve(jnp.array([-2.0, 3.0, 1.0]))
    assert bool(res.solved)
    np.testing.assert_allclose(np.asarray(res.variables), [1.0, 0.0, 0.5], atol=1e-3)


def maratos():
    """The Maratos effect problem: full steps get rejected by naive merit
    functions near the solution (x* = [1, 0])."""
    solver = Solver(
        lambda x: 2.0 * (x[0] ** 2 + x[1] ** 2 - 1.0) - x[0],
        lambda x: jnp.array([x[0] ** 2 + x[1] ** 2 - 1.0]),
        empty_constraint,
        2,
        options=Options(verbose=True, print_frequency=5),
    )
    res = solver.solve(jnp.array([2.0, 1.0]))
    assert bool(res.solved)
    np.testing.assert_allclose(np.asarray(res.variables), [1.0, 0.0], atol=1e-3)


def complementarity():
    """Knitro's mixed-complementarity example: x >= 0 complementary to
    F(x) >= 0, formulated with slack pairs (reference complementarity.jl)."""

    def cone(x):
        # x[:3] >= 0 and the three complementarity residuals as slacks
        return jnp.concatenate([x[:3], x[3:6]])

    def eq(x):
        f1 = -x[0] - x[1] + x[2] + 2.0
        f2 = x[0] - 2.0 * x[2] + 1.0
        f3 = x[0] + x[1] + 2.0 * x[2] - 6.0
        # slack definitions + complementarity products
        return jnp.array(
            [
                x[3] - f1,
                x[4] - f2,
                x[5] - f3,
                x[0] * x[3] + x[1] * x[4] + x[2] * x[5],
            ]
        )

    solver = Solver(
        lambda x: (x[0] - 1.0) ** 2 + (x[2] - 1.5) ** 2,
        eq,
        cone,
        6,
        options=Options(verbose=True, print_frequency=10),
    )
    res = solver.solve(jnp.ones(6))
    assert bool(res.solved)
    print("complementarity solution:", np.round(np.asarray(res.variables[:3]), 4))


if __name__ == "__main__":
    wachter()
    maratos()
    complementarity()
