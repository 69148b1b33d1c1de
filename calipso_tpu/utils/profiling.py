"""Profiling helpers (SURVEY.md section 5: the reference's only runtime
introspection is console telemetry; this build gets jax.profiler
traces plus the per-iteration metrics already carried in the solve state
and exposed via Options.verbose / Solver.callbacks)."""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard / xprof):

        with profiling.trace("/tmp/calipso-trace"):
            solver.solve(x0)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def iteration_stats(state):
    """Summarize a SolveResult state's diagnostics as plain floats."""
    return {
        "solved": bool(state.solved),
        "failed": bool(state.failed),
        "outer_iterations": int(state.outer_i),
        "total_iterations": int(state.total_i),
        "residual_violation": float(state.residual_violation),
        "optimality_violation": float(state.optimality_violation),
        "equality_violation": float(state.equality_violation),
        "complementarity_violation": float(state.cone_product_violation),
        "step_size": float(state.step_size),
        "lu_fallbacks": int(state.num_fallbacks),
    }


def batch_stats(state):
    """Summarize a batched SolveResult state (leading batch axis): per-lane
    convergence masks plus iteration-load statistics. The `lockstep_waste`
    fraction is the share of lane-iterations spent as masked no-ops while
    the slowest lane finished -- the knob batch-size tuning trades against
    per-chip occupancy."""
    import numpy as np

    iters = np.asarray(state.total_i)
    solved = np.asarray(state.solved)
    mx = int(iters.max(initial=0))
    return {
        "batch": int(iters.shape[0]),
        "solved": int(solved.sum()),
        "failed": int(np.asarray(state.failed).sum()),
        "iterations_mean": float(iters.mean()),
        "iterations_max": mx,
        "lockstep_waste": float(1.0 - iters.mean() / mx) if mx else 0.0,
    }
