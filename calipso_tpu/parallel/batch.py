"""Scenario/batch data parallelism: vmap whole solves, shard over meshes.

The reference is single-process/single-threaded (SURVEY.md section 2.4);
batched and sharded solving is a new capability:
  * vmap: one XLA program runs B independent solves in lockstep; finished
    lanes are masked no-ops inside the while_loops.
  * sharding over a Mesh axis: the batch axis spreads across devices, and
    collectives go over NVLink/NCCL on GPUs (nothing to communicate during
    independent solves; reductions appear in autotuning losses downstream).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from calipso_tpu.options import Options
from calipso_tpu.solver.api import solve_fn, SolveResult
from calipso_tpu.solver.problem import ProblemFunctions
from calipso_tpu.ops.cones import ConeLayout


class BatchedSolver:
    """vmap/shard a whole conic solve over a leading batch axis of
    (x0, theta).

    Example:
        bs = BatchedSolver(objective, equality, cone, n, num_parameters=p)
        results = bs.solve(x0_batch, theta_batch)      # single device
        results = bs.solve(x0_batch, theta_batch, mesh=mesh, axis="batch")
    """

    def __init__(
        self,
        objective,
        equality,
        cone,
        num_variables: int,
        *,
        num_parameters: int = 0,
        nonnegative_indices=None,
        second_order_indices=None,
        options: Options = Options(),
    ):
        self.fns = ProblemFunctions(objective, equality, cone, num_variables, num_parameters)
        self.layout = ConeLayout(self.fns.dims.cone, nonnegative_indices, second_order_indices)
        self.options = options
        run = solve_fn(self.fns, self.layout, options)
        self._batched = jax.jit(jax.vmap(lambda x0, th: run(x0, th)))

    def aot_save(self, path, batch_size, dtype=jnp.float32):
        """Serialize the traced batched solve at this batch size (see
        BatchedTrajOptSolver.aot_save; same contract)."""
        from calipso_tpu.utils import aot

        x0 = jnp.zeros((batch_size, self.fns.dims.variables), dtype)
        th = jnp.zeros((batch_size, self.fns.dims.parameters), dtype)
        with open(path, "wb") as f:
            f.write(aot.export_fn(self._batched, x0, th))
        return path

    def aot_load(self, path):
        """Load a program saved by aot_save (skips tracing)."""
        from calipso_tpu.utils import aot

        with open(path, "rb") as f:
            self._batched = aot.load_fn(f.read())
        return self

    def solve(
        self,
        x0_batch,
        theta_batch=None,
        mesh: Optional[Mesh] = None,
        axis: str = "batch",
    ) -> SolveResult:
        x0_batch = jnp.asarray(x0_batch)
        if theta_batch is None:
            theta_batch = jnp.zeros(
                (x0_batch.shape[0], self.fns.dims.parameters), x0_batch.dtype
            )
        theta_batch = jnp.asarray(theta_batch, x0_batch.dtype)
        if mesh is not None:
            sharding = NamedSharding(mesh, P(axis))
            x0_batch = jax.device_put(x0_batch, sharding)
            theta_batch = jax.device_put(theta_batch, sharding)
        return self._batched(x0_batch, theta_batch)


class BatchedTrajOptSolver:
    """vmap/shard whole trajopt solves over a scenario batch -- the
    flagship workload (one XLA program runs B independent AL-IPM
    solves in lockstep; a mesh spreads the batch over chips with nothing
    to communicate during the solves).

    Built from a configured TrajOptSolver via `ts.batched()`:

        bts = ts.batched()
        res = bts.solve(parameters=theta_batch)                 # one chip
        res = bts.solve(parameters=theta_batch, mesh=mesh)      # sharded
        res = bts.solve(parameters=theta_batch, warm=res.state.p)  # MPC carry

    Scenario variation enters through per-stage `parameters` (the
    reference's per-stage parameter vectors, solver.jl:77) and/or
    per-lane initial guesses."""

    def __init__(self, ts):
        solver = ts.solver
        self._ts = ts
        self.fns, self.layout = solver.fns, solver.layout
        self.options = solver.options
        run = solve_fn(self.fns, self.layout, self.options)
        self._batched = jax.jit(jax.vmap(lambda x0, th: run(x0, th)))
        self._batched_warm = jax.jit(jax.vmap(lambda x0, th, w: run(x0, th, w)))

    def _batch_size(self, parameters, guess):
        for a in (parameters, guess):
            if a is not None and jnp.ndim(a) == 2:
                return a.shape[0]
        raise ValueError(
            "cannot infer batch size: pass a batched `parameters` (B, p) "
            "or a batched `guess` (B, n)"
        )

    # ---- ahead-of-time program cache (utils/aot.py) ----------------------
    # Tracing the batched contact-class program costs minutes of pure
    # Python; these serialize
    # the traced program so a later process skips tracing entirely and
    # goes straight to the (persistently cached) XLA compile.

    def _example_args(self, batch_size, num_parameters=None):
        import numpy as np

        n = int(np.size(self._ts._guess))
        g = jnp.asarray(self._ts._guess)  # natural dtype (f32 by default,
        # f64 under the x64 config) so the exported program matches
        # what solve() will dispatch
        guess_b = jnp.broadcast_to(g, (batch_size, n))
        p = self.fns.dims.parameters if num_parameters is None else num_parameters
        th = jnp.zeros((batch_size, p), g.dtype)
        return guess_b, th

    def aot_save(self, path, batch_size, num_parameters=None):
        """Trace the batched solve at this batch size and serialize the
        program (jax.export / StableHLO) to `path`. Shapes and dtypes
        are fixed at save time (pass num_parameters when solve() will be
        called with a different parameter-row width than the problem's
        declared one); reuse across package-code changes is the caller's
        responsibility (the keyed cache in utils/aot.py hashes the
        package sources instead)."""
        from calipso_tpu.utils import aot

        blob = aot.export_fn(
            self._batched, *self._example_args(batch_size, num_parameters)
        )
        with open(path, "wb") as f:
            f.write(blob)
        return path

    def aot_load(self, path):
        """Replace the batched solve with a program saved by aot_save:
        no tracing; the XLA compile still goes through the persistent
        compilation cache."""
        from calipso_tpu.utils import aot

        with open(path, "rb") as f:
            self._batched = aot.load_fn(f.read())
        return self

    def solve(
        self,
        parameters=None,
        guess=None,
        warm=None,
        mesh: Optional[Mesh] = None,
        axis: str = "batch",
    ) -> SolveResult:
        """Solve B scenarios. `parameters`: (B, p) flat per-stage parameter
        rows (or None for a parameterless problem). `guess`: (B, n) or (n,)
        or None (the TrajOptSolver's initialize_states/actions guess,
        broadcast). `warm`: a batched primal-dual Blocks pytree from a
        previous batched solve (warmstart carry for MPC loops). `mesh`:
        shard the batch axis over devices."""
        if parameters is not None:
            parameters = jnp.asarray(parameters)
        if guess is None:
            g = getattr(self._ts, "_guess", None)
            if g is None:
                raise ValueError(
                    "no initial guess: call initialize_states/actions or pass guess"
                )
            guess = jnp.asarray(g)
        else:
            guess = jnp.asarray(guess)
        B = self._batch_size(parameters, guess)
        dtype = guess.dtype if parameters is None else jnp.result_type(parameters, guess)
        if guess.ndim == 1:
            guess = jnp.broadcast_to(guess, (B,) + guess.shape)
        guess = guess.astype(dtype)
        if parameters is None:
            parameters = jnp.zeros((B, self.fns.dims.parameters), dtype)
        parameters = parameters.astype(dtype)
        if mesh is not None:
            sharding = NamedSharding(mesh, P(axis))
            guess = jax.device_put(guess, sharding)
            parameters = jax.device_put(parameters, sharding)
            if warm is not None:
                warm = jax.tree.map(lambda a: jax.device_put(a, sharding), warm)
        if warm is not None:
            return self._batched_warm(guess, parameters, warm)
        return self._batched(guess, parameters)
