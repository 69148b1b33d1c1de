"""calipso_tpu: a conic augmented-Lagrangian interior-point solver in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of CALIPSO.jl
(reference: thowell/CALIPSO.jl). Solves

    minimize_x   c(x; theta)
    subject to   g(x; theta) = 0
                 h(x; theta) in K = R+^q x Q_l1 x ... x Q_lj

with differentiable solutions dw*/dtheta, plus a stagewise
trajectory-optimization front-end (reference README.md:13-57).

Design stance (accelerator-first, not a port):
  * dense, block-structured linear algebra with static shapes instead of the
    reference's sparse Symbolics/QDLDL machinery,
  * jax.grad/jacfwd/hessian instead of symbolic codegen,
  * the whole solve is one XLA program (lax.while_loop nests),
  * whole solves vmap over problem batches and shard over device meshes.
"""

import os as _os

import jax as _jax


def cache_root():
    """Root directory of the persistent caches: $JAX_COMPILATION_CACHE_DIR
    when it is set, else `.jax_cache/` in the checkout. A fixed path
    matters: the directory is part of what makes a cache hit, so a
    directory that moves between runs never hits. JAX's compilation cache
    uses the root itself; the traced-program cache (utils/aot.py) uses
    its `aot/` subdirectory."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
    )


def _on_accelerator():
    """True unless the platform is CPU. XLA:CPU cache entries embed machine
    code for the compiling host's CPU features, and loading one on a host
    whose features differ can crash inside deserialization, so the
    compilation cache stays off on the CPU. An explicit platform setting
    (jax_platforms config or JAX_PLATFORMS) decides without initializing
    a backend; otherwise the initialized default backend decides."""
    plat = _jax.config.jax_platforms or _os.environ.get("JAX_PLATFORMS", "")
    entries = [p for p in plat.lower().split(",") if p]
    if entries:
        return any(p != "cpu" for p in entries)
    return _jax.default_backend() != "cpu"


_cache_decided = False


def _maybe_enable_cache():
    """Turn on JAX's persistent compilation cache once, lazily (called from
    Solver/TrajOptSolver construction, not at import: resolving the
    platform at import time would pin the backend before user code can
    call jax.config.update('jax_platforms', ...)). Solver programs are
    while_loop nests that take long to compile, and MPC/auto-tuning
    workloads compile the same shapes in every process. A directory set
    through JAX_COMPILATION_CACHE_DIR or jax.config is left as it is."""
    global _cache_decided
    if _cache_decided:
        return
    _cache_decided = True
    if _jax.config.jax_compilation_cache_dir is not None:
        return
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR") or not _on_accelerator():
        return
    _jax.config.update("jax_compilation_cache_dir", cache_root())
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


from calipso_tpu.options import Options
from calipso_tpu.ops.cones import ConeLayout
from calipso_tpu.solver.problem import ProblemFunctions, empty_constraint
from calipso_tpu.solver.api import Solver, SolveResult
from calipso_tpu.trajopt.api import (
    TrajOptSolver,
    Cost,
    Dynamics,
    Constraint,
    linear_interpolation,
)
from calipso_tpu.parallel.batch import BatchedSolver, BatchedTrajOptSolver

__all__ = [
    "Options",
    "ConeLayout",
    "ProblemFunctions",
    "empty_constraint",
    "Solver",
    "SolveResult",
    "TrajOptSolver",
    "Cost",
    "Dynamics",
    "Constraint",
    "linear_interpolation",
    "BatchedSolver",
    "BatchedTrajOptSolver",
]

__version__ = "0.1.0"
