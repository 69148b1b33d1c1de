"""Solver options.

Mirrors the reference's `Options` kwdef struct (reference
src/solver/options.jl:6-59) as a frozen, hashable dataclass so it can be a
static argument to `jax.jit`: every field is trace-time constant, so loop
bounds and tolerances bake into the compiled program.

Reference fields that are Julia-implementation artifacts and deliberately
have no counterpart here:
- ``codegen_threads`` / ``codegen_checkbounds`` (options.jl:51-52):
  Symbolics.jl codegen tuning; derivative "codegen" here is jax autodiff
  under jit, always compiled and parallelized by XLA.
- ``update_factorization`` (options.jl:43): QDLDL symbolic-pattern reuse;
  the block-structured factorizations here have static shapes, so every
  factorization is the fast path.
- ``callback_inner`` / ``callback_outer`` (options.jl:55-56): callbacks
  cannot be static jit arguments; install them via ``Solver.callbacks()``
  (solver/api.py) instead.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class Options:
    # norms (p for ||.||_p; 1.0, 2.0 or inf)
    residual_norm: float = 1.0
    constraint_norm: float = 1.0

    # iteration caps (reference options.jl:9-10)
    max_outer_iterations: int = 10
    max_residual_iterations: int = 100

    # line search (reference options.jl:11-13,:44-49)
    scaling_line_search: float = 0.5
    max_residual_line_search: int = 25
    max_cone_line_search: int = 25
    violation_tolerance: float = 1.0e-5
    violation_exponent: float = 1.1
    merit_tolerance: float = 1.0e-5
    merit_exponent: float = 2.3
    armijo_tolerance: float = 1.0e-4
    machine_tolerance: float = 1.0e-16

    # iterative refinement (reference options.jl:14-17)
    iterative_refinement: bool = True
    max_iterative_refinement: int = 10
    min_iterative_refinement: int = 1
    iterative_refinement_tolerance: float = 1.0e-10
    # when iterative refinement DIVERGES (its correction chain amplifies
    # the error -- a factorization with no usable digits), re-solve the
    # step on the full 6-block system with dense LU and take it if
    # measurably better (reference search_direction.jl:22,
    # iterative_refinement.jl:50-53). Off by default, pinned by a round-3
    # f32 trigger sweep (tests/test_inertia.py
    # test_refinement_fallback_default_off_is_pinned):
    # * green suite (wachter/knitro/rosenbrock/pendulum-trajopt, f32):
    #   fallback-on is bit-identical to off -- the trigger never fires;
    # * ill-conditioned f32 QPs (kappa 1e6-3e7) where schur+refinement
    #   stalls short of the contract: a pure full-system LU stalls too
    #   (measured final residual 1.2e-3 condensed vs 4.0e-3 LU), so there
    #   is nothing for the escalation to rescue -- the limit is f32, not
    #   the condensed factorization;
    # * under vmap the lax.cond escalation lowers to a select that pays
    #   the dense (total x total) LU for EVERY lane on EVERY refinement
    #   trip -- a pure throughput tax on the batched flagship workload.
    # Turn on for single ill-conditioned f64 solves where a corrupted
    # condensed factorization is suspected (the rescue case is tested:
    # test_refinement_fallback_rescues_broken_factorization).
    refinement_fallback: bool = False

    # central path / interior point (reference options.jl:18-21,:39)
    central_path_initial: float = 1.0
    central_path_update_tolerance: float = 10.0
    central_path_scaling: float = 0.2
    central_path_exponent: float = 1.5
    min_central_path: float = 1.0e-8

    # augmented Lagrangian (reference options.jl:22-24,:40)
    penalty_initial: float = 1.0
    penalty_scaling: float = 10.0
    dual_initial: float = 0.0
    max_penalty: float = 1.0e8

    # convergence tolerances (reference options.jl:25-29)
    residual_tolerance: float = 1.0e-4
    optimality_tolerance: float = 1.0e-4
    slack_tolerance: float = 1.0e-4
    equality_tolerance: float = 1.0e-4
    complementarity_tolerance: float = 1.0e-4

    # regularization / inertia-correction ladder (reference options.jl:30-38)
    min_regularization: float = 1.0e-20
    primal_regularization_initial: float = 1.0e-7
    dual_regularization_initial: float = 1.0e-7
    max_regularization: float = 1.0e40
    dual_regularization: float = 1.0e-8
    dual_regularization_exponent: float = 0.25
    scaling_regularization_initial: float = 100.0
    scaling_regularization: float = 8.0
    scaling_regularization_last: float = 1.0 / 3.0

    # second derivatives of constraints in the Lagrangian Hessian
    # (reference options.jl:41)
    constraint_tensor: bool = True

    # linear-solver backend:
    #   "auto"    -> "riccati" for trajopt problems with more than ~96
    #                variables (general equality rows ride the low-rank
    #                border), else "schur" (one dense Cholesky of the
    #                (n, n) primal Schur complement is taken to beat the
    #                T-step Riccati scan for small n; the crossover is
    #                not measured on the H100)
    #   "riccati" -> block-tridiagonal Cholesky over stage blocks
    #                (lax.scan Riccati sweep; O(T d^3) per factorization)
    #   "cr"      -> parallel-in-time block cyclic reduction over stages
    #                (O(log T) depth; long-horizon trajopt)
    #   "schur"   -> primal Schur-complement dense Cholesky (the dense
    #                fast path; ldl's rank-1 loop is far slower)
    #   "ldl"     -> dense unpivoted LDL^T of the condensed quasidefinite
    #                system; exact inertia from sign(D) (QDLDL analogue)
    #   "lu"      -> dense LU of the full 6-block system (the reference's
    #                :LU path for hard nonsymmetric cases)
    #   "spike"   -> horizon-sharded block-tridiagonal solve over a device
    #                mesh (ops/spike.py): set spike_mesh (+ spike_axis) to
    #                a jax.sharding.Mesh whose axis divides the horizon
    #                into chunks of >= 2 stages. For single solves whose
    #                horizon outgrows one device.
    linear_solver: str = "auto"
    spike_mesh: object = None  # jax.sharding.Mesh (trace-time static)
    spike_axis: str = "horizon"

    # line-search execution mode. The reference's backtracking loops
    # (solve.jl:193-221 cone search, :252-302 filter search) are serial:
    # each trial evaluates the cone violation / the full (f, g, h). On an
    # accelerator the same semantics run as ONE batched evaluation of every
    # candidate step size 0.5^k followed by a first-accepted select -- no
    # data-dependent loop, so vmapped solves stay out of lockstep stalls
    # and the serial dependency chain per Newton step collapses.
    #   "auto"     -> "parallel" on an accelerator, "serial" on CPU
    #   "serial"   -> reference-shaped masked while_loops
    #   "parallel" -> batched candidate evaluation (identical accept rule)
    line_search_mode: str = "auto"
    # candidates evaluated per batched chunk in "parallel" mode: the
    # chunked loop only continues when no candidate of the current chunk
    # is accepted, so expensive constraint oracles (contact dynamics)
    # are evaluated ~width times instead of max_residual_line_search + 1
    # times per iteration; selection is bit-identical to the serial loop
    parallel_line_search_width: int = 8

    # differentiation (reference options.jl:53)
    differentiate: bool = False

    # warmstart: keep the caller-provided primal-dual point instead of
    # reinitializing slacks/duals (reference options.jl:57, solve.jl:10-13)
    warmstart: bool = False

    # filter capacity; reset every outer iteration so
    # max_residual_iterations + 2 always suffices (reference filter.jl)
    max_filter: int = 102

    # matmul precision for everything traced inside the solve: GPUs may
    # run f32 matmuls in TF32 (about three decimal digits), which wrecks
    # the chained factorizations (riccati sweeps especially) -- "highest"
    # keeps true f32
    matmul_precision: str = "highest"

    # host-side verbose printing via jax.debug.callback (off inside vmap);
    # the iteration table prints every print_frequency inner iterations
    # (reference options.jl:54,:58; print.jl:20-53)
    verbose: bool = False
    print_frequency: int = 1

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)
