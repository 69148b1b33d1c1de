"""The AL-IPM solve loop as one XLA program.

Functional rebuild of the reference main loop (reference
src/solver/solve.jl:8-377): outer loop updates the central path kappa, the
fraction-to-the-boundary tau, and the augmented-Lagrangian (lambda, rho);
the inner loop takes inertia-corrected Newton steps on the 6-block KKT
residual, globalized by a fraction-to-the-boundary cone search plus an
Ipopt-style filter line search.

Differences from the reference:
  * the whole solve is a nest of lax.while_loops -- no Python control flow
    touches traced values, so solves jit, vmap and shard;
  * failures (cone line-search overflow solve.jl:210, inertia overflow
    inertia.jl:72) are status flags in the carried state, not exceptions;
  * all bounded data-dependent loops (backtracking, inertia ladder,
    refinement) are masked while_loops so batched lanes stay in lockstep.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from calipso_tpu.ops import cones
from calipso_tpu.solver import kkt
from calipso_tpu.solver.kkt import Blocks
from calipso_tpu.utils.norms import norm_p, inf_norm, one_norm

BIG = 1.0e8  # empty-filter sentinel (reference filter.jl:8-13)


def resolve_options(opts, fns):
    """Resolve linear_solver='auto': riccati for large trajopt problems
    (general equality rows ride the low-rank border), dense Schur
    otherwise. Small trajopt problems also take the dense path: one
    batched Cholesky of the (n, n) primal Schur complement is taken to
    beat the T-step Riccati scan up to n = 96 (a crossover not yet
    measured on the H100)."""
    if opts.line_search_mode == "auto":
        opts = opts.replace(
            line_search_mode="serial" if jax.default_backend() == "cpu" else "parallel"
        )
    if opts.linear_solver != "auto":
        return opts
    structure = getattr(fns, "stage_structure", None)
    return opts.replace(
        linear_solver=(
            "riccati" if structure is not None and fns.dims.variables > 96 else "schur"
        )
    )


class State(NamedTuple):
    p: Blocks  # current primal-dual iterate (x, r, s, y, z, t)
    kappa: jnp.ndarray  # central path
    tau: jnp.ndarray  # fraction to boundary
    rho: jnp.ndarray  # AL penalty
    lam: jnp.ndarray  # AL dual estimate (m_e,)
    eps_p_last: jnp.ndarray  # regularization warm start (inertia.jl:76)
    eps_p_used: jnp.ndarray  # regularization of the last factorization
    eps_d_used: jnp.ndarray
    filt: jnp.ndarray  # (F, 2) filter pairs (violation, merit)
    nfilt: jnp.ndarray  # filter count
    solved: jnp.ndarray
    failed: jnp.ndarray
    inner_done: jnp.ndarray
    outer_i: jnp.ndarray
    inner_i: jnp.ndarray
    total_i: jnp.ndarray
    # diagnostics of the last evaluated point
    residual_violation: jnp.ndarray
    optimality_violation: jnp.ndarray
    slack_violation: jnp.ndarray
    equality_violation: jnp.ndarray
    cone_product_violation: jnp.ndarray
    step_size: jnp.ndarray
    # steps that escalated to the full-system LU after refinement failure
    # (reference search_direction.jl:22)
    num_fallbacks: jnp.ndarray
    # cost-accounting counters (round 5): total inertia-ladder
    # re-factorizations, refinement correction trips, and line-search
    # chunk evaluations across the solve -- the per-iteration
    # multiplicities of a per-iteration time budget. (No
    # default values: a jnp default at class-definition time would
    # initialize the backend at import, breaking the documented
    # set-platform-before-first-use CPU recipe.)
    num_ladder: jnp.ndarray
    num_refine: jnp.ndarray
    num_ls_chunks: jnp.ndarray


# ---- filter (reference filter.jl:43-89) -------------------------------------


def filter_check(cv, merit, filt):
    """Acceptable to the filter iff for every pair: cv < f1 or merit < f2."""
    return jnp.all((cv < filt[:, 0]) | (merit < filt[:, 1]))


def filter_augment(filt, nfilt, cv, merit):
    """Add (cv, merit) with dominance pruning. Dominated old entries are
    overwritten with the vacuous sentinel instead of compacted (same
    semantics as the reference's compaction, jit-friendly)."""
    passes = filter_check(cv, merit, filt)
    dominated = (filt[:, 0] >= cv) & (filt[:, 1] >= merit)
    pruned = jnp.where(dominated[:, None], jnp.full_like(filt, BIG), filt)
    idx = jnp.minimum(nfilt, filt.shape[0] - 1)
    added = pruned.at[idx].set(jnp.stack([cv, merit]))
    return (
        jnp.where(passes, added, filt),
        jnp.where(passes, nfilt + 1, nfilt),
    )


# ---- line-search predicates (reference line_search.jl:2-18) -----------------


def switching_condition(step_size, dgrad, merit_exp, violation, violation_exp):
    return (dgrad < 0.0) & (
        step_size * (-dgrad) ** merit_exp > violation**violation_exp
    )


def armijo(merit, merit_cand, dgrad, step_size, tol, mach_tol):
    return merit_cand - merit - 10.0 * mach_tol * jnp.abs(merit) <= tol * step_size * dgrad


def sufficient_progress(v, v_cand, m, m_cand, v_tol, m_tol, mach_tol):
    return (v_cand - 10.0 * mach_tol * jnp.abs(v) <= (1.0 - v_tol) * v) | (
        m_cand - 10.0 * mach_tol * jnp.abs(m) <= m - m_tol * v
    )


# ---- iterative refinement (reference iterative_refinement.jl:1-53) ----------


def refine_step(
    opts, layout, structure, n, me, mc, step, res, Hxx, gx, hx, fact, s, t, rho,
    solve_fn=None, matvec_fn=None,
):
    """Iteratively refine a search direction on the exact (matrix-free)
    6-block operator, with optional escalation to a full-system LU re-solve
    on catastrophic refinement failure (reference iterative_refinement.jl
    + search_direction.jl:22). Returns (step, fell_back). solve_fn /
    matvec_fn are optional jit-deduped closures (see make_solve's
    trace-dedup wrappers); the kkt defaults are used when absent."""
    if matvec_fn is None:
        matvec_fn = lambda Hxx_, d: kkt.matvec(
            layout, Hxx_, gx, hx, s, t, rho, fact.eps_p, fact.eps_d, d
        )
    if solve_fn is None:
        solve_fn = lambda fact_, err: kkt.solve_with(
            layout, fact_, err, n, me, mc, opts.linear_solver, structure,
            getattr(opts, "spike_mesh", None), getattr(opts, "spike_axis", None),
        )

    def err_of(stp):
        mv = matvec_fn(Hxx, stp)
        return Blocks(*(a - b for a, b in zip(res, mv)))

    err0 = err_of(step)
    en0 = inf_norm(err0.all)

    def cond(c):
        _, _, en, i, done = c
        return (~done) & (i <= opts.max_iterative_refinement)

    def body(c):
        stp, err, en, i, _ = c
        done_now = (en <= opts.iterative_refinement_tolerance) & (
            i >= opts.min_iterative_refinement
        )
        corr = solve_fn(fact, err)
        stp2 = Blocks(*(jnp.where(done_now, a, a + b) for a, b in zip(stp, corr)))
        err2 = err_of(stp2)
        en2 = jnp.where(done_now, en, inf_norm(err2.all))
        err2 = Blocks(*(jnp.where(done_now, a, b) for a, b in zip(err, err2)))
        return stp2, err2, en2, i + (~done_now).astype(i.dtype), done_now

    stp_f, _, en_f, trips, _ = lax.while_loop(
        cond, body, (step, err0, en0, jnp.zeros((), jnp.int32), jnp.asarray(False))
    )
    # guard: never return a step worse than the unrefined one
    ok = en_f <= jnp.maximum(en0, opts.iterative_refinement_tolerance)
    best = Blocks(*(jnp.where(ok, a, b) for a, b in zip(stp_f, step)))
    if not opts.refinement_fallback:
        return best, jnp.zeros((), jnp.int32), trips
    # failure escalation (reference search_direction.jl:22): re-solve the
    # step on the full nonsymmetric 6-block system with dense LU, gated on
    # the refined step solving fewer than ~2 digits of the system relative
    # to the residual scale -- a factorization with no usable digits.
    # Tighter triggers (100*eps absolute, or sqrt(eps) relative) fire on
    # the ordinary roundoff plateau of ill-scaled problems, where swapping
    # in full-LU steps destabilizes the filter line search (measured: f32
    # solves that converge without the fallback stall with it; see
    # Options.refinement_fallback).
    en_best = jnp.minimum(en_f, en0)
    failed = en_best > 1.0e-2 * inf_norm(res.all)

    def lu_fallback(_):
        lu_step = kkt.lu_solve_full(
            layout, Hxx, gx, hx, s, t, rho, fact.eps_p, fact.eps_d, res
        )
        en_lu = inf_norm(err_of(lu_step).all)
        # swap only when the LU step is measurably better: an
        # unconditionally-taken fallback step can be worse than the
        # refined condensed one
        better = en_lu < 0.5 * en_best
        stp = Blocks(*(jnp.where(better, a, b) for a, b in zip(lu_step, best)))
        return stp, better.astype(jnp.int32)

    stp, fb = lax.cond(
        failed, lu_fallback, lambda _: (best, jnp.zeros((), jnp.int32)), None
    )
    return stp, fb, trips


def _row_printer(j, i, r, o, sl, e, c, k, p, a, ep, ed):
    """Host-side iteration row (reference print.jl:20-53 format)."""
    print(
        f"outer {int(j)} inner {int(i)} | res {float(r):.2e} opt {float(o):.2e} "
        f"slack {float(sl):.2e} eq {float(e):.2e} comp {float(c):.2e} | "
        f"kappa {float(k):.1e} rho {float(p):.1e} alpha {float(a):.1e} "
        f"ep {float(ep):.1e} ed {float(ed):.1e}"
    )


# ---- solver construction ----------------------------------------------------


def make_solve(fns, layout, opts, callbacks=None):
    """Build the jittable solve(x0, theta[, warm]) closure for a fixed
    problem (fns/layout/opts are trace-time static). callbacks is an
    optional (inner, outer) pair of host functions receiving a diagnostics
    dict after each accepted step / outer update (reference
    callback_inner/outer, solver.jl:183-193)."""
    cb_inner, cb_outer = callbacks if callbacks is not None else (None, None)
    dims = fns.dims
    n, me, mc, npar = dims.variables, dims.equality, dims.cone, dims.parameters
    ns, ntot = dims.symmetric, dims.total
    structure = getattr(fns, "stage_structure", None)
    opts = resolve_options(opts, fns)
    if opts.linear_solver in ("riccati", "cr", "spike"):
        if structure is None:
            raise ValueError(
                f"linear_solver={opts.linear_solver!r} requires a trajopt problem (stage structure)"
            )
    if opts.linear_solver == "spike":
        if opts.spike_mesh is None:
            raise ValueError(
                "linear_solver='spike' needs Options.spike_mesh (a jax.sharding.Mesh "
                "with axis Options.spike_axis over which the horizon shards)"
            )
        T, P = structure.horizon, opts.spike_mesh.shape[opts.spike_axis]
        if T % P != 0 or T // P < 2:
            raise ValueError(
                f"spike: horizon {T} must split into {P} chunks of >= 2 stages"
            )
    spike_mesh, spike_axis = opts.spike_mesh, opts.spike_axis
    # ---- trace-dedup wrappers (round 5) -------------------------------
    # The factorization / condensed solve / refinement matvec are each
    # traced at MULTIPLE call sites (inertia ladder x2, main step +
    # refinement trips, error operator), and each inline copy of the
    # riccati/cone pipeline costs tens of thousands of jaxpr equations:
    # jit-wrapping them makes every site one cached pjit call, which cut
    # the d=54 contact program's trace+batching wall from ~407 s to
    # ~30 s on the builder box (XLA inlines the calls back during
    # optimization -- compiled code unchanged). The spike backend stays
    # unwrapped: its solves run shard_map collectives that must stay in
    # the caller's mesh context.
    _dedup = opts.linear_solver != "spike"
    _fact_method = "schur" if opts.linear_solver == "lu" else opts.linear_solver

    def _factorize_raw(Hxx, gx, hx, s, t, rho, e_p, e_d):
        return kkt.factorize(
            layout, Hxx, gx, hx, s, t, rho, e_p, e_d, _fact_method, structure,
            spike_mesh, spike_axis,
        )

    def _solve_with_raw(fact, res):
        return kkt.solve_with(
            layout, fact, res, n, me, mc, opts.linear_solver, structure,
            spike_mesh, spike_axis,
        )

    def _matvec_raw(Hxx, gx, hx, s, t, rho, e_p, e_d, d):
        return kkt.matvec(layout, Hxx, gx, hx, s, t, rho, e_p, e_d, d)

    if _dedup:
        _factorize_j = jax.jit(_factorize_raw)
        _solve_with_j = jax.jit(_solve_with_raw)
        _matvec_j = jax.jit(_matvec_raw)
    else:
        _factorize_j, _solve_with_j, _matvec_j = (
            _factorize_raw, _solve_with_raw, _matvec_raw,
        )
    # structured backends consume the Lagrangian Hessian directly in
    # stage-block tridiagonal form (kkt.BandHessian): no dense (n, n)
    # Hessian is ever materialized -- O(T d^2) memory per lane and no
    # elementwise scatter assembly
    use_band_hessian = (
        opts.linear_solver in ("riccati", "cr", "spike")
        and structure is not None
        and getattr(fns, "_block_maps", None) is not None
        and fns._block_maps() is not None
    )

    def merit_value(f, r, barrier_val, kappa, lam, rho):
        """AL + barrier merit M = f + lam'r + rho/2 |r|^2 - kappa*Phi
        (reference merit.jl:2-15)."""
        m = f - kappa * barrier_val
        if me > 0:
            m = m + lam @ r + 0.5 * rho * (r @ r)
        return m

    def constraint_violation(g, r, h, s, p_norm):
        """theta = |(g - r; h - s)|_p / (m_e + m_c) (reference
        constraint_violation.jl:1-13)."""
        if me + mc == 0:
            return jnp.zeros((), g.dtype)
        c = jnp.concatenate([g - r, h - s])
        return norm_p(c, p_norm) / (me + mc)

    def optimality_error(p, res):
        """Ipopt-style scaled optimality error (reference
        optimality_error.jl:1-27)."""
        if me + mc > 0:
            sd = jnp.maximum(100.0, (one_norm(p.y) + one_norm(p.z)) / (me + mc)) / 100.0
        else:
            sd = 1.0
        sc = jnp.maximum(100.0, one_norm(p.t) / mc) / 100.0 if mc > 0 else 1.0
        return jnp.max(
            jnp.stack(
                [
                    inf_norm(res.primals) / sd,
                    inf_norm(res.y),
                    inf_norm(res.z),
                    inf_norm(res.t) / sc,
                ]
            )
        )

    def evaluate_residual(p, theta, kappa, rho, lam):
        x, y, z = p.x, p.y, p.z
        fx = fns.fx(x, theta)
        gty = fns.gty_x(x, theta, y) if me > 0 else jnp.zeros_like(x)
        htz = fns.htz_x(x, theta, z) if mc > 0 else jnp.zeros_like(x)
        g = fns.g(x, theta)
        h = fns.h(x, theta)
        sot = cones.product(layout, p.s, p.t)
        e = layout.target(x.dtype)
        res = kkt.residual(fx, gty, htz, g, h, sot, e, p, kappa, rho, lam)
        return res, fx, g, h, sot

    # ---- inertia correction (reference inertia.jl:30-79) --------------------

    def inertia_correction(Hxx, gx, hx, s, t, rho, kappa, eps_p_last, dtype):
        import numpy as _np

        # cap the ladder limit to the dtype range (1e40 overflows f32)
        max_reg = min(opts.max_regularization, float(_np.finfo(dtype).max) / 1e3)
        e_p0 = jnp.asarray(opts.primal_regularization_initial, dtype)
        e_d0 = jnp.asarray(opts.dual_regularization_initial, dtype)

        # the 'lu' backend computes steps on the full system but runs the
        # inertia ladder on the condensed Schur factorization (the
        # reference likewise keeps QDLDL for inertia under :LU)
        method = _fact_method
        fact0 = _factorize_j(Hxx, gx, hx, s, t, rho, e_p0, e_d0)
        ok0 = kkt.inertia_ok(fact0, n, me, mc, method, structure)

        # IC-2: rank-deficiency -> dual regularization scaled by kappa
        zero0 = kkt.num_zero_eigs(fact0, method, structure)
        e_d1 = jnp.where(
            zero0 != 0,
            opts.dual_regularization * kappa**opts.dual_regularization_exponent,
            e_d0,
        )
        # IC-3: primal regularization warm start from the last accepted value
        e_p1 = jnp.where(
            eps_p_last == 0.0,
            e_p0,
            jnp.maximum(opts.min_regularization, opts.scaling_regularization_last * eps_p_last),
        )
        scale = jnp.where(
            eps_p_last == 0.0,
            opts.scaling_regularization_initial,
            opts.scaling_regularization,
        )

        # the ladder while carries ONLY the varying pieces of the
        # factorization (factor blocks + eps_p): the loop-invariant dense
        # gx/hx (O(m n) per lane -- ~1.2 MB/lane for the d=54 contact
        # class) must not ride the carry, where the body's pass-through
        # write costs a full copy per trip
        def core_of(fact):
            return (
                fact.L, fact.d, fact.M, fact.cr,
                fact.Wg, fact.Lc, fact.dc, fact.spike,
                fact.eps_p, fact.eps_d,
            )

        def fact_of(core):
            L, dd, M, cr, Wg, Lc, dc, spike, e_p, e_d = core
            return kkt.Factorization(
                L, dd, M, gx, hx, s, t, rho, e_p, e_d,
                cr, Wg=Wg, Lc=Lc, dc=dc, spike=spike,
            )

        def cond(c):
            _, _, done, failed, _ = c
            return (~done) & (~failed)

        def body(c):
            _, e_p, _, _, trips = c
            fact = _factorize_j(Hxx, gx, hx, s, t, rho, e_p, e_d1)
            ok = kkt.inertia_ok(fact, n, me, mc, method, structure)
            e_p_next = jnp.where(ok, e_p, e_p * scale)  # IC-5
            failed = (~ok) & (e_p_next > max_reg)  # IC-6
            return core_of(fact), e_p_next, ok, failed, trips + 1

        core, _, _, ic_failed, ladder_trips = lax.while_loop(
            cond, body, (core_of(fact0), e_p1, ok0, jnp.asarray(False), jnp.zeros((), jnp.int32))
        )
        fact = fact_of(core)
        # primal_regularization_last updates only when the ladder ran
        # (reference inertia.jl: early return on IC-1 success)
        eps_p_last_new = jnp.where(ok0, eps_p_last, fact.eps_p)
        return fact, ic_failed, eps_p_last_new, ladder_trips

    def refine(step, res, Hxx, gx, hx, fact, s, t, rho):
        return refine_step(
            opts, layout, structure, n, me, mc, step, res, Hxx, gx, hx, fact,
            s, t, rho,
            solve_fn=_solve_with_j,
            matvec_fn=lambda Hxx_, d: _matvec_j(
                Hxx_, gx, hx, s, t, rho, fact.eps_p, fact.eps_d, d
            ),
        )

    # ---- fraction-to-the-boundary cone search (reference solve.jl:193-221) --

    def candidate_alphas(a0, count):
        """[a0, a0*c, a0*c^2, ...] (count+1 entries) by cumulative product.
        For the default power-of-two scaling_line_search (0.5) every
        product is exact, so this matches the serial loop's repeated
        multiplication bit-for-bit; for a non-power-of-two user value
        cumprod's association order may differ from the serial chain by
        ULPs (the selection logic is then equivalent only up to ULP)."""
        facs = jnp.concatenate(
            [
                jnp.ones((1,), a0.dtype),
                jnp.full((count,), opts.scaling_line_search, a0.dtype),
            ]
        )
        return a0 * jnp.cumprod(facs)

    def ftb_search(u, du, tau):
        one = jnp.ones((), u.dtype)
        if mc == 0:
            return one, jnp.asarray(False)
        if opts.line_search_mode == "parallel":
            # evaluate every candidate 0.5^k at once; take the first
            # (largest) non-violating one -- identical to the serial scan
            alphas = candidate_alphas(one, opts.max_cone_line_search)
            viol = jax.vmap(lambda a: cones.violation(layout, u - a * du, u, tau))(alphas)
            ok = ~viol
            fail = ~jnp.any(ok)
            a = jnp.where(fail, alphas[-1], alphas[jnp.argmax(ok)])
            return a, fail
        v0 = cones.violation(layout, u - du, u, tau)

        def cond(c):
            _, k, viol = c
            return viol & (k < opts.max_cone_line_search)

        def body(c):
            a, k, _ = c
            a2 = opts.scaling_line_search * a
            return a2, k + 1, cones.violation(layout, u - a2 * du, u, tau)

        a, _, viol = lax.while_loop(cond, body, (one, jnp.zeros((), jnp.int32), v0))
        return a, viol

    # ---- the inner Newton iteration -----------------------------------------

    def do_step(st, theta, res, fval, fx, g, h):
        p = st.p
        dtype = p.x.dtype
        # dtype-aware machine tolerance: the reference's 1e-16 is f64 eps;
        # in f32 the 10*eps*|M| noise slacks must widen accordingly
        import numpy as _np
        mach = max(opts.machine_tolerance, float(_np.finfo(dtype).eps))
        x, r, s, y, z, t = p

        # pre-step constraint violation theta (reference solve.jl:170-172)
        cv = constraint_violation(g, r, h, s, opts.constraint_norm)

        # second derivatives (the hot evaluation, reference solve.jl:175-185)
        if use_band_hessian:
            Dh, Oh, Hgen = fns.lagrangian_hessian_blocks(
                x, theta, y, z, opts.constraint_tensor
            )
            Hxx = kkt.BandHessian(Dh, Oh, Hgen, structure)
        else:
            Hxx = fns.lagrangian_hessian_xx(x, theta, y, z, opts.constraint_tensor)
        gx = fns.gx(x, theta)
        hx = fns.hx(x, theta)

        # inertia-corrected factorization
        fact, ic_failed, eps_p_last, ladder_trips = inertia_correction(
            Hxx, gx, hx, s, t, st.rho, st.kappa, st.eps_p_last, dtype
        )

        # search direction + refinement
        fell_back = jnp.zeros((), jnp.int32)
        refine_trips = jnp.zeros((), jnp.int32)
        if opts.linear_solver == "lu":
            # exact full-system solve; refinement unnecessary
            step = kkt.lu_solve_full(
                layout, Hxx, gx, hx, s, t, st.rho, fact.eps_p, fact.eps_d, res
            )
        else:
            step = _solve_with_j(fact, res)
            if opts.iterative_refinement:
                step, fell_back, refine_trips = refine(
                    step, res, Hxx, gx, hx, fact, s, t, st.rho
                )

        # merit and its directional derivative (reference merit.jl:2-31)
        barrier_val = cones.barrier(layout, s)
        barrier_grad = cones.barrier_gradient(layout, s)
        merit = merit_value(fval, r, barrier_val, st.kappa, st.lam, st.rho)
        merit_grad = jnp.concatenate(
            [fx, st.lam + st.rho * r, -st.kappa * barrier_grad]
        )
        dgrad = merit_grad @ step.primals

        # cone fraction-to-the-boundary searches; t gets its own step size
        # (reference solve.jl:191-221)
        alpha_s, fail_s = ftb_search(s, step.s, st.tau)
        alpha_t, fail_t = ftb_search(t, step.t, st.tau)

        # filter line search on (x, r, s) (reference solve.jl:252-302)
        def cand_eval(a):
            xh = x - a * step.x
            rh = r - a * step.r
            sh = s - a * step.s
            fh = fns.f(xh, theta)
            gh = fns.g(xh, theta)
            hh = fns.h(xh, theta)
            mh = merit_value(fh, rh, cones.barrier(layout, sh), st.kappa, st.lam, st.rho)
            th = constraint_violation(gh, rh, hh, sh, opts.constraint_norm)
            return mh, th

        def accept_rule(a, mh, th):
            """The reference's acceptance test (solve.jl:262-301): filter
            admissibility AND (switching+Armijo OR sufficient progress).
            Elementwise, so it applies to a whole candidate vector too."""
            ok_filter = filter_check(th, mh, st.filt)
            c1 = (
                (cv <= opts.slack_tolerance)
                & switching_condition(
                    a, dgrad, opts.merit_exponent, cv, opts.violation_exponent
                )
                & armijo(merit, mh, dgrad, a, opts.armijo_tolerance, mach)
            )
            c2 = sufficient_progress(
                cv, th, merit, mh,
                opts.violation_tolerance, opts.merit_tolerance, mach,
            )
            return ok_filter & (c1 | c2)

        if opts.line_search_mode == "parallel":
            # CHUNKED batched line search: evaluate W candidates
            # alpha * 0.5^k at a time and only continue to the next chunk
            # if none is accepted. Acceptance almost always happens in the
            # first few candidates, so this does ~W (f, g, h) evaluations
            # where the round-3 formulation always did
            # max_residual_line_search + 1 = 26 -- a large share of the
            # iteration for expensive constraint oracles (contact
            # dynamics). Selection is bit-identical to the one-shot
            # parallel evaluation and to the serial loop for the default
            # power-of-two scaling_line_search (exact products: same
            # candidate floats whether chained or cumprod'd, same first
            # accepted index, same untested final fallback candidate);
            # for non-power-of-two scalings the candidates agree only up
            # to ULP (see candidate_alphas).
            max_k = opts.max_residual_line_search  # candidates 0..max_k
            W = max(1, min(opts.parallel_line_search_width, max_k + 1))
            num_chunks = -(-(max_k + 1) // W)
            zero = jnp.zeros((), dtype)

            def chunk_cond(c):
                found, chunk = c[0], c[1]
                return (~found) & (chunk < num_chunks)

            def chunk_body(c):
                found, chunk, a_base, alpha_f, m_f, t_f = c
                alphas = candidate_alphas(a_base, W - 1)  # W entries
                ms, ths = jax.vmap(cand_eval)(alphas)
                gidx = chunk * W + jnp.arange(W)
                acc = (
                    jax.vmap(accept_rule)(alphas, ms, ths)
                    # the serial loop never tests the final fallback
                    # candidate (index max_k) or the over-shoot padding
                    & (gidx < max_k)
                )
                any_acc = jnp.any(acc)
                is_last = chunk == num_chunks - 1
                j_fb = jnp.clip(max_k - chunk * W, 0, W - 1)
                sel = jnp.where(any_acc, jnp.argmax(acc), j_fb)
                take = any_acc | is_last
                return (
                    any_acc,
                    chunk + 1,
                    alphas[-1] * opts.scaling_line_search,
                    jnp.where(take, alphas[sel], alpha_f),
                    jnp.where(take, ms[sel], m_f),
                    jnp.where(take, ths[sel], t_f),
                )

            _, ls_chunks, _, alpha, m_cand, t_cand = lax.while_loop(
                chunk_cond,
                chunk_body,
                (
                    jnp.asarray(False),
                    jnp.zeros((), jnp.int32),
                    alpha_s,
                    alpha_s,
                    zero,
                    zero,
                ),
            )
        else:
            m0, t0 = cand_eval(alpha_s)

            def ls_cond(c):
                _, _, _, k, accepted = c
                return (~accepted) & (k < opts.max_residual_line_search)

            def ls_body(c):
                a, mh, th, k, _ = c
                accepted = accept_rule(a, mh, th)

                def halve(_):
                    a2 = opts.scaling_line_search * a
                    m2, t2 = cand_eval(a2)
                    return a2, m2, t2

                a2, m2, t2 = lax.cond(accepted, lambda _: (a, mh, th), halve, None)
                return a2, m2, t2, k + (~accepted).astype(k.dtype), accepted

            alpha, m_cand, t_cand, ls_chunks, _ = lax.while_loop(
                ls_cond, ls_body, (alpha_s, m0, t0, jnp.zeros((), jnp.int32), jnp.asarray(False))
            )

        # filter augmentation (reference filter.jl:81-89): add the pre-step
        # pair when the switching or Armijo condition failed at alpha
        sw = switching_condition(alpha, dgrad, opts.merit_exponent, cv, opts.violation_exponent)
        ar = armijo(merit, m_cand, dgrad, alpha, opts.armijo_tolerance, mach)
        filt_a, nfilt_a = filter_augment(
            st.filt, st.nfilt,
            (1.0 - opts.violation_tolerance) * cv,
            merit - opts.merit_tolerance * cv,
        )
        do_aug = ~(sw & ar)
        filt = jnp.where(do_aug, filt_a, st.filt)
        nfilt = jnp.where(do_aug, nfilt_a, st.nfilt)

        # accept (reference solve.jl:309-326); duals share the primal alpha,
        # t uses its own cone step size
        p_new = Blocks(
            x - alpha * step.x,
            r - alpha * step.r,
            s - alpha * step.s,
            y - alpha * step.y,
            z - alpha * step.z,
            t - alpha_t * step.t,
        )

        if cb_inner is not None:
            jax.debug.callback(
                cb_inner,
                dict(
                    inner=st.inner_i, outer=st.outer_i, total=st.total_i,
                    step_size=alpha, merit=merit, violation=cv,
                ),
            )
        return st._replace(
            p=p_new,
            eps_p_last=eps_p_last,
            eps_p_used=fact.eps_p,
            eps_d_used=fact.eps_d,
            filt=filt,
            nfilt=nfilt,
            failed=st.failed | ic_failed | fail_s | fail_t,
            inner_i=st.inner_i + 1,
            total_i=st.total_i + 1,
            step_size=alpha,
            num_fallbacks=st.num_fallbacks + fell_back,
            num_ladder=st.num_ladder + ladder_trips,
            num_refine=st.num_refine + refine_trips,
            num_ls_chunks=st.num_ls_chunks + ls_chunks,
        )

    def inner_body(st, theta):
        res, fx, g, h, sot = evaluate_residual(st.p, theta, st.kappa, st.rho, st.lam)
        fval = fns.f(st.p.x, theta)

        residual_violation = norm_p(res.all, opts.residual_norm) / ntot
        slack_violation = jnp.maximum(inf_norm(res.y), inf_norm(res.z))
        equality_violation = inf_norm(g)
        cone_product_violation = inf_norm(sot)
        opt_violation = optimality_error(st.p, res)

        solved = (
            (residual_violation < opts.residual_tolerance)
            & (slack_violation < opts.slack_tolerance)
            & (equality_violation <= opts.equality_tolerance)
            & (cone_product_violation <= opts.complementarity_tolerance)
        )
        inner_done = (~solved) & (
            opt_violation
            <= jnp.maximum(
                opts.central_path_update_tolerance * st.kappa, opts.optimality_tolerance
            )
        )

        st = st._replace(
            solved=st.solved | solved,
            inner_done=inner_done,
            residual_violation=residual_violation,
            optimality_violation=opt_violation,
            slack_violation=slack_violation,
            equality_violation=equality_violation,
            cone_product_violation=cone_product_violation,
        )
        if opts.verbose:
            # host-side iteration telemetry every print_frequency inner
            # iterations (reference print.jl:20-53, options.jl:54)
            def _print_row(s):
                # jax.debug.callback, NOT jax.debug.print: on this jax
                # build debug_print inside cond-in-while lowers through a
                # cached rule to an untyped custom call with no registered
                # host-callback index (NOT_FOUND at run time) for some
                # programs; debug.callback always lowers typed-FFI
                jax.debug.callback(
                    _row_printer,
                    s.outer_i, s.inner_i, s.residual_violation,
                    s.optimality_violation, s.slack_violation,
                    s.equality_violation, s.cone_product_violation,
                    s.kappa, s.rho, s.step_size,
                    s.eps_p_used, s.eps_d_used,
                )

            lax.cond(
                st.total_i % opts.print_frequency == 0,
                _print_row,
                lambda s: None,
                st,
            )
        take = ~(st.solved | st.inner_done | st.failed)
        return lax.cond(
            take,
            lambda s: do_step(s, theta, res, fval, fx, g, h),
            lambda s: s,
            st,
        )

    def outer_body(st, theta):
        st = st._replace(inner_done=jnp.asarray(False), inner_i=jnp.zeros((), jnp.int32))

        st = lax.while_loop(
            lambda s: (s.inner_i < opts.max_residual_iterations)
            & ~(s.solved | s.failed | s.inner_done),
            lambda s: inner_body(s, theta),
            st,
        )

        active = ~(st.solved | st.failed)
        # outer updates (reference solve.jl:356-365)
        kappa_n = jnp.maximum(
            opts.residual_tolerance / 10.0,
            jnp.minimum(
                opts.central_path_scaling * st.kappa,
                st.kappa**opts.central_path_exponent,
            ),
        )
        tau_n = jnp.maximum(0.99, 1.0 - kappa_n)
        lam_n = st.lam + st.rho * st.p.r
        rho_n = jnp.minimum(
            jnp.maximum(opts.penalty_scaling * st.rho, 1.0 / kappa_n), opts.max_penalty
        )
        filt_n = jnp.full_like(st.filt, BIG)

        if cb_outer is not None:
            jax.debug.callback(
                cb_outer,
                dict(
                    outer=st.outer_i, kappa=kappa_n, rho=rho_n,
                    solved=st.solved, active=active,
                ),
            )
        return st._replace(
            kappa=jnp.where(active, kappa_n, st.kappa),
            tau=jnp.where(active, tau_n, st.tau),
            lam=jnp.where(active, lam_n, st.lam),
            rho=jnp.where(active, rho_n, st.rho),
            filt=jnp.where(active, filt_n, st.filt),
            nfilt=jnp.where(active, jnp.zeros_like(st.nfilt), st.nfilt),
            outer_i=st.outer_i + 1,
        )

    def init_state(x0, theta, warm: Optional[Blocks] = None) -> State:
        dtype = x0.dtype
        if opts.warmstart and warm is not None:
            p = warm
        else:
            # reference initialize.jl:15-36: r <- g(x0); s, t <- cone
            # interior point; y, z <- 0
            g0 = fns.g(x0, theta)
            p = Blocks(
                x0,
                g0,
                layout.initialize(dtype),
                jnp.zeros((me,), dtype),
                jnp.zeros((mc,), dtype),
                layout.initialize(dtype),
            )
        kappa = jnp.asarray(opts.central_path_initial, dtype)
        z0 = jnp.zeros((), dtype)
        i0 = jnp.zeros((), jnp.int32)
        return State(
            p=p,
            kappa=kappa,
            tau=jnp.maximum(jnp.asarray(0.99, dtype), 1.0 - kappa),
            rho=jnp.asarray(opts.penalty_initial, dtype),
            lam=jnp.full((me,), opts.dual_initial, dtype),
            eps_p_last=z0,
            eps_p_used=jnp.asarray(opts.primal_regularization_initial, dtype),
            eps_d_used=jnp.asarray(opts.dual_regularization_initial, dtype),
            filt=jnp.full((opts.max_filter, 2), BIG, dtype),
            nfilt=i0,
            solved=jnp.asarray(False),
            failed=jnp.asarray(False),
            inner_done=jnp.asarray(False),
            outer_i=i0,
            inner_i=i0,
            total_i=i0,
            residual_violation=z0,
            optimality_violation=z0,
            slack_violation=z0,
            equality_violation=z0,
            cone_product_violation=z0,
            step_size=jnp.ones((), dtype),
            num_fallbacks=i0,
            num_ladder=i0,
            num_refine=i0,
            num_ls_chunks=i0,
        )

    def solve(x0, theta=None, warm: Optional[Blocks] = None) -> State:
        x0 = jnp.asarray(x0)
        theta = (
            jnp.zeros((npar,), x0.dtype) if theta is None else jnp.asarray(theta, x0.dtype)
        )
        with jax.default_matmul_precision(opts.matmul_precision):
            st = init_state(x0, theta, warm)
            st = lax.while_loop(
                lambda s: (s.outer_i < opts.max_outer_iterations) & ~(s.solved | s.failed),
                lambda s: outer_body(s, theta),
                st,
            )
        return st

    return solve
