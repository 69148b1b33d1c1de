"""Benchmark: batched trajopt solves/s on the current GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

All problems run at the reference acceptance contract (1e-4 tolerances,
reference src/solver/options.jl:25-29 + test/solver/wachter.jl:35-46).

vs_baseline is MEASURED fresh each run (BASELINE.md requirement): a
subprocess solves the same pendulum family sequentially, one problem at a
time, on the host CPU in f64 -- the reference solver's operating mode
(single-process CPU, SURVEY.md section 2.4; Julia is not in this image, so
the repo's own CPU path is the documented proxy). vs_baseline =
batched-GPU solves/s / sequential-CPU solves/s.

Times are host-clock seconds around work that ends in
`jax.block_until_ready`. The factorization rate is computed analytically
(block-tridiagonal Cholesky: ~8/3 * d^3 flops/stage/lane, or n^3/3 for
the dense schur factorization) and divided by the card's float32 peak
outside the tensor cores (the solver runs f32 at matmul precision
"highest"); for blocks this small that share is a roofline statement,
not a target.

The workload constructors (`build`, `build_rocket_batch`, `build_quadruped_batch`,
`build_rocket101`) are shared with chip_smoke.py, which runs the same
workloads once and checks them against CPU references.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import jax
import jax.numpy as jnp

# B=8192 was the throughput knee of the pendulum cell on the accelerator
# this bench was first tuned on; the knee is not yet measured on the
# H100. The batch size is part of the metric label.
BATCH = int(os.environ.get("BENCH_BATCH", "8192"))
HORIZON = int(os.environ.get("BENCH_HORIZON", "11"))
TOL = float(os.environ.get("BENCH_TOL", "1e-4"))

# Published dense peaks per card, keyed by jax device_kind (NVIDIA H100
# SXM data sheet, at the full 700 W power limit): float32 outside the
# tensor cores, TF32 and bf16 in the tensor cores, HBM bandwidth. A
# device that is not listed is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def nvidia_smi():
    """Name and power limit of each card, one line per card, as nvidia-smi
    gives them (a card set below its maximum power runs slower under
    load)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip()


def card_record():
    """What ran the benchmark: JAX's platform, device kind and device
    count, plus the first card's name and power limit."""
    dev = jax.devices()[0]
    smi = nvidia_smi()
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": smi.splitlines()[0] if smi else "",
    }


def peaks(device_kind):
    if device_kind not in PEAKS:
        raise KeyError(
            f"no published peaks for device_kind {device_kind!r}; add it to bench.PEAKS"
        )
    return PEAKS[device_kind]


def _tol_options(**kw):
    from calipso_tpu import Options

    return Options(
        residual_tolerance=TOL,
        optimality_tolerance=TOL,
        slack_tolerance=TOL,
        equality_tolerance=TOL,
        complementarity_tolerance=TOL,
        iterative_refinement_tolerance=1e-6,
        **kw,
    )


def _pendulum_family(H):
    def pend_c(x, u):
        return jnp.array(
            [x[1], u[0] / 0.25 - 9.81 * jnp.sin(x[0]) / 0.5 - 0.1 * x[1] / 0.25]
        )

    def pend_d(y, x, u):
        return y - (x + 0.05 * pend_c(0.5 * (x + y), u))

    xg = jnp.array([np.pi, 0.0])
    objective = [
        *[(lambda x, u, w: 0.1 * x @ x + 0.1 * u @ u)] * (H - 1),
        lambda x, u, w: 0.1 * x @ x,
    ]
    equality = [
        lambda x, u, w: x - w,  # initial state is the scenario parameter
        *[None] * (H - 2),
        lambda x, u, w: x - xg,
    ]
    return objective, pend_d, equality, xg


def build(horizon=None, **options):
    """The pendulum swing-up family: (batched solver, stage dims, solver).
    Scenarios differ in their initial state (the stage-0 parameter)."""
    from calipso_tpu import TrajOptSolver

    H = HORIZON if horizon is None else horizon
    objective, pend_d, equality, xg = _pendulum_family(H)
    ts = TrajOptSolver(
        objective,
        [pend_d] * (H - 1),
        [2] * H,
        [1] * (H - 1),
        equality=equality,
        parameters=[np.zeros(2)] + [np.zeros(0)] * (H - 1),
        options=_tol_options(**options),
    )
    # shared swing-up guess, scenario-specific initial state
    ts.initialize_states([np.asarray(xg) * t / (H - 1) for t in range(H)])
    bts = ts.batched()
    stage_dims = [nx + nu for nx, nu in zip(ts.num_states, ts.num_actions)]
    return bts, stage_dims, ts


def pendulum_scenarios(B, seed=0):
    """(B, 2) initial states of the pendulum family, float64 NumPy."""
    return 0.2 * np.random.default_rng(seed).normal(size=(B, 2))


def build_rocket_batch(B, horizon=31, seed=0, **options):
    """Batched rocket SOC landing (d=9 stage blocks) on the riccati
    backend. The landing problem has no stage parameters (its x0 is a
    constraint constant), so scenario variation enters through a
    per-lane perturbation of the guess. Returns (batched solver, (B, n)
    float64 NumPy guesses)."""
    from calipso_tpu import TrajOptSolver
    from calipso_tpu.models import rocket

    prob = rocket.landing_problem(horizon=horizon)
    kw = {
        k: v
        for k, v in prob.items()
        if k not in ("state_guess", "state_initial", "state_goal")
    }
    opts = _tol_options(max_iterative_refinement=2, linear_solver="riccati", **options)
    ts = TrajOptSolver(options=opts, **kw)
    ts.initialize_states([np.asarray(s) for s in prob["state_guess"]])
    g0 = np.asarray(ts._guess, np.float64)
    rng = np.random.default_rng(seed)
    return ts.batched(), g0[None] + 0.01 * rng.normal(size=(B, g0.size))


def build_quadruped_batch(B, horizon=8, seed=0):
    """Batched quadruped drops: stage blocks d=54 (11-DOF planar
    quadruped, 4 friction-SOC contacts, reference quadruped_drop.jl
    class) on the riccati backend. Each lane drops the nominal stance
    from its own height in [0.02, 0.10]. Returns (batched solver, trajopt
    solver, (B, 22) float64 NumPy initial states)."""
    from calipso_tpu import TrajOptSolver
    from calipso_tpu.models import quadruped

    prob = quadruped.mpc_problem(horizon=horizon)
    kw = {
        k: v
        for k, v in prob.items()
        if k not in ("state_guess", "state_initial", "state_goal", "action_guess")
    }
    ts = TrajOptSolver(options=_tol_options(max_iterative_refinement=2), **kw)
    ts.initialize_states([np.asarray(s) for s in prob["state_guess"]])
    ts.initialize_actions([np.asarray(a) for a in prob["action_guess"]])
    heights = np.random.default_rng(seed).uniform(0.02, 0.10, size=(B,))
    q0 = quadruped._nominal_q()
    x0 = np.tile(np.concatenate([q0, q0])[None], (B, 1))
    x0[:, 1] += heights
    x0[:, 11 + 1] += heights
    return ts.batched(), ts, x0


def build_rocket101():
    """Single rocket SOC landing T=101 (the reference's full-size trajopt,
    903 vars + 100 SOCs) on the cyclic-reduction backend, with the guess
    tests/test_golden.py uses. Two refinement trips absorb the f32 CR
    solve error at this tolerance. Returns (trajopt solver, float64 NumPy
    guess)."""
    from calipso_tpu import TrajOptSolver
    from calipso_tpu.models import rocket

    prob = rocket.landing_problem(horizon=101)
    kw = {
        k: v
        for k, v in prob.items()
        if k not in ("state_guess", "state_initial", "state_goal")
    }
    opts = _tol_options(max_iterative_refinement=2, linear_solver="cr")
    ts = TrajOptSolver(options=opts, **kw)
    guess = np.zeros(ts.num_variables)
    for t, idx in enumerate(ts._state_indices):
        guess[idx] = np.asarray(prob["state_guess"][t])
    rng = np.random.default_rng(0)
    for t, idx in enumerate(ts._action_indices):
        guess[idx] = 1e-3 * rng.normal(size=3)
    return ts, guess


_BASELINE_SNIPPET = r"""
import os, sys, time, json
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np, jax.numpy as jnp
import bench
bench.TOL = {tol}
_, _, ts = bench.build({horizon})
x0s = bench.pendulum_scenarios({k} + 1)
r = ts.solve(parameters=jnp.asarray(x0s[0]))  # compile
jax.block_until_ready(r.state.p.x)
# median-of-K per-solve timing: the per-solve MEDIAN is robust to
# scheduler spikes, and the p10/p90 rate spread + 1-min load average are
# recorded so the headline ratio's denominator is auditable
solved, times = 0, []
for i in range(1, {k} + 1):
    t0 = time.time()
    r = ts.solve(parameters=jnp.asarray(x0s[i]))
    jax.block_until_ready(r.state.p.x)
    times.append(time.time() - t0)
    solved += int(r.solved)
med = float(np.median(times))
p10, p90 = float(np.percentile(times, 10)), float(np.percentile(times, 90))
print(json.dumps({{"cpu_sequential_solves_per_s": 1.0 / med,
                   "cpu_sequential_spread": [1.0 / p90, 1.0 / p10],
                   "cpu_load_avg_1m": os.getloadavg()[0],
                   "cpu_sequential_solved": solved, "cpu_k": {k}}}))
"""


def measure_cpu_baseline(k=64):
    """Sequential one-at-a-time CPU f64 solves of the same problem family
    in a subprocess that never opens the GPU (fresh measurement; see
    module docstring). The rate is 1/median of the k per-solve times;
    the p10/p90 rate spread and load average ride along in the JSON."""
    code = _BASELINE_SNIPPET.format(
        repo=os.path.dirname(os.path.abspath(__file__)),
        horizon=HORIZON,
        tol=TOL,
        k=k,
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": ""},
    )
    line = out.stdout.strip().splitlines()[-1]
    return json.loads(line)


# analytic per-stage factorization work for the block-tridiagonal
# Cholesky (ops/riccati.py): chol(S_t) d^3/3 + M_t = L^-1 O' d^3 +
# M'M update 2 d^3 multiply-add-counted flops
FACTOR_FLOPS_PER_STAGE = lambda d: (1.0 / 3.0 + 1.0 + 2.0) * d**3
# HBM bytes per stage: read D + O, write L + M, f32
FACTOR_BYTES_PER_STAGE = lambda d: 4 * d * d * 4


def bench_quadruped_batch():
    """Batched large-d contact workload: B quadruped drops (d=54 stage
    blocks) solved in lockstep on the riccati backend, with analytic
    factorization flops and bytes per iteration."""
    B = int(os.environ.get("BENCH_QUAD_BATCH", "128"))
    H = 8
    bts, ts, x0 = build_quadruped_batch(B, horizon=H)
    th = jnp.asarray(x0)

    # ahead-of-time traced-program cache (utils/aot.py): the persistent
    # XLA cache cannot absorb the Python tracing of this program; the
    # keyed AOT cache skips tracing on a warm run. compile_s spans the
    # WHOLE cold start: trace+export on an AOT miss (or deserialize on a
    # hit), XLA compile, and the first dispatch.
    from calipso_tpu.utils import aot as _aot

    t0 = time.time()
    fp = f"quadruped-B{B}-H{H}-tol{TOL}-refine2-p{th.shape[1]}"
    fn, aot_cached = _aot.cached_batched(
        bts._batched, "quad", fp, *bts._example_args(B, th.shape[1])
    )
    bts._batched = fn
    res = jax.block_until_ready(bts.solve(parameters=th))
    compile_s = time.time() - t0
    reps = 2
    t0 = time.time()
    for _ in range(reps):
        res = jax.block_until_ready(bts.solve(parameters=th))
    dt = (time.time() - t0) / reps

    total_i = np.asarray(res.state.total_i)
    iters = int(total_i.sum())
    dmax = max(nx + nu for nx, nu in zip(ts.num_states, ts.num_actions))
    fact_stages_per_s = iters * H / dt
    # the counters are per-LANE totals whose lane-MAX bounds what the
    # lockstep batch executed (vmapped while loops run until every lane
    # is done)
    return {
        "quadruped_batch": B,
        "quadruped_solved": int(np.asarray(res.state.solved).sum()),
        "quadruped_solves_per_s": B / dt,
        "quadruped_stage_block_d": dmax,
        "quadruped_total_inner_iterations": iters,
        "quadruped_lockstep_iterations": int(total_i.max()),
        "quadruped_ladder_refactorizations_max": int(np.asarray(res.state.num_ladder).max()),
        "quadruped_refine_trips_max": int(np.asarray(res.state.num_refine).max()),
        "quadruped_ls_chunks_max": int(np.asarray(res.state.num_ls_chunks).max()),
        "quadruped_per_batch_wall_s": dt,
        "quadruped_compile_s": compile_s,
        "quadruped_aot_cached": bool(aot_cached),
        "quadruped_fact_gflops_per_s_lower_bound": fact_stages_per_s * FACTOR_FLOPS_PER_STAGE(dmax) / 1e9,
        "quadruped_fact_gbps_lower_bound": fact_stages_per_s * FACTOR_BYTES_PER_STAGE(dmax) / 1e9,
    }


def bench_rocket_batch():
    """Batched rocket SOC landing T=31, B=128 (d=9 stage blocks) on the
    riccati backend: the batched factor/solve route of small stage
    blocks."""
    B = 128
    bts, guesses = build_rocket_batch(B)
    res = jax.block_until_ready(bts.solve(guess=jnp.asarray(guesses)))
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        res = jax.block_until_ready(bts.solve(guess=jnp.asarray(guesses)))
    dt = (time.time() - t0) / reps
    return {
        "rocket_batch_solves_per_s": B / dt,
        "rocket_batch_solved": int(np.asarray(res.state.solved).sum()),
        "rocket_batch_iterations": int(np.asarray(res.state.total_i).sum()),
    }


def bench_rocket101():
    """Single rocket SOC landing T=101 on the cyclic-reduction backend
    (chosen over riccati for single long solves; the choice is not yet
    measured on the H100)."""
    ts, guess = build_rocket101()
    ts.solver.initialize(jnp.asarray(guess))
    t0 = time.time()
    r = jax.block_until_ready(ts.solve())
    compile_s = time.time() - t0
    reps = 2
    t0 = time.time()
    for _ in range(reps):
        r = jax.block_until_ready(ts.solver.solve(x0=jnp.asarray(guess)))
    dt = (time.time() - t0) / reps
    return {
        "rocket101_solved": bool(r.solved),
        "rocket101_iterations": int(r.iterations),
        "rocket101_solve_s": dt,
        "rocket101_compile_s": compile_s,
        "rocket101_backend": ts.solver.options.linear_solver,
    }


def bench_hopper_gait():
    """Contact-implicit hopper gait T=21 (SOC friction, impact
    complementarity, gait periodicity + travel through equality_general on
    the riccati low-rank border) -- the reference's hardest-in-CI example
    family (test/examples/hopper_gait.jl), single solve, f32."""
    from calipso_tpu import TrajOptSolver
    from calipso_tpu.models import hopper

    prob = hopper.gait_problem()
    kw = {
        k: v
        for k, v in prob.items()
        if k
        not in ("state_guess", "state_initial", "state_goal", "action_guess", "penalty_initial")
    }
    # per-problem option tuning (the reference's examples tune options the
    # same way): a shorter first central-path leg suits this contact
    # problem, and two refinement trips absorb the f32 error like the
    # rocket bench
    ts = TrajOptSolver(
        options=_tol_options(central_path_initial=0.1, max_iterative_refinement=2),
        **kw,
    )
    ts.initialize_states([np.asarray(s) for s in prob["state_guess"]])
    if "action_guess" in prob:
        ts.initialize_actions([np.asarray(a) for a in prob["action_guess"]])
    r = jax.block_until_ready(ts.solve())
    g = jnp.asarray(ts._guess)
    t0 = time.time()
    r = jax.block_until_ready(ts.solver.solve(x0=g))
    dt = time.time() - t0
    return {
        "hopper_gait_solved": bool(r.solved),
        "hopper_gait_iterations": int(r.iterations),
        "hopper_gait_solve_s": dt,
        "hopper_gait_backend": ts.solver.options.linear_solver,
    }


def main():
    import calipso_tpu

    card = card_record()
    peak = peaks(card["device_kind"])
    calipso_tpu._maybe_enable_cache()

    bts, stage_dims, ts = build()
    x0s = jnp.asarray(pendulum_scenarios(BATCH))

    # warmup / compile (compile_s includes tracing; trace_s isolates the
    # Python/jaxpr part, measured COLD on a freshly built solver so the
    # jaxpr cache from the warmup call cannot hide it)
    t0 = time.time()
    res = jax.block_until_ready(bts.solve(parameters=x0s))
    compile_s = time.time() - t0
    bts_cold, _, _ = build()
    guess_b = jnp.broadcast_to(
        jnp.asarray(bts._ts._guess, x0s.dtype), (BATCH, int(np.size(bts._ts._guess)))
    )
    t0 = time.time()
    bts_cold._batched.lower(guess_b, x0s)
    trace_s = time.time() - t0

    reps = 2
    t0 = time.time()
    for _ in range(reps):
        res = jax.block_until_ready(bts.solve(parameters=x0s))
    dt = (time.time() - t0) / reps

    solves_per_s = BATCH / dt

    # lockstep waste is computed over solved lanes only so early failures
    # cannot inflate it (n_failed reported alongside)
    solved_mask = np.asarray(res.state.solved)
    total_i = np.asarray(res.state.total_i)
    n_solved = int(solved_mask.sum())
    n_failed = int(BATCH - n_solved)
    iters = int(total_i.sum())
    iters_max = int(total_i[solved_mask].max()) if n_solved else 0
    iters_solved = int(total_i[solved_mask].sum()) if n_solved else 0

    # analytic KKT-factorization flop rate (lower bound: one
    # factorization per inner iteration; the inertia ladder re-factorizes
    # on regularization bumps, which are not counted). The resolved
    # backend of this family is schur (dense Cholesky of the n x n primal
    # Schur complement), so the per-iteration factorization is one n^3/3
    # Cholesky.
    backend = ts.solver.options.linear_solver
    n_schur = ts.num_variables
    if backend == "schur":
        fact_flops_per_lane = n_schur**3 / 3.0
        fact_bytes_per_lane = 2 * n_schur * n_schur * 4  # read S, write L
    else:
        fact_flops_per_lane = sum(FACTOR_FLOPS_PER_STAGE(d) for d in stage_dims)
        fact_bytes_per_lane = sum(FACTOR_BYTES_PER_STAGE(d) for d in stage_dims)
    kkt_flops_per_s = iters / dt * fact_flops_per_lane
    kkt_bytes_per_s = iters / dt * fact_bytes_per_lane
    extra = {
        **card,
        "solved": n_solved,
        "failed": n_failed,
        "batch": BATCH,
        "tolerance": TOL,
        "total_inner_iterations": iters,
        # lockstep occupancy: vmapped lanes run masked no-ops until the
        # slowest lane finishes; waste = 1 - mean/max iterations over the
        # solved lanes
        "iterations_max": iters_max,
        "lockstep_waste": 1.0 - iters_solved / (n_solved * iters_max)
        if iters_max and n_solved
        else 0.0,
        "kkt_factorizations_per_s_lower_bound": iters / dt,
        # cost-accounting counters (lane-max)
        "ladder_refactorizations_max": int(np.asarray(res.state.num_ladder).max()),
        "refine_trips_max": int(np.asarray(res.state.num_refine).max()),
        "ls_chunks_max": int(np.asarray(res.state.num_ls_chunks).max()),
        "kkt_backend": backend,
        "kkt_factorization_gflops_per_s": kkt_flops_per_s / 1e9,
        "kkt_factorization_gbps": kkt_bytes_per_s / 1e9,
        "kkt_factorization_share_of_fp32_peak": kkt_flops_per_s / peak["fp32_flops"],
        "compile_s": compile_s,
        "trace_s": trace_s,
        "compile_cache_dir": jax.config.jax_compilation_cache_dir,
        "per_batch_wall_s": dt,
    }
    sections = (
        ("BENCH_SKIP_BASELINE", "cpu_baseline_error", measure_cpu_baseline),
        ("BENCH_SKIP_ROCKET", "rocket101_error", bench_rocket101),
        ("BENCH_SKIP_CONTACT", "hopper_gait_error", bench_hopper_gait),
        ("BENCH_SKIP_ROCKET_BATCH", "rocket_batch_error", bench_rocket_batch),
        ("BENCH_SKIP_QUAD", "quadruped_error", bench_quadruped_batch),
    )
    for skip, err_key, section in sections:
        if os.environ.get(skip, "0") == "1":
            continue
        try:
            extra.update(section())
        except Exception as e:  # keep the primary metric robust
            extra[err_key] = repr(e)[:200]

    base = extra.get("cpu_sequential_solves_per_s")
    print(
        json.dumps(
            {
                "metric": f"batched pendulum trajopt solves/s (T={HORIZON}, B={BATCH}, "
                f"tol={TOL:g}, {card['platform']})",
                "value": solves_per_s,
                "unit": "solves/s",
                "vs_baseline": solves_per_s / base if base else None,
                "extra": extra,
            }
        )
    )


if __name__ == "__main__":
    main()
