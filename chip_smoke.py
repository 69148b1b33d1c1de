"""Run the solver's main path once on one GPU and check what comes out.

    python chip_smoke.py               # phases 1-7 on one GPU
    python chip_smoke.py --multichip   # the sharded path on four GPUs

Every phase goes through the public entry points (Solver, TrajOptSolver
and its batched form) at the sizes the benchmark runs, in float32 at the
reference's 1e-4 acceptance contract (bench._tol_options), and checks its
result against a reference: a known solution, the committed float64
golden trajectory, a float64 NumPy solve, or the same lanes solved on the
CPU by child processes started with JAX_PLATFORMS=cpu (they never open the
card, so one process uses it).

Each phase prints one JSON line: first-call (trace + compile + run) and
warm seconds on the host clock around `block_until_ready`,
solved/attempted, the lane-max counters the solver State carries, and its
comparison with the reference. The last line,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}},
is printed only when every phase passed. The script exits non-zero, and
prints no such line, when the first device is not a GPU or any phase
failed.
"""

import json
import os
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import __graft_entry__ as ge
import bench
import calipso_tpu
from calipso_tpu import Solver, TrajOptSolver
from calipso_tpu.models import rocket
from calipso_tpu.ops import riccati as rc

REPO = os.path.dirname(os.path.abspath(__file__))

PEND_B = 8192
PEND_LANES = np.linspace(0, PEND_B - 1, 16).astype(int)
ROCKET_B = 128
ROCKET_LANES = np.linspace(0, ROCKET_B - 1, 4).astype(int)
QUAD_B = 128
DIFF_B = 1024
DIFF_LANES = np.linspace(0, DIFF_B - 1, 4).astype(int)
# (batch, horizon T, stage width d): the batched factorization shapes of
# the pendulum (dense schur, T=1), rocket T=31 and quadruped cells
FACTOR_SHAPES = ((8192, 1, 32), (128, 31, 9), (128, 8, 54))
SPIKE_HORIZON = 100  # rocket landing; spike needs T divisible by 4 devices

# Tolerances, each with its reason:
# - primal solutions: the golden tests' atol. Both sides stop at the 1e-4
#   contract, so they agree to about that accuracy times the problem's
#   conditioning, not to round-off.
X_ATOL = 1e-3
# - rocket lanes against float64: the contract bounds scaled residuals,
#   so agreement scales with the solution (thrusts up to ~10 here): the
#   bound is X_RTOL times the lane's largest |x|. The CPU float32 solve of
#   the same lanes with the GPU's (parallel) line search is 4.1e-3 off
#   float64 in one lane -- it takes 23 iterations where float64 takes 22
#   and stops at another point inside the contract.
X_RTOL = 1e-3
# - TF32 leak: float32 products silently run in TF32 blew iteration
#   counts up ~30x when a low-precision pass leaked in before, so a GPU
#   lane-max more than twice the CPU float32 lane-max means one leaked.
ITER_RATIO = 2.0
# - sensitivities: dw*/dtheta solves the KKT system at the converged
#   point, which both sides know only to the 1e-4 contract, and float32
#   loses digits in that solve; the error is measured against the largest
#   sensitivity entry of the lane. The CPU float32 solve of the same four
#   lanes is 1.6e-2 off the float64 one, so the bound is 5e-2.
SENS_RTOL = 5e-2
# - factorization: the backward error of float32 Cholesky and
#   substitution is a small multiple of n * 6e-8 relative to |S| |x|;
#   the blocks are well conditioned (A A' + d I, small couplings).
RESID_RTOL = 1e-5
# - sharded vs one card: the same lanes in the same float32 program; only
#   the order of reductions across devices differs.
SHARD_RTOL = 1e-4

COUNTERS = ("total_i", "num_ladder", "num_refine", "num_ls_chunks")


def _timed(fn):

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _counters(state, lanes=None):
    out = {}
    for k in COUNTERS:
        v = np.asarray(getattr(state, k))
        out[f"{k}_max"] = int((v if lanes is None else v[lanes]).max())
    return out


def _check(info, cond, msg):
    """Record a failed check in the phase's info (the phase still prints
    everything it measured) -- any failed check fails the phase."""
    if not cond:
        info.setdefault("failed_checks", []).append(msg)


# ---- factorization: the batched XLA route alone --------------------------


def spd_blocks(B, T, d, seed=0):
    """Batch of well-conditioned SPD block-tridiagonal systems: D (B, T,
    d, d), O (B, T-1, d, d), b (B, T, d), float64 NumPy."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, T, d, d))
    D = A @ np.swapaxes(A, -1, -2) + d * np.eye(d)
    O = 0.3 * rng.normal(size=(B, T - 1, d, d))
    return D, O, rng.normal(size=(B, T, d))


def factor_solve_fn(T):
    """The batched factor + solve of the solver's backends: the dense
    schur route (Cholesky + two triangular solves) at T=1, the Riccati
    sweep (ops/riccati.py) otherwise, vmapped over the batch."""

    def dense(D, O, b):
        L = jnp.linalg.cholesky(D[0])
        y = jax.scipy.linalg.solve_triangular(L, b[0], lower=True)
        x = jax.scipy.linalg.solve_triangular(L, y, lower=True, trans="T")
        return L[None], x[None]

    def sweep(D, O, b):
        L, M = rc.factor(D, O)
        return L, rc.solve(L, M, b)

    return jax.jit(jax.vmap(dense if T == 1 else sweep))


def tridiag_matvec(D, O, x):
    """S x for the batched block-tridiagonal S (float64 NumPy)."""
    y = np.einsum("btij,btj->bti", D, x)
    if O.shape[1]:
        y[:, 1:] += np.einsum("btij,btj->bti", O, x[:, :-1])
        y[:, :-1] += np.einsum("btji,btj->bti", O, x[:, 1:])
    return y


def factor_solve_residual(B, T, d, dtype, seed=0):
    """Run the batched factor + solve at (B, T, d) in `dtype` and return
    (x, max over lanes of |S x - b| / |b|, computed in float64)."""

    D, O, b = spd_blocks(B, T, d, seed)
    f = factor_solve_fn(T)
    _, x = f(*(jnp.asarray(a, dtype) for a in (D, O, b)))
    x = np.asarray(x, np.float64)
    r = tridiag_matvec(D, O, x) - b
    rel = np.linalg.norm(r.reshape(B, -1), axis=1) / np.linalg.norm(b.reshape(B, -1), axis=1)
    return x, float(rel.max())


def nonpd_lane_is_flagged(B, T, d, dtype, bad_lane=1):
    """The inertia ladder's signal: a non-PD stage block in one lane of a
    vmapped factorization must come out non-finite in that lane's factor
    and leave every other lane finite. Returns True when it does."""

    D, O, b = spd_blocks(B, T, d, seed=1)
    D[bad_lane, T // 2] = -np.eye(d)
    L, _ = factor_solve_fn(T)(*(jnp.asarray(a, dtype) for a in (D, O, b)))
    finite = np.isfinite(np.asarray(L)).reshape(B, -1).all(axis=1)
    return (not finite[bad_lane]) and bool(np.delete(finite, bad_lane).all())


def phase_factorization(shapes=FACTOR_SHAPES, reps=20):

    out = {}
    info = {"shapes": out, "reference": "float64 NumPy", "resid_rtol": RESID_RTOL}
    for B, T, d in shapes:
        tag = f"{B}x{T}x{d}"
        D, O, b = (jnp.asarray(a, jnp.float32) for a in spd_blocks(B, T, d))
        f = factor_solve_fn(T)
        _, first = _timed(lambda: f(D, O, b))
        t0 = time.perf_counter()
        for _ in range(reps):
            res = f(D, O, b)
        jax.block_until_ready(res)
        ms = 1e3 * (time.perf_counter() - t0) / reps
        x, rel = factor_solve_residual(B, T, d, jnp.float32)
        # the float64 NumPy solve of a few lanes, dense
        Dn, On, bn = spd_blocks(B, T, d)
        err = 0.0
        for i in range(min(B, 4)):
            S = np.zeros((T * d, T * d))
            for t in range(T):
                S[t * d : (t + 1) * d, t * d : (t + 1) * d] = Dn[i, t]
            for t in range(T - 1):
                S[(t + 1) * d : (t + 2) * d, t * d : (t + 1) * d] = On[i, t]
                S[t * d : (t + 1) * d, (t + 1) * d : (t + 2) * d] = On[i, t].T
            xr = np.linalg.solve(S, bn[i].reshape(-1))
            err = max(err, float(np.abs(x[i].reshape(-1) - xr).max() / np.abs(xr).max()))
        nan_ok = nonpd_lane_is_flagged(B, T, d, jnp.float32)
        out[tag] = {
            "first_call_s": first,
            "ms_per_factor_solve": ms,
            "rel_residual_max": rel,
            "rel_err_vs_numpy_f64": err,
            "nonpd_lane_nan": nan_ok,
        }
        _check(info, rel <= RESID_RTOL, f"{tag}: relative residual {rel:.3e} > {RESID_RTOL}")
        _check(info, nan_ok, f"{tag}: a non-PD lane did not come out non-finite alone")
    return info


# ---- CPU reference (child process, JAX_PLATFORMS=cpu) ----------------------


def cpu_reference(precision):
    """Solve the compared lanes on the CPU. float64: pendulum, rocket and
    sensitivity lanes; float32: the pendulum and rocket lanes with the
    line search the GPU runs ("parallel"; the CPU's default is "serial"),
    the same algorithm in the same precision on another backend.
    Returns a JSON-able dict."""

    mode = {"line_search_mode": "parallel"} if precision == "f32" else {}
    th = bench.pendulum_scenarios(PEND_B)[PEND_LANES]
    bts, _, _ = bench.build(**mode)
    r = bts.solve(parameters=jnp.asarray(th))
    out = {
        "pendulum_x": np.asarray(r.state.p.x).tolist(),
        "pendulum_iters": np.asarray(r.state.total_i).tolist(),
    }
    bts, guesses = bench.build_rocket_batch(ROCKET_B, **mode)
    r = bts.solve(guess=jnp.asarray(guesses[ROCKET_LANES]))
    out["rocket_x"] = np.asarray(r.state.p.x).tolist()
    out["rocket_iters"] = np.asarray(r.state.total_i).tolist()
    if precision == "f32":
        return out
    bts, _, ts = bench.build(differentiate=True)
    th = bench.pendulum_scenarios(DIFF_B)[DIFF_LANES]
    r = bts.solve(parameters=jnp.asarray(th))
    out["sens"] = np.asarray(r.sensitivity[:, : ts.num_variables, :]).tolist()
    return out


def _cpu_reference_main(precision):
    # stay on a few of the host's cores, away from the GPU process's host
    # work; a child never opens the card (JAX_PLATFORMS=cpu)
    cores = sorted(os.sched_getaffinity(0))
    k = max(1, len(cores) // 4)
    mine = cores[-k:] if precision == "f64" else cores[-2 * k : -k]
    if mine:
        os.sched_setaffinity(0, mine)

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", precision == "f64")
    print(json.dumps(cpu_reference(precision)))


class Reference:
    """A CPU reference child, started at once and read when first needed.
    It runs with JAX_PLATFORMS=cpu and no GPU visible, and without the
    compilation cache (XLA:CPU entries carry host machine code)."""

    def __init__(self, precision):
        self.precision = precision
        env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
        env.update(JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-reference", precision],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
            cwd=REPO,
        )
        self._data = None

    def get(self, timeout=900):
        if self._data is None:
            out, err = self.proc.communicate(timeout=timeout)
            if self.proc.returncode != 0:
                raise RuntimeError(
                    f"CPU {self.precision} reference failed "
                    f"(rc={self.proc.returncode}): {err[-2000:]}"
                )
            self._data = json.loads(out.strip().splitlines()[-1])
        return self._data

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


# ---- GPU phases -------------------------------------------------------------


def phase_nlp():

    s = Solver(
        lambda x: x[0],
        lambda x: jnp.array([x[0] ** 2 - x[1] - 1.0, x[0] - x[2] - 0.5]),
        lambda x: x[1:3],
        3,
        options=bench._tol_options(),
    )
    x0 = jnp.array([-2.0, 3.0, 1.0])
    _, first = _timed(lambda: s.solve(x0))
    r, warm = _timed(lambda: s.solve(x0))
    err = float(np.abs(np.asarray(r.variables) - [1.0, 0.0, 0.5]).max())
    info = {"first_call_s": first, "warm_s": warm, "solved": f"{int(r.solved)}/1",
            **_counters(r.state), "x_err_vs_known": err}
    _check(info, bool(r.solved), "Wachter not solved")
    _check(info, err <= 1e-3, f"x* off by {err:.3e}")
    return info


def phase_pendulum_batch(ref64, ref32, B=PEND_B, lanes=PEND_LANES):

    bts, _, ts = bench.build()
    th = jnp.asarray(bench.pendulum_scenarios(B))
    _, first = _timed(lambda: bts.solve(parameters=th))
    r, warm = _timed(lambda: bts.solve(parameters=th))
    solved = int(np.asarray(r.state.solved).sum())
    x = np.asarray(r.state.p.x)[lanes]
    d64 = ref64.get()
    c32 = ref32.get()
    err = float(np.abs(x - np.asarray(d64["pendulum_x"])).max())
    it_gpu = int(np.asarray(r.state.total_i)[lanes].max())
    it_cpu32 = int(max(c32["pendulum_iters"]))
    it_cpu64 = int(max(d64["pendulum_iters"]))
    info = {"backend": ts.solver.options.linear_solver, "first_call_s": first,
            "warm_s": warm, "solved": f"{solved}/{B}", **_counters(r.state),
            "x_maxabs_vs_cpu_f64": err, "lanes": len(lanes),
            "iters_max_lanes_gpu_f32": it_gpu, "iters_max_lanes_cpu_f32": it_cpu32,
            "iters_max_lanes_cpu_f64": it_cpu64}
    _check(info, solved == B, f"pendulum {solved}/{B} solved")
    _check(info, err <= X_ATOL, f"pendulum lanes differ from CPU f64 by {err:.3e}")
    _check(info, it_gpu <= ITER_RATIO * it_cpu32,
           f"GPU lane-max iterations {it_gpu} > {ITER_RATIO} x CPU f32 {it_cpu32}: TF32 leak?")
    return info


def phase_rocket_batch(ref64, ref32, B=ROCKET_B, lanes=ROCKET_LANES):

    bts, guesses = bench.build_rocket_batch(B)
    g = jnp.asarray(guesses)
    _, first = _timed(lambda: bts.solve(guess=g))
    r, warm = _timed(lambda: bts.solve(guess=g))
    solved = int(np.asarray(r.state.solved).sum())
    x = np.asarray(r.state.p.x)[lanes]
    x64, x32 = np.asarray(ref64.get()["rocket_x"]), np.asarray(ref32.get()["rocket_x"])
    err64 = np.abs(x - x64).max(axis=1)
    bound64 = X_RTOL * np.maximum(1.0, np.abs(x64).max(axis=1))
    err32 = float(np.abs(x - x32).max())
    info = {"backend": bts.options.linear_solver, "first_call_s": first, "warm_s": warm,
            "solved": f"{solved}/{B}", **_counters(r.state), "lanes": len(lanes),
            "x_maxabs_vs_cpu_f64": err64.tolist(), "bound_vs_cpu_f64": bound64.tolist(),
            "x_maxabs_vs_cpu_f32": err32,
            "iters_lanes_gpu": np.asarray(r.state.total_i)[lanes].tolist(),
            "iters_lanes_cpu_f32": ref32.get()["rocket_iters"],
            "iters_lanes_cpu_f64": ref64.get()["rocket_iters"]}
    _check(info, solved == B, f"rocket batch {solved}/{B} solved")
    _check(info, bool((err64 <= bound64).all()),
           f"rocket lanes differ from CPU f64 by {err64.max():.3e}")
    _check(info, err32 <= X_ATOL, f"rocket lanes differ from CPU f32 by {err32:.3e}")
    return info


def phase_quadruped_batch(B=QUAD_B):

    bts, ts, x0 = bench.build_quadruped_batch(B)
    th = jnp.asarray(x0)
    # cold start split: Python tracing, then XLA compilation; the solves
    # then run the compiled program through the public solve()
    t0 = time.perf_counter()
    lowered = bts._batched.lower(*bts._example_args(B, th.shape[1]))
    trace_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bts._batched = lowered.compile()
    compile_s = time.perf_counter() - t0
    _, first = _timed(lambda: bts.solve(parameters=th))
    r, warm = _timed(lambda: bts.solve(parameters=th))
    solved = int(np.asarray(r.state.solved).sum())
    dmax = max(nx + nu for nx, nu in zip(ts.num_states, ts.num_actions))
    info = {"backend": bts.options.linear_solver, "stage_block_d": dmax,
            "trace_s": trace_s, "compile_s": compile_s, "first_run_s": first,
            "warm_s": warm, "solved": f"{solved}/{B}", **_counters(r.state)}
    _check(info, solved == B, f"quadruped {solved}/{B} solved")
    return info


def phase_rocket101():

    gold = np.load(os.path.join(REPO, "tests", "golden", "rocket101.npz"))
    ts, guess = bench.build_rocket101()
    ts.solver.initialize(jnp.asarray(guess))
    _, first = _timed(lambda: ts.solve())
    r, warm = _timed(lambda: ts.solve())
    states = lambda z: np.concatenate([np.asarray(z)[idx] for idx in ts._state_indices])
    err = float(np.abs(states(r.variables) - states(gold["variables"])).max())
    info = {"backend": ts.solver.options.linear_solver, "first_call_s": first,
            "warm_s": warm, "solved": f"{int(r.solved)}/1", **_counters(r.state),
            "states_maxabs_vs_golden_f64": err, "golden_iterations": int(gold["iterations"])}
    _check(info, bool(r.solved), "rocket101 not solved")
    _check(info, err <= X_ATOL, f"rocket101 states differ from the golden by {err:.3e}")
    return info


def phase_differentiate_batch(ref64, B=DIFF_B, lanes=DIFF_LANES):

    bts, _, ts = bench.build(differentiate=True)
    th = jnp.asarray(bench.pendulum_scenarios(B))
    _, first = _timed(lambda: bts.solve(parameters=th))
    r, warm = _timed(lambda: bts.solve(parameters=th))
    solved = int(np.asarray(r.state.solved).sum())
    sens = np.asarray(r.sensitivity[:, : ts.num_variables, :])[lanes]
    ref = np.asarray(ref64.get()["sens"])
    scale = np.abs(ref).reshape(len(lanes), -1).max(axis=1)
    rel = float((np.abs(sens - ref).reshape(len(lanes), -1).max(axis=1) / scale).max())
    info = {"first_call_s": first, "warm_s": warm, "solved": f"{solved}/{B}",
            **_counters(r.state), "sens_rel_err_vs_cpu_f64": rel, "sens_rtol": SENS_RTOL,
            "finite": bool(np.isfinite(np.asarray(r.sensitivity)).all())}
    _check(info, solved == B, f"differentiable batch {solved}/{B} solved")
    _check(info, info["finite"], "non-finite sensitivities")
    _check(info, rel <= SENS_RTOL, f"sensitivities differ from CPU f64 by {rel:.3e} (relative)")
    return info


# ---- four cards ---------------------------------------------------------------


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def phase_sharded_pendulum(mesh, B=PEND_B):

    bts, _, ts = bench.build()
    th = bench.pendulum_scenarios(B).astype(np.float32)
    guess = np.broadcast_to(np.asarray(ts._guess, np.float32), (B, ts.num_variables))
    shard = NamedSharding(mesh, P("batch"))
    th_s, g_s = jax.device_put(th, shard), jax.device_put(guess, shard)
    _, first = _timed(lambda: bts.solve(parameters=th_s, guess=g_s, mesh=mesh))
    rs, warm = _timed(lambda: bts.solve(parameters=th_s, guess=g_s, mesh=mesh))
    x = rs.state.p.x
    devices = {d.id for d in x.sharding.device_set}
    rows = sorted(s.data.shape[0] for s in x.addressable_shards)
    one = jax.devices()[0]
    th1, g1 = jax.device_put(th, one), jax.device_put(guess, one)
    _, first1 = _timed(lambda: bts.solve(parameters=th1, guess=g1))
    r1, warm1 = _timed(lambda: bts.solve(parameters=th1, guess=g1))
    n = mesh.devices.size
    solved = int(np.asarray(rs.state.solved).sum())
    err = float(np.abs(np.asarray(x) - np.asarray(r1.state.p.x)).max())
    info = {"devices": len(devices), "rows_per_device": rows, "first_call_s": first,
            "warm_s": warm, "one_card_first_call_s": first1, "one_card_warm_s": warm1,
            "solved": f"{solved}/{B}", **_counters(rs.state),
            "x_maxabs_vs_one_card": err,
            "iters_equal": bool(np.array_equal(rs.state.total_i, r1.state.total_i))}
    _check(info, len(devices) == n and rows == [B // n] * n,
           f"solution not spread over {n} devices: {rows}")
    _check(info, solved == B, f"sharded pendulum {solved}/{B} solved")
    _check(info, err <= X_ATOL, f"sharded lanes differ from one card by {err:.3e}")
    return info


def phase_sharded_autotuning(mesh, one_mesh, B=DIFF_B):

    _, _, ts = bench.build(differentiate=True)
    th = bench.pendulum_scenarios(B).astype(np.float32)
    guess = np.asarray(ts._guess, np.float32)
    out = {}
    for tag, m in (("sharded", mesh), ("one_card", one_mesh)):
        step = ge.autotuning_step(ts, m, B)
        args = (jax.device_put(th, NamedSharding(m, P("batch"))),
                jax.device_put(guess, NamedSharding(m, P())))
        _, first = _timed(lambda: step(*args))
        (loss, grad, ok), warm = _timed(lambda: step(*args))
        out[tag] = dict(loss=float(loss), grad=np.asarray(grad), ok=int(ok),
                        first_call_s=first, warm_s=warm)
    s, o = out["sharded"], out["one_card"]
    info = {"batch": B, "devices": mesh.devices.size, "first_call_s": s["first_call_s"],
            "warm_s": s["warm_s"], "one_card_warm_s": o["warm_s"],
            "solved": f"{s['ok']}/{B}", "loss": s["loss"], "loss_one_card": o["loss"],
            "loss_rel_diff": _rel(s["loss"], o["loss"]),
            "grad_rel_diff": _rel(s["grad"], o["grad"]), "rtol": SHARD_RTOL}
    _check(info, s["ok"] == B and o["ok"] == B, f"auto-tuning solves {s['ok']}, {o['ok']} of {B}")
    _check(info, info["loss_rel_diff"] <= SHARD_RTOL and info["grad_rel_diff"] <= SHARD_RTOL,
           "sharded auto-tuning step differs from one card")
    return info


def phase_spike(devices, horizon=SPIKE_HORIZON):

    prob = rocket.landing_problem(horizon=horizon)
    kw = {k: v for k, v in prob.items()
          if k not in ("state_guess", "state_initial", "state_goal")}
    mesh_h = Mesh(np.array(devices), axis_names=("horizon",))
    out = {}
    for tag, extra in (("spike", dict(linear_solver="spike", spike_mesh=mesh_h)),
                       ("riccati", dict(linear_solver="riccati"))):
        ts = TrajOptSolver(options=bench._tol_options(max_iterative_refinement=2, **extra), **kw)
        ts.initialize_states([np.asarray(s) for s in prob["state_guess"]])
        _, first = _timed(lambda: ts.solve())
        r, warm = _timed(lambda: ts.solve())
        out[tag] = dict(r=r, first=first, warm=warm)
    sp, rc = out["spike"]["r"], out["riccati"]["r"]
    err = float(np.abs(np.asarray(sp.variables) - np.asarray(rc.variables)).max())
    info = {"horizon": horizon, "devices": len(devices),
            "first_call_s": out["spike"]["first"], "warm_s": out["spike"]["warm"],
            "riccati_one_card_warm_s": out["riccati"]["warm"],
            "solved": f"{int(sp.solved)}/1", **_counters(sp.state),
            "riccati_total_i": int(rc.iterations), "x_maxabs_vs_riccati": err}
    _check(info, bool(sp.solved) and bool(rc.solved), "spike or riccati solve failed")
    _check(info, int(sp.iterations) == int(rc.iterations),
           f"spike {int(sp.iterations)} iterations != riccati {int(rc.iterations)}")
    _check(info, err <= X_ATOL, f"spike solution differs from riccati by {err:.3e}")
    return info


# ---- main ---------------------------------------------------------------------


def run_phase(name, fn, results):
    t0 = time.perf_counter()
    try:
        info = fn()
        ok = not info.get("failed_checks")
    except Exception as e:  # every phase runs; any failure fails the script
        traceback.print_exc()
        info, ok = {"error": repr(e)[:500]}, False
    results[name] = (ok, info)
    print(json.dumps({"phase": name, "ok": ok, "phase_s": time.perf_counter() - t0, **info},
                     default=lambda o: o.tolist() if hasattr(o, "tolist") else str(o)),
          flush=True)
    return ok


def main(argv):
    multichip = "--multichip" in argv

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: first device is {dev.platform!r}, not a GPU", file=sys.stderr)
        return 2
    calipso_tpu._maybe_enable_cache()
    for line in bench.nvidia_smi().splitlines():
        print(f"card: {line}")
    print(f"jax {jax.__version__}; devices {len(jax.devices())} x {dev.device_kind}; "
          f"compile cache {jax.config.jax_compilation_cache_dir}", flush=True)

    results = {}
    if multichip:
    
        devs = jax.devices()
        if len(devs) < 4:
            print(f"chip_smoke --multichip: needs 4 GPUs, found {len(devs)}", file=sys.stderr)
            return 2
        devs = devs[:4]
        mesh = Mesh(np.array(devs), axis_names=("batch",))
        one = Mesh(np.array(devs[:1]), axis_names=("batch",))
        run_phase("sharded_pendulum", lambda: phase_sharded_pendulum(mesh), results)
        run_phase("sharded_autotuning", lambda: phase_sharded_autotuning(mesh, one), results)
        run_phase("spike_horizon", lambda: phase_spike(devs), results)
    else:
        ref64, ref32 = Reference("f64"), Reference("f32")
        try:
            run_phase("nlp", phase_nlp, results)
            run_phase("pendulum_batch", lambda: phase_pendulum_batch(ref64, ref32), results)
            run_phase("rocket_batch", lambda: phase_rocket_batch(ref64, ref32), results)
            run_phase("quadruped_batch", phase_quadruped_batch, results)
            run_phase("rocket101", phase_rocket101, results)
            run_phase("differentiate_batch", lambda: phase_differentiate_batch(ref64), results)
            run_phase("factorization", phase_factorization, results)
        finally:
            ref64.stop()
            ref32.stop()
        pend, fact = results["pendulum_batch"], results["factorization"]
        if pend[0] and fact[0]:
            # share of the pendulum solve spent in the T=1 dense
            # factor+solve: XLA's time per (8192, 32, 32) call times the
            # lockstep factorizations (inner iterations + ladder trips)
            ms = fact[1]["shapes"]["8192x1x32"]["ms_per_factor_solve"]
            n_fact = pend[1]["total_i_max"] + pend[1]["num_ladder_max"]
            share = ms / 1e3 * n_fact / pend[1]["warm_s"]
            print(json.dumps({"t1_factor_share_of_pendulum": share, "ms_per_factor_solve": ms,
                              "factorizations": n_fact, "pendulum_warm_s": pend[1]["warm_s"]}),
                  flush=True)
    if not all(ok for ok, _ in results.values()):
        failed = [k for k, (ok, _) in results.items() if not ok]
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind,
                                             "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    if "--cpu-reference" in sys.argv:
        _cpu_reference_main(sys.argv[sys.argv.index("--cpu-reference") + 1])
    else:
        sys.exit(main(sys.argv[1:]))
