"""Planar quadruped: contact-implicit drop and gait (reference
test/examples/quadruped_drop.jl / quadruped_gait.jl, which wrap RoboDojo's
11-DOF planar quadruped; here an analytic JAX model of the same class).

Configuration q (11) = [x, z, pitch, (alpha_i, r_i) x 4]: body pose plus a
swing angle and telescoping length per leg. Foot i sits at
  p_f,i = p_body + R(pitch) @ (hip_i + r_i [sin a_i, -cos a_i]).
Controls (8) = hip torques + leg forces. Contacts: 4 feet with friction
SOC pairs (like the hopper), leg limits as plain inequalities.
Lagrangian derivatives come from jax.grad of L(q, v) with foot velocities
via jax.jvp -- no hand-derived mass matrix.
State: [q1; q2] (22) at t=0, then [q1; q2; gamma(4)] (26); the gait
periodicity + travel rows couple the first and last stages through
`equality_general`, handled by the structured KKT backends as a low-rank
Schur border (the reference instead augments every stage's state with a
carried copy of x_1 -- quadruped_gait.jl `loop` over nx + nc + nx states
-- which widens every stage block 54 -> 76 and costs ~2.8x the
factorization flops).
Action u (28) = [u_ctrl(8); gamma(4); beta(8); eta(8)].
"""

import numpy as np
import jax
import jax.numpy as jnp

MASS_BODY, INERTIA_BODY = 1.0, 0.1
MASS_FOOT = 0.05
HIPS = np.array([0.3, 0.1, -0.1, -0.3])
FOOT_RADIUS = 0.02
GRAVITY = 9.81
MU = 0.8
LEG_MIN, LEG_MAX = 0.15, 0.45
ALPHA_LIM = 0.6
TIMESTEP = 0.05
NQ = 11
NU_CTRL = 8
NU = NU_CTRL + 4 + 8 + 8  # 28


def foot_positions(q):
    """All four foot positions at once, (4, 2). Vectorizing the foot
    axis (instead of a Python loop of per-foot scalar chains) shrinks
    the dynamics jaxpr ~4x -- and the LAGRANGIAN HESSIAN the solver
    differentiates through it by the cube of that: the batched oracle is
    op-COUNT-bound, not flop-bound."""
    c, s = jnp.cos(q[2]), jnp.sin(q[2])
    R = jnp.array([[c, -s], [s, c]])
    a, r = q[3::2], q[4::2]  # (4,) swing angles / leg lengths
    local = jnp.stack(
        [jnp.asarray(HIPS, q.dtype) + r * jnp.sin(a), -r * jnp.cos(a)], axis=1
    )  # (4, 2)
    return q[:2][None, :] + local @ R.T


def foot_position(q, i):
    return foot_positions(q)[i]


_foot_jacs = jax.jacfwd(foot_positions)  # (4, 2, 11)


def mass_matrix(q):
    """M(q) = body diag + sum_i m_f J_i' J_i (identical to the kinetic
    energy of point feet; explicit form keeps the autodiff graph shallow
    -- the nested-jvp Lagrangian tripled XLA compile times). One jacfwd
    over the stacked foot map instead of four."""
    M = jnp.diag(jnp.array([MASS_BODY, MASS_BODY, INERTIA_BODY] + [0.0] * 8))
    J = _foot_jacs(q)  # (4, 2, 11)
    return M + MASS_FOOT * jnp.einsum("fij,fik->jk", J, J)


def lagrangian(q, v):
    pe = MASS_BODY * GRAVITY * q[1] + MASS_FOOT * GRAVITY * jnp.sum(
        foot_positions(q)[:, 1]
    )
    return 0.5 * v @ (mass_matrix(q) @ v) - pe


_D1L = jax.grad(lagrangian, argnums=0)
_D2L = jax.grad(lagrangian, argnums=1)


def signed_distance(q):
    return foot_positions(q)[:, 1] - FOOT_RADIUS


def foot_jacobian(q, i):
    return _foot_jacs(q)[i]


def contact_impulse(q, gamma, beta):
    J = _foot_jacs(q)  # (4, 2, 11): rows (x, z) per foot
    w = jnp.stack([beta[1::2], gamma], axis=1)  # (4, 2)
    return jnp.einsum("fij,fi->j", J, w)


def control_map(u_ctrl):
    """Hip torques act on alpha DOFs, leg forces on r DOFs -- the
    (alpha_i, r_i) DOFs are contiguous at q[3:11] in control order."""
    return jnp.concatenate([jnp.zeros((3,), u_ctrl.dtype), u_ctrl])


def variational_dynamics(h, q0, q1, u_ctrl, lam, q2):
    qm1, vm1 = 0.5 * (q0 + q1), (q1 - q0) / h
    qm2, vm2 = 0.5 * (q1 + q2), (q2 - q1) / h
    d = (
        0.5 * h * _D1L(qm1, vm1)
        + _D2L(qm1, vm1)
        + 0.5 * h * _D1L(qm2, vm2)
        - _D2L(qm2, vm2)
    )
    return d + control_map(u_ctrl) + lam


def _dyn_core(y, x, u):
    q1m, q2m = x[0:NQ], x[NQ : 2 * NQ]
    q2p, q3p = y[0:NQ], y[NQ : 2 * NQ]
    gamma, beta = u[8:12], u[12:20]
    lam = contact_impulse(q2p, gamma, beta)
    return jnp.concatenate(
        [q2p - q2m, variational_dynamics(TIMESTEP, q1m, q2p, u[:8], lam, q3p)]
    )


def dynamics(y, x, u):
    # y carries [q2+, q3+, gamma]
    return jnp.concatenate([_dyn_core(y, x, u), y[22:26] - u[8:12]])


def soc_product2(a, b):
    return jnp.array([a @ b, a[0] * b[1] + b[0] * a[1]])


def friction_equality(x, u):
    q2, q3 = x[0:NQ], x[NQ : 2 * NQ]
    gamma, beta, eta = u[8:12], u[12:20], u[20:28]
    v = (q3 - q2) / TIMESTEP
    rows = [MU * gamma - beta[0::2]]  # fc (4)
    vts = []
    for i in range(4):
        _, dp = jax.jvp(lambda qq: foot_position(qq, i), (q3,), (v,))
        vts.append(dp[0] - eta[2 * i + 1])
    rows.append(jnp.stack(vts))  # vc (4)
    for i in range(4):
        rows.append(soc_product2(beta[2 * i : 2 * i + 2], eta[2 * i : 2 * i + 2]))
    return jnp.concatenate(rows)


def _nominal_q(x=0.0):
    q = np.zeros(NQ)
    q[0], q[1] = x, 0.3 + FOOT_RADIUS
    q[2] = 0.0
    for i in range(4):
        q[3 + 2 * i] = 0.0
        q[4 + 2 * i] = 0.3
    return q


def _bounds_rows(x, u):
    q3 = x[NQ : 2 * NQ]
    legs = q3[4::2]
    alphas = q3[3::2]
    return jnp.concatenate(
        [
            legs - LEG_MIN,
            LEG_MAX - legs,
            ALPHA_LIM - alphas,
            alphas + ALPHA_LIM,
            u[:8] + 20.0,
            20.0 - u[:8],
        ]
    )


def drop_problem(horizon=8, drop_height=0.1):
    """Drop from rest above the ground and land (reference
    quadruped_drop.jl): pure contact-implicit dynamics feasibility."""
    q0 = _nominal_q()
    q0[1] += drop_height
    x1 = np.concatenate([q0, q0])
    q_ref = _nominal_q()
    x_ref = np.concatenate([q_ref, q_ref])

    def obj_t(x, u):
        dx = x[: 2 * NQ] - x_ref
        return 0.05 * dx @ dx + 0.5e-2 * (u[:8] @ u[:8])

    def obj_T(x, u):
        dx = x[: 2 * NQ] - x_ref
        return 0.5 * dx @ dx

    objective = [obj_t] * (horizon - 1) + [obj_T]

    def eq_1(x, u):
        return jnp.concatenate([friction_equality(x, u), x[: 2 * NQ] - x1])

    def eq_t(x, u):
        compl = x[22:26] * signed_distance(x[NQ : 2 * NQ])
        return jnp.concatenate([friction_equality(x, u), compl])

    def eq_last(x, u):
        return x[22:26] * signed_distance(x[NQ : 2 * NQ])

    equality = [eq_1] + [eq_t] * (horizon - 2) + [eq_last]

    def ineq_t(x, u):
        return jnp.concatenate(
            [signed_distance(x[NQ : 2 * NQ]), u[8:12], _bounds_rows(x, u)]
        )

    def ineq_last(x, u):
        q3 = x[NQ : 2 * NQ]
        legs, alphas = q3[4::2], q3[3::2]
        return jnp.concatenate(
            [
                signed_distance(q3),
                legs - LEG_MIN,
                LEG_MAX - legs,
                ALPHA_LIM - alphas,
                alphas + ALPHA_LIM,
            ]
        )

    nonnegative = [ineq_t] * (horizon - 1) + [ineq_last]

    soc_stage = [
        (lambda x, u, _i=i: u[12 + 2 * _i : 14 + 2 * _i]) for i in range(4)
    ] + [(lambda x, u, _i=i: u[20 + 2 * _i : 22 + 2 * _i]) for i in range(4)]
    second_order = [soc_stage] * (horizon - 1) + [[]]

    state_guess = [x1] + [
        np.concatenate([x1, np.zeros(4)]) for _ in range(horizon - 1)
    ]
    g_quarter = (MASS_BODY + 4 * MASS_FOOT) * GRAVITY * TIMESTEP / 4.0
    action_guess = [
        np.concatenate(
            [np.zeros(8), g_quarter * np.ones(4), np.tile([0.3, 0.0], 4), np.tile([0.3, 0.0], 4)]
        )
        for _ in range(horizon - 1)
    ]

    return dict(
        objective=objective,
        dynamics=[dynamics] * (horizon - 1),
        num_states=[22] + [26] * (horizon - 1),
        num_actions=[NU] * (horizon - 1),
        equality=equality,
        nonnegative=nonnegative,
        second_order=second_order,
        state_guess=state_guess,
        action_guess=action_guess,
        state_initial=x1,
    )


def gait_problem(horizon=11, travel=0.2):
    """Periodic gait with a travel requirement (reference
    quadruped_gait.jl): the final state repeats the first up to an x-body
    translation of at least `travel`.

    Stage 0 pins only config 1 (x[0:NQ] = q0), leaving config 2 free --
    so the config-2 periodicity and travel rows genuinely couple the
    first and last stages. They ride `equality_general` (reference
    equality_general.jl:29-113 / quadruped_gait.jl `loop`), which the
    structured backends absorb as an 11-row low-rank Schur border; the
    config-1 rows reduce to stage-local constraints against the known q0
    (same split as the hopper, models/hopper.py)."""
    prob = drop_problem(horizon=horizon, drop_height=0.0)
    q0 = _nominal_q()
    q_ref = _nominal_q(x=travel)
    x_ref = np.concatenate([q_ref, q_ref])

    def obj_t(x, u):
        dx = x[: 2 * NQ] - x_ref
        return 0.05 * dx @ dx + 0.5e-2 * (u[:8] @ u[:8])

    def obj_T(x, u):
        dx = x[: 2 * NQ] - x_ref
        return 0.5 * dx @ dx

    prob["objective"] = [obj_t] * (horizon - 1) + [obj_T]

    def eq_1(x, u):
        # pin config 1 only; config 2 is determined by the periodicity
        # border + dynamics (hopper eq_1 analogue)
        return jnp.concatenate([friction_equality(x, u), x[0:NQ] - q0])

    def eq_T(x, u):
        # config-1 periodicity is stage-local: eq_1 pins x_1[0:NQ] = q0,
        # so x_T[1:NQ] - x_1[1:NQ] reduces to x[1:NQ] - q0[1:NQ]
        compl = x[22:26] * signed_distance(x[NQ : 2 * NQ])
        return jnp.concatenate([compl, x[1:NQ] - jnp.asarray(q0)[1:NQ]])

    prob["equality"] = [eq_1] + prob["equality"][1:-1] + [eq_T]

    def ineq_T(x, u):
        # config-1 travel is stage-local too (x_1[0] = q0[0] pinned)
        return jnp.concatenate(
            [
                jnp.array([x[0] - (q0[0] + travel)]),
                signed_distance(x[NQ : 2 * NQ]),
            ]
        )

    prob["nonnegative"] = prob["nonnegative"][:-1] + [ineq_T]

    n_last = 26  # last-stage state width [q1; q2; gamma]

    def equality_general(z, theta):
        # config-2 periodicity (10 rows) + exact config-2 travel (1 row)
        # between the free first-stage config 2 and the last stage
        # (reference quadruped_gait.jl `loop` + the travel inequality,
        # made exact like the hopper border -- it is active at the
        # optimum)
        q2_first = z[NQ : 2 * NQ]
        q2_last = z[z.shape[0] - n_last + NQ : z.shape[0] - n_last + 2 * NQ]
        return jnp.concatenate(
            [
                q2_last[1:NQ] - q2_first[1:NQ],
                q2_last[0:1] - q2_first[0:1] - travel,
            ]
        )

    prob["equality_general"] = equality_general
    return prob


# leg-pair mirror for the half-cycle gait (reference quadruped_gait_v2.jl
# `perm`: body coordinates fixed, the two legs of each pair swap): legs
# (0, 1) at hips (0.3, 0.1) and (2, 3) at hips (-0.1, -0.3)
_MIRROR_IDX = np.array([0, 1, 2, 5, 6, 3, 4, 9, 10, 7, 8])


def mirror_config(q):
    return q[jnp.asarray(_MIRROR_IDX)]


def gait_problem_v2(horizon=11, travel=0.2, t_fix=4):
    """Mirrored half-cycle gait with a foot-pinning stance phase
    (reference examples/contact_implicit/quadruped_gait_v2.jl): for the
    first `t_fix` stages, feet 1 and 3 are pinned to their nominal ground
    positions (per-stage equality, reference pinned1/pinned2); the final
    state must repeat the MIRRORED first state advanced by `travel`
    (reference `loop` with the leg-pair permutation) -- the mirror
    periodicity rides the same 11-row `equality_general` Schur border as
    gait_problem."""
    prob = drop_problem(horizon=horizon, drop_height=0.0)
    q0 = _nominal_q()
    q_ref = _nominal_q(x=travel)
    x_ref = np.concatenate([q_ref, q_ref])
    p_pin = [np.asarray(foot_position(jnp.asarray(q0), i)) for i in (1, 3)]

    def obj_t(x, u):
        dx = x[: 2 * NQ] - x_ref
        return 0.05 * dx @ dx + 0.5e-2 * (u[:8] @ u[:8])

    def obj_T(x, u):
        dx = x[: 2 * NQ] - x_ref
        return 0.5 * dx @ dx

    prob["objective"] = [obj_t] * (horizon - 1) + [obj_T]

    def pinned_feet(q):
        return jnp.concatenate(
            [foot_position(q, i) - jnp.asarray(p) for i, p in zip((1, 3), p_pin)]
        )

    def eq_1(x, u):
        return jnp.concatenate([friction_equality(x, u), x[0:NQ] - q0])

    def eq_fix(x, u):
        # stance phase: feet 1/3 of the current config pinned
        compl = x[22:26] * signed_distance(x[NQ : 2 * NQ])
        return jnp.concatenate(
            [friction_equality(x, u), compl, pinned_feet(x[NQ : 2 * NQ])]
        )

    def eq_t(x, u):
        compl = x[22:26] * signed_distance(x[NQ : 2 * NQ])
        return jnp.concatenate([friction_equality(x, u), compl])

    def eq_T(x, u):
        # config-1 mirrored periodicity is stage-local (x_1[0:NQ] = q0
        # pinned): x_T[1:NQ] = (P q0)[1:NQ]
        compl = x[22:26] * signed_distance(x[NQ : 2 * NQ])
        pq0 = jnp.asarray(q0)[jnp.asarray(_MIRROR_IDX)]
        return jnp.concatenate([compl, x[1:NQ] - pq0[1:NQ]])

    prob["equality"] = (
        [eq_1] + [eq_fix] * (t_fix - 1) + [eq_t] * (horizon - 1 - t_fix) + [eq_T]
    )

    def ineq_T(x, u):
        return jnp.concatenate(
            [
                jnp.array([x[0] - (q0[0] + travel)]),
                signed_distance(x[NQ : 2 * NQ]),
            ]
        )

    prob["nonnegative"] = prob["nonnegative"][:-1] + [ineq_T]

    n_last = 26

    def equality_general(z, theta):
        # mirrored config-2 periodicity + exact config-2 travel between
        # the free first-stage config 2 and the last stage
        q2_first = z[NQ : 2 * NQ]
        q2_last = z[z.shape[0] - n_last + NQ : z.shape[0] - n_last + 2 * NQ]
        pq = mirror_config(q2_first)
        return jnp.concatenate(
            [
                q2_last[1:NQ] - pq[1:NQ],
                q2_last[0:1] - pq[0:1] - travel,
            ]
        )

    prob["equality_general"] = equality_general
    return prob


def mpc_problem(horizon=4):
    """Short-horizon contact-implicit MPC problem for stance stabilization
    (the workload of reference examples/contact_implicit/quadruped_mpc.jl,
    which tracks a CALIPSO-solved gait with ContactImplicitMPC.jl's
    controller; here the controller IS this solver). The measured state
    (q1, q2) enters through the stage-0 parameter so one compiled
    short-horizon contact solve serves every control step — the
    receding-horizon pattern of apps/mpc.py."""
    prob = drop_problem(horizon=horizon, drop_height=0.0)

    def eq_1(x, u, w):
        return jnp.concatenate([friction_equality(x, u), x[: 2 * NQ] - w])

    prob["equality"] = [eq_1] + prob["equality"][1:]
    prob["parameters"] = [np.zeros(2 * NQ)] + [np.zeros(0)] * (horizon - 1)
    return prob
