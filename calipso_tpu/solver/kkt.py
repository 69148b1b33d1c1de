"""KKT residual, condensed system assembly, solve + expansion, and a
matrix-free 6x6-block matvec for iterative refinement.

The primal-dual point is w = (x, r, s, y, z, t):
  x primal variables, r equality slacks (g(x) = r), s cone slacks
  (h(x) = s in K), y equality duals, z cone duals, t cone-slack duals.

6-block residual R(w) (reference src/solver/residual.jl:1-51):
  rx = fx + gx'y + hx'z
  rr = lambda + rho*r - y
  rs = -z - t
  ry = g - r
  rz = h - s
  rt = s o t - kappa*e

Newton system J dw = R with regularization (+eps_p primal / -eps_d dual,
reference residual_jacobian_variables.jl:83-105), condensed by eliminating
(r, s, t) to the symmetric quasidefinite (n + m_e + m_c) system
(reference residual.jl:53-101, residual_jacobian_variables.jl:110-167):

  [ Hxx+eps_p*I      gx'              hx'          ] [dx]   [ rx            ]
  [ gx           (-1/(rho+eps_p)-eps_d)*I   0      ] [dy] = [ ry + rr/(rho+eps_p) ]
  [ hx               0          -eps_d*I - M^-1*Cv ] [dz]   [ rz + M^-1(Cv rs + rt)]

with Cv = arrow(s - eps_d*e), M = arrow(t) + eps_p*Cv, and exact expansion
(reference search_direction.jl:59-101):
  dr = (rr + dy)/(rho+eps_p)
  ds = M^-1 (rt + Cv (rs + dz))
  dt = Cv^-1 (rt - arrow(t) ds)

The update convention is w_new = w - alpha * dw (reference solve.jl:193-326).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from calipso_tpu.ops import cones
from calipso_tpu.ops.ldl import ldl_factor, ldl_solve, inertia_counts


class BandHessian:
    """Lagrangian Hessian in stage-block tridiagonal form (structured
    trajopt backends; built by
    trajopt/structured.py:lagrangian_hessian_blocks): D (T, dmax, dmax)
    diagonal blocks, O (T-1, dmax, dmax) sub-diagonal couplings, Hgen the
    dense equality_general dual Hessian or None (zero -- and folded away
    by XLA -- for linear periodicity constraints), st the StageStructure.
    Never materializes the dense (n, n) Hessian on the factorization
    path: O(T d^2) memory per lane instead of O(n^2).

    Registered as a pytree with `st` as STATIC aux data (identity
    hash/eq -- one StageStructure per problem), so a BandHessian can
    cross jit boundaries: the round-5 trace-dedup wraps the repeated
    factorize/solve/matvec call sites in jax.jit (see solve.make_solve),
    and the Hessian rides through as an ordinary argument."""

    def __init__(self, D, O, Hgen, st):
        self.D = D
        self.O = O
        self.Hgen = Hgen
        self.st = st

    @property
    def dtype(self):
        return self.D.dtype

    @property
    def num_variables(self):
        return self.st.num_variables


jax.tree_util.register_pytree_node(
    BandHessian,
    lambda h: ((h.D, h.O, h.Hgen), h.st),
    lambda st, children: BandHessian(children[0], children[1], children[2], st),
)


def hess_mv(Hxx, v):
    """Hxx @ v for a dense or BandHessian Lagrangian Hessian."""
    if isinstance(Hxx, BandHessian):
        out = Hxx.st.band_matvec(Hxx.D, Hxx.O, v)
        if Hxx.Hgen is not None:
            out = out + Hxx.Hgen @ v
        return out
    return Hxx @ v


def hess_dense(Hxx):
    """Dense (n, n) view of a dense or BandHessian Lagrangian Hessian
    (T static dynamic-update-slice writes; used by the dense backends and
    the rare full-LU fallback)."""
    if isinstance(Hxx, BandHessian):
        H = Hxx.st.densify(Hxx.D, Hxx.O)
        return H + Hxx.Hgen if Hxx.Hgen is not None else H
    return Hxx


class Blocks(NamedTuple):
    """A vector in the 6-block residual/step space."""

    x: jnp.ndarray
    r: jnp.ndarray
    s: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray
    t: jnp.ndarray

    @property
    def all(self):
        return jnp.concatenate(list(self))

    @property
    def primals(self):
        return jnp.concatenate([self.x, self.r, self.s])


def residual(fx, gty_x, htz_x, g, h, cone_prod, cone_target, point, kappa, rho, lam):
    """6-block KKT residual at `point` (reference residual.jl:1-51)."""
    rx = fx + gty_x + htz_x
    rr = lam + rho * point.r - point.y
    rs = -point.z - point.t
    ry = g - point.r
    rz = h - point.s
    rt = cone_prod - kappa * cone_target
    return Blocks(rx, rr, rs, ry, rz, rt)


def condensed_matrix(layout, Hxx, gx, hx, s, t, rho, eps_p, eps_d):
    """Assemble the dense symmetric condensed KKT matrix (see module doc).
    The SOC cone block is mildly nonsymmetric; it is symmetrized here (the
    reference equivalently keeps one triangle for QDLDL) and iterative
    refinement against the exact 6-block operator absorbs the difference."""
    Hxx = hess_dense(Hxx)
    n = Hxx.shape[0]
    me, mc = gx.shape[0], hx.shape[0]
    dtype = Hxx.dtype

    K11 = Hxx + eps_p * jnp.eye(n, dtype=dtype)
    Keq = (-1.0 / (rho + eps_p) - eps_d) * jnp.eye(me, dtype=dtype)
    Kcone = cones.condensed_block(layout, s, t, eps_p, eps_d, dtype)
    Kcone = 0.5 * (Kcone + Kcone.T)

    top = jnp.concatenate([K11, gx.T, hx.T], axis=1)
    mid = jnp.concatenate([gx, Keq, jnp.zeros((me, mc), dtype)], axis=1)
    bot = jnp.concatenate([hx, jnp.zeros((mc, me), dtype), Kcone], axis=1)
    return jnp.concatenate([top, mid, bot], axis=0)


def condensed_rhs(layout, res: Blocks, s, t, rho, eps_p, eps_d):
    """Condense the 6-block residual to the symmetric RHS (reference
    residual.jl:53-101)."""
    req = res.y + res.r / (rho + eps_p)
    if s.shape[0] == 0:
        # mc == 0: skip the zero-size cone ops entirely (XLA CPU
        # miscompiles callback-bearing while loops whose bodies carry
        # folded zero-size custom computations)
        return jnp.concatenate([res.x, req, res.z])
    e = layout.target(res.x.dtype)
    v = s - eps_d * e
    w = t + eps_p * v
    rcone = res.z + cones.arrow_solve(layout, w, cones.product(layout, v, res.s) + res.t)
    return jnp.concatenate([res.x, req, rcone])


def expand(layout, res: Blocks, d_sym, n, me, mc, s, t, rho, eps_p, eps_d):
    """Recover (dr, ds, dt) from the condensed solution exactly (reference
    search_direction.jl:59-101)."""
    dx = d_sym[:n]
    dy = d_sym[n : n + me]
    dz = d_sym[n + me :]
    dr = (res.r + dy) / (rho + eps_p)
    if mc == 0:
        return Blocks(dx, dr, res.s, dy, dz, res.t)
    e = layout.target(res.x.dtype)
    v = s - eps_d * e
    w = t + eps_p * v
    ds = cones.arrow_solve(
        layout, w, res.t + cones.product(layout, v, res.s + dz)
    )
    dt = cones.arrow_solve(layout, v, res.t - cones.product(layout, t, ds))
    return Blocks(dx, dr, ds, dy, dz, dt)


def matvec(layout, Hxx, gx, hx, s, t, rho, eps_p, eps_d, d: Blocks) -> Blocks:
    """Exact regularized 6-block Jacobian-vector product J @ d, matrix-free
    (replaces the reference's assembled sparse jacobian_variables for
    iterative refinement, iterative_refinement.jl:1-53)."""
    orr = (rho + eps_p) * d.r - d.y
    oy = gx @ d.x - d.r - eps_d * d.y
    if s.shape[0] == 0:
        ox = hess_mv(Hxx, d.x) + eps_p * d.x + gx.T @ d.y
        return Blocks(ox, orr, d.s, oy, d.z, d.t)
    e = layout.target(d.x.dtype)
    v = s - eps_d * e
    ox = hess_mv(Hxx, d.x) + eps_p * d.x + gx.T @ d.y + hx.T @ d.z
    os = eps_p * d.s - d.z - d.t
    oz = hx @ d.x - d.s - eps_d * d.z
    ot = cones.product(layout, t, d.s) + cones.product(layout, v, d.t)
    return Blocks(ox, orr, os, oy, oz, ot)


def full_matrix(layout, Hxx, gx, hx, s, t, rho, eps_p, eps_d):
    """Dense regularized 6-block KKT matrix (reference
    residual_jacobian_variables.jl:1-108). Used by the "lu" backend -- the
    reference's :LU / ILU0 non-symmetric path (search_direction.jl:106-119)
    for problems where the condensed symmetric path struggles."""
    Hxx = hess_dense(Hxx)
    n = Hxx.shape[0]
    me, mc = gx.shape[0], hx.shape[0]
    dt = Hxx.dtype
    Ieq = jnp.eye(me, dtype=dt)
    Ic = jnp.eye(mc, dtype=dt)
    Cs = cones.dense_arrow(layout, t)
    Ct = cones.dense_arrow(layout, s) - eps_d * Ic
    Z = lambda a, b: jnp.zeros((a, b), dt)
    rows = [
        [Hxx + eps_p * jnp.eye(n, dtype=dt), Z(n, me), Z(n, mc), gx.T, hx.T, Z(n, mc)],
        [Z(me, n), (rho + eps_p) * Ieq, Z(me, mc), -Ieq, Z(me, mc), Z(me, mc)],
        [Z(mc, n), Z(mc, me), eps_p * Ic, Z(mc, me), -Ic, -Ic],
        [gx, -Ieq, Z(me, mc), -eps_d * Ieq, Z(me, mc), Z(me, mc)],
        [hx, Z(mc, me), -Ic, Z(mc, me), -eps_d * Ic, Z(mc, mc)],
        [Z(mc, n), Z(mc, me), Cs, Z(mc, me), Z(mc, mc), Ct],
    ]
    return jnp.concatenate([jnp.concatenate(r, axis=1) for r in rows], axis=0)


def lu_solve_full(layout, Hxx, gx, hx, s, t, rho, eps_p, eps_d, res: Blocks) -> Blocks:
    """Solve the full 6-block system with dense LU."""
    Hxx = hess_dense(Hxx)
    n = Hxx.shape[0]
    me, mc = gx.shape[0], hx.shape[0]
    J = full_matrix(layout, Hxx, gx, hx, s, t, rho, eps_p, eps_d)
    rhs = res.all
    vec = rhs.ndim == 1
    sol = jnp.linalg.solve(J, rhs if not vec else rhs[:, None])
    sol = sol[:, 0] if vec else sol
    o = np.cumsum([0, n, me, mc, me, mc, mc])
    return Blocks(*(sol[o[i] : o[i + 1]] for i in range(6)))


class Factorization(NamedTuple):
    """Factorization of the condensed system plus the context needed to
    apply it. Backends (static choice via Options.linear_solver; "auto"
    resolves to riccati for trajopt, else schur):

    * "ldl":     dense unpivoted LDL^T of the full (n+m_e+m_c) condensed
                 matrix; exact inertia from sign(D). Reference-faithful
                 (QDLDL analogue).
    * "schur":   one more Schur complement onto the primal block,
                 S = W + eps_p*I + gx' Ceq^-1 gx + hx' Ccone^-1 hx,
                 factorized by XLA's blocked Cholesky -- the dense fast
                 path. Correct inertia <=> S is PD <=> the Cholesky is
                 finite (inertia(K) = inertia(-C) + inertia(S), C PD).
    * "riccati": same S in stage-block tridiagonal form, factorized by a
                 lax.scan block-Cholesky sweep (ops/riccati.py); O(T d^3)
                 per factorization. Trajopt only (needs stage structure).
                 General-equality rows (gait periodicity etc., reference
                 equality_general.jl:29-113) are handled as a low-rank
                 Schur-complement border: S = S_band + Jg' Jg / c_eq with
                 Jg the r_g dense coupling rows, solved by Woodbury
                 through r_g extra banded solves (SURVEY.md section 7
                 step 7).
    * "cr":      same stage-block tridiagonal S, factorized by parallel
                 block cyclic reduction (ops/cyclic_reduction.py):
                 O(log T) sequential depth, every level a batched
                 Cholesky/matmul over all odd stages -- the
                 parallel-in-time backend for long horizons. Trajopt
                 only; same low-rank border for equality_general.
    * "lu":      steps from dense LU of the full 6-block system
                 (lu_solve_full); the ladder still runs on "schur".
    * "spike":   same stage-block tridiagonal S with the HORIZON sharded
                 over a device-mesh axis (ops/spike.py partitioned
                 Schur-complement elimination): each device factors its
                 chunk's interior locally, the P separators form a tiny
                 replicated Schur system assembled with one all_gather
                 across devices. The CP-like axis of SURVEY.md section 5 --
                 for single solves whose horizon outgrows one chip.
                 Trajopt only; same low-rank border for equality_general.
    """

    L: jnp.ndarray  # ldl: unit-lower; schur: chol(S); riccati: (T,d,d) chols
    d: jnp.ndarray  # ldl: pivots of D; otherwise empty
    M: jnp.ndarray  # riccati: (T-1,d,d) coupling factors; otherwise empty
    gx: jnp.ndarray
    hx: jnp.ndarray
    s: jnp.ndarray
    t: jnp.ndarray
    rho: jnp.ndarray
    eps_p: jnp.ndarray
    eps_d: jnp.ndarray
    # cr: (levels, L_final) from ops/cyclic_reduction.factor; () otherwise
    cr: tuple = ()
    # low-rank general-equality border (riccati/cr with equality_general,
    # see _general_border): Wg = S_bd^{-1} V (n, k*r_g), (Lc, dc) =
    # (eigenvectors, eigenvalues) of the indefinite capacitance
    # C = Kx^{-1} + V' S_bd^{-1} V (eigh: C is tiny and saddle-structured,
    # so unpivoted LDL^T would hit zero pivots)
    Wg: jnp.ndarray = None
    Lc: jnp.ndarray = None
    dc: jnp.ndarray = None
    # spike: sharded factorization pytree from ops/spike.factor_sharded
    spike: dict = None


def _ceq(fact):
    """Diagonal of the condensed equality block (positive)."""
    return 1.0 / (fact.rho + fact.eps_p) + fact.eps_d


def _banded_solve_multi(structure, method, L, M, cr, B, spike=None, mesh=None, axis=None):
    """Apply S_band^{-1} to columns of B (n, k) through the stage-block
    tridiagonal factorization of the chosen backend."""
    Bb = jax.vmap(structure.to_blocks, in_axes=1, out_axes=2)(B)
    if method == "riccati":
        from calipso_tpu.ops import riccati as rc

        X = rc.solve_multi(L, M, Bb)
    elif method == "spike":
        from calipso_tpu.ops import spike as sp

        X = sp.solve_fact(spike, Bb, mesh, axis)
    else:
        from calipso_tpu.ops import cyclic_reduction as crd

        X = crd.solve_multi(cr, Bb)
    return jax.vmap(structure.from_blocks, in_axes=2, out_axes=1)(X)


def _border_V(structure, gx):
    """Stage-split border columns for the general-equality rows.

    The r_g general rows Jg (last rows of gx, dense over the whole
    trajectory -- reference equality_general.jl:29-113) touch the k =
    len(general_stages) stages detected at construction. Splitting
    Jg' = sum_t V_t with V_t = Jg' masked to stage t's variable rows,

        Jg' Jg = sum_t V_t V_t'  +  sum_{t != t'} V_t V_t'

    The first (block-diagonal) part is PSD and banded -- it is folded into
    the stage blocks by _riccati_blocks. The cross part is the low-rank
    border V Kx V' with V = [V_1 .. V_k] (n, k*r_g) and
    Kx = ((11' - I) kron I_rg) / c_eq, returned here as V."""
    rg = structure.num_general
    n = gx.shape[1]
    JgT = gx[gx.shape[0] - rg :].T  # (n, rg)
    cols = []
    for t in structure.general_stages:
        lo = structure.col_starts[t]
        hi = lo + structure.col_dims[t]
        mask = jnp.zeros((n, 1), gx.dtype).at[lo:hi].set(1.0)
        cols.append(JgT * mask)
    return jnp.concatenate(cols, axis=1)


def _general_border(
    structure, method, L, M, cr, gx, rho, eps_p, eps_d, spike=None, mesh=None, axis=None
):
    """Border factorization for S = S_bd + V Kx V' (see _border_V; S_bd is
    the banded part including the folded block-diagonal of Jg'Jg/c_eq).

    Woodbury with the indefinite core Kx:
      S^{-1} b = S_bd^{-1} b - Wg C^{-1} V' S_bd^{-1} b,
      Wg = S_bd^{-1} V,  C = Kx^{-1} + V' Wg,
    with C factorized by dense LDL^T (it is indefinite by design). By
    Haynsworth, S is PD iff S_bd is PD and inertia(C) = (r_g, (k-1) r_g, 0)
    -- the exact structured-backend replacement for QDLDL's sign(D)
    inertia readout (reference linear_solver.jl:33-44)."""
    rg = structure.num_general
    k = len(structure.general_stages)
    ceq = 1.0 / (rho + eps_p) + eps_d
    V = _border_V(structure, gx)
    Wg = _banded_solve_multi(structure, method, L, M, cr, V, spike, mesh, axis)
    # Kx^{-1} = c_eq * ((11'-I)^{-1} kron I_rg), (11'-I)^{-1} = J/(k-1) - I
    Jk = jnp.ones((k, k), gx.dtype) / (k - 1) - jnp.eye(k, dtype=gx.dtype)
    Kx_inv = ceq * jnp.kron(Jk, jnp.eye(rg, dtype=gx.dtype))
    C = Kx_inv + V.T @ Wg
    C = 0.5 * (C + C.T)
    dc, Lc = jnp.linalg.eigh(C)
    return Wg, Lc, dc


def factorize(
    layout, Hxx, gx, hx, s, t, rho, eps_p, eps_d, method="ldl", structure=None,
    mesh=None, axis=None,
):
    rho = jnp.asarray(rho, Hxx.dtype)
    dt = Hxx.dtype
    e0 = jnp.zeros((0,), dt)
    e3 = jnp.zeros((0, 0, 0), dt)
    if method == "spike":
        assert structure is not None, "spike backend needs trajopt stage structure"
        assert mesh is not None and axis is not None, "spike backend needs mesh+axis"
        D, O = _riccati_blocks(layout, structure, Hxx, gx, hx, s, t, rho, eps_p, eps_d)
        from calipso_tpu.ops import spike as sp

        sf = sp.factor_sharded(D, O, mesh, axis)
        Wg = Lc = dc = None
        if structure.num_general and len(structure.general_stages) >= 2:
            Wg, Lc, dc = _general_border(
                structure, method, e3, e3, (), gx, rho, eps_p, eps_d, sf, mesh, axis
            )
        return Factorization(
            e3, e0, e3, gx, hx, s, t, rho, eps_p, eps_d,
            Wg=Wg, Lc=Lc, dc=dc, spike=sf,
        )
    if method == "ldl":
        K = condensed_matrix(layout, Hxx, gx, hx, s, t, rho, eps_p, eps_d)
        L, dvec = ldl_factor(K)
        return Factorization(L, dvec, e3, gx, hx, s, t, rho, eps_p, eps_d)
    if method == "riccati":
        assert structure is not None, "riccati backend needs trajopt stage structure"
        D, O = _riccati_blocks(layout, structure, Hxx, gx, hx, s, t, rho, eps_p, eps_d)
        from calipso_tpu.ops import riccati as rc

        L, M = rc.factor(D, O)
        Wg = Lc = dc = None
        if structure.num_general and len(structure.general_stages) >= 2:
            Wg, Lc, dc = _general_border(structure, method, L, M, (), gx, rho, eps_p, eps_d)
        return Factorization(L, e0, M, gx, hx, s, t, rho, eps_p, eps_d, Wg=Wg, Lc=Lc, dc=dc)
    if method == "cr":
        assert structure is not None, "cr backend needs trajopt stage structure"
        D, O = _riccati_blocks(layout, structure, Hxx, gx, hx, s, t, rho, eps_p, eps_d)
        from calipso_tpu.ops import cyclic_reduction as crd

        fact_cr = crd.factor(D, O)
        Wg = Lc = dc = None
        if structure.num_general and len(structure.general_stages) >= 2:
            Wg, Lc, dc = _general_border(
                structure, method, e3, e3, fact_cr, gx, rho, eps_p, eps_d
            )
        return Factorization(
            e3, e0, e3, gx, hx, s, t, rho, eps_p, eps_d, fact_cr, Wg=Wg, Lc=Lc, dc=dc
        )
    assert method == "schur", method
    Hxx = hess_dense(Hxx)
    n = Hxx.shape[0]
    ceq = 1.0 / (rho + eps_p) + eps_d
    S = Hxx + eps_p * jnp.eye(n, dtype=dt)
    if gx.shape[0] > 0:
        S = S + gx.T @ (gx / ceq)
    if hx.shape[0] > 0:
        Cinv_hx = cones.c_block_solve(layout, s, t, eps_p, eps_d, hx)
        S = S + hx.T @ Cinv_hx
    S = 0.5 * (S + S.T)
    L = jnp.linalg.cholesky(S)
    return Factorization(L, e0, e3, gx, hx, s, t, rho, eps_p, eps_d)


def _riccati_blocks(layout, st, Hxx, gx, hx, s, t, rho, eps_p, eps_d):
    """Assemble the stage-block tridiagonal form of the primal Schur
    complement S (see Factorization doc) with batched gathers + einsums:
    spans of equal shape are stacked and processed in one vectorized op, so
    tracing is O(#span groups), not O(T). Padded index slots read zero and
    the padded diagonal is restored to identity so ragged stages decouple
    exactly. O(T d^2 r) work; no O(n^2 m) matmuls, no dense S.

    Hxx may be a BandHessian (direct stage-block assembly, no dense
    Hessian ever built -- the structured-backend default) or a dense
    (n, n) array (gathered into blocks here)."""
    dt = Hxx.dtype
    T, dmax = st.horizon, st.dmax
    n = st.num_variables
    ceq = 1.0 / (rho + eps_p) + eps_d
    Chx = (
        cones.c_block_solve(layout, s, t, eps_p, eps_d, hx)
        if hx.shape[0] > 0
        else hx
    )

    blk = jnp.asarray(st.blk_idx)  # (T, dmax), sentinel n on padding
    if isinstance(Hxx, BandHessian):
        D, O = Hxx.D, Hxx.O
        if Hxx.Hgen is not None:
            # equality_general curvature: band part folds into the blocks
            # (the off-band remainder is absorbed by iterative refinement,
            # exactly like the dense path's band gather)
            Hp = jnp.pad(Hxx.Hgen, ((0, 1), (0, 1)))
            D = D + Hp[blk[:, :, None], blk[:, None, :]]
            if T > 1:
                O = O + Hp[blk[1:, :, None], blk[:-1, None, :]]
    else:
        Hp = jnp.pad(Hxx, ((0, 1), (0, 1)))
        D = Hp[blk[:, :, None], blk[:, None, :]]  # (T, dmax, dmax)
        O = (
            Hp[blk[1:, :, None], blk[:-1, None, :]]
            if T > 1
            else jnp.zeros((0, dmax, dmax), dt)
        )
    # padded diagonal -> 1, real diagonal += eps_p
    pad_mask = jnp.asarray(st.blk_idx == n)  # (T, dmax)
    diag_add = jnp.where(pad_mask, 1.0, eps_p)
    D = D + jax.vmap(jnp.diag)(diag_add.astype(dt))

    def grouped(spans, key_fn):
        table = {}
        for sp in spans:
            table.setdefault(key_fn(sp), []).append(sp)
        return table.values()

    def span_block(M, sp, stage):
        """(r, dmax) block of M for one span x one stage, by STATIC row
        and column slices (span rows are contiguous, stage columns are
        contiguous): no elementwise gather, whose lowering serializes."""
        cs, dcol = st.col_starts[stage], st.col_dims[stage]
        blkm = M[sp.row_start : sp.row_start + sp.num_rows, cs : cs + dcol]
        return jnp.pad(blkm, ((0, 0), (0, st.dmax - dcol)))

    for group in grouped(
        st.eq_spans, lambda sp: (sp.num_rows, sp.two_stage, st.col_dims[sp.stage], sp.next_width)
    ):
        t_idx = jnp.asarray(np.array([sp.stage for sp in group]))
        J1 = jnp.stack([span_block(gx, sp, sp.stage) for sp in group])  # (G, r, dmax)
        D = D.at[t_idx].add(jnp.einsum("grw,grv->gwv", J1, J1) / ceq)
        if group[0].two_stage:
            J2 = jnp.stack([span_block(gx, sp, sp.stage + 1) for sp in group])
            D = D.at[t_idx + 1].add(jnp.einsum("grw,grv->gwv", J2, J2) / ceq)
            O = O.at[t_idx].add(jnp.einsum("grw,grv->gwv", J2, J1) / ceq)

    # block-diagonal fold of the general-equality Gram Jg'Jg/c_eq (the
    # banded, PSD part of the border split -- see _border_V): keeps the
    # boundary-condition curvature in the band so the inertia ladder does
    # not over-regularize
    rg = st.num_general
    if rg and st.general_stages:
        Jg = gx[gx.shape[0] - rg :]
        tg_idx = jnp.asarray(np.array(st.general_stages))
        G = jnp.stack(
            [
                jnp.pad(
                    Jg[:, st.col_starts[t] : st.col_starts[t] + st.col_dims[t]],
                    ((0, 0), (0, st.dmax - st.col_dims[t])),
                )
                for t in st.general_stages
            ],
            axis=1,
        )  # (rg, k, dmax)
        D = D.at[tg_idx].add(jnp.einsum("rkw,rkv->kwv", G, G) / ceq)

    if hx.shape[0]:
        for group in grouped(
            st.cone_spans, lambda sp: (sp.num_rows, st.col_dims[sp.stage])
        ):
            t_idx = jnp.asarray(np.array([sp.stage for sp in group]))
            J = jnp.stack([span_block(hx, sp, sp.stage) for sp in group])
            Jc = jnp.stack([span_block(Chx, sp, sp.stage) for sp in group])
            b = jnp.einsum("grw,grv->gwv", J, Jc)
            D = D.at[t_idx].add(0.5 * (b + jnp.swapaxes(b, 1, 2)))

    return D, O


def _apply_border(fact: Factorization, structure, dx):
    """Woodbury correction for the general-equality border:
    dx <- dx - Wg C^{-1} V' dx (no-op without a border)."""
    if fact.Wg is None:
        return dx
    V = _border_V(structure, fact.gx)
    w = fact.Lc.T @ (V.T @ dx)
    w = w / (fact.dc[:, None] if w.ndim == 2 else fact.dc)
    return dx - fact.Wg @ (fact.Lc @ w)


def _border_inertia_ok(fact: Factorization, structure):
    """Border part of the inertia test: inertia(C) = (r_g, (k-1) r_g, 0)
    (Haynsworth; see _general_border). Eigenvalues within a dtype-scaled
    band of zero count as zero eigenvalues."""
    if fact.Lc is None:
        return jnp.asarray(True)
    rg = structure.num_general
    k = len(structure.general_stages)
    tol = jnp.finfo(fact.dc.dtype).eps ** 0.75 * jnp.max(jnp.abs(fact.dc))
    pos = jnp.sum(fact.dc > tol)
    neg = jnp.sum(fact.dc < -tol)
    return (pos == rg) & (neg == (k - 1) * rg)


def inertia_ok(fact: Factorization, n, me, mc, method="ldl", structure=None):
    """Target inertia (n positive, m_e+m_c negative, 0 zero) -- reference
    inertia.jl:7-11. The schur/riccati backends read it off Cholesky
    success, plus the border capacitance inertia when a general-equality
    border is present."""
    if method == "cr":
        from calipso_tpu.ops import cyclic_reduction as crd

        return crd.factors_finite(fact.cr) & _border_inertia_ok(fact, structure)
    if method == "riccati":
        return jnp.all(jnp.isfinite(fact.L)) & _border_inertia_ok(fact, structure)
    if method == "spike":
        from calipso_tpu.ops import spike as sp

        return sp.factors_finite(fact.spike) & _border_inertia_ok(fact, structure)
    if method == "schur":
        return jnp.all(jnp.isfinite(fact.L))
    pos, neg, zero = inertia_counts(fact.d)
    return (pos == n) & (neg == me + mc) & (zero == 0)


def _tiny_pivots(diags):
    """Count Cholesky pivots below a dtype-scaled relative threshold --
    the rank-deficiency signal of the Cholesky backends (QDLDL reads the
    same thing off sign(D) = 0, reference linear_solver.jl:33-44). NaN/Inf
    pivots (failed factorization) do not count: the inertia ladder handles
    those through inertia_ok instead."""
    a = jnp.abs(diags)
    finite = jnp.isfinite(a)
    amax = jnp.max(jnp.where(finite, a, 0.0))
    thr = jnp.asarray(jnp.finfo(diags.dtype).eps, diags.dtype) ** 0.75 * amax
    return jnp.sum(finite & (a <= thr)).astype(jnp.int32)


def num_zero_eigs(fact: Factorization, method="ldl", structure=None):
    """Zero-eigenvalue count for the IC-2 rank-deficiency branch
    (reference inertia.jl:41-47). ldl reads it exactly from sign(D); the
    Cholesky backends (schur/riccati/cr) detect near-rank-deficiency as
    pivots that collapsed below a dtype-scaled threshold."""
    if method == "schur":
        return _tiny_pivots(jnp.diagonal(fact.L))
    if method == "riccati":
        diags = jnp.diagonal(fact.L, axis1=-2, axis2=-1)  # (T, dmax)
        if structure is not None:
            # exclude the padded unit pivots of ragged stages
            pad = jnp.asarray(structure.blk_idx == structure.num_variables)
            diags = jnp.where(pad, jnp.nan, diags)
        return _tiny_pivots(diags)
    if method == "cr":
        # level l eliminates the odd entries of the surviving stage list
        # (original indices (2k+1)*2^l); padded dims stay exactly identity
        # through every Schur reduction, so the same ragged-stage exclusion
        # as riccati applies per level
        levels, L_final = fact.cr
        pad = (
            np.asarray(structure.blk_idx == structure.num_variables)
            if structure is not None
            else None
        )
        stages = np.arange(len(levels[0][0]) * 2 + 1) if structure is None else np.arange(
            structure.horizon
        )
        diags = []
        for L, _, _ in levels:
            dlev = jnp.diagonal(L, axis1=-2, axis2=-1)
            if pad is not None:
                dlev = jnp.where(jnp.asarray(pad[stages[1::2]]), jnp.nan, dlev)
            stages = stages[0::2]
            diags.append(dlev.reshape(-1))
        dfin = jnp.diagonal(L_final)
        if pad is not None:
            dfin = jnp.where(jnp.asarray(pad[stages[0]]), jnp.nan, dfin)
        diags.append(dfin)
        return _tiny_pivots(jnp.concatenate(diags))
    if method == "spike":
        # interior + separator pivots; padded unit pivots of ragged stages
        # are excluded like the riccati path. Shard p of P owns stages
        # [p*Tc, (p+1)*Tc) with the chunk's last stage as separator, so the
        # global interior rows are the non-separator stages in order and
        # the separator rows are stages Tc-1, 2Tc-1, ...
        dI = jnp.diagonal(fact.spike["L"], axis1=-2, axis2=-1)  # (T-P, dmax)
        dS = jnp.diagonal(fact.spike["Ls"], axis1=-2, axis2=-1)  # (P, dmax)
        if structure is not None:
            T, P = structure.horizon, dS.shape[0]
            Tc = T // P
            pad = np.asarray(structure.blk_idx == structure.num_variables)
            sep = np.zeros(T, bool)
            sep[Tc - 1 :: Tc] = True
            dI = jnp.where(jnp.asarray(pad[~sep]), jnp.nan, dI)
            dS = jnp.where(jnp.asarray(pad[sep]), jnp.nan, dS)
        return _tiny_pivots(jnp.concatenate([dI.reshape(-1), dS.reshape(-1)]))
    _, _, zero = inertia_counts(fact.d)
    return zero.astype(jnp.int32)


def solve_sym(
    layout, fact: Factorization, rhs, n, me, mc, method="ldl", structure=None,
    mesh=None, axis=None,
):
    """Solve the condensed symmetric system for rhs of shape (ns,) or
    (ns, k)."""
    if method == "ldl":
        return ldl_solve(fact.L, fact.d, rhs)
    rx = rhs[:n]
    req = rhs[n : n + me]
    rcone = rhs[n + me :]
    ceq = _ceq(fact)
    rhs_x = rx
    if me > 0:
        t2 = req / ceq
        rhs_x = rhs_x + fact.gx.T @ t2
    if mc > 0:
        t3 = cones.c_block_solve(layout, fact.s, fact.t, fact.eps_p, fact.eps_d, rcone)
        rhs_x = rhs_x + fact.hx.T @ t3
    vec = rhs_x.ndim == 1
    if method == "riccati":
        from calipso_tpu.ops import riccati as rc

        if vec:
            dx = structure.from_blocks(rc.solve(fact.L, fact.M, structure.to_blocks(rhs_x)))
        else:
            B = jax.vmap(structure.to_blocks, in_axes=1, out_axes=2)(rhs_x)
            X = rc.solve_multi(fact.L, fact.M, B)
            dx = jax.vmap(structure.from_blocks, in_axes=2, out_axes=1)(X)
        dx = _apply_border(fact, structure, dx)
    elif method == "cr":
        from calipso_tpu.ops import cyclic_reduction as crd

        if vec:
            dx = structure.from_blocks(crd.solve(fact.cr, structure.to_blocks(rhs_x)))
        else:
            B = jax.vmap(structure.to_blocks, in_axes=1, out_axes=2)(rhs_x)
            X = crd.solve_multi(fact.cr, B)
            dx = jax.vmap(structure.from_blocks, in_axes=2, out_axes=1)(X)
        dx = _apply_border(fact, structure, dx)
    elif method == "spike":
        from calipso_tpu.ops import spike as sp

        if vec:
            dx = structure.from_blocks(
                sp.solve_fact(fact.spike, structure.to_blocks(rhs_x), mesh, axis)
            )
        else:
            B = jax.vmap(structure.to_blocks, in_axes=1, out_axes=2)(rhs_x)
            X = sp.solve_fact(fact.spike, B, mesh, axis)
            dx = jax.vmap(structure.from_blocks, in_axes=2, out_axes=1)(X)
        dx = _apply_border(fact, structure, dx)
    else:
        y = jax.scipy.linalg.solve_triangular(fact.L, rhs_x, lower=True)
        dx = jax.scipy.linalg.solve_triangular(fact.L, y, lower=True, trans="T")
    dy = (fact.gx @ dx - req) / ceq if me > 0 else req
    if mc > 0:
        dz = cones.c_block_solve(
            layout, fact.s, fact.t, fact.eps_p, fact.eps_d, fact.hx @ dx - rcone
        )
    else:
        dz = rcone
    return jnp.concatenate([dx, dy, dz], axis=0)


def solve_with(
    layout, fact: Factorization, res: Blocks, n, me, mc, method="ldl", structure=None,
    mesh=None, axis=None,
) -> Blocks:
    """Condense -> factorized solve -> expand, for an arbitrary 6-block
    RHS."""
    s, t, rho = fact.s, fact.t, fact.rho
    rhs = condensed_rhs(layout, res, s, t, rho, fact.eps_p, fact.eps_d)
    d_sym = solve_sym(layout, fact, rhs, n, me, mc, method, structure, mesh, axis)
    return expand(layout, res, d_sym, n, me, mc, s, t, rho, fact.eps_p, fact.eps_d)
