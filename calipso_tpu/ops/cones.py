"""Vectorized cone kernels for K = R+^q x Q_l1 x ... x Q_lj.

Design: every cone is treated as a second-order cone (a
nonnegative-orthant entry is a 1-dimensional SOC -- identical barrier,
Jordan product, target and fraction-to-the-boundary formulas), so the whole
cone program is a single padded (num_cones, max_dim) tensor computation
with zero data-dependent control flow. This replaces the reference's
per-cone Julia loops (reference src/solver/cones/{cone,nonnegative,
second_order}.jl) with batched dense ops.

Padding is algebraically inert: padded slots gather the appended zero, and
zeros do not perturb dots, dets, or arrow solves, so no masks are needed in
the arithmetic -- only in the scatter, which drops padded slots by writing
them past the end of the output buffer.

Key math (all per cone, head component x1, tail xbar):
  barrier      0.5*log(x1^2 - |xbar|^2)          (== log x for 1-d cones)
  product      a o b = [<a,b>; a1*bbar + b1*abar] (arrow(a) @ b)
  target       e = (1, 0, ..., 0)
  arrow(u)     [[u1, ubar^T], [ubar, u1*I]]
  arrow solve  y1 = (u1*x1 - <ubar,xbar>) / (u1^2 - |ubar|^2)
               ybar = (xbar - y1*ubar) / u1
  FTB violation  v = xhat - (1-tau)*x ; violated iff v1 <= |vbar|
References: second_order.jl:13-47 (barrier/product/target/violation),
nonnegative.jl:11-34, cone.jl:62-68 (violation dispatch).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


class ConeLayout:
    """Static (trace-time) description of the cone Cartesian product.

    Mirrors the role of `Indices.cone_nonnegative` / `cone_second_order`
    (reference src/solver/indices.jl:20-63) but as padded index tensors.

    Args:
      num_cone: total dimension m_c of the cone variable.
      nonnegative_indices: 0-based flat indices belonging to R+.
      second_order_indices: list of 0-based flat index arrays, one per SOC.
    """

    def __init__(self, num_cone, nonnegative_indices=None, second_order_indices=None):
        if nonnegative_indices is None and second_order_indices is None:
            nonnegative_indices = np.arange(num_cone)
        nn = np.asarray(
            nonnegative_indices if nonnegative_indices is not None else [], dtype=np.int64
        ).reshape(-1)
        socs = [
            np.asarray(idx, dtype=np.int64).reshape(-1)
            for idx in (second_order_indices or [])
            if len(idx) > 0
        ]
        covered = np.concatenate([nn] + socs) if (len(nn) or socs) else np.zeros(0, np.int64)
        if len(covered) != num_cone or (
            len(covered) and not np.array_equal(np.sort(covered), np.arange(num_cone))
        ):
            raise ValueError(
                "nonnegative + second-order indices must partition 0..num_cone-1 "
                f"(got {len(covered)} of {num_cone})"
            )

        self.num_cone = int(num_cone)
        self.num_nonnegative = int(len(nn))
        self.second_order_dims = tuple(int(len(s)) for s in socs)
        self.nonnegative_indices = nn
        self.second_order_indices = socs

        # unified cone list: 1-d cones for each orthant entry, then SOCs
        cones = [np.array([i]) for i in nn] + socs
        self.num_cones = len(cones)
        self.max_dim = max((len(c) for c in cones), default=1)

        C, D = max(self.num_cones, 1), self.max_dim
        idx = np.full((C, D), num_cone, dtype=np.int64)  # pad -> sentinel m_c
        for c, members in enumerate(cones):
            idx[c, : len(members)] = members
        self.idx = idx
        self.slot_mask = idx < num_cone  # (C, D) real-slot mask

        # inverse map: flat position -> (cone, slot); scatter becomes a gather
        inv_c = np.zeros(max(num_cone, 1), dtype=np.int64)
        inv_j = np.zeros(max(num_cone, 1), dtype=np.int64)
        for c, members in enumerate(cones):
            for j, k in enumerate(members):
                inv_c[k], inv_j[k] = c, j
        self.inv_cone = inv_c
        self.inv_slot = inv_j

        # e (cone target) and the interior initialization point as flat
        # numpy constants (reference nonnegative.jl:26/second_order.jl:42 and
        # initialize_* at nonnegative.jl:2-7/second_order.jl:2-10)
        target = np.zeros(num_cone)
        init = np.zeros(num_cone)
        for members in cones:
            target[members[0]] = 1.0
            init[members[0]] = 1.0
            init[members[1:]] = 0.1
        self.target_np = target
        self.init_np = init

    # ---- padded-view helpers -------------------------------------------------

    def gather(self, x):
        """(m_c,) flat -> (C, D) padded; padded slots read 0."""
        xpad = jnp.concatenate([x, jnp.zeros((1,), x.dtype)])
        return xpad[self.idx]

    def scatter(self, vp):
        """(C, D) padded -> (m_c,) flat (inverse permutation; exact)."""
        return vp[self.inv_cone, self.inv_slot]

    def target(self, dtype):
        return jnp.asarray(self.target_np, dtype)

    def initialize(self, dtype):
        return jnp.asarray(self.init_np, dtype)


# ---- cone algebra (flat in, flat out; all shapes static) ---------------------


def product(layout: ConeLayout, a, b):
    """Jordan product a o b = arrow(a) @ b (reference second_order.jl:17,
    nonnegative.jl:15)."""
    if layout.num_cone == 0:
        return a
    ap, bp = layout.gather(a), layout.gather(b)
    head = jnp.sum(ap * bp, axis=1, keepdims=True)  # <a, b>
    tail = ap[:, :1] * bp[:, 1:] + bp[:, :1] * ap[:, 1:]
    return layout.scatter(jnp.concatenate([head, tail], axis=1))


def arrow_solve(layout: ConeLayout, u, x):
    """Solve arrow(u) y = x per cone, closed form (replaces the reference's
    reflection-based inverse, second_order.jl:50-69; equal results)."""
    if layout.num_cone == 0:
        return x
    up, xp = layout.gather(u), layout.gather(x)
    u1, ubar = up[:, :1], up[:, 1:]
    x1, xbar = xp[:, :1], xp[:, 1:]
    det = u1 * u1 - jnp.sum(ubar * ubar, axis=1, keepdims=True)
    y1 = (u1 * x1 - jnp.sum(ubar * xbar, axis=1, keepdims=True)) / det
    ybar = (xbar - y1 * ubar) / u1
    return layout.scatter(jnp.concatenate([y1, ybar], axis=1))


def barrier(layout: ConeLayout, s):
    """Phi(s) = sum log s_nn + sum 0.5*log(s1^2 - |sbar|^2)
    (reference nonnegative.jl:11, second_order.jl:13)."""
    if layout.num_cone == 0:
        return jnp.asarray(0.0, s.dtype)
    sp = layout.gather(s)
    det = sp[:, 0] ** 2 - jnp.sum(sp[:, 1:] ** 2, axis=1)
    return 0.5 * jnp.sum(jnp.log(det))


def barrier_gradient(layout: ConeLayout, s):
    """grad Phi = (1/det) * [s1; -sbar] per cone (reference
    nonnegative.jl:12, second_order.jl:14)."""
    if layout.num_cone == 0:
        return s
    sp = layout.gather(s)
    det = sp[:, 0:1] ** 2 - jnp.sum(sp[:, 1:] ** 2, axis=1, keepdims=True)
    grad = jnp.concatenate([sp[:, 0:1], -sp[:, 1:]], axis=1) / det
    return layout.scatter(grad)


def violation(layout: ConeLayout, xhat, x, tau):
    """Fraction-to-the-boundary test: True if any cone violates
    xhat - (1-tau)x strictly-interior (reference cone.jl:62-68)."""
    if layout.num_cone == 0:
        return jnp.asarray(False)
    v = layout.gather(xhat - (1.0 - tau) * x)
    tail_norm = jnp.sqrt(jnp.sum(v[:, 1:] ** 2, axis=1))
    return jnp.any(v[:, 0] <= tail_norm)


def arrow_matrices(layout: ConeLayout, u):
    """Dense padded per-cone arrow matrices, (C, D, D). Padded rows/columns
    carry garbage that the caller's scatter drops."""
    C, D = layout.idx.shape
    up = layout.gather(u)
    eye = jnp.eye(D, dtype=u.dtype)
    A = up[:, 0:1, None] * eye[None]  # u1 * I
    A = A.at[:, 0, :].set(up)  # head row  [u1, ubar]
    A = A.at[:, :, 0].set(up)  # head col
    return A


def dense_arrow(layout: ConeLayout, u):
    """Block-diagonal (m_c, m_c) matrix of per-cone arrow(u) blocks."""
    mc = layout.num_cone
    if mc == 0:
        return jnp.zeros((0, 0), u.dtype)
    A = arrow_matrices(layout, u)
    idx = jnp.asarray(layout.idx)
    big = jnp.zeros((mc + 1, mc + 1), u.dtype)
    big = big.at[idx[:, :, None], idx[:, None, :]].add(A)
    return big[:mc, :mc]


def c_block_solve(layout: ConeLayout, s, t, eps_p, eps_d, b):
    """Solve (eps_d*I + M^{-1} Cv) x = b per cone, where Cv = arrow(v),
    v = s - eps_d*e, M = arrow(w), w = t + eps_p*v. Multiplying by M:
    (eps_d*arrow(w) + arrow(v)) x = arrow(w) b, all arrow ops. Used by the
    Schur-complement backend to apply the inverse of the condensed cone
    block. b may be (m_c,) or (m_c, k)."""
    if layout.num_cone == 0:
        return b
    e = layout.target(s.dtype)
    v = s - eps_d * e
    w = t + eps_p * v
    u = v + eps_d * w

    def one(col):
        return arrow_solve(layout, u, product(layout, w, col))

    if b.ndim == 2:
        import jax

        return jax.vmap(one, in_axes=1, out_axes=1)(b)
    return one(b)


def condensed_block(layout: ConeLayout, s, t, eps_p, eps_d, dtype):
    """Dense (m_c, m_c) condensed cone block  -eps_d*I - M^{-1} arrow(v),
    where v = s - eps_d*e and M = arrow(t) + eps_p*arrow(v) = arrow(w),
    w = t + eps_p*v.  This is the 3x3-system cone diagonal of the reference
    (residual_jacobian_variables.jl:142-163: -Sbar/(T+Sbar*P)+D for the
    orthant, -(Cs+Ct*P)^{-1}Ct + D per SOC), computed via closed-form arrow
    solves on the padded cone tensor instead of per-cone matrix inverses.
    """
    mc = layout.num_cone
    if mc == 0:
        return jnp.zeros((0, 0), dtype)
    e = layout.target(dtype)
    v = s - eps_d * e
    w = t + eps_p * v

    wp = layout.gather(w)  # (C, D)
    Av = arrow_matrices(layout, v)  # (C, D, D)

    # columnwise arrow solve: X[c] = arrow(w[c])^{-1} Av[c]
    u1 = wp[:, 0:1, None]  # (C,1,1)
    ubar = wp[:, 1:]  # (C, D-1)
    det = (wp[:, 0] ** 2 - jnp.sum(ubar**2, axis=1))[:, None, None]
    x1 = Av[:, 0:1, :]  # (C,1,D) head rows of columns
    xbar = Av[:, 1:, :]  # (C,D-1,D)
    y1 = (u1 * x1 - jnp.sum(ubar[:, :, None] * xbar, axis=1, keepdims=True)) / det
    ybar = (xbar - y1 * ubar[:, :, None]) / u1
    X = jnp.concatenate([y1, ybar], axis=1)  # (C, D, D)

    block = -X
    # subtract eps_d on the (real-slot) diagonal
    D = layout.idx.shape[1]
    block = block - eps_d * jnp.eye(D, dtype=dtype)[None]

    # scatter per-cone blocks into the (m_c, m_c) matrix; padded indices
    # point at the sacrificial last row/col which is trimmed off
    idx = jnp.asarray(layout.idx)
    big = jnp.zeros((mc + 1, mc + 1), dtype)
    big = big.at[idx[:, :, None], idx[:, None, :]].add(block)
    return big[:mc, :mc]
