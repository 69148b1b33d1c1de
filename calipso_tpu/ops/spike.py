"""Horizon-sharded block-tridiagonal solve (sequence-parallel / SPIKE).

The CP-like axis of SURVEY.md section 5: when a single trajopt solve must
scale past one chip (horizon T too long, or batch too small to fill the
mesh), shard the *stage* axis over devices and solve the stage-block
tridiagonal system with partitioned Schur-complement elimination
(block-SPIKE / domain decomposition):

  1. each device owns a contiguous chunk of T/P stages; the chunk's last
     stage is its *separator*;
  2. every device factors its interior (T/P - 1 stages) with the local
     Riccati sweep (ops/riccati.py) and eliminates it against the two
     adjacent separators -- one multi-RHS local solve whose right-hand
     sides are the boundary couplings;
  3. the P separators form a tiny P-block tridiagonal Schur system whose
     per-chunk contributions are `all_gather`ed (P d x d blocks -- a few
     KB between devices) and solved redundantly on every device;
  4. each device back-substitutes its interior locally:
     x_i = A^{-1} r  -  (A^{-1}E) x_{sep,p-1}  -  (A^{-1}F') x_{sep,p}.

Work per device O((T/P) d^3), one all_gather of O(P d^2): weak-scales the
horizon across devices. The reference has no analogue (single-threaded QDLDL,
qdldl.jl:400-589); this is the invention the survey calls
"horizon sharding across chips with boundary exchange".

Coupling convention: `Oin[t]` is the block at (row t, col t-1) -- the
coupling *into* stage t from stage t-1, with Oin[0] = 0. (This is
ops/riccati.py's O shifted by one so the stage axis shards evenly.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from calipso_tpu.ops import riccati as rc


def to_inbound(O, T):
    """Shift ops/riccati.py's O (T-1, d, d) to the inbound layout
    Oin (T, d, d) with Oin[0] = 0."""
    d = O.shape[-1] if O.size else 0
    if T == 1:
        return jnp.zeros((1,) + O.shape[1:], O.dtype)
    return jnp.concatenate([jnp.zeros((1, O.shape[1], O.shape[2]), O.dtype), O], axis=0)


def factor_local(D_loc, Oin_loc, axis: str):
    """Per-shard factorization phase (b-independent): interior Riccati
    factors, boundary eliminations A^{-1}E / A^{-1}F', and the replicated
    P-block separator Schur factorization. Returns the pytree consumed by
    apply_local; call inside shard_map. Splitting factor from apply lets
    the AL-IPM inertia ladder and iterative refinement reuse one
    factorization across many solves, like the other backends."""
    Tc, d, _ = D_loc.shape
    assert Tc >= 2, "horizon sharding needs >= 2 stages per device"

    E = Oin_loc[0]  # coupling from previous shard's separator (0 on shard 0)
    F = Oin_loc[Tc - 1]  # coupling interior last stage -> own separator

    # interior factorization (Tc-1 stages)
    L, M = rc.factor(D_loc[:-1], Oin_loc[1 : Tc - 1])

    # eliminate the interior against both separators: A^{-1}[E; F'] with
    # E entering at block row 0 and F' at block row Tc-2
    R = jnp.zeros((Tc - 1, d, 2 * d), D_loc.dtype)
    R = R.at[0, :, :d].set(E)
    R = R.at[Tc - 2, :, d:].set(F.T)
    X = rc.solve_multi(L, M, R)
    G_E, G_F = X[..., :d], X[..., d:]  # A^{-1}E, A^{-1}F'

    # per-chunk Schur pieces (all (d, d))
    diag_own = D_loc[Tc - 1] - F @ G_F[Tc - 2]  # D_sep - F A^{-1} F'
    diag_prev = E.T @ G_E[0]  # E' A^{-1} E  -> previous separator's diagonal
    off_prev = -F @ G_E[Tc - 2]  # couples own separator (row) to prev (col)

    # assemble the P-block separator system on every shard (tiny gather)
    g = lambda x: lax.all_gather(x, axis)  # (P, ...)
    Sd = g(diag_own)
    Sd = Sd - jnp.concatenate([g(diag_prev)[1:], jnp.zeros((1, d, d), Sd.dtype)], axis=0)
    So = g(off_prev)[1:]  # So[k] couples separator k+1 (row) to k (col)
    Ls, Ms = rc.factor(Sd, So)
    return dict(L=L, M=M, G_E=G_E, G_F=G_F, E=E, F=F, Ls=Ls, Ms=Ms)


def apply_local(f, b_loc, axis: str):
    """Per-shard solve phase against a factor_local factorization.
    b_loc (Tc, d) or (Tc, d, k); returns the local solution chunk of the
    same shape. Call inside shard_map."""
    L, M, G_E, G_F, E, F = f["L"], f["M"], f["G_E"], f["G_F"], f["E"], f["F"]
    Ls, Ms = f["Ls"], f["Ms"]
    Tc = b_loc.shape[0]
    d = b_loc.shape[1]
    p = lax.axis_index(axis)
    multi = b_loc.ndim == 3

    u = (rc.solve_multi if multi else rc.solve)(L, M, b_loc[:-1])  # A^{-1} r
    rhs_own = b_loc[Tc - 1] - F @ u[Tc - 2]
    rhs_prev = E.T @ u[0]
    g = lambda x: lax.all_gather(x, axis)
    rb = g(rhs_own) - jnp.concatenate(
        [g(rhs_prev)[1:], jnp.zeros_like(g(rhs_prev)[:1])], axis=0
    )
    x_sep = (rc.solve_multi if multi else rc.solve)(Ls, Ms, rb)  # (P, d[, k])

    zero = jnp.zeros_like(x_sep[0])
    x_prev = jnp.where(p > 0, x_sep[jnp.maximum(p - 1, 0)], zero)
    x_own = x_sep[p]
    ein = "tij,jk->tik" if multi else "tij,j->ti"
    x_int = u - jnp.einsum(ein, G_E, x_prev) - jnp.einsum(ein, G_F, x_own)
    return jnp.concatenate([x_int, x_own[None]], axis=0)


def solve_local(D_loc, Oin_loc, b_loc, axis: str):
    """Per-shard body: solve the globally coupled system from local chunks
    (factor_local + apply_local in one shot).

    D_loc (Tc, d, d), Oin_loc (Tc, d, d), b_loc (Tc, d) are this shard's
    stages; `axis` is the mesh axis name the horizon is sharded over.
    Requires Tc >= 2. Call inside shard_map; returns the local solution
    chunk (Tc, d)."""
    return apply_local(factor_local(D_loc, Oin_loc, axis), b_loc, axis)


def _smap(f, mesh, axis, in_specs, out_specs):
    from jax.sharding import PartitionSpec as Pspec

    spec = lambda s: Pspec(axis) if s else Pspec()
    return jax.shard_map(
        f,
        mesh=mesh,
        in_specs=tuple(spec(s) for s in in_specs),
        out_specs=jax.tree.map(spec, out_specs),
        check_vma=False,
    )


def _check_split(T, P):
    if T % P != 0 or T // P < 2:
        raise ValueError(f"horizon {T} must split into {P} chunks of >= 2 stages")


def factor_sharded(D, O, mesh, axis: str):
    """Factor the block-tridiagonal system with the horizon sharded over
    `axis` of `mesh` (D (T, d, d), O (T-1, d, d) in ops/riccati.py's
    convention). Returns the sharded factorization pytree for
    solve_fact -- the `linear_solver=\"spike\"` backend's factorize
    phase."""
    T = D.shape[0]
    _check_split(T, mesh.shape[axis])
    Oin = to_inbound(O, T)
    # interior/boundary pieces are sharded over the axis; the separator
    # Schur factors (Ls, Ms) are replicated on every shard
    out_specs = dict(L=True, M=True, G_E=True, G_F=True, E=True, F=True, Ls=False, Ms=False)
    # E/F/Ls/Ms have no leading chunk axis per shard: gather/shard manually
    # via a uniform "everything sharded on axis 0" trick -- stack them with
    # a leading length-1 axis per shard
    def body(Dl, Ol):
        f = factor_local(Dl, Ol, axis)
        return dict(
            L=f["L"],
            M=f["M"],
            G_E=f["G_E"],
            G_F=f["G_F"],
            E=f["E"][None],
            F=f["F"][None],
            Ls=f["Ls"],
            Ms=f["Ms"],
        )

    return _smap(body, mesh, axis, (True, True), out_specs)(D, Oin)


def solve_fact(fact, b, mesh, axis: str):
    """Solve against a factor_sharded factorization; b (T, d) or
    (T, d, k)."""
    T = b.shape[0]
    P = mesh.shape[axis]
    _check_split(T, P)

    def body(L, M, G_E, G_F, E, F, Ls, Ms, bl):
        f = dict(L=L, M=M, G_E=G_E, G_F=G_F, E=E[0], F=F[0], Ls=Ls, Ms=Ms)
        return apply_local(f, bl, axis)

    in_specs = (True, True, True, True, True, True, False, False, True)
    return _smap(body, mesh, axis, in_specs, True)(
        fact["L"], fact["M"], fact["G_E"], fact["G_F"],
        fact["E"], fact["F"], fact["Ls"], fact["Ms"], b,
    )


def factors_finite(fact):
    """Inertia signal for the AL-IPM ladder: all interior and separator
    Cholesky factors finite (the Cholesky-success reading of the target
    inertia, like riccati/cr -- reference inertia.jl:7-11)."""
    return jnp.all(jnp.isfinite(fact["L"])) & jnp.all(jnp.isfinite(fact["Ls"]))


def solve_sharded(D, O, b, mesh, axis: str):
    """Solve the block-tridiagonal system with the horizon sharded over
    `axis` of `mesh`. D (T, d, d), O (T-1, d, d) in ops/riccati.py's
    convention, b (T, d); T must be divisible by the axis size with
    T/P >= 2. Returns x (T, d)."""
    T = D.shape[0]
    _check_split(T, mesh.shape[axis])
    Oin = to_inbound(O, T)
    return _smap(
        lambda Dl, Ol, bl: solve_local(Dl, Ol, bl, axis),
        mesh, axis, (True, True, True), True,
    )(D, Oin, b)
