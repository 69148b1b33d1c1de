"""Structure-exploiting trajopt evaluators: vmapped stage derivatives
scattered into the flat problem arrays.

The naive transcription differentiates one flat function of all T stages:
tracing is O(T) repeated work and jacfwd/hessian sweep O(n) = O(T * nxu)
tangents over the whole horizon -- O(T^2) flops. Here stages are grouped by
(callable identity, dimensions) -- the same dedup the reference does at
codegen time (reference trajectory_optimization/solver.jl:129-176) -- and
each group's values/gradients/Jacobians/Hessians are computed with ONE
vmapped stage-local transform, then scattered into the flat vectors and
dense block matrices with static index tables (reference
indices.jl/sparsity.jl play this role for the sparse assembler).

Tracing cost: O(#groups). Evaluation cost: O(T) stage-local work, batched
under vmap. The dense downstream solver is unchanged; the block-sparse
KKT backend consumes the same stage tables.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from calipso_tpu.solver.problem import Dimensions


class _Group(NamedTuple):
    fn: Callable  # stage function of (zrow, wrow) -> (rdim,) or scalar
    zcols: np.ndarray  # (G, width) flat variable indices feeding each stage
    pcols: np.ndarray  # (G, npw) flat parameter indices (padded w/ sentinel)
    rows: np.ndarray  # (G, rdim) output row indices ([] for costs)
    width: int
    npw: int
    rdim: int


def _group_stages(entries):
    """entries: list of (key, fn, zcols, pcols, rows). Groups consecutive-
    compatible stages by (key, shapes)."""
    table = {}
    order = []
    for key, fn, zc, pc, rw in entries:
        gkey = (key, len(zc), len(pc), len(rw))
        if gkey not in table:
            table[gkey] = []
            order.append(gkey)
        table[gkey].append((fn, zc, pc, rw))
    groups = []
    for gkey in order:
        items = table[gkey]
        fn = items[0][0]
        zcols = np.stack([it[1] for it in items])
        pcols = np.stack([it[2] for it in items])
        rows = np.stack([it[3] for it in items])
        groups.append(
            _Group(fn, zcols, pcols, rows, zcols.shape[1], pcols.shape[1], rows.shape[1])
        )
    return groups


def _gather(vec, idx, sentinel_len):
    """Gather with sentinel padding: index == sentinel_len reads 0."""
    vpad = jnp.concatenate([vec, jnp.zeros((1,), vec.dtype)])
    return vpad[idx]


def _onehot(idx, size):
    """(..., k) static int indices -> (..., k, size + 1) 0/1 float matrix;
    the sentinel index == size maps to the extra trailing slot (dropped by
    the caller's [:size] slice). Used to turn static-index scatter-adds
    into einsum contractions: an elementwise scatter serializes its
    updates, while the equivalent one-hot contraction is one dense
    matmul (the speed ratio was not measured on the H100). Exact: multipliers
    are 0/1 and partial sums are adds of distinct scatter contributions."""
    idx = np.asarray(idx)
    out = np.zeros(idx.shape + (size + 1,), np.float32)
    np.put_along_axis(out, idx[..., None], 1.0, axis=-1)
    return out


class StructuredProblemFunctions:
    """Drop-in replacement for ProblemFunctions built from stagewise
    callables; same call surface, structure-exploiting internals."""

    def __init__(
        self,
        num_variables: int,
        num_parameters: int,
        cost_entries,  # list of (key, fn(z,w)->scalar, zcols, pcols)
        eq_entries,  # list of (key, fn(z,w)->(r,), zcols, pcols, rows)
        cone_entries,  # same shape as eq_entries
        num_equality: int,
        num_cone: int,
        general_equality=None,  # optional fn(zflat, theta) -> (rg,), rows
        general_rows=None,
    ):
        n, p = int(num_variables), int(num_parameters)
        self.dims = Dimensions(n, p, int(num_equality), int(num_cone))
        self._n, self._p = n, p
        # assembly strategy (round 4): the default hot path has NO
        # elementwise scatter anywhere -- Hessians assemble directly in
        # stage-block form (lagrangian_hessian_blocks), Jacobians by
        # one-hot column contraction + row concatenation, gradients by
        # stage-block placement + from_blocks, values by concatenation.
        # The historical full one-hot einsum formulation stays reachable
        # via CALIPSO_EINSUM_ASSEMBLY=1 and the scatter formulation is
        # the fallback when a problem's groups defeat the static block
        # maps (_block_maps() -> None) or row tiling.
        import os

        self._einsum_assembly = (
            os.environ.get("CALIPSO_EINSUM_ASSEMBLY", "0") == "1" and n <= 128
        )

        self.cost_groups = _group_stages(
            [(k, fn, zc, pc, np.zeros((0,), np.int64)) for (k, fn, zc, pc) in cost_entries]
        )
        self.eq_groups = _group_stages(eq_entries)
        self.cone_groups = _group_stages(cone_entries)
        self.general = general_equality
        self.general_rows = (
            np.asarray(general_rows, np.int64) if general_rows is not None else None
        )

        me, mc = self.dims.equality, self.dims.cone

        # row-tiling flags: when the groups' row spans (in group order,
        # general rows last) exactly tile [0, m), constraint values and
        # Jacobians assemble by CONCATENATION -- no scatter at all (an
        # elementwise scatter serializes its updates). Holds by construction for trajopt
        # transcriptions (dynamics rows, then per-stage rows in stage
        # order, then general); verified here, scatter fallback otherwise.
        def _rows_order(groups, m, general_rows):
            """Row-concat plan: None if the groups' rows do not exactly
            cover [0, m); otherwise "identity" when the concat order IS
            row order, or a static permutation (np argsort) to apply
            after concatenation (e.g. per-foot SOC groups whose rows
            interleave across stages)."""
            parts = [np.asarray(g.rows).ravel() for g in groups]
            if general_rows is not None:
                parts.append(np.asarray(general_rows).ravel())
            cat = np.concatenate(parts) if parts else np.zeros((0,), np.int64)
            if cat.size != m or not np.array_equal(np.sort(cat), np.arange(m)):
                return None
            if np.array_equal(cat, np.arange(m)):
                return "identity"
            return np.argsort(cat, kind="stable")

        self._eq_rows_tiled = _rows_order(
            self.eq_groups, me,
            self.general_rows if general_equality is not None else None,
        )
        self._cone_rows_tiled = _rows_order(self.cone_groups, mc, None)

        # ---- scalar objective ------------------------------------------------

        def f(z, theta):
            total = jnp.zeros((), z.dtype)
            for g in self.cost_groups:
                Z = _gather(z, g.zcols, n)
                W = _gather(theta, g.pcols, p)
                total = total + jnp.sum(jax.vmap(g.fn)(Z, W))
            return total

        self.f = f
        self.fx = self._scatter_grad(self.cost_groups)
        self._fxx = self._scatter_hess(self.cost_groups)

        # ---- constraints -----------------------------------------------------

        def make_eval(groups, m, general=False):
            use_es = self._einsum_assembly
            Rs = [_onehot(g.rows, m) for g in groups] if use_es else None
            tiled = self._eq_rows_tiled if general else self._cone_rows_tiled

            def fn(z, theta):
                if tiled is not None and not use_es:
                    parts = []
                    for g in groups:
                        Z = _gather(z, g.zcols, n)
                        W = _gather(theta, g.pcols, p)
                        parts.append(jax.vmap(g.fn)(Z, W).reshape(-1))
                    if general and self.general is not None:
                        parts.append(self.general(z, theta))
                    if not parts:
                        return jnp.zeros((m,), z.dtype)
                    out = jnp.concatenate(parts)
                    if isinstance(tiled, np.ndarray):
                        out = out[jnp.asarray(tiled)]
                    return out
                out = jnp.zeros((m,), z.dtype)
                for i, g in enumerate(groups):
                    Z = _gather(z, g.zcols, n)
                    W = _gather(theta, g.pcols, p)
                    vals = jax.vmap(g.fn)(Z, W)
                    if use_es:
                        R = jnp.asarray(Rs[i], z.dtype)
                        out = out + jnp.einsum("gr,grm->m", vals, R)[:m]
                    else:
                        out = out.at[jnp.asarray(g.rows)].set(vals)
                if general and self.general is not None:
                    out = out.at[jnp.asarray(self.general_rows)].set(
                        self.general(z, theta)
                    )
                return out

            return fn

        self.g = make_eval(self.eq_groups, me, general=True)
        self.h = make_eval(self.cone_groups, mc)

        self.gx = self._scatter_jac(self.eq_groups, me, wrt="z", general=True, kind="eq")
        self.hx = self._scatter_jac(self.cone_groups, mc, wrt="z", kind="cone")
        self.gt = self._scatter_jac(self.eq_groups, me, wrt="w", general=True)
        self.ht = self._scatter_jac(self.cone_groups, mc, wrt="w")

        self.gty_x = self._scatter_dual_grad(self.eq_groups, general=True, kind="eq")
        self.htz_x = self._scatter_dual_grad(self.cone_groups, kind="cone")
        self._gty_xx = self._scatter_dual_hess(self.eq_groups, general=True)
        self._htz_xx = self._scatter_dual_hess(self.cone_groups)

        self.fxt = self._scatter_mixed(self.cost_groups)
        self.gty_xt = self._scatter_dual_mixed(self.eq_groups, general=True)
        self.htz_xt = self._scatter_dual_mixed(self.cone_groups)

        # ---- trace-time dedup (round 5) ---------------------------------
        # Each evaluator is jit-wrapped so it lowers to ONE cached
        # closed-jaxpr call: the contact-class solve program inlined the
        # grouped hessian/jacfwd transforms at every call site
        # (residual, line-search chunk, oracle, refinement), producing a
        # ~1.4M-primitive jaxpr whose tracing and vmap re-batching took
        # minutes of host time (cProfile, d=54 B=128) -- a TRACE wall that
        # the persistent XLA cache can never absorb. With pjit-call dedup the
        # body is traced and batched once per evaluator; XLA inlines the
        # calls again during optimization, so the compiled code is
        # unchanged. lagrangian_hessian_blocks/_xx take constraint_tensor
        # as a static positional arg (index 4).
        for _name in (
            "f", "g", "h", "fx", "gx", "hx", "gt", "ht",
            "gty_x", "htz_x", "fxt", "gty_xt", "htz_xt",
        ):
            setattr(self, _name, jax.jit(getattr(self, _name)))
        self.lagrangian_hessian_blocks = jax.jit(
            self.lagrangian_hessian_blocks, static_argnums=4
        )
        self.lagrangian_hessian_xx = jax.jit(
            self.lagrangian_hessian_xx, static_argnums=4
        )

    # ---- scatter builders ----------------------------------------------------

    def _grad_blocks_place(self, grad_list, maps_list, dtype):
        """Scatter-free flat-gradient assembly: per-group (G, w) gradients
        are placed into (T, dmax) stage-block form (pad via the static Q0/
        Q1 maps + one-hot stage contraction) and gathered back to flat
        with from_blocks -- no elementwise scatter-add."""
        st = self.stage_structure
        T, dmax = st.horizon, st.dmax
        out = jnp.zeros((T, dmax), dtype)
        for grads, m in zip(grad_list, maps_list):
            t_idx, Q0, Q1 = m
            G = grads.shape[0]
            S0 = jnp.asarray(_onehot(t_idx, T)[:, :T], dtype)
            g0 = grads @ jnp.asarray(Q0, dtype)  # (G, dmax)
            out = out + jnp.einsum("gt,ga->ta", S0, g0)
            if Q1 is not None:
                S1 = jnp.asarray(_onehot(t_idx + 1, T)[:, :T], dtype)
                g1 = grads @ jnp.asarray(Q1, dtype)
                out = out + jnp.einsum("gt,ga->ta", S1, g1)
        return st.from_blocks(out)

    def _scatter_grad(self, groups):
        n, p = self._n, self._p
        use_es = self._einsum_assembly
        Cs = [_onehot(g.zcols, n) for g in groups] if use_es else None

        def fx(z, theta):
            maps = self._block_maps()
            if maps is not None and not use_es:
                grad_list, maps_list = [], []
                for i, g in enumerate(groups):
                    Z = _gather(z, g.zcols, n)
                    W = _gather(theta, g.pcols, p)
                    grad_list.append(jax.vmap(jax.grad(g.fn))(Z, W))
                    maps_list.append(maps["cost"][i])
                return self._grad_blocks_place(grad_list, maps_list, z.dtype)
            out = jnp.zeros((n + 1,), z.dtype)
            for i, g in enumerate(groups):
                Z = _gather(z, g.zcols, n)
                W = _gather(theta, g.pcols, p)
                grads = jax.vmap(jax.grad(g.fn))(Z, W)  # (G, width)
                if use_es:
                    C = jnp.asarray(Cs[i], z.dtype)
                    out = out + jnp.einsum("gw,gwn->n", grads, C)
                else:
                    out = out.at[jnp.asarray(g.zcols)].add(grads)
            return out[:n]

        return fx

    def _scatter_hess(self, groups):
        n, p = self._n, self._p
        use_es = self._einsum_assembly
        Cs = [_onehot(g.zcols, n) for g in groups] if use_es else None

        def fxx(z, theta):
            out = jnp.zeros((n + 1, n + 1), z.dtype)
            for i, g in enumerate(groups):
                Z = _gather(z, g.zcols, n)
                W = _gather(theta, g.pcols, p)
                hess = jax.vmap(jax.hessian(g.fn))(Z, W)  # (G, w, w)
                if use_es:
                    C = jnp.asarray(Cs[i], z.dtype)
                    tmp = jnp.einsum("gwv,gvn->gwn", hess, C)
                    out = out + jnp.einsum("gwm,gwn->mn", C, tmp)
                else:
                    zc = jnp.asarray(g.zcols)
                    out = out.at[zc[:, :, None], zc[:, None, :]].add(hess)
            return out[:n, :n]

        return fxx

    def _scatter_jac(self, groups, m, wrt="z", general=False, kind=None):
        n, p = self._n, self._p
        ncols = n if wrt == "z" else p
        use_es = self._einsum_assembly
        if use_es:
            Rs = [_onehot(g.rows, m) for g in groups]
            Cs = [_onehot(g.zcols if wrt == "z" else g.pcols, ncols) for g in groups]
        tiled = (
            (self._eq_rows_tiled if kind == "eq" else self._cone_rows_tiled)
            if (wrt == "z" and kind is not None)
            else None
        )

        def jac(z, theta):
            argnum = 0 if wrt == "z" else 1
            maps = self._block_maps() if tiled is not None else None
            if maps is not None and not use_es:
                # concat assembly: the groups' rows exactly cover [0, m),
                # so each group's (G, r, w) Jacobian is column-placed by
                # a one-hot contraction (a matmul) and row-placed by
                # concatenation (+ a static row-permutation gather when
                # the concat order is not row order) -- zero scatters
                parts = []
                for i, g in enumerate(groups):
                    Z = _gather(z, g.zcols, n)
                    W = _gather(theta, g.pcols, p)
                    J = jax.vmap(jax.jacfwd(g.fn, argnums=0))(Z, W)  # (G, r, w)
                    C = jnp.asarray(_onehot(g.zcols, n)[:, :, :n], z.dtype)
                    Jp = jnp.einsum("grw,gwc->grc", J, C)
                    parts.append(Jp.reshape(-1, n))
                if general and self.general is not None:
                    parts.append(jax.jacfwd(self.general)(z, theta))
                if not parts:
                    return jnp.zeros((m, n), z.dtype)
                out = jnp.concatenate(parts, axis=0)
                if isinstance(tiled, np.ndarray):
                    out = out[jnp.asarray(tiled)]
                return out
            out = jnp.zeros((m, ncols + 1), z.dtype)
            for i, g in enumerate(groups):
                Z = _gather(z, g.zcols, n)
                W = _gather(theta, g.pcols, p)
                J = jax.vmap(jax.jacfwd(g.fn, argnums=argnum))(Z, W)  # (G, r, w)
                if use_es:
                    R = jnp.asarray(Rs[i], z.dtype)
                    C = jnp.asarray(Cs[i], z.dtype)
                    tmp = jnp.einsum("grw,gwc->grc", J, C)
                    out = out + jnp.einsum("grm,grc->mc", R, tmp)[:m]
                else:
                    rows = jnp.asarray(g.rows)
                    cols = jnp.asarray(g.zcols if wrt == "z" else g.pcols)
                    out = out.at[rows[:, :, None], cols[:, None, :]].add(J)
            if general and self.general is not None:
                Jg = (
                    jax.jacfwd(self.general, argnums=0 if wrt == "z" else 1)(z, theta)
                )
                out = out.at[jnp.asarray(self.general_rows), :ncols].set(Jg)
            return out[:, :ncols]

        return jac

    def _scatter_dual_grad(self, groups, general=False, kind=None):
        n, p = self._n, self._p
        use_es = self._einsum_assembly
        Cs = [_onehot(g.zcols, n) for g in groups] if use_es else None

        def dual_grad(z, theta, dual):
            maps = self._block_maps() if kind is not None else None
            if maps is not None and not use_es:
                grad_list, maps_list = [], []
                for i, g in enumerate(groups):
                    Z = _gather(z, g.zcols, n)
                    W = _gather(theta, g.pcols, p)
                    Y = dual[jnp.asarray(g.rows)]

                    def scal(zrow, wrow, yrow, fn=g.fn):
                        return fn(zrow, wrow) @ yrow

                    grad_list.append(jax.vmap(jax.grad(scal))(Z, W, Y))
                    maps_list.append(maps[kind][i])
                out = self._grad_blocks_place(grad_list, maps_list, z.dtype)
                if general and self.general is not None:
                    yg = dual[jnp.asarray(self.general_rows)]
                    out = out + jax.grad(lambda zz: self.general(zz, theta) @ yg)(z)
                return out
            out = jnp.zeros((n + 1,), z.dtype)
            for i, g in enumerate(groups):
                Z = _gather(z, g.zcols, n)
                W = _gather(theta, g.pcols, p)
                Y = dual[jnp.asarray(g.rows)]  # (G, r)

                def scal(zrow, wrow, yrow, fn=g.fn):
                    return fn(zrow, wrow) @ yrow

                grads = jax.vmap(jax.grad(scal))(Z, W, Y)
                if use_es:
                    C = jnp.asarray(Cs[i], z.dtype)
                    out = out + jnp.einsum("gw,gwn->n", grads, C)
                else:
                    out = out.at[jnp.asarray(g.zcols)].add(grads)
            if general and self.general is not None:
                yg = dual[jnp.asarray(self.general_rows)]
                out = out.at[:n].add(
                    jax.grad(lambda zz: self.general(zz, theta) @ yg)(z)
                )
            return out[:n]

        return dual_grad

    def _scatter_dual_hess(self, groups, general=False):
        n, p = self._n, self._p
        use_es = self._einsum_assembly
        Cs = [_onehot(g.zcols, n) for g in groups] if use_es else None

        def dual_hess(z, theta, dual):
            out = jnp.zeros((n + 1, n + 1), z.dtype)
            for i, g in enumerate(groups):
                Z = _gather(z, g.zcols, n)
                W = _gather(theta, g.pcols, p)
                Y = dual[jnp.asarray(g.rows)]

                def scal(zrow, wrow, yrow, fn=g.fn):
                    return fn(zrow, wrow) @ yrow

                hess = jax.vmap(jax.hessian(scal))(Z, W, Y)
                if use_es:
                    C = jnp.asarray(Cs[i], z.dtype)
                    tmp = jnp.einsum("gwv,gvn->gwn", hess, C)
                    out = out + jnp.einsum("gwm,gwn->mn", C, tmp)
                else:
                    zc = jnp.asarray(g.zcols)
                    out = out.at[zc[:, :, None], zc[:, None, :]].add(hess)
            if general and self.general is not None:
                yg = dual[jnp.asarray(self.general_rows)]
                out = out.at[:n, :n].add(
                    jax.hessian(lambda zz: self.general(zz, theta) @ yg)(z)
                )
            return out[:n, :n]

        return dual_hess

    def _scatter_mixed(self, groups):
        """d/dtheta of grad_z(sum of costs): (n, p)."""
        n, p = self._n, self._p
        use_es = self._einsum_assembly
        if use_es:
            Cs = [_onehot(g.zcols, n) for g in groups]
            Ps = [_onehot(g.pcols, p) for g in groups]

        def fxt(z, theta):
            out = jnp.zeros((n + 1, p + 1), z.dtype)
            for i, g in enumerate(groups):
                Z = _gather(z, g.zcols, n)
                W = _gather(theta, g.pcols, p)
                mixed = jax.vmap(jax.jacfwd(jax.grad(g.fn), argnums=1))(Z, W)
                if use_es:
                    C = jnp.asarray(Cs[i], z.dtype)
                    P = jnp.asarray(Ps[i], z.dtype)
                    tmp = jnp.einsum("gwq,gqp->gwp", mixed, P)
                    out = out + jnp.einsum("gwn,gwp->np", C, tmp)
                else:
                    zc, pc = jnp.asarray(g.zcols), jnp.asarray(g.pcols)
                    out = out.at[zc[:, :, None], pc[:, None, :]].add(mixed)
            return out[:n, :p]

        return fxt

    def _scatter_dual_mixed(self, groups, general=False):
        n, p = self._n, self._p
        use_es = self._einsum_assembly
        if use_es:
            Cs = [_onehot(g.zcols, n) for g in groups]
            Ps = [_onehot(g.pcols, p) for g in groups]

        def dual_mixed(z, theta, dual):
            out = jnp.zeros((n + 1, p + 1), z.dtype)
            for i, g in enumerate(groups):
                Z = _gather(z, g.zcols, n)
                W = _gather(theta, g.pcols, p)
                Y = dual[jnp.asarray(g.rows)]

                def scal(zrow, wrow, yrow, fn=g.fn):
                    return fn(zrow, wrow) @ yrow

                mixed = jax.vmap(jax.jacfwd(jax.grad(scal), argnums=1))(Z, W, Y)
                if use_es:
                    C = jnp.asarray(Cs[i], z.dtype)
                    P = jnp.asarray(Ps[i], z.dtype)
                    tmp = jnp.einsum("gwq,gqp->gwp", mixed, P)
                    out = out + jnp.einsum("gwn,gwp->np", C, tmp)
                else:
                    zc, pc = jnp.asarray(g.zcols), jnp.asarray(g.pcols)
                    out = out.at[zc[:, :, None], pc[:, None, :]].add(mixed)
            if general and self.general is not None:
                yg = dual[jnp.asarray(self.general_rows)]
                out = out.at[:n, :p].add(
                    jax.jacfwd(
                        jax.grad(lambda zz, tt: self.general(zz, tt) @ yg), argnums=1
                    )(z, theta)
                )
            return out[:n, :p]

        return dual_mixed

    def lagrangian_hessian_xx(self, x, theta, y, z, constraint_tensor=True):
        if self._block_maps() is not None:
            # blocks + T static dynamic-update-slice writes instead of
            # elementwise (n, n) scatter-adds, which serialize
            D, O, Hgen = self.lagrangian_hessian_blocks(
                x, theta, y, z, constraint_tensor
            )
            H = self.stage_structure.densify(D, O)
            return H if Hgen is None else H + Hgen
        H = self._fxx(x, theta)
        if constraint_tensor:
            if self.dims.equality > 0:
                H = H + self._gty_xx(x, theta, y)
            if self.dims.cone > 0:
                H = H + self._htz_xx(x, theta, z)
        return H

    # ---- direct stage-block Hessian assembly --------------------------------
    # The Lagrangian Hessian of a stagewise problem is stage-block
    # tridiagonal (stage-local functions touch one stage or two adjacent
    # stages) plus a rare dense remainder from equality_general. Building
    # the (T, dmax, dmax) diagonal/coupling blocks directly from the
    # grouped per-stage Hessians -- pad + one-hot stage contraction, no
    # elementwise scatter, no dense (n, n) intermediate -- no serialized
    # scatter assembly and no O(n^2)-per-lane memory wall in the
    # structured backends.

    def _block_maps(self):
        """Per-group static placement maps (t_idx, Q0, Q1), computed once.
        Returns None when any group's members disagree on their relative
        (stage-offset, segment) pattern or stage_structure is missing --
        callers then fall back to the dense scatter path."""
        st = getattr(self, "stage_structure", None)
        if st is None:
            return None  # not cached: the structure may be attached later
        if hasattr(self, "_block_maps_cache"):
            return self._block_maps_cache
        try:
            maps = {
                "cost": [self._group_map(g, st) for g in self.cost_groups],
                "eq": [self._group_map(g, st) for g in self.eq_groups],
                "cone": [self._group_map(g, st) for g in self.cone_groups],
            }
        except ValueError:
            maps = None
        self._block_maps_cache = maps
        return maps

    @staticmethod
    def _group_map(g: _Group, st):
        """Static placement of one group's stage-local variable columns:
        member i's zcols land in stage t_i (segment 0) and optionally
        stage t_i + 1 (segment 1, dynamics' next-state block). Q0/Q1 are
        0/1 (width, dmax) matrices mapping width-index -> block offset,
        shared by every member (verified; ValueError if violated)."""
        n = st.num_variables
        zc = np.asarray(g.zcols)
        if np.any(zc >= n):
            raise ValueError("sentinel-padded columns")  # not stage-local
        zt = st.inv_t[zc]  # (G, w) stage of each column
        zo = st.inv_o[zc]  # (G, w) offset within the stage block
        t_idx = zt.min(axis=1)  # (G,)
        seg = zt - t_idx[:, None]
        if seg.max(initial=0) > 1:
            raise ValueError("columns span more than two stages")
        if not (np.all(seg == seg[0]) and np.all(zo == zo[0])):
            raise ValueError("members disagree on the placement pattern")
        seg0, off0 = seg[0], zo[0]
        w, dmax = zc.shape[1], st.dmax
        Q0 = np.zeros((w, dmax), np.float32)
        Q1 = np.zeros((w, dmax), np.float32)
        Q0[seg0 == 0, off0[seg0 == 0]] = 1.0
        Q1[seg0 == 1, off0[seg0 == 1]] = 1.0
        return t_idx, Q0, (Q1 if np.any(seg0 == 1) else None)

    def lagrangian_hessian_blocks(self, x, theta, y, z, constraint_tensor=True):
        """Stage-block tridiagonal Lagrangian Hessian: (D (T, dmax, dmax),
        O (T-1, dmax, dmax), Hgen dense-or-None). D/O carry every
        stage-local term; Hgen is the equality_general dual Hessian (dense
        (n, n); zero -- and folded away by XLA -- for the usual linear
        periodicity constraints)."""
        st = self.stage_structure
        maps = self._block_maps()
        T, dmax = st.horizon, st.dmax
        n, p = self._n, self._p
        dt = x.dtype
        D = jnp.zeros((T, dmax, dmax), dt)
        O = jnp.zeros((max(T - 1, 0), dmax, dmax), dt)

        def add_group(D, O, H, m):
            """H (G, w, w) member Hessians -> block contributions."""
            t_idx, Q0, Q1 = m
            q0 = jnp.asarray(Q0, dt)
            S0 = jnp.asarray(_onehot(t_idx, T)[:, :T], dt)  # (G, T)
            A00 = jnp.einsum("ja,gjk,kb->gab", q0, H, q0)
            D = D + jnp.einsum("gt,gab->tab", S0, A00)
            if Q1 is not None:
                q1 = jnp.asarray(Q1, dt)
                S1 = jnp.asarray(_onehot(t_idx + 1, T)[:, :T], dt)
                A11 = jnp.einsum("ja,gjk,kb->gab", q1, H, q1)
                D = D + jnp.einsum("gt,gab->tab", S1, A11)
                # O_t = H[stage t+1 rows, stage t cols]
                So = jnp.asarray(_onehot(t_idx, max(T - 1, 1))[:, : T - 1], dt)
                A10 = jnp.einsum("ja,gjk,kb->gab", q1, H, q0)
                O = O + jnp.einsum("gt,gab->tab", So, A10)
            return D, O

        for i, g in enumerate(self.cost_groups):
            Z = _gather(x, g.zcols, n)
            W = _gather(theta, g.pcols, p)
            H = jax.vmap(jax.hessian(g.fn))(Z, W)
            D, O = add_group(D, O, H, maps["cost"][i])

        if constraint_tensor:
            for kind, groups, dual in (
                ("eq", self.eq_groups, y),
                ("cone", self.cone_groups, z),
            ):
                if dual is None or dual.shape[0] == 0:
                    continue
                for i, g in enumerate(groups):
                    Z = _gather(x, g.zcols, n)
                    W = _gather(theta, g.pcols, p)
                    Y = dual[jnp.asarray(g.rows)]

                    def scal(zrow, wrow, yrow, fn=g.fn):
                        return fn(zrow, wrow) @ yrow

                    H = jax.vmap(jax.hessian(scal))(Z, W, Y)
                    D, O = add_group(D, O, H, maps[kind][i])

        Hgen = None
        if constraint_tensor and self.general is not None:
            yg = y[jnp.asarray(self.general_rows)]
            Hgen = jax.hessian(lambda zz: self.general(zz, theta) @ yg)(x)
        return D, O, Hgen
